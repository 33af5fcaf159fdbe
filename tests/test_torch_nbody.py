"""Port parity: the spring n-body data against the JAX package, in float64.

The JAX package draws initial states from ``jax.random`` and the port from
torch's generators, so the simulation is compared from the JAX package's own
initial states (``trajs[:, 0]``): edges equal, accelerations and every step
of a 30-step simulation to 1e-12, the one-step dataset equal.  The port's
generator gives the same data for the same seed, and without damping the
spring forces conserve momentum, as ``tests/test_data.py`` checks for JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_odenet_tpu.data.nbody import SpringSystem as JSpringSystem
from graph_odenet_tpu.data.nbody import generate_trajectories as jgenerate
from graph_odenet_tpu.data.nbody import one_step_dataset as jone_step
from graph_odenet_tpu_torch.data import (
    SpringSystem,
    generate_trajectories,
    one_step_dataset,
    simulate,
)

TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", [2, 4, 6])
def test_edges_are_jax_sender_major_order(n):
    s, r = SpringSystem(n_bodies=n).edges()
    js, jr = JSpringSystem(n_bodies=n).edges()
    assert s.dtype == torch.int64 and s.shape == (n * (n - 1),)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))


@pytest.mark.parametrize("damping", [0.0, 0.02])
def test_acceleration_and_step_match_jax(damping):
    rng = np.random.default_rng(0)
    mass = rng.uniform(0.5, 2.0, (3, 4, 1))
    pos, vel = rng.standard_normal((3, 4, 2)), rng.standard_normal((3, 4, 2))
    jsys = JSpringSystem(n_bodies=4, damping=damping)
    tsys = SpringSystem(n_bodies=4, damping=damping)
    want = jax.vmap(jsys.acceleration)(*map(jnp.asarray, (mass, pos, vel)))
    got = tsys.acceleration(*map(torch.from_numpy, (mass, pos, vel)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jpos, jvel = jax.vmap(jsys.step)(*map(jnp.asarray, (mass, pos, vel)))
    tpos, tvel = tsys.step(*map(torch.from_numpy, (mass, pos, vel)))
    np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), **TOL)
    np.testing.assert_allclose(tvel.numpy(), np.asarray(jvel), **TOL)


@pytest.mark.parametrize("record_every", [1, 2])
def test_simulation_from_jax_initial_states(record_every):
    jsys = JSpringSystem(n_bodies=4)
    want = np.array(jgenerate(jsys, jax.random.PRNGKey(3), 3, 30, record_every=record_every))
    assert want.dtype == np.float64
    first = torch.from_numpy(want[:, 0])
    got = simulate(SpringSystem(n_bodies=4), first[..., :1], first[..., 1:3], first[..., 3:5], 30,
                   record_every=record_every)
    assert got.shape == want.shape == (3, 31, 4, 5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_one_step_dataset_matches_jax():
    want = np.array(jgenerate(JSpringSystem(n_bodies=3), jax.random.PRNGKey(4), 2, 5))
    jx, jy = jone_step(jnp.asarray(want))
    x, y = one_step_dataset(torch.from_numpy(want))
    assert x.shape == (10, 3, 5) and y.shape == (10, 3, 2)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


def test_generator_is_deterministic_per_seed():
    sys_ = SpringSystem(n_bodies=4)
    make = lambda seed: generate_trajectories(  # noqa: E731
        sys_, 3, 10, generator=torch.Generator().manual_seed(seed))
    a, b, c = make(0), make(0), make(1)
    assert a.shape == (3, 11, 4, 5) and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    mass = a[..., :1]
    assert torch.all((mass >= 0.5) & (mass <= 2.0))
    torch.testing.assert_close(mass, mass[:, :1].expand_as(mass), rtol=0, atol=0)


def test_momentum_conserved_without_damping():
    """Spring forces are equal and opposite, so Σ m·v is invariant."""
    sys_ = SpringSystem(n_bodies=5, damping=0.0)
    trajs = generate_trajectories(sys_, 2, 200, generator=torch.Generator().manual_seed(1))
    p = (trajs[..., :1] * trajs[..., 3:5]).sum(dim=2)  # [S, T, 2]
    drift = float((p - p[:, :1]).abs().max())
    assert drift < 1e-3, drift
    assert torch.isfinite(trajs).all() and trajs[..., 1:3].abs().max() < 100.0
