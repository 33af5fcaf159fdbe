"""Port parity: fixed-grid ``odeint`` against the JAX package.

The toy problems of ``tests/test_ode.py`` in float32, made with numpy and
given to both packages.  Trajectories agree to 1e-6 and the NFE counts are
equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_odenet_tpu.ode import odeint as jodeint
from graph_odenet_tpu_torch.ode import odeint as todeint
from graph_odenet_tpu_torch.ode.tableaus import RK4_38, rk_step

TOL = dict(rtol=1e-6, atol=1e-6)

PROBLEMS = {
    # name: (jax dynamics, torch dynamics, y0)
    "exp_decay": (lambda t, y: -0.5 * y, lambda t, y: -0.5 * y, [1.0, 2.0]),
    "oscillator": (
        lambda t, y: jnp.stack([y[1], -y[0]]),
        lambda t, y: torch.stack([y[1], -y[0]]),
        [1.0, 0.0],
    ),
    "forced": (
        lambda t, y: jnp.sin(t) * jnp.ones_like(y),
        lambda t, y: torch.sin(t) * torch.ones_like(y),
        [0.0, 0.5],
    ),
}


@pytest.mark.parametrize("method", ["rk4", "rk4_classic", "euler"])
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
@pytest.mark.parametrize("reverse", [False, True])
def test_odeint_matches_jax(method, problem, reverse):
    jf, tf, y0 = PROBLEMS[problem]
    y0 = np.asarray(y0, np.float32)
    ts = np.linspace(0.0, 2.0, 9).astype(np.float32)
    if reverse:
        ts = ts[::-1].copy()
    jys, jstats = jodeint(
        jf, jnp.asarray(y0), jnp.asarray(ts), method=method,
        steps_per_interval=4, return_stats=True,
    )
    tys, tstats = todeint(
        tf, torch.from_numpy(y0), torch.from_numpy(ts), method=method,
        steps_per_interval=4, return_stats=True,
    )
    assert tys.dtype == torch.float32 and tys.shape == (9, 2)
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys), **TOL)
    assert tstats["nfe"] == int(jstats["nfe"])


def test_odeint_args_and_gradient():
    """``*args`` reach the dynamics, and autograd goes through the steps."""
    k = torch.tensor(0.7, requires_grad=True)
    ys = todeint(
        lambda t, y, k: -k * y, torch.tensor([1.0]), [0.0, 1.0], k,
        method="rk4", steps_per_interval=16,
    )
    ys[-1, 0].backward()
    np.testing.assert_allclose(float(ys[-1, 0].detach()), np.exp(-0.7), rtol=1e-5)
    np.testing.assert_allclose(float(k.grad), -np.exp(-0.7), rtol=1e-4)


def test_rk_step_matches_kutta_three_eighths():
    f = lambda t, y: -0.5 * y  # noqa: E731
    y0 = torch.tensor([1.0])
    dt = torch.tensor(0.1)
    y1, f1, y_err, ks = rk_step(f, RK4_38, torch.tensor(0.0), y0, f(0.0, y0), dt)
    assert len(ks) == 4 and y_err is None
    np.testing.assert_allclose(float(y1), np.exp(-0.05), rtol=1e-6)
    np.testing.assert_allclose(float(f1), -0.5 * float(y1), rtol=1e-6)


@pytest.mark.parametrize("method,item", [("dopri5", "A12"), ("dopri5_scan", "A12"), ("adams", "A14")])
def test_unported_methods_name_their_roadmap_item(method, item):
    with pytest.raises(NotImplementedError, match=item):
        todeint(lambda t, y: y, torch.ones(2), [0.0, 1.0], method=method)
