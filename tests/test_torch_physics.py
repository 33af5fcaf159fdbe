"""Port parity: the interaction network and the IN-ODE against flax, at
small widths.

The flax parameters are carried over by ``convert.params_from_interaction``.
Outputs agree to 1e-5 in float32 and every parameter's gradient to 1e-4;
the IN-ODE runs dopri5_scan (each window its own problem, as under
``jax.vmap``) and rk4, with and without remat, batched and unbatched.  The
trainers are in ``tests/test_torch_physics_train.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_odenet_tpu.data.nbody import SpringSystem as JSpringSystem
from graph_odenet_tpu.models import INODE as JINODE
from graph_odenet_tpu.models import InteractionNetwork as JIN
from graph_odenet_tpu_torch.convert import params_from_interaction
from graph_odenet_tpu_torch.data import SpringSystem
from graph_odenet_tpu_torch.models import INODE, InteractionNetwork

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
N = 4
WIDTHS = dict(effect_dim=8, relation_hidden=(16, 16), object_hidden=(16,))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _edges():
    s, r = JSpringSystem(n_bodies=N).edges()
    return s, r, *SpringSystem(n_bodies=N).edges()


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _check_grads(model, jgrads):
    want = params_from_interaction(_numpy_tree(jgrads))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], **GRAD_TOL, msg=lambda m, k=k: f"{k}: {m}")


@pytest.mark.parametrize("extras", [False, True])
@pytest.mark.parametrize("batched", [False, True])
def test_interaction_network_matches_flax(batched, extras):
    js, jr, ts_, tr = _edges()
    rng = np.random.default_rng(0)
    lead = (3,) if batched else ()
    objs = _f32(rng, *lead, N, 5)
    rel = _f32(rng, *lead, N * (N - 1), 2) if extras else None
    ext = _f32(rng, *lead, N, 3) if extras else None
    w = _f32(rng, *lead, N, 2)
    jmodel = JIN(out_dim=2, **WIDTHS)
    one = lambda o, ra, e: (o, js, jr, ra, e)  # noqa: E731
    first = lambda a: a[0] if batched and a is not None else a  # noqa: E731
    jparams = jmodel.init(jax.random.PRNGKey(0), *one(*map(first, (objs, rel, ext))))["params"]

    def japply(p):
        f = lambda o, ra, e: jmodel.apply({"params": p}, *one(o, ra, e))  # noqa: E731
        return jax.vmap(f)(objs, rel, ext) if batched else f(objs, rel, ext)

    jout = np.array(japply(jparams))
    jgrads = jax.grad(lambda p: jnp.sum(japply(p) * w))(jparams)

    model = InteractionNetwork(5, 2, **WIDTHS, rel_dim=2 if extras else 0,
                               ext_dim=3 if extras else 0)
    model.load_state_dict(params_from_interaction(_numpy_tree(jparams)))
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    out = model(t(objs), ts_, tr, t(rel), t(ext))
    torch.testing.assert_close(out, torch.from_numpy(jout), **OUT_TOL)
    (out * t(w)).sum().backward()
    _check_grads(model, jgrads)


INODE_KW = dict(rtol=1e-4, atol=1e-6, steps=6, **WIDTHS)


@functools.lru_cache(maxsize=None)
def _jax_inode(method, batched):
    """Inputs, flax parameters, output and parameter gradients of the JAX
    IN-ODE (remat changes memory, not values, so one reference serves both)."""
    js, jr, _, _ = _edges()
    rng = np.random.default_rng(1)
    lead = (3,) if batched else ()
    y0 = _f32(rng, *lead, N, 4)
    mass = rng.uniform(0.5, 2.0, lead + (N, 1)).astype(np.float32)
    ts = (np.arange(5) * 0.01).astype(np.float32)
    w = _f32(rng, *lead, 5, N, 4)
    jmodel = JINODE(dim=2, method=method, **INODE_KW)
    jparams = jmodel.init(jax.random.PRNGKey(0), y0[0] if batched else y0, jnp.asarray(ts),
                          mass[0] if batched else mass, js, jr)["params"]

    def loss(p):
        f = lambda y, m: jmodel.apply({"params": p}, y, jnp.asarray(ts), m, js, jr)  # noqa: E731
        out = jax.vmap(f)(y0, mass) if batched else f(y0, mass)
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jparams)
    return (y0, mass, ts, w), _numpy_tree(jparams), np.array(jout), _numpy_tree(jgrads)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("method", ["dopri5_scan", "rk4"])
def test_inode_matches_flax(method, batched, remat):
    (y0, mass, ts, w), jparams, jout, jgrads = _jax_inode(method, batched)
    _, _, ts_, tr = _edges()
    model = INODE(dim=2, method=method, remat=remat, **INODE_KW)
    model.load_state_dict(params_from_interaction(jparams))
    out = model(torch.from_numpy(y0), torch.from_numpy(ts), torch.from_numpy(mass), ts_, tr)
    assert out.shape == ((3,) if batched else ()) + (5, N, 4)
    torch.testing.assert_close(out, torch.from_numpy(jout), **OUT_TOL)
    (out * torch.from_numpy(w)).sum().backward()
    _check_grads(model, jgrads)
    if method == "dopri5_scan" and batched:
        assert model.stats["success"].all() and model.stats["n_accept"].shape == (3,)
