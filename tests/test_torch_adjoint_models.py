"""Port parity: the models trained through ``odeint_adjoint`` (GCN-ODE and
GAT-ODE through ``ODEBlock``, and the IN-ODE) against the flax models with
the same ``adjoint``.

The flax parameters are carried over by ``convert``.  The node classifiers
run in float32, as the kernels do: the port's GCN-ODE aggregates through
the CSR kernel's wrapper and its GAT-ODE through the GAT kernels' wrappers
(their plain versions on the CPU), where JAX takes the segment path.  Their
log-probs and parameter gradients agree as the direct path's do
(``tests/test_torch_gcnode.py``, ``tests/test_torch_gatode.py``): to 1e-5
for GCN-ODE (rk4, fixed steps both ways) and 1e-4 for GAT-ODE, whose
forward and continuous-adjoint reverse solves are adaptive and carry the
float32 rounding of the error estimate.  The IN-ODE has no kernel and runs
in float64 (both packages compute with the same float32-rounded weights):
trajectories to 1e-9, gradients to 1e-9 of each one's largest entry with
the checkpointed adjoint and 1e-8 with the continuous one, whose adaptive
reverse solve takes its error ratio over about 1,000 components of very
different scale, so that its steps carry the rounding of that sum further
(``tests/test_torch_adjoint.py``; a θ̄ shared by the windows moves them by
4e-4 of the largest entry, 9e-2 of some).

The JAX ``INODE`` with an adjoint cannot run under ``jax.vmap``: its
dynamics closes over the batched ``static_attr`` inside the adjoint's
``custom_vjp`` (an ``UnexpectedTracerError``, ROADMAP C).  So the port's
batched adjoints are held to the sum of the JAX gradients of each window,
which is what ``jax.vmap`` would compute: every window its own problem.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_odenet_tpu.data import synthetic_planetoid as jsynthetic
from graph_odenet_tpu.data.nbody import SpringSystem as JSpringSystem
from graph_odenet_tpu.models import GATODE as JGATODE
from graph_odenet_tpu.models import GCNODE as JGCNODE
from graph_odenet_tpu.models import INODE as JINODE
from graph_odenet_tpu.utils.metrics import masked_nll as jnll
from graph_odenet_tpu_torch.convert import params_from_flax, params_from_interaction
from graph_odenet_tpu_torch.data import SpringSystem
from graph_odenet_tpu_torch.data import synthetic_planetoid as tsynthetic
from graph_odenet_tpu_torch.models import GATODE, GCNODE, INODE
from graph_odenet_tpu_torch.ops import prepare
from graph_odenet_tpu_torch.utils.metrics import masked_nll

REL = 1e-9  # the IN-ODE's, of each gradient's largest entry
REL_CONTINUOUS = 1e-8
F64 = jnp.float64
TOL = {"gcnode": dict(rtol=1e-5, atol=1e-5), "gatode": dict(rtol=1e-4, atol=1e-4)}


@pytest.fixture(scope="module")
def data():
    return tsynthetic("cora", scale=0.08), jsynthetic("cora", scale=0.08)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, F64), tree)


def _to_torch64(convert, tree):
    """``convert`` of a float64 tree at float64: its float32 head and tail."""
    hi = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    lo = jax.tree_util.tree_map(lambda a, h: np.asarray(np.asarray(a, np.float64) - h,
                                                        np.float32), tree, hi)
    hi, lo = convert(hi), convert(lo)
    return {k: hi[k].double() + lo[k].double() for k in hi}


def _assert_grads(model, want, rel=None, **tol):
    got = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, g in want.items():
        kw = tol or dict(rtol=rel, atol=rel * float(g.abs().max()))
        torch.testing.assert_close(got[k], g, **kw, msg=lambda m, k=k: f"{k}: {m}")


# GCN-ODE on rk4 × 2 (the reverse solve fixed too); GAT-ODE on dopri5_scan
# with 6 attempts (the continuous adjoint's reverse solve adaptive).
MODELS = {
    "gcnode": (lambda n_in, c, adj: GCNODE(n_in, hidden=8, n_class=c, method="rk4", steps=2,
                                           adjoint=adj),
               lambda c, adj: JGCNODE(hidden=8, n_class=c, method="rk4", steps=2, adjoint=adj)),
    "gatode": (lambda n_in, c, adj: GATODE(n_in, hidden=4, heads=2, n_class=c, steps=6,
                                           adjoint=adj),
               lambda c, adj: JGATODE(hidden=4, heads=2, n_class=c, steps=6, adjoint=adj)),
}


@pytest.mark.parametrize("adjoint", [True, "checkpoint"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_logprobs_and_gradients_match_flax(data, name, adjoint):
    td, jd = data
    make_t, make_j = MODELS[name]
    jmodel = make_j(jd.n_class, adjoint)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jd.graph, jd.features)["params"]

    @jax.jit
    def jloss(p):
        out, state = jmodel.apply({"params": p}, jd.graph, jd.features, mutable=["intermediates"])
        return jnll(out, jd.labels, jd.idx_train), (out, state)

    (jl, (jout, jstate)), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)

    model = make_t(td.features.shape[1], td.n_class, adjoint)
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, jparams)))
    out = model(prepare(td.graph), td.features)
    loss = masked_nll(out, td.labels, td.idx_train)
    loss.backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL[name])
    np.testing.assert_allclose(loss.item(), float(jl), **TOL[name])
    _assert_grads(model, params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads)),
                  **TOL[name])
    (jstats,) = jstate["intermediates"]["ODEBlock_0"]["ode_stats"]
    for k, v in model.odeblock.stats.items():
        if k != "t_reached":
            assert v == int(jstats[k]), k


def test_checkpoint_and_continuous_adjoints_agree_in_a_model(data):
    """tests/test_ode.py:586: GCNODE with either adjoint on dopri5_scan gives
    the same loss and, within the solves' tolerance, the same gradients (the
    continuous one under ``remat``, which changes memory, not values)."""
    td, _ = data
    grads, losses = [], []
    for adjoint in ("checkpoint", True):
        model = GCNODE(td.features.shape[1], hidden=8, n_class=td.n_class, method="dopri5_scan",
                       steps=16, rtol=1e-5, atol=1e-7, adjoint=adjoint, remat=adjoint is True,
                       generator=torch.Generator().manual_seed(0))
        loss = masked_nll(model(prepare(td.graph), td.features), td.labels, td.idx_train)
        loss.backward()
        losses.append(loss.item())
        grads.append([p.grad for p in model.parameters()])
        assert model.odeblock.stats["success"]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=2e-3, rtol=2e-2)


# --- the IN-ODE ------------------------------------------------------------

N = 4
WIDTHS = dict(effect_dim=8, relation_hidden=(16, 16), object_hidden=(16,))
INODE_KW = dict(method="dopri5_scan", rtol=1e-5, atol=1e-7, steps=128, **WIDTHS)


@functools.lru_cache(maxsize=None)
def _windows():
    """Two windows of different stiffness (the second moves six times
    faster), and the JAX package's parameters."""
    rng = np.random.default_rng(1)
    y0 = rng.standard_normal((2, N, 4))
    y0[1] *= 6.0
    mass = rng.uniform(0.5, 2.0, (2, N, 1))
    ts = np.arange(3) * 0.05
    w = rng.standard_normal((2, 3, N, 4))
    js, jr = JSpringSystem(n_bodies=N).edges()
    p32 = JINODE(dim=2, **INODE_KW).init(jax.random.PRNGKey(0), y0[0], jnp.asarray(ts),
                                        mass[0], js, jr)["params"]
    return y0, mass, ts, w, jax.tree_util.tree_map(np.asarray, p32)


@functools.lru_cache(maxsize=None)
def _jax_inode(adjoint):
    """The JAX IN-ODE's trajectories and summed parameter gradients, window by
    window, in float64 (remat changes memory, not values: one serves both)."""
    y0, mass, ts, w, p32 = _windows()
    js, jr = JSpringSystem(n_bodies=N).edges()
    jmodel = JINODE(dim=2, adjoint=adjoint, dtype=F64, param_dtype=F64, **INODE_KW)
    outs, grads = [], None
    for b in range(2):
        def jloss(p, b=b):
            out = jmodel.apply({"params": p}, y0[b], jnp.asarray(ts), mass[b], js, jr)
            return jnp.sum(out * w[b]), out

        (_, out), g = jax.value_and_grad(jloss, has_aux=True)(_f64(p32))
        outs.append(np.asarray(out))
        grads = g if grads is None else jax.tree_util.tree_map(jnp.add, grads, g)
    return np.stack(outs), _to_torch64(params_from_interaction, grads)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("adjoint", [True, "checkpoint"])
def test_batched_inode_matches_flax_window_by_window(adjoint, remat):
    y0, mass, ts, w, p32 = _windows()
    jout, jgrads = _jax_inode(adjoint)
    senders, receivers = SpringSystem(n_bodies=N).edges()
    model = INODE(dim=2, adjoint=adjoint, remat=remat, **INODE_KW)
    model.load_state_dict(params_from_interaction(p32))
    model.double()
    out = model(*map(torch.from_numpy, (y0, ts, mass)), senders, receivers)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=REL, atol=REL)
    _assert_grads(model, jgrads, REL_CONTINUOUS if adjoint is True else REL)
    assert model.stats["success"].all()
    if adjoint is True:  # the windows take their own steps, so each needs its own θ̄
        acc = model.stats["n_accept"].tolist()
        assert acc[0] != acc[1], acc
