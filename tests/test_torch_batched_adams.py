"""Port parity: the batched VCABM (``odeint(batch_dims=1)`` on ``adams`` and
``adams_scan``), the batched continuous adjoint over them and over
``scipy_solver``, and the batched ``scipy_solver``, against ``jax.vmap`` of
the JAX package's functions, in float64; the batched IN-ODE on
``adams_scan`` against flax in float32.

Under ``jax.vmap`` every sample of JAX's VCABM has its own order, history,
step size and stats; so has every sample of the port's batched form.
Oscillators of different stiffness climb to different orders in different
numbers of steps.  Values agree to 1e-10, the per-sample ``nfe``,
``n_accept``, ``n_reject``, ``success`` and ``final_order`` are equal and
``t_reached`` agrees to 1e-7; a sample that runs out of its budget stops at
the same step, its values to 1e-7 (the rounding of its last steps, as in the
unbatched exhaustion test of ``tests/test_torch_adams.py``).  Gradients agree
with ``jax.grad`` to 1e-10 and through the continuous adjoint with
``jax.vmap`` of JAX's ``odeint_adjoint`` to 1e-9.  ``scipy_solver`` runs one
host solve per sample and agrees to 1e-12, as unbatched.  The host reads once
an attempt round for the whole batch.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_odenet_tpu.ode import odeint as jodeint
from graph_odenet_tpu.ode import odeint_adjoint as jadjoint
from graph_odenet_tpu_torch.ode import odeint as todeint
from graph_odenet_tpu_torch.ode import odeint_adjoint as tadjoint
from graph_odenet_tpu_torch.ode import vcabm

F64 = torch.float64
TRAJ = dict(rtol=1e-10, atol=1e-10)
EXHAUSTED = dict(rtol=1e-7, atol=1e-7)
GRAD = dict(rtol=1e-10, atol=1e-12)
ADJOINT = dict(rtol=1e-9, atol=1e-9)
SCIPY = dict(rtol=1e-12, atol=1e-12)
COUNTS = ("nfe", "n_accept", "n_reject", "success", "final_order")
# Oscillators y'' = -k·y - c·y' (tests/test_torch_batched_ode.py): stiffness
# 1, 25 and a damped 9; the stiff set puts 400 in the middle.
STIFFNESS = np.array([1.0, 25.0, 9.0])
STIFF = np.array([1.0, 400.0, 9.0])
DAMPING = np.array([0.0, 0.0, 0.5])
Y0 = np.array([[1.0, 0.0], [1.0, 0.0], [0.3, -1.0]])
TS = np.linspace(0.0, 2.0, 6)
TOLS = dict(rtol=1e-6, atol=1e-8)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jfield(t, y, k, c):
    return jnp.stack([y[1], -k * y[0] - c * y[1]])


def _tfield(k, c):
    k, c = torch.from_numpy(k), torch.from_numpy(c)

    def f(t, y):
        assert t.shape == (y.shape[0],)
        return torch.stack([y[:, 1], -k * y[:, 0] - c * y[:, 1]], dim=-1)

    return f


def _both(method, ts=TS, stiffness=STIFFNESS, **kw):
    def one(y0, k, c):
        return jodeint(_jfield, y0, jnp.asarray(ts), k, c, method=method, return_stats=True,
                       **kw)

    jys, js = jax.vmap(one)(jnp.asarray(Y0), jnp.asarray(stiffness), jnp.asarray(DAMPING))
    tys, tst = todeint(_tfield(stiffness, DAMPING), torch.from_numpy(Y0),
                       torch.from_numpy(np.asarray(ts)), method=method, return_stats=True,
                       batch_dims=1, **kw)
    return np.swapaxes(np.asarray(jys), 0, 1), {k: np.asarray(v) for k, v in js.items()}, tys, tst


def _assert_counts(tst, js, t_tol=dict(rtol=1e-7)):
    for k in COUNTS:
        np.testing.assert_array_equal(tst[k].numpy(), js[k], err_msg=k)
    np.testing.assert_allclose(tst["t_reached"].numpy(), js["t_reached"], **t_tol)


@pytest.mark.parametrize("kw", [{}, dict(first_step=0.01), dict(max_order=4)],
                         ids=["default", "first_step", "max_order"])
@pytest.mark.parametrize("method", ["adams", "adams_scan"])
def test_batched_matches_vmapped_jax(method, kw):
    jys, js, tys, tst = _both(method, **TOLS, **kw)
    assert tys.dtype == F64 and tys.shape == jys.shape == (6, 3, 2)
    np.testing.assert_allclose(tys.numpy(), jys, **TRAJ)
    _assert_counts(tst, js)
    assert tst["success"].all()
    assert tst["final_order"].max() <= kw.get("max_order", 12)


def test_samples_climb_to_their_own_orders():
    """One controller for the batch would give every sample the same steps and
    order."""
    jys, js, tys, tst = _both("adams_scan", stiffness=STIFF, max_steps_per_interval=256, **TOLS)
    np.testing.assert_allclose(tys.numpy(), jys, **TRAJ)
    _assert_counts(tst, js)
    acc = tst["n_accept"].numpy()
    assert acc[1] > 3 * acc[0], acc
    assert len(set(tst["final_order"].tolist())) > 1, tst["final_order"]


@pytest.mark.parametrize("method,budget", [("adams", "max_steps"),
                                           ("adams_scan", "max_steps_per_interval")])
def test_per_sample_budget_exhaustion(method, budget):
    """The stiff sample runs out of attempts; the others still succeed."""
    jys, js, tys, tst = _both(method, stiffness=STIFF, **TOLS, **{budget: 20})
    np.testing.assert_array_equal(tst["success"].numpy(), [True, False, True])
    _assert_counts(tst, js)
    np.testing.assert_allclose(tys.numpy()[:, [0, 2]], jys[:, [0, 2]], **TRAJ)
    np.testing.assert_allclose(tys.numpy()[:, 1], jys[:, 1], **EXHAUSTED)


def test_reverse_time_per_sample():
    jys, js, tys, tst = _both("adams", ts=np.array([1.0, 0.6, 0.0]), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(tys.numpy(), jys, **TRAJ)
    _assert_counts(tst, js, t_tol=dict(rtol=0, atol=1e-12))


@pytest.mark.parametrize("method", ["adams", "adams_scan"])
def test_batch_of_one_is_the_unbatched_form(method):
    ts = torch.linspace(0.0, 2.0, 5, dtype=F64)
    f = _tfield(STIFF[1:2], DAMPING[1:2])
    y0 = torch.from_numpy(Y0[1:2])
    kw = dict(method=method, return_stats=True, **TOLS)
    ys_b, s_b = todeint(f, y0, ts, batch_dims=1, **kw)
    ys_u, s_u = todeint(lambda t, y: f(t.reshape(1), y[None])[0], y0[0], ts, **kw)
    torch.testing.assert_close(ys_b[:, 0], ys_u, **TRAJ)
    for k in COUNTS:
        assert s_b[k].item() == s_u[k], k
    assert s_b["t_reached"].item() == pytest.approx(s_u["t_reached"], rel=1e-12)


@pytest.mark.parametrize("method", ["adams_scan", "adams"])
def test_gradients_match_vmapped_jax(method):
    """d/d(y0, k, c) of a loss over every sample's trajectory.  The soft
    oscillator lands on each output time rounds before the stiff one, and
    passes the rest of the round's attempts through: its gradient stays
    finite and JAX's.  ``adams`` (JAX's while form) is held to ``jax.grad``
    of the scan form, which takes the same steps."""
    ts = np.linspace(0.0, 1.0, 4)
    kw = dict(rtol=1e-7, atol=1e-9, max_steps_per_interval=128)
    w = np.random.default_rng(0).standard_normal((4, 3, 2))

    def jloss(y0, k, c):
        ys = jax.vmap(lambda y, kk, cc: jodeint(_jfield, y, jnp.asarray(ts), kk, cc,
                                                method="adams_scan", **kw))(y0, k, c)
        return jnp.sum(jnp.swapaxes(ys, 0, 1) * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (Y0, STIFF, DAMPING)))
    y0, k, c = (torch.from_numpy(a.copy()).requires_grad_() for a in (Y0, STIFF, DAMPING))

    def f(t, y):
        return torch.stack([y[:, 1], -k * y[:, 0] - c * y[:, 1]], dim=-1)

    ys, stats = todeint(f, y0, torch.from_numpy(ts), method=method, batch_dims=1,
                        return_stats=True, **kw)
    attempts = (stats["n_accept"] + stats["n_reject"]).tolist()
    assert attempts[1] > 2 * attempts[0], attempts
    (ys * torch.from_numpy(w)).sum().backward()
    for got, want in zip((y0.grad, k.grad, c.grad), jg):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD)


def _jtanh(t, y, w):
    return jnp.tanh(w @ y) * (1 + t)


def _ttanh(t, y, w):
    scale = 1 + t.reshape(t.shape + (1,) * (y.dim() - t.dim()))
    return torch.tanh(torch.einsum("...ij,...j->...i", w, y)) * scale


@pytest.mark.parametrize("method", ["adams", "adams_scan", "scipy_solver"])
def test_continuous_adjoint_matches_vmapped_jax(method):
    """y0, the shared parameter and ts through the continuous adjoint, whose
    reverse solve of each sample's ``[y | a | t̄ | θ̄]`` runs on the forward's
    method with its own controller."""
    ts = np.linspace(0.0, 1.0, 3)
    y0_ = np.array([[0.5, -0.3], [5.0, 2.0], [0.0, 1.0]])
    wt = np.random.default_rng(0).standard_normal((3, 3, 2))
    w4 = np.array([[0.1, -4.0], [3.0, 0.2]])
    kw = dict(method=method, rtol=1e-8, atol=1e-10)

    def jloss(y0, w, tt):
        ys = jax.vmap(lambda y: jadjoint(_jtanh, y, tt, w, **kw))(y0)
        return jnp.sum(jnp.swapaxes(ys, 0, 1) * wt)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (y0_, w4, ts)))
    y0, w, tt = (torch.tensor(a, dtype=F64, requires_grad=True) for a in (y0_, w4, ts))
    ys, stats = tadjoint(_ttanh, y0, tt, w, batch_dims=1, return_stats=True, **kw)
    (ys * torch.from_numpy(wt)).sum().backward()
    for got, want in zip((y0.grad, w.grad, tt.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ADJOINT)
    assert stats["nfe"].shape == (3,)


def test_scipy_solver_batched_matches_vmapped_jax():
    """One host solve per sample, in order (JAX's ``vmap_method="sequential"``),
    with ``nfe`` -1 for each as ``jax.vmap`` gives it; forward only."""
    jys, js, tys, tst = _both("scipy_solver", rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(tys.numpy(), jys, **SCIPY)
    np.testing.assert_array_equal(tst["nfe"].numpy(), js["nfe"])
    k = torch.from_numpy(STIFFNESS.copy()).requires_grad_()
    ys = todeint(lambda t, y, k: torch.stack([y[:, 1], -k * y[:, 0]], dim=-1),
                 torch.from_numpy(Y0), [0.0, 1.0], k, method="scipy_solver", batch_dims=1)
    with pytest.raises(RuntimeError, match="forward only"):
        ys.sum().backward()


class _HostReads:
    """Counts the tensor methods that read a value on the host."""

    NAMES = ("tolist", "item", "__bool__", "__float__", "__int__")

    def __init__(self, monkeypatch):
        self.count = 0
        for name in self.NAMES:
            monkeypatch.setattr(torch.Tensor, name, self._counting(getattr(torch.Tensor, name)))

    def _counting(self, fn):
        def wrapped(*args, **kw):
            self.count += 1
            return fn(*args, **kw)
        return wrapped


@pytest.mark.parametrize("method", ["adams", "adams_scan"])
def test_one_host_read_an_attempt_round(method, monkeypatch):
    """The host reads "every sample done?" with the round's largest order once
    an attempt round and once more an interval, and nothing else: no read
    per sample, and none in the attempt."""
    f = _tfield(STIFF, DAMPING)
    y0, ts = torch.from_numpy(Y0), torch.from_numpy(TS).to(F64)
    reads = _HostReads(monkeypatch)
    _, stats = vcabm._run(f, y0, ts, 1e-6, 1e-8, 12, 256, None, 1)
    assert reads.count == stats["host_reads"]
    slowest = int((stats["n_accept"] + stats["n_reject"]).max())
    assert stats["host_reads"] == slowest + len(TS) - 1


def test_attempt_passes_done_samples_through():
    y0 = torch.from_numpy(Y0)
    f = _tfield(STIFFNESS, DAMPING)
    s, gstar = _state(f, y0)
    for _ in range(6):  # past the start-up rule's first orders
        vcabm._attempt_batched(f, 1e-6, 1e-8, 12, gstar, torch.tensor(2.0, dtype=F64), s,
                               torch.zeros(3, dtype=torch.bool), int(s.order.max()))
    keys = ("y", "prev_t", "next_t", "phi", "order", "n_hist", "n_steps", "nfe", "n_accept",
            "n_reject")
    before = {k: getattr(s, k).clone() for k in keys}
    done = torch.tensor([True, False, True])
    vcabm._attempt_batched(f, 1e-6, 1e-8, 12, gstar, torch.tensor(2.0, dtype=F64), s, done,
                           int(s.order[~done].max()))
    for k, v in before.items():
        got = getattr(s, k)
        if k in ("prev_t", "phi"):
            got, v = got.transpose(0, 1), v.transpose(0, 1)
        torch.testing.assert_close(got[done], v[done], rtol=0, atol=0, msg=k)
    assert (s.nfe - before["nfe"]).tolist()[::2] == [0, 0]
    assert not torch.equal(s.next_t[1], before["next_t"][1])


def _state(f, y0):
    gstar = torch.from_numpy(vcabm.gamma_star(14))
    t0 = torch.zeros(y0.shape[0], dtype=F64)
    f0 = f(t0, y0)
    phi = torch.cat([f0[None], f0.new_zeros((13,) + f0.shape)])
    return vcabm._BatchState(y0, t0.expand(14, -1), t0 + 0.05, phi, 1), gstar


def test_frozen_sample_gets_no_nan_gradient():
    """A sample that lands in the first round of an interval passes every
    later round through with ``dt = 0`` and zero history spans: its gradient
    comes only from its own steps, and no guarded denominator leaks NaN."""
    ts = torch.tensor([0.0, 0.05, 0.1], dtype=F64)
    k = torch.tensor([0.01, 400.0], dtype=F64, requires_grad=True)
    y0 = torch.tensor([[1.0, 0.0], [1.0, 0.0]], dtype=F64, requires_grad=True)

    def f(t, y):
        return torch.stack([y[:, 1], -k * y[:, 0]], dim=-1)

    ys, stats = todeint(f, y0, ts, method="adams_scan", batch_dims=1, return_stats=True,
                        first_step=0.05, rtol=1e-6, atol=1e-8)
    attempts = (stats["n_accept"] + stats["n_reject"]).tolist()
    assert attempts[0] == 2 and attempts[1] > 10, attempts
    ys.sum().backward()
    assert torch.isfinite(k.grad).all() and torch.isfinite(y0.grad).all()
    one = todeint(lambda t, y: torch.stack([y[:, 1], -k[:1] * y[:, 0]], dim=-1), y0[:1], ts,
                  method="adams_scan", batch_dims=1, first_step=0.05, rtol=1e-6, atol=1e-8)
    g_one = torch.autograd.grad(one.sum(), (k, y0))
    torch.testing.assert_close(k.grad[0], g_one[0][0], rtol=1e-12, atol=1e-15)
    torch.testing.assert_close(y0.grad[0], g_one[1][0], rtol=1e-12, atol=1e-15)


# --- the IN-ODE -------------------------------------------------------------------


N = 4
WIDTHS = dict(effect_dim=8, relation_hidden=(16, 16), object_hidden=(16,))
INODE_KW = dict(rtol=1e-4, atol=1e-6, steps=16, **WIDTHS)
OUT_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_torch_physics.py's
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_inode():
    """Inputs, flax parameters, output and parameter gradients of JAX's
    IN-ODE on adams_scan under ``jax.vmap``, in float32."""
    from graph_odenet_tpu.data.nbody import SpringSystem as JSpringSystem
    from graph_odenet_tpu.models import INODE as JINODE

    js, jr = JSpringSystem(n_bodies=N).edges()
    rng = np.random.default_rng(1)
    y0 = rng.standard_normal((3, N, 4)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, (3, N, 1)).astype(np.float32)
    ts = (np.arange(5) * 0.01).astype(np.float32)
    w = rng.standard_normal((3, 5, N, 4)).astype(np.float32)
    jmodel = JINODE(dim=2, method="adams_scan", **INODE_KW)
    jparams = jmodel.init(jax.random.PRNGKey(0), y0[0], jnp.asarray(ts), mass[0], js,
                          jr)["params"]

    def loss(p):
        f = lambda y, m: jmodel.apply({"params": p}, y, jnp.asarray(ts), m, js, jr)  # noqa: E731
        out = jax.vmap(f)(y0, mass)
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jparams)
    return (y0, mass, ts, w), _numpy_tree(jparams), np.array(jout), _numpy_tree(jgrads)


@pytest.mark.parametrize("remat", [False, True])
def test_inode_adams_scan_batched_matches_flax(remat):
    from graph_odenet_tpu_torch.convert import params_from_interaction
    from graph_odenet_tpu_torch.data import SpringSystem
    from graph_odenet_tpu_torch.models import INODE

    (y0, mass, ts, w), jparams, jout, jgrads = _jax_inode()
    model = INODE(dim=2, method="adams_scan", remat=remat, **INODE_KW)
    model.load_state_dict(params_from_interaction(jparams))
    out = model(torch.from_numpy(y0), torch.from_numpy(ts), torch.from_numpy(mass),
                *SpringSystem(n_bodies=N).edges())
    assert out.shape == (3, 5, N, 4)
    torch.testing.assert_close(out, torch.from_numpy(jout), **OUT_TOL)
    (out * torch.from_numpy(w)).sum().backward()
    want = params_from_interaction(jgrads)
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, want[name], **GRAD_TOL,
                                   msg=lambda m, name=name: f"{name}: {m}")
    assert model.stats["success"].all() and model.stats["final_order"].shape == (3,)


def _inode64(method, adjoint=False):
    from graph_odenet_tpu_torch.data import SpringSystem, generate_trajectories
    from graph_odenet_tpu_torch.models import INODE

    system = SpringSystem(n_bodies=N)
    trajs = generate_trajectories(system, 3, 4, generator=torch.Generator().manual_seed(0),
                                  device="cpu").double()
    model = INODE(dim=2, method=method, adjoint=adjoint, rtol=1e-6, atol=1e-8, steps=32,
                  generator=torch.Generator().manual_seed(0), **WIDTHS).double()
    ts = torch.arange(5, dtype=F64) * system.dt
    edges = system.edges()

    def solve(batch):
        return model(batch[:, 0, :, 1:], ts, batch[:, 0, :, :1], *edges)

    return model, trajs, solve


@pytest.mark.parametrize("method,adjoint", [("adams_scan", True), ("adams", True),
                                            ("scipy_solver", False)])
def test_inode_batch_equals_one_window_at_a_time(method, adjoint):
    """Each window of a batch is its own problem: its trajectory (and, through
    the continuous adjoint, its share of the gradient) equals its solve
    alone.  JAX's IN-ODE with an adjoint cannot be vmapped, so the batch is
    held to its windows."""
    model, wins, solve = _inode64(method, adjoint)

    def run(batch):
        model.zero_grad(set_to_none=True)
        out = solve(batch)
        if adjoint:
            (out ** 2).flatten(1).mean(1).sum().backward()
        grads = {k: p.grad.clone() for k, p in model.named_parameters()} if adjoint else {}
        return out.detach(), grads, model.stats

    together, g_all, stats = run(wins)
    alone = [run(wins[i:i + 1]) for i in range(wins.shape[0])]
    torch.testing.assert_close(together, torch.cat([a[0] for a in alone]), **TRAJ)
    for k, g in g_all.items():
        torch.testing.assert_close(g, sum(a[1][k] for a in alone), **ADJOINT)
    if method != "scipy_solver":
        for k in COUNTS:
            assert stats[k].tolist() == [a[2][k].item() for a in alone], k
