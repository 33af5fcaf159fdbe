"""Port parity: ``odeint_adjoint`` (the continuous and the checkpointed adjoint)
and the trace-recording solver ``odeint_adaptive_ckpt`` against the JAX
package, in float64.

The cases of ``tests/test_ode.py``'s adjoint tests, each run through both
packages on the same inputs.  Values and gradients agree to 1e-12 where
both run the same steps.  An adaptive solve's step sizes carry the rounding
of the error estimate (``tests/test_torch_adaptive.py``): the times of its
accepted steps agree to 1e-7 of the span at rtol 1e-6, the states there to
1e-7 (each at its own time: 3e-8 apart where |f| is 25), the states at the output times, where
the steps land exactly, to 1e-10, and the gradients of a nonlinear problem,
or through the continuous adjoint's adaptive reverse solve, to 1e-9.  The batched forms (``batch_dims=1``) are held
to ``jax.vmap`` of the JAX functions, with samples that take different
numbers of steps.  And the unbatched solver's first step now takes JAX's
derivative of ``|y0|`` at 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_odenet_tpu.ode import adaptive as jadaptive
from graph_odenet_tpu.ode import odeint as jodeint
from graph_odenet_tpu.ode import odeint_adjoint as jadjoint
from graph_odenet_tpu.ode import tableaus as jtableaus
from graph_odenet_tpu_torch.ode import adaptive, tableaus
from graph_odenet_tpu_torch.ode import odeint as todeint
from graph_odenet_tpu_torch.ode import odeint_adjoint as tadjoint

F64 = torch.float64
SAME = dict(rtol=1e-12, atol=1e-12)      # the same steps in both packages
TRAJ = dict(rtol=1e-10, atol=1e-10)      # states at the output times
STEP_T = dict(rtol=0, atol=1e-7)         # the accepted steps' times (span 2) ...
STEP_Y = dict(rtol=0, atol=1e-7)         # ... and states
ADAPTIVE = dict(rtol=1e-9, atol=1e-9)    # gradients through adaptive steps
ANALYTIC = dict(rtol=1e-4)               # tests/test_ode.py's tolerance


def _t(*arrays):
    """Float64 leaves that take a gradient."""
    return [torch.tensor(np.asarray(a, np.float64), requires_grad=True) for a in arrays]


def _decay(t, y, k):
    return -k * y


# --- the repair: |y0| at 0 in the unbatched first step --------------------


@pytest.mark.parametrize("method", ["dopri5", "dopri5_scan"])
def test_gradient_wrt_zero_state_matches_jax(method):
    """A ``y0`` holding exact zeros: the first step's scale takes JAX's
    derivative of ``|y0|`` at 0 (1, where torch's ``abs`` has 0)."""
    y0 = np.array([0.0, 1.0, 0.0, -0.5])
    ts = np.linspace(0.0, 1.0, 3)
    w = np.random.default_rng(0).standard_normal((3, 4))
    kw = dict(method=method, rtol=1e-5, atol=1e-7)

    def jf(t, y):
        return jnp.tanh(jnp.roll(y, 1)) - 0.3 * y

    # JAX differentiates dopri5's while_loop in forward mode only.
    diff = jax.jacfwd if method == "dopri5" else jax.grad
    jg = diff(lambda y: jnp.sum(jodeint(jf, y, jnp.asarray(ts), **kw) * w))(jnp.asarray(y0))
    (y,) = _t(y0)
    ys = todeint(lambda t, y: torch.tanh(torch.roll(y, 1)) - 0.3 * y, y, torch.from_numpy(ts),
                 **kw)
    (ys * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(jg), rtol=1e-10, atol=1e-10)


def test_first_step_values_are_those_of_abs():
    """The repair moves no value: the first step is bit-equal to the one
    ``torch.abs`` gives, zeros, negative zeros and float32 included."""

    def with_abs(func, t0, y0, f0, order, rtol, atol):
        scale = atol + torch.abs(y0) * rtol
        d0, d1 = adaptive._rms(y0 / scale), adaptive._rms(f0 / scale)
        h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
        f1 = func(t0 + h0, y0 + h0 * f0)
        dmax = torch.maximum(d1, adaptive._rms((f1 - f0) / scale) / h0)
        h1 = torch.where(dmax <= 1e-15, torch.clamp(h0 * 1e-3, min=1e-6),
                         (0.01 / dmax) ** (1.0 / (order + 1)))
        return torch.minimum(100.0 * h0, h1)

    rng = np.random.default_rng(1)
    for dtype in (torch.float32, torch.float64):
        y0 = torch.from_numpy(rng.standard_normal(64)).to(dtype)
        y0[::5], y0[1::7] = 0.0, -0.0
        f0 = torch.cos(y0)
        args = (lambda t, y: torch.cos(y), torch.zeros((), dtype=dtype), y0, f0, 4, 1e-3, 1e-4)
        assert torch.equal(adaptive._initial_step(*args), with_abs(*args))


# --- the trace-recording solver -------------------------------------------


def _jtrace(tab, ts, y0, **kw):
    ys, stats, trace = jadaptive.odeint_adaptive_ckpt(
        lambda t, y: jnp.stack([y[1], -9.0 * y[0]]), jnp.asarray(y0), jnp.asarray(ts),
        tab=getattr(jtableaus, tab), **kw)
    return np.asarray(ys), {k: np.asarray(v) for k, v in stats.items()}, {
        k: np.asarray(v) for k, v in trace.items()}


@pytest.mark.parametrize("budget", [64, 6])  # 6: the trace overflows
@pytest.mark.parametrize("tab", ["DOPRI5", "BOSH3"])
def test_ckpt_trace_matches_jax(tab, budget):
    ts, y0 = np.linspace(0.0, 2.0, 4), np.array([1.0, 0.0])
    kw = dict(rtol=1e-6, atol=1e-8, trace_per_interval=budget)
    jys, js, jtr = _jtrace(tab, ts, y0, **kw)
    tys, tst, ttr = adaptive.odeint_adaptive_ckpt(
        lambda t, y: torch.stack([y[1], -9.0 * y[0]]), torch.from_numpy(y0),
        torch.from_numpy(ts), tab=getattr(tableaus, tab), **kw)
    n = int(jtr["n_steps"])
    assert ttr["n_steps"] == n and ttr["ok"] == bool(jtr["ok"]) == (n <= budget * 3)
    np.testing.assert_array_equal(ttr["acc_at_target"], jtr["acc_at_target"])
    # The trace holds every accepted step, or on overflow JAX's K + 2 slots.
    assert ttr["t"].shape[0] == min(n + 1, budget * 3 + 2)
    np.testing.assert_allclose(ttr["t"].numpy(), jtr["t"][:ttr["t"].shape[0]], **STEP_T)
    np.testing.assert_allclose(ttr["y"].numpy(), jtr["y"][:ttr["t"].shape[0]], **STEP_Y)
    np.testing.assert_allclose(tys.numpy(), jys, **TRAJ)
    for k in ("nfe", "n_accept", "n_reject", "success"):
        assert tst[k] == js[k], k
    if jtr["ok"]:  # steps land exactly on the output times
        assert ttr["t"][ttr["acc_at_target"]].tolist() == ts.tolist()


def test_batched_ckpt_trace_matches_vmapped_jax():
    """Each sample its own trace: stiffness 1, 25 and 9 take different steps."""
    ts = np.linspace(0.0, 2.0, 4)
    k = np.array([1.0, 25.0, 9.0])
    y0 = np.array([[1.0, 0.0], [1.0, 0.0], [0.3, -1.0]])

    def one(y, kk):
        return jadaptive.odeint_adaptive_ckpt(
            lambda t, y: jnp.stack([y[1], -kk * y[0]]), y, jnp.asarray(ts),
            rtol=1e-6, atol=1e-8, trace_per_interval=64)

    jys, js, jtr = jax.vmap(one)(jnp.asarray(y0), jnp.asarray(k))
    kt = torch.from_numpy(k)
    tys, tst, ttr = adaptive.odeint_adaptive_ckpt(
        lambda t, y: torch.stack([y[:, 1], -kt * y[:, 0]], dim=-1), torch.from_numpy(y0),
        torch.from_numpy(ts), rtol=1e-6, atol=1e-8, trace_per_interval=64, batch_dims=1)
    np.testing.assert_allclose(tys.numpy(), np.swapaxes(np.asarray(jys), 0, 1), **TRAJ)
    steps = np.asarray(jtr["n_steps"])
    assert len(set(steps.tolist())) == 3
    np.testing.assert_array_equal(ttr["n_steps"].numpy(), steps)
    np.testing.assert_array_equal(ttr["acc_at_target"].numpy(), np.asarray(jtr["acc_at_target"]).T)
    for b, n in enumerate(steps):
        np.testing.assert_allclose(ttr["t"][:n + 1, b].numpy(), np.asarray(jtr["t"])[b, :n + 1],
                                   **STEP_T)
        np.testing.assert_allclose(ttr["y"][:n + 1, b].numpy(), np.asarray(jtr["y"])[b, :n + 1],
                                   **STEP_Y)
    for key in ("nfe", "n_accept", "n_reject", "success"):
        np.testing.assert_array_equal(tst[key].numpy(), np.asarray(js[key]), err_msg=key)
    assert tst["success"].all() and ttr["ok"].all()


# --- odeint_adjoint against JAX's ------------------------------------------

CASES = [
    (False, dict(method="dopri5", rtol=1e-8, atol=1e-10)),
    # tests/test_ode.py:485-495, the checkpointed adjoint's five cases.
    (True, dict(method="dopri5", rtol=1e-8, atol=1e-10)),
    (True, dict(method="dopri5", rtol=1e-8, atol=1e-10, bwd_method="dopri5")),
    (True, dict(method="rk4", steps_per_interval=32)),
    (True, dict(method="dopri5_scan", rtol=1e-8, atol=1e-10, max_steps_per_interval=64,
                bwd_substeps=2)),
    (True, dict(method="bosh3", rtol=1e-7, atol=1e-9, bwd_method="bosh3")),
]


@pytest.mark.parametrize("checkpoint,kw", CASES)
def test_decay_matches_jax_and_analytic(checkpoint, kw):
    """d/dk of y(1) for y' = −k·y.  The bosh3 case overflows its 64-step trace
    (82 steps) in both packages: its gradient is JAX's, 2.2e-5 off the
    analytic one, inside tests/test_ode.py's tolerance."""

    def jloss(k):
        return jadjoint(_decay, jnp.array([1.0]), jnp.array([0.0, 1.0]), k,
                        checkpoint=checkpoint, **kw)[-1, 0]

    jv, jg = jax.value_and_grad(jloss)(1.0)
    (k,) = _t(1.0)
    ys = tadjoint(_decay, torch.tensor([1.0], dtype=F64), [0.0, 1.0], k,
                  checkpoint=checkpoint, **kw)
    ys[-1, 0].backward()
    np.testing.assert_allclose(ys[-1, 0].item(), float(jv), **SAME)
    np.testing.assert_allclose(k.grad.item(), float(jg), **(SAME if checkpoint else ADAPTIVE))
    np.testing.assert_allclose(ys[-1, 0].item(), np.exp(-1.0), rtol=1e-5)
    np.testing.assert_allclose(k.grad.item(), -np.exp(-1.0), **ANALYTIC)


@pytest.mark.parametrize("checkpoint", [False, True])
def test_y0_and_multiple_output_times(checkpoint):
    """Cotangents of an interior output time enter where the solve passes it:
    on the continuous adjoint's interval boundary, on the checkpointed
    adjoint's clipped step boundary."""
    kw = dict(method="dopri5", rtol=1e-9, atol=1e-11)
    if checkpoint:
        kw.update(checkpoint=True, bwd_method="dopri5")

    def jloss(y0):
        ys = jadjoint(lambda t, y: -y, y0, jnp.linspace(0.0, 1.0, 5), **kw)
        return jnp.sum(ys[-1]) + jnp.sum(ys[2])

    jg = jax.grad(jloss)(jnp.array([1.0, 2.0]))
    (y0,) = _t([1.0, 2.0])
    ys = tadjoint(lambda t, y: -y, y0, torch.linspace(0.0, 1.0, 5, dtype=F64), **kw)
    (ys[-1].sum() + ys[2].sum()).backward()
    np.testing.assert_allclose(y0.grad.numpy(), np.asarray(jg), **ADAPTIVE)
    np.testing.assert_allclose(y0.grad.numpy(), np.exp(-1.0) + np.exp(-0.5), **ANALYTIC)


@pytest.mark.parametrize("checkpoint", [False, True])
def test_forward_stats_are_surfaced(checkpoint):
    kw = dict(method="dopri5", rtol=1e-6, atol=1e-8, return_stats=True)
    _, js = jadjoint(lambda t, y: -y, jnp.array([1.0]), jnp.array([0.0, 1.0]),
                     checkpoint=checkpoint, **kw)
    _, ts_ = tadjoint(lambda t, y: -y, torch.tensor([1.0], dtype=F64), [0.0, 1.0],
                      checkpoint=checkpoint, **kw)
    _, direct = todeint(lambda t, y: -y, torch.tensor([1.0], dtype=F64), [0.0, 1.0], **kw)
    for k in ("nfe", "n_accept", "n_reject", "success"):
        assert ts_[k] == js[k], k
    if not checkpoint:  # the continuous adjoint's forward is odeint itself
        assert ts_ == direct
    assert ts_["nfe"] > 0 and ts_["success"]


W = np.array([[0.1, -0.4], [0.7, 0.2]])


def _jtanh(t, y, w):
    return jnp.tanh(w @ y)


def _ttanh(t, y, w):
    return torch.tanh(torch.einsum("...ij,...j->...i", w, y))


@pytest.mark.parametrize("checkpoint", [False, True])
def test_param_and_y0_gradients_match_jax_and_direct_backprop(checkpoint):
    y00, ts = np.array([0.5, -0.3]), np.array([0.0, 1.0])
    kw = dict(method="dopri5", rtol=1e-9, atol=1e-11)
    if checkpoint:
        kw.update(checkpoint=True, bwd_method="dopri5")

    def jloss(w, y0):
        return jnp.sum(jadjoint(_jtanh, y0, jnp.asarray(ts), w, **kw)[-1])

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(W), jnp.asarray(y00))
    w, y0 = _t(W, y00)
    tadjoint(_ttanh, y0, torch.from_numpy(ts), w, **kw)[-1].sum().backward()
    wd, y0d = _t(W, y00)
    todeint(_ttanh, y0d, torch.from_numpy(ts), wd, method="rk4",
            steps_per_interval=64)[-1].sum().backward()
    for got, want, direct in zip((w.grad, y0.grad), jg, (wd.grad, y0d.grad)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ADAPTIVE)
        np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=1e-5)


def test_ckpt_time_gradient_and_stats():
    def jloss(t1):
        return jadjoint(lambda t, y: -y, jnp.array([1.0]), jnp.stack([0.0 * t1, t1]),
                        method="dopri5", rtol=1e-9, atol=1e-11, checkpoint=True,
                        bwd_method="dopri5", bwd_substeps=2)[-1, 0]

    jg = jax.grad(jloss)(0.8)
    (t1,) = _t(0.8)
    ys, stats = tadjoint(lambda t, y: -y, torch.tensor([1.0], dtype=F64), torch.stack([0 * t1, t1]),
                         method="dopri5", rtol=1e-9, atol=1e-11, checkpoint=True,
                         bwd_method="dopri5", bwd_substeps=2, return_stats=True)
    ys[-1, 0].backward()
    np.testing.assert_allclose(t1.grad.item(), float(jg), **SAME)
    np.testing.assert_allclose(t1.grad.item(), -np.exp(-0.8), **ANALYTIC)
    assert stats["nfe"] > 0 and stats["success"]


@pytest.mark.parametrize("checkpoint", [False, True])
def test_time_dependent_field_time_gradients_match_jax(checkpoint):
    """Both ends of ``ts`` move, and ``f`` reads ``t``: ``t̄`` runs through the
    augmented state."""
    kw = dict(method="dopri5", rtol=1e-9, atol=1e-11, checkpoint=checkpoint)
    jg = jax.grad(lambda tt: jnp.sum(jadjoint(lambda t, y: -y * (1 + t), jnp.array([1.0, 0.5]),
                                              tt, **kw)[1:]))(jnp.array([0.1, 0.5, 0.8]))
    (tt,) = _t([0.1, 0.5, 0.8])
    tadjoint(lambda t, y: -y * (1 + t), torch.tensor([1.0, 0.5], dtype=F64), tt,
             **kw)[1:].sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jg), **ADAPTIVE)


def test_ckpt_refuses_methods_without_a_trace():
    with pytest.raises(ValueError, match="checkpoint adjoint"):
        tadjoint(lambda t, y: -y, torch.tensor([1.0], dtype=F64), [0.0, 1.0],
                 method="adams", checkpoint=True)


def test_unread_parameters_get_zero_gradients():
    w, unused = _t(W, [1.0, 2.0])
    for checkpoint in (False, True):
        tadjoint(lambda t, y, w, _: _ttanh(t, y, w), torch.tensor([0.5, -0.3], dtype=F64),
                 [0.0, 1.0], w, unused, method="rk4", checkpoint=checkpoint).sum().backward()
        assert torch.equal(unused.grad, torch.zeros(2, dtype=F64))


# --- batch_dims=1 against jax.vmap -----------------------------------------

Y0 = np.array([[0.5, -0.3], [5.0, 2.0], [0.0, 1.0]])  # three stiffnesses of tanh(W y)


@pytest.mark.parametrize("checkpoint,kw", [
    (False, dict(method="dopri5_scan", rtol=1e-6, atol=1e-8, max_steps_per_interval=64)),
    (True, dict(method="dopri5", rtol=1e-6, atol=1e-8)),
    (True, dict(method="rk4", steps_per_interval=3)),
    (True, dict(method="dopri5_scan", rtol=1e-6, atol=1e-8, bwd_method="dopri5",
                bwd_substeps=2)),
])
def test_batched_matches_vmapped_jax(checkpoint, kw):
    """y0, the shared parameter and ts, with samples that take different
    steps.  The continuous adjoint gives each sample its own θ̄ (a shared
    one moves the y0 gradient by 8e-7 here); the checkpointed one shares it."""
    ts = np.linspace(0.0, 1.0, 3)
    wt = np.random.default_rng(0).standard_normal((3, 3, 2))
    w4 = np.array([[0.1, -4.0], [3.0, 0.2]])

    def jloss(y0, w, tt):
        ys = jax.vmap(lambda y: jadjoint(lambda t, y, w: _jtanh(t, y, w) * (1 + t), y, tt, w,
                                         checkpoint=checkpoint, **kw))(y0)
        return jnp.sum(jnp.swapaxes(ys, 0, 1) * wt)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (Y0, w4, ts)))

    def field(t, y, w):
        return _ttanh(t, y, w) * (1 + t.reshape(t.shape + (1,) * (y.dim() - t.dim())))

    y0, w, tt = _t(Y0, w4, ts)
    ys, stats = tadjoint(field, y0, tt, w, checkpoint=checkpoint, batch_dims=1,
                         return_stats=True, **kw)
    (ys * torch.from_numpy(wt)).sum().backward()
    for got, want in zip((y0.grad, w.grad, tt.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ADAPTIVE)
    if "n_accept" in stats:
        assert len(set(stats["n_accept"].tolist())) == 3
