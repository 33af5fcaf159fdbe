"""Port parity: the batched adaptive solver (``odeint(batch_dims=1)``) against
``jax.vmap`` of the JAX package's ``odeint``, in float64.

Under ``jax.vmap`` every sample of the JAX solvers has its own step size,
error ratio, accept mask and stats; so has every sample of the port's
batched form.  Trajectories and gradients agree to 1e-10; the per-sample
counts ``nfe``, ``n_accept``, ``n_reject`` and ``success`` are equal, and
``t_reached`` agrees to 1e-7 (the step sizes carry the rounding of the error
estimate's sum, see ``tests/test_torch_adaptive.py``).  Samples of different
stiffness take different numbers of steps, a batch of one is the unbatched
form, and the fixed-grid rk4 is elementwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_odenet_tpu.ode import odeint as jodeint
from graph_odenet_tpu_torch.ode import adaptive
from graph_odenet_tpu_torch.ode import odeint as todeint

TOL = dict(rtol=1e-10, atol=1e-10)
F64 = torch.float64
# Oscillators y'' = -k·y - c·y': stiffness 1 and 25, and a damped third.
STIFFNESS = np.array([1.0, 25.0, 9.0])
# The stiff pair: dopri5 takes 14 and 208 steps over [0, 2] at rtol 1e-6.
STIFF = np.array([1.0, 400.0, 9.0])
DAMPING = np.array([0.0, 0.0, 0.5])
Y0 = np.array([[1.0, 0.0], [1.0, 0.0], [0.3, -1.0]])
COUNTS = ("nfe", "n_accept", "n_reject", "success")


def _jfield(t, y, k, c):
    return jnp.stack([y[1], -k * y[0] - c * y[1]])


def _tfield(k, c):
    k, c = torch.from_numpy(k), torch.from_numpy(c)

    def f(t, y):
        assert t.shape == (y.shape[0],) or t.dim() == 0
        return torch.stack([y[:, 1], -k * y[:, 0] - c * y[:, 1]], dim=-1)

    return f


def _both(method, ts, stiffness=STIFFNESS, **kw):
    def one(y0, k, c):
        return jodeint(_jfield, y0, jnp.asarray(ts), k, c, method=method, return_stats=True, **kw)

    jys, js = jax.vmap(one)(jnp.asarray(Y0), jnp.asarray(stiffness), jnp.asarray(DAMPING))
    tys, tst = todeint(_tfield(stiffness, DAMPING), torch.from_numpy(Y0),
                       torch.from_numpy(np.asarray(ts)), method=method, return_stats=True,
                       batch_dims=1, **kw)
    return np.swapaxes(np.asarray(jys), 0, 1), {k: np.asarray(v) for k, v in js.items()}, tys, tst


def _assert_counts(tst, js, t_tol=dict(rtol=1e-7)):
    for k in COUNTS:
        np.testing.assert_array_equal(tst[k].numpy(), js[k], err_msg=k)
    np.testing.assert_allclose(tst["t_reached"].numpy(), js["t_reached"], **t_tol)


@pytest.mark.parametrize("first_step", [None, 0.01])
@pytest.mark.parametrize("method", ["dopri5_scan", "dopri5", "bosh3_scan", "fehlberg2_scan"])
def test_batched_matches_vmapped_jax(method, first_step):
    ts = np.linspace(0.0, 2.0, 6)
    jys, js, tys, tst = _both(method, ts, rtol=1e-6, atol=1e-8, max_steps_per_interval=256,
                              first_step=first_step)
    assert tys.dtype == F64 and tys.shape == jys.shape == (6, 3, 2)
    np.testing.assert_allclose(tys.numpy(), jys, **TOL)
    _assert_counts(tst, js)
    assert tst["success"].all()


def test_samples_of_different_stiffness_take_different_steps():
    """One controller for the batch would give every sample the same counts."""
    ts = np.linspace(0.0, 2.0, 6)
    jys, js, tys, tst = _both("dopri5_scan", ts, STIFF, rtol=1e-6, atol=1e-8,
                              max_steps_per_interval=256)
    np.testing.assert_allclose(tys.numpy(), jys, **TOL)
    acc = tst["n_accept"].numpy()
    assert acc[1] > 5 * acc[0], acc
    np.testing.assert_array_equal(acc, js["n_accept"])
    np.testing.assert_array_equal(tst["nfe"].numpy(), js["nfe"])


def test_per_sample_budget_exhaustion():
    """The stiff sample runs out of attempts; the others still succeed."""
    ts = np.linspace(0.0, 2.0, 5)
    jys, js, tys, tst = _both("dopri5_scan", ts, STIFF, rtol=1e-6, atol=1e-8,
                              max_steps_per_interval=20)
    np.testing.assert_array_equal(tst["success"].numpy(), [True, False, True])
    _assert_counts(tst, js)
    # The exhausted sample's rows are extrapolated; the others are exact.
    np.testing.assert_allclose(tys.numpy()[:, [0, 2]], jys[:, [0, 2]], **TOL)


def test_reverse_time_per_sample():
    ts = np.array([1.0, 0.6, 0.0])
    jys, js, tys, tst = _both("dopri5_scan", ts, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(tys.numpy(), jys, **TOL)
    # Reversed, the grid is [-1, -0.6, 0] and t_reached lies just past 0, so
    # its error is measured against the span: at rtol 1e-8 the last step
    # agrees to 2e-4 of itself, as in the unbatched form's exhaustion test
    # (tests/test_torch_adaptive.py), about 1e-6 of the span.
    _assert_counts(tst, js, t_tol=dict(rtol=0, atol=1e-5))


def test_rk4_is_elementwise():
    ts = np.linspace(0.0, 1.0, 4)
    jys, _, tys, tst = _both("rk4", ts, steps_per_interval=3)
    np.testing.assert_allclose(tys.numpy(), jys, **TOL)
    assert tst["nfe"] == 3 * 3 * 4


@pytest.mark.parametrize("first_step", [None, 0.05])
def test_gradients_match_vmapped_jax(first_step):
    """d/d(k, c, y0) of a loss over every sample's trajectory."""
    ts = np.linspace(0.0, 1.0, 4)
    kw = dict(method="dopri5_scan", rtol=1e-5, atol=1e-7, max_steps_per_interval=64,
              first_step=first_step)
    w = np.random.default_rng(0).standard_normal((4, 3, 2))

    def jloss(y0, k, c):
        ys = jax.vmap(lambda y, kk, cc: jodeint(_jfield, y, jnp.asarray(ts), kk, cc, **kw))(
            y0, k, c)
        return jnp.sum(jnp.swapaxes(ys, 0, 1) * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (Y0, STIFFNESS, DAMPING)))
    y0, k, c = (torch.from_numpy(a.copy()).requires_grad_() for a in (Y0, STIFFNESS, DAMPING))

    def f(t, y):
        return torch.stack([y[:, 1], -k * y[:, 0] - c * y[:, 1]], dim=-1)

    ys = todeint(f, y0, torch.from_numpy(ts), batch_dims=1, **kw)
    (ys * torch.from_numpy(w)).sum().backward()
    for got, want in zip((y0.grad, k.grad, c.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("method", ["dopri5_scan", "bosh3"])
def test_batch_of_one_is_the_unbatched_form(method):
    ts = torch.linspace(0.0, 2.0, 5, dtype=F64)
    f = _tfield(STIFF[1:2], DAMPING[1:2])
    y0 = torch.from_numpy(Y0[1:2])
    kw = dict(method=method, rtol=1e-6, atol=1e-8, return_stats=True)
    ys_b, s_b = todeint(f, y0, ts, batch_dims=1, **kw)
    ys_u, s_u = todeint(lambda t, y: f(t, y[None])[0], y0[0], ts, **kw)
    torch.testing.assert_close(ys_b[:, 0], ys_u, **TOL)
    for k in ("nfe", "n_accept", "n_reject", "success"):
        assert s_b[k].item() == s_u[k], k
    assert s_b["t_reached"].item() == pytest.approx(s_u["t_reached"], rel=1e-12)


def test_one_host_read_an_attempt():
    """The host reads "every sample done?" once an attempt and once more an
    interval; the attempt itself reads nothing (its accepts are masks)."""
    ts = np.linspace(0.0, 2.0, 6)
    _, _, _, tst = _both("dopri5_scan", ts, STIFF, rtol=1e-6, atol=1e-8,
                         max_steps_per_interval=256)
    slowest = int((tst["n_accept"] + tst["n_reject"]).max())
    assert tst["host_reads"] == slowest + len(ts) - 1


def test_attempt_passes_done_samples_through():
    y0 = torch.from_numpy(Y0)
    f = _tfield(STIFFNESS, DAMPING)
    s = adaptive._init_batched(f, y0, torch.zeros((), dtype=F64), adaptive.DOPRI5, 1e-6, 1e-8,
                               None)
    keys = ("t", "y", "f", "dt", "last_t", "facold", "rejected", "nfe", "n_accept", "n_reject")
    before = {k: getattr(s, k).clone() for k in keys}
    done = torch.tensor([True, False, True])
    adaptive._attempt_batched(f, adaptive.DOPRI5, 1e-6, 1e-8, s, done)
    for k, v in before.items():
        torch.testing.assert_close(getattr(s, k)[done], v[done], rtol=0, atol=0)
    assert s.n_accept.tolist() == [0, 1, 0] and s.nfe.tolist() == [3, 9, 3]
    for k in ("t", "y", "f", "dt"):
        assert not torch.equal(getattr(s, k)[~done], before[k][~done]), k


def test_batch_dims_other_than_0_or_1_raise():
    with pytest.raises(ValueError, match="batch_dims"):
        todeint(lambda t, y: -y, torch.ones(2, 2, 2, dtype=F64), [0.0, 1.0], method="dopri5",
                batch_dims=2)
