"""Port parity: the adaptive solvers against the JAX package, in float64.

The closed-form problems of ``tests/test_ode.py``: trajectories agree to
1e-10 and the counts ``nfe``, ``n_accept``, ``n_reject`` are equal (both
packages run the same controller in float64).  The step sizes agree less
closely than the trajectories: the error estimate ``dt·Σ b_err·k`` cancels
almost completely, so the order of that sum (a sequential sum here, a dot
product in XLA) moves the error ratio, and the next step, in the ninth
digit, and by 2e-4 at rtol = 1e-9.  The ``_scan`` forms match the while
forms, the oscillator is solved to tolerance, exhaustion is reported,
reverse time works, and the gradient through the first step (not
detached, as in JAX) agrees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_odenet_tpu.ode import odeint as jodeint
from graph_odenet_tpu_torch.ode import odeint as todeint

TOL = dict(rtol=1e-10, atol=1e-10)
F64 = torch.float64

PROBLEMS = {
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


def _both(problem, method, ts, **kw):
    jf, tf, y0 = PROBLEMS[problem]
    y0 = np.asarray(y0, np.float64)
    jys, js = jodeint(jf, jnp.asarray(y0), jnp.asarray(ts), method=method, return_stats=True, **kw)
    tys, ts_ = todeint(tf, torch.from_numpy(y0), torch.from_numpy(np.asarray(ts)),
                       method=method, return_stats=True, **kw)
    return np.asarray(jys), js, tys, ts_


@pytest.mark.parametrize("method", [
    "dopri5", "dopri5_scan", "bosh3", "adaptive_heun", "fehlberg2", "dopri8_scan",
])
@pytest.mark.parametrize("problem", ["oscillator", "forced"])
def test_adaptive_matches_jax(method, problem):
    ts = np.linspace(0.0, 2 * np.pi, 9)
    jys, js, tys, tst = _both(problem, method, ts, rtol=1e-6, atol=1e-8,
                              max_steps_per_interval=512)
    assert tys.dtype == F64 and tys.shape == jys.shape
    np.testing.assert_allclose(tys.numpy(), jys, **TOL)
    for k in ("nfe", "n_accept", "n_reject"):
        assert tst[k] == int(js[k]), k
    assert tst["success"] is True and bool(js["success"])
    np.testing.assert_allclose(tst["t_reached"], float(js["t_reached"]), rtol=1e-7)


@pytest.mark.parametrize("method", ["dopri5", "bosh3", "dopri8"])
def test_scan_matches_while(method):
    _, tf, y0 = PROBLEMS["oscillator"]
    y0 = torch.tensor(y0, dtype=F64)
    ts = torch.linspace(0.0, 2 * np.pi, 9, dtype=F64)
    kw = dict(rtol=1e-6, atol=1e-8, return_stats=True)
    ys_w, s_w = todeint(tf, y0, ts, method=method, **kw)
    ys_s, s_s = todeint(tf, y0, ts, method=f"{method}_scan", max_steps_per_interval=256, **kw)
    assert s_w == s_s
    torch.testing.assert_close(ys_w, ys_s, rtol=0, atol=0)


@pytest.mark.parametrize("method", ["dopri5", "dopri5_scan"])
def test_oscillator_to_tolerance(method):
    _, tf, y0 = PROBLEMS["oscillator"]
    ts = np.linspace(0.0, 2 * np.pi, 20)
    ys, stats = todeint(tf, torch.tensor(y0, dtype=F64), torch.from_numpy(ts), method=method,
                        rtol=1e-6, atol=1e-8, return_stats=True)
    np.testing.assert_allclose(ys.numpy(), np.stack([np.cos(ts), -np.sin(ts)]).T, atol=1e-4)
    assert stats["nfe"] > 0 and stats["success"]


@pytest.mark.parametrize("method", ["dopri5", "dopri5_scan"])
def test_exhaustion_reported(method):
    ts = np.array([0.0, 2 * np.pi])
    lim = dict(max_steps=3) if method == "dopri5" else dict(max_steps_per_interval=3)
    jys, js, tys, tst = _both("oscillator", method, ts, rtol=1e-9, atol=1e-12, **lim)
    assert tst["success"] is False and not bool(js["success"])
    assert tst["t_reached"] < ts[-1]
    np.testing.assert_allclose(tst["t_reached"], float(js["t_reached"]), rtol=2e-4)
    assert (tst["nfe"], tst["n_accept"], tst["n_reject"]) == tuple(
        int(js[k]) for k in ("nfe", "n_accept", "n_reject"))


@pytest.mark.parametrize("method", ["dopri5", "dopri5_scan"])
def test_reverse_time_matches_jax(method):
    ts = np.array([1.0, 0.5, 0.0])
    jys, js, tys, tst = _both("forced", method, ts, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(tys.numpy(), jys, **TOL)
    assert tst["nfe"] == int(js["nfe"])


@pytest.mark.parametrize("first_step", [None, 0.05])
def test_gradient_through_dopri5_scan_matches_jax(first_step):
    """d y(1) / d k for dy/dt = -k·y: the first step's gradient path included."""
    kw = dict(method="dopri5_scan", rtol=1e-3, atol=1e-4, max_steps_per_interval=32,
              first_step=first_step)

    def jloss(k):
        return jodeint(lambda t, y, k: -k * y, jnp.array([1.0, 0.3]), jnp.array([0.0, 1.0]),
                       k, **kw)[-1].sum()

    jg = float(jax.grad(jloss)(jnp.asarray(0.7, jnp.float64)))
    k = torch.tensor(0.7, dtype=F64, requires_grad=True)
    ys = todeint(lambda t, y, k: -k * y, torch.tensor([1.0, 0.3], dtype=F64), [0.0, 1.0], k, **kw)
    ys[-1].sum().backward()
    np.testing.assert_allclose(float(ys[-1].sum()), float(jloss(jnp.asarray(0.7))), **TOL)
    np.testing.assert_allclose(float(k.grad), jg, **TOL)
