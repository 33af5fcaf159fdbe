"""Adaptive embedded Runge-Kutta integration (dopri5 and its kin).

Counterpart of ``graph_odenet_tpu/ode/adaptive.py``: FSAL stepping, RMS
error control against ``atol + rtol·max(|y0|, |y1|)`` over the whole state,
Hairer's initial step, the dopri5.f PI step-size controller (safety 0.9,
growth clamp 10×, shrink clamp 0.2×, β = 0.04), and the quartic dense
output: steps are never clipped to the requested times, which are
interpolated.

The JAX package has a ``while_loop`` form and a bounded masked ``scan`` form
of the same attempt sequence.  PyTorch runs eagerly, so both are one Python
loop here: an interval ends once ``t >= t_target``, or after its budget of
attempts (``max_steps`` / ``max_steps_per_interval``), when ``success`` is
reported False.  The masked scan passes the state through unchanged after
that point, so values, stats and gradients are those of the JAX forms.

The error ratio and the controller run without gradient (JAX's
``stop_gradient``).  The first step ``dt0`` from ``_initial_step`` is not
detached: gradients reach the parameters through ``t``, ``dt`` and the
interpolation weights, as in JAX.  Each attempt reads its accept decision
on the host (one synchronisation per attempt on a card).
"""

from __future__ import annotations

from typing import Callable

import torch

from graph_odenet_tpu_torch.ode.tableaus import DOPRI5, Tableau, rk_step

__all__ = ["odeint_adaptive", "odeint_adaptive_scan"]

# dopri5.f controller constants.
_SAFETY = 0.9
_BETA = 0.04
_EXPO1 = 0.2 - 0.75 * _BETA
_FAC_MIN = 0.2    # max shrink per step:   dt <- >= 0.2·dt
_FAC_MAX = 10.0   # max growth per step:   dt <- <= 10·dt
_ERR_FLOOR = 1e-10


def _rms(x):
    return torch.sqrt(torch.mean(torch.square(x)))


def _error_ratio(y_err, y0, y1, rtol, atol):
    scale = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
    return _rms(y_err / scale)


def _initial_step(func, t0, y0, f0, order, rtol, atol):
    """Hairer's starting-step heuristic (torchdiffeq ``_select_initial_step``)."""
    scale = atol + torch.abs(y0) * rtol
    d0 = _rms(y0 / scale)
    d1 = _rms(f0 / scale)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    y1 = y0 + h0 * f0
    f1 = func(t0 + h0, y1)
    d2 = _rms((f1 - f0) / scale) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(
        dmax <= 1e-15,
        torch.clamp(h0 * 1e-3, min=1e-6),
        (0.01 / dmax) ** (1.0 / (order + 1)),
    )
    return torch.minimum(100.0 * h0, h1)


def _interp_fit(y0, y1, y_mid, f0, f1, dt):
    """Quartic through (y0, y_mid, y1) with end slopes (f0, f1): the
    coefficients ``(a, b, c, d, e)`` of ``((((a·x + b)·x + c)·x + d)·x + e)``
    on x in [0, 1]."""
    a = 2.0 * dt * (f1 - f0) - 8.0 * (y1 + y0) + 16.0 * y_mid
    b = dt * (5.0 * f0 - 3.0 * f1) + 18.0 * y0 + 14.0 * y1 - 32.0 * y_mid
    c = dt * (f1 - 4.0 * f0) - 11.0 * y0 - 5.0 * y1 + 16.0 * y_mid
    d = dt * f0
    return a, b, c, d, y0


def _interp_eval(coeffs, t0, t1, t):
    """Evaluate the dense-output quartic at t in [t0, t1]."""
    span = t1 - t0
    x = torch.where(span > 0, (t - t0) / torch.where(span > 0, span, 1.0), 0.0)
    a, b, c, d, e = coeffs
    return ((((a * x + b) * x + c) * x + d) * x) + e


class _State:
    """Solver state; ``coeffs`` is the dense-output quartic over [last_t, t]."""

    def __init__(self, t, y, f, dt, last_t, coeffs, facold, rejected, nfe, n_accept, n_reject):
        self.t, self.y, self.f, self.dt = t, y, f, dt
        self.last_t, self.coeffs = last_t, coeffs
        self.facold, self.rejected = facold, rejected
        self.nfe, self.n_accept, self.n_reject = nfe, n_accept, n_reject


@torch.no_grad()
def _controller(err, facold, rejected: bool, dt):
    """dopri5.f PI step-size update.  Returns (accept, dt_next, facold')."""
    err = torch.clamp(err, min=_ERR_FLOOR)
    accept = bool(err <= 1.0)
    fac11 = err ** _EXPO1
    fac = fac11 / facold ** _BETA
    fac = torch.clamp(fac / _SAFETY, 1.0 / _FAC_MAX, 1.0 / _FAC_MIN)
    if not accept:
        return False, dt / torch.clamp(fac11 / _SAFETY, max=1.0 / _FAC_MIN), facold
    dt_next = dt / fac
    if rejected:  # after a rejection, never grow the step on the following accept
        dt_next = torch.minimum(dt_next, dt)
    return True, dt_next, torch.clamp(err, min=1e-4)


def _nfe_per_step(tab: Tableau) -> int:
    # rk_step evaluates stages 1..S-1 (k0 is the FSAL carry) plus one extra
    # f(t+dt, y1) for tableaus without FSAL.
    return len(tab.b) - 1 + (0 if tab.fsal else 1)


def _attempt_step(func, tab, rtol, atol, s: _State) -> None:
    """One accept-or-reject RK attempt from s.t with step s.dt (updates s)."""
    y1, f1, y_err, ks = rk_step(func, tab, s.t, s.y, s.f, s.dt)
    with torch.no_grad():
        err = _error_ratio(y_err, s.y, y1, rtol, atol)
    accept, dt_next, s.facold = _controller(err, s.facold, s.rejected, s.dt.detach())
    s.nfe += _nfe_per_step(tab)
    s.rejected = not accept
    if accept:
        if tab.c_mid is not None:
            terms = [float(c) * k for c, k in zip(tab.c_mid, ks) if c != 0.0]
            y_mid = s.y + s.dt * sum(terms[1:], terms[0])
        else:
            # Cubic-Hermite midpoint: enough dense-output accuracy for order
            # <= 3 tableaus without published c_mid weights.
            y_mid = 0.5 * (s.y + y1) + s.dt * (s.f - f1) / 8.0
        s.coeffs = _interp_fit(s.y, y1, y_mid, s.f, f1, s.dt)
        s.last_t, s.t, s.y, s.f = s.t, s.t + s.dt, y1, f1
        s.n_accept += 1
    else:
        s.n_reject += 1
    s.dt = dt_next


def _integrate(func, y0, ts, tab, rtol, atol, max_attempts, first_step):
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    t0 = ts[0]
    f0 = func(t0, y0)
    if first_step is None:
        dt0 = _initial_step(func, t0, y0, f0, tab.order - 1, rtol, atol)
        nfe0 = 3  # f0 + the two probe evaluations
    else:
        dt0 = torch.as_tensor(first_step, dtype=y0.dtype, device=y0.device)
        nfe0 = 1
    zero = torch.zeros((), dtype=y0.dtype, device=y0.device)
    s = _State(
        t=t0, y=y0, f=f0, dt=dt0, last_t=t0,
        coeffs=_interp_fit(y0, y0, y0, f0 * 0, f0 * 0, zero),
        facold=torch.full((), 1e-4, dtype=y0.dtype, device=y0.device),
        rejected=False, nfe=nfe0, n_accept=0, n_reject=0,
    )
    ys, reached = [y0], True
    for t_target in ts[1:]:
        for _ in range(max_attempts):
            if bool(s.t >= t_target):
                break
            _attempt_step(func, tab, rtol, atol, s)
        reached = reached and bool(s.t >= t_target)
        ys.append(_interp_eval(s.coeffs, s.last_t, s.t, t_target))
    stats = dict(
        nfe=s.nfe, n_accept=s.n_accept, n_reject=s.n_reject,
        success=reached, t_reached=float(s.t.detach()),
    )
    return torch.stack(ys), stats


def odeint_adaptive(
    func: Callable, y0: torch.Tensor, ts, *, tab: Tableau = DOPRI5,
    rtol: float = 1e-7, atol: float = 1e-9, max_steps: int = 10_000,
    first_step: float | None = None,
):
    """Adaptive integration with a data-dependent step count (JAX's while form).

    ``ts`` must be strictly increasing (the api layer handles reversal).
    Returns ``(ys [T, ...], stats)`` with stats ``{nfe, n_accept, n_reject,
    success, t_reached}``; ``success=False`` means an interval used up
    ``max_steps`` attempts and its row of ``ys`` is extrapolated.
    """
    return _integrate(func, y0, ts, tab, rtol, atol, max_steps, first_step)


def odeint_adaptive_scan(
    func: Callable, y0: torch.Tensor, ts, *, tab: Tableau = DOPRI5,
    rtol: float = 1e-7, atol: float = 1e-9, max_steps_per_interval: int = 64,
    first_step: float | None = None,
):
    """JAX's bounded-scan form: at most ``max_steps_per_interval`` attempts per
    output interval.  Same returns as ``odeint_adaptive``."""
    return _integrate(func, y0, ts, tab, rtol, atol, max_steps_per_interval, first_step)
