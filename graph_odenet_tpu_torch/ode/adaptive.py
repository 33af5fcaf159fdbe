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

``batch_dims=1`` takes a leading axis of ``y0`` as independent problems,
each with its own controller (``jax.vmap`` of the JAX forms); see
``_integrate_batched``.

``odeint_adaptive_ckpt`` is the forward of the checkpointed adjoint: steps
clipped to land on the requested times, every accepted ``(t, y)`` recorded.
"""

from __future__ import annotations

from typing import Callable

import torch

from graph_odenet_tpu_torch.ode.tableaus import DOPRI5, Tableau, rk_step

__all__ = [
    "odeint_adaptive", "odeint_adaptive_scan", "odeint_adaptive_ckpt", "odeint_dopri5",
    "odeint_dopri5_scan",
]

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
    """Hairer's starting-step heuristic (torchdiffeq ``_select_initial_step``).

    ``|y0|`` is taken as ``where(y0 >= 0, y0, -y0)``: the same values, and
    the derivative 1 at 0 that JAX's ``abs`` has (torch's ``abs`` has 0)."""
    scale = atol + torch.where(y0 >= 0, y0, -y0) * rtol
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


def _init_state(func, y0, t0, tab, rtol, atol, first_step) -> _State:
    f0 = func(t0, y0)
    if first_step is None:
        dt0 = _initial_step(func, t0, y0, f0, tab.order - 1, rtol, atol)
        nfe0 = 3  # f0 + the two probe evaluations
    else:
        dt0 = torch.as_tensor(first_step, dtype=y0.dtype, device=y0.device)
        nfe0 = 1
    zero = torch.zeros((), dtype=y0.dtype, device=y0.device)
    return _State(
        t=t0, y=y0, f=f0, dt=dt0, last_t=t0,
        coeffs=_interp_fit(y0, y0, y0, f0 * 0, f0 * 0, zero),
        facold=torch.full((), 1e-4, dtype=y0.dtype, device=y0.device),
        rejected=False, nfe=nfe0, n_accept=0, n_reject=0,
    )


def _integrate(func, y0, ts, tab, rtol, atol, max_attempts, first_step):
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    s = _init_state(func, y0, ts[0], tab, rtol, atol, first_step)
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


def _clip(s: _State, t_target):
    """Clip the proposal ``s.dt`` to the time left to ``t_target``; returns the
    proposal from before the clip and whether the clip shortened it."""
    proposal, remaining = s.dt, t_target - s.t
    s.dt = torch.minimum(proposal, remaining)
    return proposal, proposal >= remaining


def _land(s: _State, took, clipped, proposal, t_target) -> None:
    """After an attempt: a clipped step that was taken lands on ``t_target``
    exactly (``t + (t_target − t)`` need not round-trip, and an ulp short
    would spin the interval on micro-steps), and the next interval starts
    from the proposal from before the clip, which shrank only because the
    interval ended."""
    land = took & clipped
    s.t = torch.where(land, t_target, s.t)
    s.dt = torch.where(land, torch.maximum(s.dt, proposal), s.dt)


def _integrate_ckpt(func, y0, ts, tab, rtol, atol, trace_per_interval, first_step):
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    s = _init_state(func, y0, ts[0], tab, rtol, atol, first_step)
    budget = trace_per_interval * (ts.shape[0] - 1)
    trace_t, trace_y, acc_at, ys, reached = [ts[0]], [y0], [0], [y0], True
    for t_target in ts[1:]:
        for _ in range(2 * trace_per_interval + 10):
            if bool(s.t >= t_target):
                break
            proposal, clipped = _clip(s, t_target)
            n_accept = s.n_accept
            _attempt_step(func, tab, rtol, atol, s)
            if s.n_accept > n_accept:
                _land(s, True, clipped, proposal, t_target)
                if s.n_accept > budget + 1:  # overflow: JAX's last slot takes it
                    trace_t.pop(), trace_y.pop()
                trace_t.append(s.t)
                trace_y.append(s.y)
        reached = reached and bool(s.t >= t_target)
        ys.append(s.y)
        acc_at.append(s.n_accept)
    ok = s.n_accept <= budget
    stats = dict(
        nfe=s.nfe, n_accept=s.n_accept, n_reject=s.n_reject,
        success=reached and ok, t_reached=float(s.t.detach()),
    )
    trace = dict(t=torch.stack(trace_t), y=torch.stack(trace_y), acc_at_target=acc_at,
                 n_steps=s.n_accept, ok=ok)
    return torch.stack(ys), stats, trace


# The batched form: a leading axis of ``y0`` holds independent problems, as
# ``jax.vmap`` of the JAX solvers makes them.  Every sample has its own t, dt,
# dense output, controller memory, error ratio, accept mask and stats, kept in
# ``[B]`` tensors; an attempt updates only the samples that have not reached
# the interval's target (JAX's ``where(done, s, s1)``), so it needs no host
# read.  The interval ends once every sample is done, which the host reads once
# an attempt; the attempts JAX's masked scan runs after that point pass every
# sample through unchanged, so values, stats and gradients are the same.


def _rms_per_sample(x):
    return torch.sqrt(torch.mean(torch.square(x).flatten(1), dim=1))


def _col(v, y):
    """A ``[B]`` tensor viewed as ``[B, 1, ...]`` against ``y``."""
    return v.view((-1,) + (1,) * (y.dim() - 1))


def _initial_step_batched(func, t0, y0, f0, order, rtol, atol):
    """Hairer's starting step of each sample, RMS over its trailing axes.

    ``|y0|`` is taken as ``where(y0 >= 0, y0, -y0)``: its derivative at 0 is
    1, as JAX's ``abs`` has it (torch's ``abs`` has 0)."""
    scale = atol + torch.where(y0 >= 0, y0, -y0) * rtol
    d0 = _rms_per_sample(y0 / scale)
    d1 = _rms_per_sample(f0 / scale)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    f1 = func(t0 + h0, y0 + _col(h0, y0) * f0)
    d2 = _rms_per_sample((f1 - f0) / scale) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(
        dmax <= 1e-15,
        torch.clamp(h0 * 1e-3, min=1e-6),
        (0.01 / dmax) ** (1.0 / (order + 1)),
    )
    return torch.minimum(100.0 * h0, h1)


@torch.no_grad()
def _controller_batched(err, facold, rejected, dt):
    """``_controller`` with a ``[B]`` tensor for every scalar: the accept mask,
    the next step and the controller memory of each sample."""
    err = torch.clamp(err, min=_ERR_FLOOR)
    accept = err <= 1.0
    fac11 = err ** _EXPO1
    fac = torch.clamp(fac11 / facold ** _BETA / _SAFETY, 1.0 / _FAC_MAX, 1.0 / _FAC_MIN)
    dt_accept = dt / fac
    dt_accept = torch.where(rejected, torch.minimum(dt_accept, dt), dt_accept)
    dt_reject = dt / torch.clamp(fac11 / _SAFETY, max=1.0 / _FAC_MIN)
    dt_next = torch.where(accept, dt_accept, dt_reject)
    return accept, dt_next, torch.where(accept, torch.clamp(err, min=1e-4), facold)


def _init_batched(func, y0, t0, tab, rtol, atol, first_step) -> _State:
    """The solver state at ``t0`` (a scalar tensor) for every sample of ``y0``:
    ``[B]`` tensors for t, dt, last_t, facold, rejected and the counts."""
    n = y0.shape[0]
    t = t0.expand(n)
    f0 = func(t, y0)
    if first_step is None:
        dt0 = _initial_step_batched(func, t, y0, f0, tab.order - 1, rtol, atol)
        nfe0 = 3  # f0 + the two probe evaluations
    else:
        dt0 = torch.full((n,), first_step, dtype=y0.dtype, device=y0.device)
        nfe0 = 1
    zero = torch.zeros((), dtype=y0.dtype, device=y0.device)
    count = lambda v: torch.full((n,), v, dtype=torch.int64, device=y0.device)  # noqa: E731
    return _State(
        t=t, y=y0, f=f0, dt=dt0, last_t=t,
        coeffs=_interp_fit(y0, y0, y0, f0 * 0, f0 * 0, zero),
        facold=torch.full((n,), 1e-4, dtype=y0.dtype, device=y0.device),
        rejected=torch.zeros(n, dtype=torch.bool, device=y0.device),
        nfe=count(nfe0), n_accept=count(0), n_reject=count(0),
    )


def _attempt_batched(func, tab, rtol, atol, s: _State, done) -> None:
    """One attempt of every sample not ``done``; the others pass through.

    Reads nothing on the host: the accept decisions stay ``[B]`` masks."""
    col = lambda v: _col(v, s.y)  # noqa: E731
    y1, f1, y_err, ks = rk_step(
        lambda t, y: func(t.reshape(-1), y), tab, col(s.t), s.y, s.f, col(s.dt)
    )
    with torch.no_grad():
        scale = atol + rtol * torch.maximum(torch.abs(s.y), torch.abs(y1))
        err = _rms_per_sample(y_err / scale)
    accept, dt_next, facold = _controller_batched(err, s.facold, s.rejected, s.dt.detach())
    if tab.c_mid is not None:
        terms = [float(c) * k for c, k in zip(tab.c_mid, ks) if c != 0.0]
        y_mid = s.y + col(s.dt) * sum(terms[1:], terms[0])
    else:
        y_mid = 0.5 * (s.y + y1) + col(s.dt) * (s.f - f1) / 8.0
    coeffs = _interp_fit(s.y, y1, y_mid, s.f, f1, col(s.dt))

    live = ~done
    take = accept & live
    take_c = col(take)
    s.coeffs = tuple(torch.where(take_c, new, old) for new, old in zip(coeffs, s.coeffs))
    s.last_t = torch.where(take, s.t, s.last_t)
    s.t = torch.where(take, s.t + s.dt, s.t)
    s.y = torch.where(take_c, y1, s.y)
    s.f = torch.where(take_c, f1, s.f)
    s.dt = torch.where(live, dt_next, s.dt)
    s.facold = torch.where(live, facold, s.facold)
    s.rejected = torch.where(live, ~accept, s.rejected)
    s.nfe = s.nfe + live * _nfe_per_step(tab)
    s.n_accept = s.n_accept + take
    s.n_reject = s.n_reject + (live & ~accept)


def _integrate_batched(func, y0, ts, tab, rtol, atol, max_attempts, first_step):
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    s = _init_batched(func, y0, ts[0], tab, rtol, atol, first_step)
    ys, reached, host_reads = [y0], torch.ones_like(s.rejected), 0
    for t_target in ts[1:]:
        for _ in range(max_attempts):
            done = s.t >= t_target
            host_reads += 1
            if bool(done.all()):
                break
            _attempt_batched(func, tab, rtol, atol, s, done)
        reached = reached & (s.t >= t_target)
        ys.append(_interp_eval(s.coeffs, _col(s.last_t, y0), _col(s.t, y0), t_target))
    stats = dict(
        nfe=s.nfe, n_accept=s.n_accept, n_reject=s.n_reject,
        success=reached, t_reached=s.t.detach(), host_reads=host_reads,
    )
    return torch.stack(ys), stats


def _integrate_ckpt_batched(func, y0, ts, tab, rtol, atol, trace_per_interval, first_step):
    """``_integrate_ckpt`` of every sample, as ``jax.vmap`` runs it: each has its
    own trace in ``[K+2, B]`` buffers, written where it accepts (slot ``K+1``
    takes the writes of the others and of an overflow)."""
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    s = _init_batched(func, y0, ts[0], tab, rtol, atol, first_step)
    budget = trace_per_interval * (ts.shape[0] - 1)
    samples = torch.arange(y0.shape[0], device=y0.device)
    trace_t = ts[0].repeat(budget + 2, y0.shape[0])
    trace_y = y0.new_zeros((budget + 2,) + y0.shape)
    trace_y[0] = y0
    ys, acc_at, reached, host_reads = [y0], [s.n_accept], torch.ones_like(s.rejected), 0
    for t_target in ts[1:]:
        for _ in range(2 * trace_per_interval + 10):
            done = s.t >= t_target
            host_reads += 1
            if bool(done.all()):
                break
            proposal, clipped = _clip(s, t_target)
            s.dt = torch.where(done, proposal, s.dt)
            n_accept = s.n_accept
            _attempt_batched(func, tab, rtol, atol, s, done)
            took = s.n_accept > n_accept
            _land(s, took, clipped, proposal, t_target)
            slot = torch.where(took, s.n_accept.clamp(max=budget + 1), budget + 1)
            trace_t[slot, samples] = s.t
            trace_y[slot, samples] = s.y
        reached = reached & (s.t >= t_target)
        ys.append(s.y)
        acc_at.append(s.n_accept)
    ok = s.n_accept <= budget
    stats = dict(
        nfe=s.nfe, n_accept=s.n_accept, n_reject=s.n_reject,
        success=reached & ok, t_reached=s.t.detach(), host_reads=host_reads,
    )
    trace = dict(t=trace_t, y=trace_y, acc_at_target=torch.stack(acc_at), n_steps=s.n_accept,
                 ok=ok)
    return torch.stack(ys), stats, trace


def _solve(func, y0, ts, tab, rtol, atol, max_attempts, first_step, batch_dims):
    if batch_dims == 0:
        return _integrate(func, y0, ts, tab, rtol, atol, max_attempts, first_step)
    if batch_dims == 1:
        return _integrate_batched(func, y0, ts, tab, rtol, atol, max_attempts, first_step)
    raise ValueError(f"batch_dims must be 0 or 1, got {batch_dims!r}")


def odeint_adaptive(
    func: Callable, y0: torch.Tensor, ts, *, tab: Tableau = DOPRI5,
    rtol: float = 1e-7, atol: float = 1e-9, max_steps: int = 10_000,
    first_step: float | None = None, batch_dims: int = 0,
):
    """Adaptive integration with a data-dependent step count (JAX's while form).

    ``ts`` must be strictly increasing (the api layer handles reversal).
    Returns ``(ys [T, ...], stats)`` with stats ``{nfe, n_accept, n_reject,
    success, t_reached}``; ``success=False`` means an interval used up
    ``max_steps`` attempts and its row of ``ys`` is extrapolated.

    ``batch_dims=1`` solves each ``y0[b]`` as its own problem, as ``jax.vmap``
    of the JAX solver does: ``func`` gets ``t`` of shape ``[B]``, the stats are
    ``[B]`` tensors, and ``stats["host_reads"]`` counts the host's reads of
    "every sample done?" (one an attempt, one more an interval).
    """
    return _solve(func, y0, ts, tab, rtol, atol, max_steps, first_step, batch_dims)


def odeint_adaptive_scan(
    func: Callable, y0: torch.Tensor, ts, *, tab: Tableau = DOPRI5,
    rtol: float = 1e-7, atol: float = 1e-9, max_steps_per_interval: int = 64,
    first_step: float | None = None, batch_dims: int = 0,
):
    """JAX's bounded-scan form: at most ``max_steps_per_interval`` attempts per
    output interval.  Same arguments and returns as ``odeint_adaptive``."""
    return _solve(func, y0, ts, tab, rtol, atol, max_steps_per_interval, first_step, batch_dims)


def odeint_adaptive_ckpt(
    func: Callable, y0: torch.Tensor, ts, *, tab: Tableau = DOPRI5,
    rtol: float = 1e-7, atol: float = 1e-9, trace_per_interval: int = 32,
    first_step: float | None = None, batch_dims: int = 0,
):
    """Adaptive integration that records the accepted steps (JAX's
    ``odeint_adaptive_ckpt``): the forward of the checkpointed adjoint.

    The last step of each interval is clipped to land exactly on the output
    time, so the output times are step boundaries and the rows of ``ys`` are
    accepted states, not interpolations.  At most ``2·trace_per_interval +
    10`` attempts an interval.  Returns ``(ys, stats, trace)``: ``trace`` holds
    ``t`` and ``y`` of the accepted states (``t[0] = ts[0]``, ``y[0] = y0``),
    ``acc_at_target[i]``, the number of accepted steps when output time i was
    reached (an index into ``t``), ``n_steps`` and ``ok``.  ``ok`` is False,
    and so is ``stats["success"]``, when more than ``K = trace_per_interval·
    (T−1)`` steps were accepted: then, as in JAX's buffers, slot ``K+1``
    holds the last accepted state and the trace is unusable for gradients.

    ``batch_dims=1`` solves each ``y0[b]`` as its own problem: ``t [K+2, B]``
    and ``y [K+2, B, ...]`` with each sample's accepted states at the front
    (slots past its ``n_steps`` hold no state of it), ``acc_at_target [T, B]``
    and ``[B]`` counts, as ``jax.vmap`` gives them.
    """
    if batch_dims == 0:
        return _integrate_ckpt(func, y0, ts, tab, rtol, atol, trace_per_interval, first_step)
    if batch_dims == 1:
        return _integrate_ckpt_batched(func, y0, ts, tab, rtol, atol, trace_per_interval,
                                       first_step)
    raise ValueError(f"batch_dims must be 0 or 1, got {batch_dims!r}")


def odeint_dopri5(func, y0, ts, **kw):
    """JAX's alias: ``odeint_adaptive`` with DOPRI5."""
    return odeint_adaptive(func, y0, ts, tab=DOPRI5, **kw)


def odeint_dopri5_scan(func, y0, ts, **kw):
    """JAX's alias: ``odeint_adaptive_scan`` with DOPRI5."""
    return odeint_adaptive_scan(func, y0, ts, tab=DOPRI5, **kw)
