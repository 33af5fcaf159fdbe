"""Variable-coefficient Adams–Bashforth–Moulton (torchdiffeq's ``adams``).

Counterpart of ``graph_odenet_tpu/ode/vcabm.py``: the Shampine–Gordon PECE
scheme with variable step and variable order 1…``max_order`` (at most 12),
g-coefficients from modified divided differences, error control against
``atol + rtol·max(|y0|, |y1|)`` with an RMS norm, and the k−1/k/k+1 order
rule driven by the γ* Adams–Moulton error constants.  Steps are clipped to
land exactly on each output time: the divided-difference history is the
method's interpolant, so there is no dense output.

The math is JAX's; the layout of the unbatched form is not.  JAX carries
the order as a traced integer and runs masked ``fori_loop``s over the
static ``max_order``; here the order, the history depth and the step count
are host integers, so the divided-difference loops run over
``range(order)`` and a history entry past the valid ones is ``None``
(JAX's zeros, which add nothing).  An attempt reads its accept decision,
whether it reached the output time, and, once the order is no longer held
by the start-up rule, the two order tests, all in one transfer: one host
read an attempt, plus two a solve (``ts`` and ``t_reached``).  So, as in
JAX, an attempt evaluates the dynamics at the corrected state before its
decision is known; ``nfe`` counts that evaluation only when the step is
accepted, as JAX's does.

``batch_dims=1`` solves each ``y0[b]`` as its own problem, as ``jax.vmap``
of the JAX forms does, and carries JAX's layout: the order, the history
depth and the counts are ``[B]`` tensors, the history is ``prev_t [K+2, B]``
and ``phi [K+2, B, ...]`` with zeros past each sample's valid entries, and
the recurrences are masked by ``j <= order`` and ``j < n_hist`` per sample
(``_attempt_batched``).  A sample that has reached the output time passes
through an attempt unchanged, values, stats and gradients.  The host reads
once an attempt round, for the whole batch: whether every sample is done,
and the largest order of those that are not, which bounds the loops over
``j`` (past it every sample's terms are masked).

Times are tensors of ``y0``'s dtype and device, and carry gradients as in
JAX (the first step is not detached); the error ratios and the step-size
controller run without gradient where JAX stops it.  ``odeint_vcabm`` (the
while form, at most ``max_steps`` attempts an interval) and
``odeint_vcabm_scan`` (JAX's bounded scan, ``max_steps_per_interval``) are
the same loop with different budgets; the scan's masked attempts past the
target change nothing, so values, stats and gradients are those of JAX's
forms.  Autograd differentiates both.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Callable

import numpy as np
import torch

from graph_odenet_tpu_torch.ode.adaptive import _col, _initial_step_batched, _rms_per_sample

__all__ = ["odeint_vcabm", "odeint_vcabm_scan", "gamma_star"]

_MAX_ORDER = 12
# The dopri-style controller constants torchdiffeq passes to VCABM.
_SAFETY, _IFACTOR, _DFACTOR = 0.9, 10.0, 0.2


def gamma_star(n: int) -> np.ndarray:
    """Adams–Moulton error constants γ*_0..γ*_{n−1}, exactly.

    γ*_0 = 1 and Σ_{j=0}^{m} γ*_j / (m − j + 1) = 0 for m ≥ 1
    (Hairer–Nørsett–Wanner II.III), in exact rational arithmetic.
    """
    g = [Fraction(1)]
    for m in range(1, n):
        g.append(-sum(g[j] / (m - j + 1) for j in range(m)))
    return np.array([float(v) for v in g], np.float64)


def _rms(x):
    return torch.sqrt(torch.mean(torch.square(x)))


@torch.no_grad()
def _error_ratio(err, y0, y1, rtol, atol):
    tol = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
    return _rms(err / tol)


@torch.no_grad()
def _optimal_step(dt, error_ratio, order):
    """torchdiffeq's ``_optimal_step_size``; a ratio below 1 never shrinks."""
    err = torch.clamp(error_ratio, min=1e-10)
    factor = torch.clamp(_SAFETY / err ** (1.0 / order), _DFACTOR, _IFACTOR)
    factor = torch.where(error_ratio < 1.0, torch.clamp(factor, min=1.0), factor)
    return dt * factor


def _initial_step(func, t0, y0, f0, rtol, atol):
    """Hairer's heuristic at order 2.  ``|y0|`` is ``where(y0 >= 0, y0, -y0)``:
    the same values, and JAX's derivative 1 at 0."""
    scale = atol + torch.where(y0 >= 0, y0, -y0) * rtol
    d0, d1 = _rms(y0 / scale), _rms(f0 / scale)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    f1 = func(t0 + h0, y0 + h0 * f0)
    d2 = _rms((f1 - f0) / scale) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= 1e-15, torch.clamp(h0 * 1e-3, min=1e-6),
                     (0.01 / dmax) ** (1.0 / 3.0))
    return torch.minimum(100.0 * h0, h1)


def _nonzero(x):
    """``x``, or 1 where it is 0 (JAX's guarded divisor)."""
    return torch.where(x != 0, x, 1.0)


def _g_and_explicit_phi(prev_t, next_t, phi, order, n_hist):
    """g-coefficients ``g[0..order]`` and the β-rescaled explicit φ for a step
    to ``next_t`` (JAX's ``_g_and_explicit_phi``).

    c starts as [1, 1/2, 1/3, …]; level j folds c ← c_head − c_tail·w_j with
    w_1 = 1 and w_j = dt/(next_t − prev_t[j−1]); g_j is c[0] after fold j.
    The first ``min(order + 1, n_hist)`` entries of φ are rescaled by
    β_j = β_{j−1}·(t_{n+1} − t_{n−j+1})/(t_n − t_{n−j}); the others are None.
    """
    dtype, device = next_t.dtype, next_t.device
    curr_t = prev_t[0]
    dt = next_t - curr_t
    c = 1.0 / torch.arange(1, order + 2, dtype=dtype, device=device)
    g = [torch.ones((), dtype=dtype, device=device)]
    e_phi = [phi[0]] + [None] * (len(phi) - 1)
    n_phi = min(order + 1, n_hist)
    beta = torch.ones((), dtype=dtype, device=device)
    for j in range(1, order + 1):
        if j < n_phi:
            beta = (next_t - prev_t[j - 1]) / _nonzero(curr_t - prev_t[j]) * beta
            e_phi[j] = phi[j] * beta
        w = 1.0 if j == 1 else dt / _nonzero(next_t - prev_t[j - 1])
        c = c - torch.cat([c[1:], c.new_zeros(1)]) * w
        g.append(c[0])
    return g, e_phi


def _implicit_phi(e_phi, f, k):
    """φ*_0..φ*_{k−1} at the step end: φ*_0 = f, φ*_j = φ*_{j−1} − φ_{j−1}."""
    out = [f]
    for j in range(1, k):
        out.append(out[-1] if e_phi[j - 1] is None else out[-1] - e_phi[j - 1])
    return out + [None] * (len(e_phi) - k)


class _State:
    """The solver's state at ``prev_t[0]``: host integers for the order, the
    history depth and the counts; tensors for times, ``y`` and φ."""

    def __init__(self, y, prev_t, next_t, phi, nfe):
        self.y, self.prev_t, self.next_t, self.phi = y, prev_t, next_t, phi
        self.order, self.n_hist, self.n_steps = 1, 1, 0
        self.nfe, self.n_accept, self.n_reject = nfe, 0, 0


def _attempt(func, rtol, atol, max_order, gstar, t_target, s: _State) -> bool:
    """One accept-or-reject attempt from ``prev_t[0]`` toward ``next_t``
    (JAX's ``_attempt_step``; updates ``s``).  Returns whether the state now
    stands at ``t_target``."""
    order, y = s.order, s.y
    next_raw = s.next_t
    next_t = torch.minimum(next_raw, t_target)
    dt = next_t - s.prev_t[0]
    g, e_phi = _g_and_explicit_phi(s.prev_t, next_t, s.phi, order, s.n_hist)

    # Predict with the first order−1 differences; at order 1 the predictor is
    # y itself and the corrector h·g₀·f(t₁, y).
    terms = [g[j] * e_phi[j] for j in range(order - 1) if e_phi[j] is not None]
    p_next = y + dt * sum(terms[1:], terms[0]) if terms else y
    f_pred = func(next_t, p_next)
    iphi = _implicit_phi(e_phi, f_pred, order + 1)
    y_next = p_next + dt * g[order - 1] * iphi[order - 1]

    err_vec = dt * (g[order] - g[order - 1]) * iphi[order]
    error_k = _error_ratio(err_vec, y, y_next, rtol, atol)

    f_next = func(next_t, y_next)
    iphi_next = _implicit_phi(e_phi, f_next, order + 2)

    young = s.n_steps <= 4 or order < 3
    with torch.no_grad():
        flags = [error_k <= 1.0, next_raw >= t_target]
        if not young:
            adt = dt.detach()
            tol_scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y_next.detach()))

            def ratio(gk, phik):  # the error ratio of an estimate at another order
                return _rms(adt * gk * phik.detach() / tol_scale)

            error_km1 = ratio(g[order - 1] - g[order - 2], iphi[order - 1])
            error_km2 = ratio(g[order - 2] - g[order - 3], iphi[order - 2])
            error_kp1 = ratio(float(gstar[order + 1]), iphi_next[order + 1])
            flags += [torch.minimum(error_km1, error_km2) < error_k, error_kp1 < error_k]
        flags = torch.stack(flags).tolist()  # the attempt's one host read
    accept, reached = flags[0], flags[1]

    if not accept:
        s.next_t = s.prev_t[0] + _optimal_step(dt.detach(), error_k, order)
        s.nfe += 1
        s.n_reject += 1
        return False
    if young:
        next_order = min(order + 1, 3, max_order)
    elif flags[2]:
        next_order = order - 1
    elif order < max_order and s.n_hist >= order + 1 and flags[3]:
        next_order = order + 1
    else:
        next_order = order
    dt_acc = dt if next_order > order else _optimal_step(dt.detach(), error_k, order + 1)
    s.y = y_next
    s.prev_t = [next_t] + s.prev_t[:-1]
    s.next_t = next_t + dt_acc
    s.phi = iphi_next
    s.n_hist = min(order + 1, s.n_hist) + 1
    s.order = next_order
    s.n_steps += 1
    s.nfe += 2
    s.n_accept += 1
    return reached


def _solve(func, y0, ts, rtol, atol, max_order, max_attempts, first_step):
    max_order = int(min(max_order, _MAX_ORDER))
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    gstar = gamma_star(max_order + 2)
    t0 = ts[0]
    f0 = func(t0, y0)
    if first_step is None:
        dt0, nfe0 = _initial_step(func, t0, y0, f0, rtol, atol), 2
    else:
        dt0, nfe0 = torch.as_tensor(first_step, dtype=y0.dtype, device=y0.device), 1
    phi = [f0] + [None] * (max_order + 1)
    s = _State(y0, [t0] * (max_order + 2), t0 + dt0, phi, nfe0)
    ts_host = ts.detach().cpu().tolist()
    ys, at_target, success = [y0], True, True
    for i in range(1, len(ts_host)):
        # prev_t[0] never passes a target, so it stands at ts[i] only if it
        # reached ts[i − 1] and ts[i] is no later.
        done = at_target and ts_host[i - 1] >= ts_host[i]
        for _ in range(max_attempts):
            if done:
                break
            done = _attempt(func, rtol, atol, max_order, gstar, ts[i], s)
        at_target = done
        success = success and done
        ys.append(s.y)
    stats = dict(
        nfe=s.nfe, n_accept=s.n_accept, n_reject=s.n_reject, success=success,
        t_reached=float(s.prev_t[0].detach()), final_order=s.order,
    )
    return torch.stack(ys), stats


# The batched form: JAX's layout under ``jax.vmap``.  Every sample has its own
# order, history depth, step count and counts (``[B]`` tensors), its own times
# ``prev_t [K+2, B]`` and ``next_t [B]``, and its own divided differences in
# ``phi [K+2, B, ...]``, zeros past its valid entries.  The loops over ``j`` are
# masked per sample by ``j <= order`` and ``j < n_hist`` as JAX's ``fori_loop``s
# are, and run to ``hi``, the largest order of the samples not yet done, which
# the host reads with "every sample done?" once an attempt round.  A masked
# term is an exact zero, so a sample's sums are those of the unbatched form.


def _take(x, idx):
    """``x[idx[b], b]`` for every sample ``b`` of a ``[L, B, ...]`` stack.  The
    index is clamped to the stack: a done sample's order may lie past the
    round's ``hi``, and what it reads is discarded."""
    idx = idx.clamp(0, x.shape[0] - 1)
    return x[idx, torch.arange(idx.shape[0], device=idx.device)]


def _lead(v, x):
    """A ``[L, B]`` tensor viewed as ``[L, B, 1, ...]`` against ``x``."""
    return v.view(v.shape + (1,) * (x.dim() - v.dim()))


@torch.no_grad()
def _optimal_step_batched(dt, error_ratio, order):
    """``_optimal_step`` with an order per sample."""
    err = torch.clamp(error_ratio, min=1e-10)
    factor = torch.clamp(_SAFETY / err ** (1.0 / order.to(err.dtype)), _DFACTOR, _IFACTOR)
    factor = torch.where(error_ratio < 1.0, torch.clamp(factor, min=1.0), factor)
    return dt * factor


def _g_and_explicit_phi_batched(prev_t, next_t, phi, order, n_hist, hi):
    """``_g_and_explicit_phi`` of every sample, ``hi >= 1`` levels: ``g [hi+1,
    B]`` (0 past a sample's order) and ``e_phi [hi+1, B, ...]`` (0 from a
    sample's ``min(order + 1, n_hist)`` on).  Past ``j = order`` a sample's
    ``c`` stops folding, as JAX's ``where(live, c_new, c)`` keeps it."""
    curr_t = prev_t[0]
    dt = next_t - curr_t
    n_phi = torch.minimum(order + 1, n_hist)
    c = (1.0 / torch.arange(1, hi + 2, dtype=dt.dtype, device=dt.device))[:, None]
    c = c.expand(-1, dt.shape[0])
    g, betas = [torch.ones_like(dt)], []
    beta = torch.ones_like(dt)
    for j in range(1, hi + 1):
        beta = torch.where(j < n_phi,
                           (next_t - prev_t[j - 1]) / _nonzero(curr_t - prev_t[j]) * beta, beta)
        betas.append(beta)
        w = 1.0 if j == 1 else dt / _nonzero(next_t - prev_t[j - 1])
        c_new = c - torch.cat([c[1:], c.new_zeros((1, c.shape[1]))]) * w
        c = torch.where(j <= order, c_new, c)
        g.append(torch.where(j <= order, c[0], 0.0))
    beta = torch.stack(betas)
    rescaled = torch.arange(1, hi + 1, device=order.device)[:, None] < n_phi
    e_phi = torch.where(_lead(rescaled, phi), phi[1:hi + 1] * _lead(beta, phi), 0.0)
    return torch.stack(g), torch.cat([phi[:1], e_phi])


def _implicit_phi_batched(e_phi, f, k, n):
    """``_implicit_phi`` of every sample: ``[n, B, ...]``, 0 from entry ``k[b]``."""
    out = [f]
    for j in range(1, n):
        out.append(torch.where(_col(j < k, f), out[-1] - e_phi[j - 1], 0.0))
    return torch.stack(out)


class _BatchState:
    """``_State`` of every sample: ``[B]`` tensors for the order, the history
    depth and the counts; ``prev_t [K+2, B]``, ``next_t [B]``, ``phi [K+2, B, ...]``."""

    def __init__(self, y, prev_t, next_t, phi, nfe):
        self.y, self.prev_t, self.next_t, self.phi = y, prev_t, next_t, phi

        def count(v):
            return torch.full(y.shape[:1], v, dtype=torch.int64, device=y.device)

        self.order, self.n_hist, self.n_steps = count(1), count(1), count(0)
        self.nfe, self.n_accept, self.n_reject = count(nfe), count(0), count(0)


def _attempt_batched(func, rtol, atol, max_order, gstar, t_target, s: _BatchState, done,
                     hi: int) -> None:
    """One attempt of every sample not ``done`` (JAX's ``_attempt_step`` under
    ``jax.vmap``); the others pass through unchanged.  ``hi`` is at least the
    order of every sample not done.  Reads nothing on the host: the accept
    decisions and the order rule stay ``[B]`` masks."""
    col = lambda v: _col(v, s.y)  # noqa: E731
    order, y = s.order, s.y
    next_t = torch.minimum(s.next_t, t_target)
    dt = next_t - s.prev_t[0]
    g, e_phi = _g_and_explicit_phi_batched(s.prev_t, next_t, s.phi, order, s.n_hist, hi)

    # Predict with the first order−1 differences, summed in the unbatched
    # form's order; at order 1 the predictor is y itself.
    p_sum = None
    for j in range(hi - 1):
        term = torch.where(col(j < order - 1), col(g[j]) * e_phi[j], 0.0)
        p_sum = term if p_sum is None else p_sum + term
    p_next = y if p_sum is None else torch.where(col(order > 1), y + col(dt) * p_sum, y)
    f_pred = func(next_t, p_next)
    iphi = _implicit_phi_batched(e_phi, f_pred, order + 1, hi + 1)
    g_k, g_km1 = _take(g, order), _take(g, order - 1)
    y_next = p_next + col(dt * g_km1) * _take(iphi, order - 1)
    err_vec = col(dt * (g_k - g_km1)) * _take(iphi, order)

    f_next = func(next_t, y_next)
    iphi_next = _implicit_phi_batched(e_phi, f_next, order + 2, hi + 2)

    with torch.no_grad():
        tol = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y_next))
        error_k = _rms_per_sample(err_vec / tol)
        adt = dt.detach()

        def ratio(gk, phik):  # the error ratio of an estimate at another order
            return _rms_per_sample(col(adt * gk) * phik / tol)

        # At the young orders these read clamped entries; the start-up rule
        # discards them.
        g_km2, g_km3 = _take(g, order - 2), _take(g, order - 3)
        error_km1 = ratio(g_km1 - g_km2, _take(iphi, order - 1))
        error_km2 = ratio(g_km2 - g_km3, _take(iphi, order - 2))
        error_kp1 = ratio(gstar[order + 1], _take(iphi_next, order + 1))
        accept = error_k <= 1.0
        young = (s.n_steps <= 4) | (order < 3)
        lower = torch.minimum(error_km1, error_km2) < error_k
        higher = (order < max_order) & (s.n_hist >= order + 1) & (error_kp1 < error_k)
        next_order = torch.where(
            young, torch.clamp(order + 1, max=min(3, max_order)),
            torch.where(lower, order - 1, torch.where(higher, order + 1, order)))
        dt_rej = _optimal_step_batched(adt, error_k, order)
        dt_opt = _optimal_step_batched(adt, error_k, order + 1)
    dt_acc = torch.where(next_order > order, dt, dt_opt)

    live = ~done
    take = accept & live
    s.y = torch.where(col(take), y_next, y)
    s.next_t = torch.where(live, torch.where(accept, next_t + dt_acc, s.prev_t[0] + dt_rej),
                           s.next_t)
    s.prev_t = torch.where(take, torch.cat([next_t[None], s.prev_t[:-1]]), s.prev_t)
    pad = s.phi.shape[0] - iphi_next.shape[0]
    phi_next = torch.cat([iphi_next, iphi_next.new_zeros((pad,) + iphi_next.shape[1:])])
    s.phi = torch.where(_col(take, y)[None], phi_next, s.phi)
    s.n_hist = torch.where(take, torch.minimum(order + 1, s.n_hist) + 1, s.n_hist)
    s.order = torch.where(take, next_order, order)
    s.n_steps = s.n_steps + take
    s.nfe = s.nfe + live + take
    s.n_accept = s.n_accept + take
    s.n_reject = s.n_reject + (live & ~accept)


def _solve_batched(func, y0, ts, rtol, atol, max_order, max_attempts, first_step):
    max_order = int(min(max_order, _MAX_ORDER))
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    gstar = torch.as_tensor(gamma_star(max_order + 2), dtype=y0.dtype, device=y0.device)
    n = y0.shape[0]
    t0 = ts[0].expand(n)
    f0 = func(t0, y0)
    if first_step is None:
        dt0, nfe0 = _initial_step_batched(func, t0, y0, f0, 2, rtol, atol), 2
    else:
        dt0, nfe0 = torch.full((n,), first_step, dtype=y0.dtype, device=y0.device), 1
    phi = torch.cat([f0[None], f0.new_zeros((max_order + 1,) + f0.shape)])
    s = _BatchState(y0, t0.expand(max_order + 2, n), t0 + dt0, phi, nfe0)
    ys, reached, host_reads = [y0], torch.ones(n, dtype=torch.bool, device=y0.device), 0
    for t_target in ts[1:]:
        for _ in range(max_attempts):
            done = s.prev_t[0] >= t_target
            # The round's one host read: every sample done?, and the largest
            # order of those that are not.
            all_done, hi = torch.stack([done.all().long(),
                                        torch.where(done, 0, s.order).max()]).tolist()
            host_reads += 1
            if all_done:
                break
            _attempt_batched(func, rtol, atol, max_order, gstar, t_target, s, done, hi)
        reached = reached & (s.prev_t[0] >= t_target)
        ys.append(s.y)
    stats = dict(
        nfe=s.nfe, n_accept=s.n_accept, n_reject=s.n_reject, success=reached,
        t_reached=s.prev_t[0].detach(), final_order=s.order, host_reads=host_reads,
    )
    return torch.stack(ys), stats


def _run(func, y0, ts, rtol, atol, max_order, max_attempts, first_step, batch_dims):
    if batch_dims == 0:
        return _solve(func, y0, ts, rtol, atol, max_order, max_attempts, first_step)
    if batch_dims == 1:
        return _solve_batched(func, y0, ts, rtol, atol, max_order, max_attempts, first_step)
    raise ValueError(f"batch_dims must be 0 or 1, got {batch_dims!r}")


def odeint_vcabm(
    func: Callable, y0: torch.Tensor, ts, *, rtol: float = 1e-7, atol: float = 1e-9,
    max_order: int = _MAX_ORDER, max_steps: int = 10_000, first_step: float | None = None,
    batch_dims: int = 0,
):
    """Adaptive-order Adams integration (JAX's while form): at most
    ``max_steps`` attempts an output interval.

    ``ts`` must be increasing (the api layer handles reversal).  Returns
    ``(ys [T, ...], stats)`` with stats ``{nfe, n_accept, n_reject, success,
    t_reached, final_order}``.

    ``batch_dims=1`` solves each ``y0[b]`` as its own problem, as ``jax.vmap``
    of the JAX solver does: ``func`` gets ``t`` of shape ``[B]``, the stats are
    ``[B]`` tensors, and ``stats["host_reads"]`` counts the host's reads, one
    an attempt round and one more an interval.
    """
    return _run(func, y0, ts, rtol, atol, max_order, max_steps, first_step, batch_dims)


def odeint_vcabm_scan(
    func: Callable, y0: torch.Tensor, ts, *, rtol: float = 1e-7, atol: float = 1e-9,
    max_order: int = _MAX_ORDER, max_steps_per_interval: int = 64,
    first_step: float | None = None, batch_dims: int = 0,
):
    """JAX's bounded-scan form: at most ``max_steps_per_interval`` attempts an
    output interval.  Same arguments and returns as ``odeint_vcabm``."""
    return _run(func, y0, ts, rtol, atol, max_order, max_steps_per_interval, first_step,
                batch_dims)
