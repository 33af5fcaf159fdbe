"""``odeint``: the torchdiffeq-compatible entry point.

Counterpart of ``graph_odenet_tpu/ode/api.py``.  ``odeint(func, y0, ts,
*args, method=...)`` integrates ``dy/dt = func(t, y, *args)`` and returns
the solution at every requested time (``ys[0] == y0``).  ``y0`` is one
tensor; the solvers work on it elementwise and take the error norm over all
of it, as JAX does over the ravelled state.

Methods: the fixed-grid tableaus, the adaptive ones (``dopri5``,
``dopri8``, ``bosh3``, ``adaptive_heun``, ``fehlberg2``) and their
``_scan`` forms.  All are differentiable by autograd through the steps.
The Adams family and ``scipy_solver`` raise ``NotImplementedError`` naming
their ROADMAP item (A14).
"""

from __future__ import annotations

from typing import Callable

import torch

from graph_odenet_tpu_torch.ode import adaptive, fixed, tableaus

__all__ = ["odeint", "SOLVERS"]

_FIXED = {
    "euler": tableaus.EULER,
    "midpoint": tableaus.MIDPOINT,
    "heun2": tableaus.HEUN2,
    "heun3": tableaus.HEUN3,
    # torchdiffeq's "rk4" is Kutta's 3/8 rule; match it.
    "rk4": tableaus.RK4_38,
    "rk4_classic": tableaus.RK4,
}

_ADAPTIVE = {
    "dopri5": tableaus.DOPRI5,
    "dopri8": tableaus.DOPRI8,
    "bosh3": tableaus.BOSH3,
    "adaptive_heun": tableaus.HEUN12,
    "fehlberg2": tableaus.FEHLBERG2,
}
_NOT_PORTED = {
    m: "A14" for m in (
        "explicit_adams", "implicit_adams", "fixed_adams", "adams", "adams_scan", "scipy_solver",
    )
}

SOLVERS = tuple(_FIXED) + tuple(_ADAPTIVE) + tuple(f"{m}_scan" for m in _ADAPTIVE)


def odeint(
    func: Callable,
    y0: torch.Tensor,
    ts,
    *args,
    method: str = "dopri5",
    rtol: float = 1e-7,
    atol: float = 1e-9,
    steps_per_interval: int = 1,
    max_steps: int = 10_000,
    max_steps_per_interval: int = 64,
    first_step: float | None = None,
    return_stats: bool = False,
    batch_dims: int = 0,
):
    """Integrate ``dy/dt = func(t, y, *args)`` over the monotonic times ``ts``.

    ``ts`` may be a list or a tensor.  Returns ``ys [T, *y0.shape]`` (and a
    stats dict when ``return_stats=True``: ``{nfe}`` for the fixed-grid
    methods, ``{nfe, n_accept, n_reject, success, t_reached}`` for the
    adaptive ones).

    ``batch_dims=1`` integrates each ``y0[b]`` as its own problem, as
    ``jax.vmap`` over ``odeint`` does: the adaptive methods keep a step size,
    error ratio, accept mask and stats per sample (stats are ``[B]`` tensors,
    plus ``host_reads``) and call ``func`` with ``t`` of shape ``[B]``; the
    fixed-grid methods are elementwise and take ``y0`` as it is.
    """
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"method {method!r} is not ported yet (ROADMAP {_NOT_PORTED[method]}); "
            f"ported: {SOLVERS}"
        )
    if method not in SOLVERS:
        raise ValueError(f"unknown method {method!r}; choose from {SOLVERS}")
    ts = torch.as_tensor(ts, dtype=y0.dtype)

    def f(t, y):
        return func(t, y, *args)

    # Reverse time: substitute s = -t, so dy/ds = -f(-s, y) over the
    # increasing grid -ts.
    if ts.shape[0] >= 2 and bool(ts[1] < ts[0]):
        inner = f

        def f(s, y):
            return -inner(-s, y)

        ts = -ts

    if method in _FIXED:
        ys, nfe = fixed.odeint_fixed(
            f, _FIXED[method], y0, ts, steps_per_interval=steps_per_interval
        )
        stats = dict(nfe=nfe)
    elif method in _ADAPTIVE:
        ys, stats = adaptive.odeint_adaptive(
            f, y0, ts, tab=_ADAPTIVE[method], rtol=rtol, atol=atol,
            max_steps=max_steps, first_step=first_step, batch_dims=batch_dims,
        )
    else:
        ys, stats = adaptive.odeint_adaptive_scan(
            f, y0, ts, tab=_ADAPTIVE[method[: -len("_scan")]], rtol=rtol, atol=atol,
            max_steps_per_interval=max_steps_per_interval, first_step=first_step,
            batch_dims=batch_dims,
        )
    return (ys, stats) if return_stats else ys
