"""``odeint``: the torchdiffeq-compatible entry point, fixed-grid methods.

Counterpart of the fixed-grid half of ``graph_odenet_tpu/ode/api.py``.
``odeint(func, y0, ts, *args, method=...)`` integrates
``dy/dt = func(t, y, *args)`` and returns the solution at every requested
time (``ys[0] == y0``).  ``y0`` is one tensor; the solvers work on it
elementwise, so it needs no ravelling.

Methods not yet ported raise ``NotImplementedError`` naming their ROADMAP
item: the adaptive solvers and their ``_scan`` forms (A12), the Adams
family and ``scipy_solver`` (A14).
"""

from __future__ import annotations

from typing import Callable

import torch

from graph_odenet_tpu_torch.ode import fixed, tableaus

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

_ADAPTIVE = ("dopri5", "dopri8", "bosh3", "adaptive_heun", "fehlberg2")
_NOT_PORTED = {
    **{m: "A12" for m in _ADAPTIVE},
    **{f"{m}_scan": "A12" for m in _ADAPTIVE},
    **{m: "A14" for m in (
        "explicit_adams", "implicit_adams", "fixed_adams", "adams", "adams_scan", "scipy_solver",
    )},
}

SOLVERS = tuple(_FIXED)


def odeint(
    func: Callable,
    y0: torch.Tensor,
    ts,
    *args,
    method: str = "dopri5",
    steps_per_interval: int = 1,
    return_stats: bool = False,
):
    """Integrate ``dy/dt = func(t, y, *args)`` over the monotonic times ``ts``.

    ``ts`` may be a list or a tensor; a host-side grid keeps the time
    arithmetic off the device.  Returns ``ys [T, *y0.shape]`` (and a stats
    dict ``{nfe}`` when ``return_stats=True``).
    """
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"method {method!r} is not ported yet (ROADMAP {_NOT_PORTED[method]}); "
            f"ported: {SOLVERS}"
        )
    if method not in _FIXED:
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

    ys, nfe = fixed.odeint_fixed(f, _FIXED[method], y0, ts, steps_per_interval=steps_per_interval)
    return (ys, dict(nfe=nfe)) if return_stats else ys
