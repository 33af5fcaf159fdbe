"""Fixed-grid Adams multistep integration (torchdiffeq's ``explicit_adams`` /
``implicit_adams``).

Counterpart of ``graph_odenet_tpu/ode/adams.py``: Adams–Bashforth 4, and
Adams–Bashforth–Moulton 4 in PECE form (predict with AB4, evaluate, correct
with the 3-step Adams–Moulton).  A step costs 1 dynamics evaluation (AB4) or 2
(ABM4) where RK4 costs 4.

The history needs a uniform step, so each output interval runs its own
uniform sub-grid, the first ``order − 1`` substeps by classic RK4, and starts
with an empty history.  JAX rolls a fixed ``[4, D]`` buffer under
``lax.cond``; here the substep index is a host integer, so the history is a
list of the last four evaluations and the warm-up is a Python branch.  The
arithmetic is JAX's: AB4's four terms in ``tensordot`` order, AM4's in the
order JAX writes them.  Autograd differentiates through the steps.
"""

from __future__ import annotations

from typing import Callable

import torch

from graph_odenet_tpu_torch.ode.tableaus import RK4, rk_step

__all__ = ["odeint_adams"]

# Adams–Bashforth weights on [f_n, f_{n−1}, f_{n−2}, f_{n−3}].
_AB4 = (55.0 / 24.0, -59.0 / 24.0, 37.0 / 24.0, -9.0 / 24.0)
# 3-step Adams–Moulton weights on [f_{n+1}, f_n, f_{n−1}, f_{n−2}].
_AM4 = (9.0 / 24.0, 19.0 / 24.0, -5.0 / 24.0, 1.0 / 24.0)
_ORDER = 4


def odeint_adams(
    func: Callable,
    y0: torch.Tensor,
    ts: torch.Tensor,
    *,
    steps_per_interval: int = 4,
    corrector: bool = False,
):
    """Integrate ``dy/dt = func(t, y)`` over the grid ``ts`` with AB4, or with
    ABM4 (``corrector=True``, torchdiffeq's ``implicit_adams``).

    Returns ``(ys [T, ...], nfe)``, as ``fixed.odeint_fixed`` does.
    """
    n_sub = int(steps_per_interval)
    ys, y, nfe = [y0], y0, 0
    for i in range(ts.shape[0] - 1):
        t = ts[i]
        dt = (ts[i + 1] - ts[i]) / n_sub
        hist = []  # most recent first
        for k in range(n_sub):
            f_now = func(t, y)
            hist = [f_now] + hist[: _ORDER - 1]
            if k < _ORDER - 1:
                y, _, _, _ = rk_step(func, RK4, t, y, f_now, dt, compute_f1=False)
                nfe += 4
            else:
                ab = _AB4[0] * hist[0] + _AB4[1] * hist[1] + _AB4[2] * hist[2] + _AB4[3] * hist[3]
                y_pred = y + dt * ab
                if corrector:
                    f_pred = func(t + dt, y_pred)
                    y = y + dt * (_AM4[0] * f_pred + _AM4[1] * hist[0] + _AM4[2] * hist[1]
                                  + _AM4[3] * hist[2])
                    nfe += 2
                else:
                    y = y_pred
                    nfe += 1
            t = t + dt
        ys.append(y)
    return torch.stack(ys), nfe
