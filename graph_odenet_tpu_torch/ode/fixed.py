"""Fixed-grid ODE integration.

Counterpart of ``graph_odenet_tpu/ode/fixed.py``: torchdiffeq-style
fixed-grid stepping between consecutive requested times, each interval cut
into ``steps_per_interval`` equal substeps.  PyTorch runs eagerly, so the
JAX ``lax.scan`` is a Python loop; autograd differentiates through it
(discretise-then-optimise).
"""

from __future__ import annotations

from typing import Callable

import torch

from graph_odenet_tpu_torch.ode.tableaus import Tableau, rk_step

__all__ = ["odeint_fixed"]


def odeint_fixed(
    func: Callable,
    tab: Tableau,
    y0: torch.Tensor,
    ts: torch.Tensor,
    *,
    steps_per_interval: int = 1,
):
    """Integrate ``dy/dt = func(t, y)`` over the grid ``ts``.

    Returns ``(ys [T, ...], nfe)``: the solution at every requested time
    (``ys[0] = y0``) and the number of dynamics evaluations.
    """
    n_sub = int(steps_per_interval)
    ys = [y0]
    y = y0
    for i in range(ts.shape[0] - 1):
        t = ts[i]
        dt = (ts[i + 1] - ts[i]) / n_sub
        for _ in range(n_sub):
            y, _, _, _ = rk_step(func, tab, t, y, func(t, y), dt, compute_f1=False)
            t = t + dt
        ys.append(y)
    n_stage_evals = len(tab.b) - 1 if tab.fsal else len(tab.b)
    nfe = (ts.shape[0] - 1) * n_sub * n_stage_evals
    return torch.stack(ys), nfe
