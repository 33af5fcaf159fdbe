"""Butcher tableaus and the generic explicit Runge-Kutta step.

Counterpart of the fixed-grid half of ``graph_odenet_tpu/ode/tableaus.py``:
euler, midpoint, heun2, heun3, classic RK4 and Kutta's 3/8 rule (what
torchdiffeq's ``rk4`` runs).  The embedded adaptive tableaus come with the
adaptive solvers (ROADMAP A12).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

__all__ = ["Tableau", "EULER", "MIDPOINT", "HEUN2", "HEUN3", "RK4", "RK4_38", "rk_step"]


class Tableau(NamedTuple):
    """Explicit RK tableau.  ``a`` is the strictly-lower-triangular stage
    matrix padded square; ``b_err`` and ``c_mid`` are only set for embedded
    adaptive methods."""

    a: np.ndarray          # [S, S]
    b: np.ndarray          # [S]
    c: np.ndarray          # [S]
    b_err: np.ndarray | None = None   # [S]
    c_mid: np.ndarray | None = None   # [S]
    order: int = 1
    fsal: bool = False     # last stage == f(t+dt, y1)


def _tab(a_rows: Sequence[Sequence[float]], b, c, **kw) -> Tableau:
    s = len(b)
    a = np.zeros((s, s), dtype=np.float64)
    for i, row in enumerate(a_rows):
        a[i + 1, : len(row)] = row
    return Tableau(a=a, b=np.asarray(b, dtype=np.float64), c=np.asarray(c, dtype=np.float64), **kw)


EULER = _tab([], b=[1.0], c=[0.0], order=1)

MIDPOINT = _tab([[0.5]], b=[0.0, 1.0], c=[0.0, 0.5], order=2)

# Heun's trapezoidal 2-stage method (torchdiffeq's fixed-grid ``heun2``).
HEUN2 = _tab([[1.0]], b=[0.5, 0.5], c=[0.0, 1.0], order=2)

# Heun's 3-stage third-order method (torchdiffeq's fixed-grid ``heun3``).
HEUN3 = _tab([[1 / 3], [0.0, 2 / 3]], b=[1 / 4, 0.0, 3 / 4], c=[0.0, 1 / 3, 2 / 3], order=3)

# Classic RK4.
RK4 = _tab(
    [[0.5], [0.0, 0.5], [0.0, 0.0, 1.0]],
    b=[1 / 6, 1 / 3, 1 / 3, 1 / 6],
    c=[0.0, 0.5, 0.5, 1.0],
    order=4,
)

# Kutta's 3/8 rule: what torchdiffeq's ``rk4`` method runs.
RK4_38 = _tab(
    [[1 / 3], [-1 / 3, 1.0], [1.0, -1.0, 1.0]],
    b=[1 / 8, 3 / 8, 3 / 8, 1 / 8],
    c=[0.0, 1 / 3, 2 / 3, 1.0],
    order=4,
)


def _combine(y0, dt, coeffs, ks):
    """``y0 + dt * Σ coeffs[j]·ks[j]`` over the nonzero coefficients."""
    terms = [float(cj) * kj for cj, kj in zip(coeffs, ks) if cj != 0.0]
    return y0 + dt * sum(terms[1:], terms[0]) if terms else y0


def rk_step(
    func: Callable,
    tab: Tableau,
    t0: torch.Tensor,
    y0: torch.Tensor,
    f0: torch.Tensor,
    dt: torch.Tensor,
    *,
    compute_f1: bool = True,
):
    """One explicit RK step.

    Returns ``(y1, f1, y_err, ks)``: ``f1`` is f(t0+dt, y1) (free for FSAL
    tableaus, one extra eval otherwise, skipped when ``compute_f1=False``);
    ``y_err`` is the embedded error estimate (None without ``b_err``);
    ``ks`` is the list of stage derivatives.
    """
    ks = [f0]
    for i in range(1, len(tab.b)):
        ti = t0 + float(tab.c[i]) * dt
        ks.append(func(ti, _combine(y0, dt, tab.a[i, :i], ks)))
    y1 = _combine(y0, dt, tab.b, ks)
    if tab.fsal:
        f1 = ks[-1]
    elif compute_f1:
        f1 = func(t0 + dt, y1)
    else:
        f1 = None
    y_err = None
    if tab.b_err is not None:
        y_err = _combine(torch.zeros_like(y0), dt, tab.b_err, ks)
    return y1, f1, y_err, ks
