"""Butcher tableaus and the generic explicit Runge-Kutta step.

Counterpart of ``graph_odenet_tpu/ode/tableaus.py``: the fixed-grid euler,
midpoint, heun2, heun3, classic RK4 and Kutta's 3/8 rule (what torchdiffeq's
``rk4`` runs), and the embedded adaptive pairs HEUN12, FEHLBERG2, BOSH3,
DOPRI5 and DOPRI8 with their error weights ``b_err = b − b*`` and, where
published or fitted, the dense-output midpoint weights ``c_mid``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

__all__ = [
    "Tableau", "EULER", "MIDPOINT", "HEUN2", "HEUN3", "RK4", "RK4_38",
    "HEUN12", "FEHLBERG2", "BOSH3", "DOPRI5", "DOPRI8", "rk_step",
]


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


# Heun–Euler 2(1) — torchdiffeq's ``adaptive_heun``.
HEUN12 = _tab(
    [[1.0]],
    b=[0.5, 0.5],
    c=[0.0, 1.0],
    b_err=[-0.5, 0.5],   # b − b*  with  b* = [1, 0]  (embedded Euler)
    order=2,
)

# Fehlberg RK1(2) — torchdiffeq's ``fehlberg2`` (2nd order with embedded 1st).
FEHLBERG2 = _tab(
    [[1 / 2], [1 / 256, 255 / 256]],
    b=[1 / 512, 255 / 256, 1 / 512],
    c=[0.0, 1 / 2, 1.0],
    b_err=[-1 / 512, 0.0, 1 / 512],   # b − b*  with  b* = [1/256, 255/256, 0]
    order=2,
)

# Bogacki–Shampine 3(2), FSAL — torchdiffeq's ``bosh3``.
BOSH3 = _tab(
    [[1 / 2], [0.0, 3 / 4], [2 / 9, 1 / 3, 4 / 9]],
    b=[2 / 9, 1 / 3, 4 / 9, 0.0],
    c=[0.0, 1 / 2, 3 / 4, 1.0],
    b_err=[-5 / 72, 1 / 12, 1 / 9, -1 / 8],   # b − [7/24, 1/4, 1/3, 1/8]
    order=3,
    fsal=True,
)

# Dormand–Prince 5(4), FSAL.  b_err = b − b* (5th-order minus embedded
# 4th-order weights); c_mid gives the 4th-order-accurate midpoint used to fit
# the dense-output quartic (same scheme torchdiffeq/jax.experimental.ode use).
DOPRI5 = _tab(
    [
        [1 / 5],
        [3 / 40, 9 / 40],
        [44 / 45, -56 / 15, 32 / 9],
        [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
        [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
        [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
    ],
    b=[35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0],
    c=[0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0],
    b_err=[
        71 / 57600,
        0.0,
        -71 / 16695,
        71 / 1920,
        -17253 / 339200,
        22 / 525,
        -1 / 40,
    ],
    c_mid=[
        6025192743 / 30085553152 / 2,
        0.0,
        51252292925 / 65400821598 / 2,
        -2691868925 / 45128329728 / 2,
        187940372067 / 1594534317056 / 2,
        -1776094331 / 19743644256 / 2,
        11237099 / 235043384 / 2,
    ],
    order=5,
    fsal=True,
)


# Prince–Dormand RK8(7)13M — torchdiffeq's ``dopri8``.  13 stages, 8th-order
# solution with embedded 7th-order error estimate (Prince & Dormand 1981;
# the same rational coefficients GSL ships as ``rk8pd``).  Not FSAL.
#
# Coefficient provenance: re-verified in-repo by tests/test_ode.py —
# row-sums Σ_j a_ij = c_i and quadrature conditions Σ_i b_i c_i^{k-1} = 1/k
# hold to ~1e-18 for k ≤ 8 (b) and k ≤ 7 (b*), and the empirical global
# convergence order on a nonlinear problem measures ≈ 8.
_D8 = dict(
    c=[
        0.0, 1 / 18, 1 / 12, 1 / 8, 5 / 16, 3 / 8, 59 / 400, 93 / 200,
        5490023248 / 9719169821, 13 / 20, 1201146811 / 1299019798, 1.0, 1.0,
    ],
    a=[
        [1 / 18],
        [1 / 48, 1 / 16],
        [1 / 32, 0.0, 3 / 32],
        [5 / 16, 0.0, -75 / 64, 75 / 64],
        [3 / 80, 0.0, 0.0, 3 / 16, 3 / 20],
        [29443841 / 614563906, 0.0, 0.0, 77736538 / 692538347,
         -28693883 / 1125000000, 23124283 / 1800000000],
        [16016141 / 946692911, 0.0, 0.0, 61564180 / 158732637,
         22789713 / 633445777, 545815736 / 2771057229, -180193667 / 1043307555],
        [39632708 / 573591083, 0.0, 0.0, -433636366 / 683701615,
         -421739975 / 2616292301, 100302831 / 723423059, 790204164 / 839813087,
         800635310 / 3783071287],
        [246121993 / 1340847787, 0.0, 0.0, -37695042795 / 15268766246,
         -309121744 / 1061227803, -12992083 / 490766935, 6005943493 / 2108947869,
         393006217 / 1396673457, 123872331 / 1001029789],
        [-1028468189 / 846180014, 0.0, 0.0, 8478235783 / 508512852,
         1311729495 / 1432422823, -10304129995 / 1701304382,
         -48777925059 / 3047939560, 15336726248 / 1032824649,
         -45442868181 / 3398467696, 3065993473 / 597172653],
        [185892177 / 718116043, 0.0, 0.0, -3185094517 / 667107341,
         -477755414 / 1098053517, -703635378 / 230739211, 5731566787 / 1027545527,
         5232866602 / 850066563, -4093664535 / 808688257, 3962137247 / 1805957418,
         65686358 / 487910083],
        [403863854 / 491063109, 0.0, 0.0, -5068492393 / 434740067,
         -411421997 / 543043805, 652783627 / 914296604, 11173962825 / 925320556,
         -13158990841 / 6184727034, 3936647629 / 1978049680,
         -160528059 / 685178525, 248638103 / 1413531060, 0.0],
    ],
    b=[
        14005451 / 335480064, 0.0, 0.0, 0.0, 0.0, -59238493 / 1068277825,
        181606767 / 758867731, 561292985 / 797845732, -1041891430 / 1371343529,
        760417239 / 1151165299, 118820643 / 751138087, -528747749 / 2220607170,
        1 / 4,
    ],
    b_hat=[
        13451932 / 455176623, 0.0, 0.0, 0.0, 0.0, -808719846 / 976000145,
        1757004468 / 5645159321, 656045339 / 265891186, -3867574721 / 1518517206,
        465885868 / 322736535, 53011238 / 667516719, 2 / 45, 0.0,
    ],
    # Dense-output midpoint weights: min-norm solution of the continuous-
    # extension order conditions at θ = 1/2 through order 5 (all 17 rooted-
    # tree conditions; lstsq residual ≤ 2e-16), restricted to the stages the
    # solution weights use.  Gives an O(h^6)-accurate y_mid for the dense-
    # output quartic — comfortably above the interpolant's own order.
    c_mid=[
        0.04074193371540536, 0.0, 0.0, 0.0, 0.0,
        0.14571307319487856, 0.2349738958592367, 0.07726659760202743,
        0.015751445954632848, -0.015192367697817857,
        -2.8536293812150244e-05, 0.00038697883272780013,
        0.00038697883272141635,
    ],
)

DOPRI8 = _tab(
    _D8["a"],
    b=_D8["b"],
    c=_D8["c"],
    b_err=list(np.asarray(_D8["b"]) - np.asarray(_D8["b_hat"])),
    c_mid=_D8["c_mid"],
    order=8,
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
