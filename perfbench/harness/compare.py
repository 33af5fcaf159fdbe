"""The comparison that decides ``correct`` for a training cell.

Three numbers, each a gap between the program's reading and the
reference's, and each held to a limit of its own (the cell's file):

  loss     the largest relative gap of the first steps' losses
  grad1    the first gradient as Adam took it (worked out from Adam's first
           moment after one step, ``m / (1 - beta1)``): over the leaves, the
           largest gap between the program's norm and the reference's, over
           the larger of the reference's norm of that leaf and of the median
           leaf
  change   the same of each leaf's change over the first steps

Leaves whose first reference gradient is under a thousandth of the median
leaf's are left out of ``change``: Adam moves them by rounding alone.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["worst_leaf_gap", "gaps", "judge", "TINY_GRAD"]

TINY_GRAD = 1e-3


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.to(torch.float64))) for k, v in leaves.items()}


def worst_leaf_gap(prog: dict, ref: dict, keys=None):
    """``(gap, leaf)``: the largest ``|‖prog‖ − ‖ref‖| / max(‖ref‖, median ‖ref‖)``."""
    keys = list(ref) if keys is None else list(keys)
    pn, rn = _norms({k: prog[k] for k in keys}), _norms({k: ref[k] for k in keys})
    med = float(np.median(list(_norms(ref).values())))
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-300) for k in keys}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def gaps(prog: dict, ref: dict, params0: dict) -> dict:
    """The three numbers of ``prog`` against ``ref``: each a dict with
    ``losses``, ``first_grad`` and ``params`` (after the steps)."""
    lp, lr = np.asarray(prog["losses"], np.float64), np.asarray(ref["losses"], np.float64)
    if lp.shape != lr.shape or not np.all(np.isfinite(lp)):
        loss = float("inf")
    else:
        loss = float(np.max(np.abs(lp - lr) / np.abs(lr)))
    grad1, grad1_leaf = worst_leaf_gap(prog["first_grad"], ref["first_grad"])
    gn = _norms(ref["first_grad"])
    med = float(np.median(list(gn.values())))
    moved = [k for k in gn if gn[k] >= TINY_GRAD * med]
    d_prog = {k: prog["params"][k].double() - params0[k].double() for k in moved}
    d_ref = {k: ref["params"][k].double() - params0[k].double() for k in moved}
    change, change_leaf = worst_leaf_gap(d_prog, d_ref)
    return dict(loss=loss, grad1=grad1, change=change, grad1_leaf=grad1_leaf,
                change_leaf=change_leaf, left_out=sorted(set(gn) - set(moved)))


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: correct when every number
    is finite and at most its limit."""
    checks = {k: dict(value=float(numbers[k]), limit=float(limits[k])) for k in limits}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
