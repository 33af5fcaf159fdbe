"""Sanitizers: index checks on the kernels' metadata and numeric checks on
solves.

Counterpart of ``graph_odenet_tpu/utils/sanitize.py``:

  * ``validate_tiling`` checks, on the host, the invariants of a
    ``CSRGraph`` or ``CSRView`` that the CUDA kernels' index arithmetic
    relies on.  On the card a broken invariant is an illegal address or a
    wrong sum inside a kernel, not an exception, so ``prepare`` and
    ``csr_view`` run it on every view they build (O(E) numpy, once a view).
  * ``odeint_checked`` is ``ode.odeint`` with explicit checks that the
    solution is finite and, for the adaptive methods, that every output
    time was reached, raising ``RuntimeError`` with JAX's two messages.

JAX's ``checkify_tiling`` (the same checks as ``checkify`` checks inside a
jitted program) has no counterpart: the port's views are built on the host,
where ``validate_tiling`` reads them.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["validate_tiling", "odeint_checked"]

_NON_FINITE = "odeint produced non-finite state (NaN/Inf in dynamics?)"
_EXHAUSTED = ("adaptive solver exhausted its step budget before reaching the requested time "
              "— increase max_steps or loosen tolerances")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.int64)


def _check_ptr(tag, ptr, n_rows, n_edge):
    if ptr.shape != (n_rows + 1,):
        raise ValueError(f"{tag} row_ptr has {ptr.shape[0]} entries, not {n_rows + 1}")
    if ptr[0] != 0 or ptr[-1] != n_edge or np.any(np.diff(ptr) < 0):
        raise ValueError(f"{tag} row_ptr must rise monotonically from 0 to {n_edge}")


def _check_range(tag, idx, n_edge, hi):
    if idx.shape != (n_edge,):
        raise ValueError(f"{tag} has {idx.shape[0]} entries, not {n_edge}")
    if idx.size and (idx.min() < 0 or idx.max() >= hi):
        raise ValueError(f"{tag} out of [0, {hi}): [{idx.min()}, {idx.max()}]")


def _check_partition(tag, part, ptr, n_edge):
    from graph_odenet_tpu_torch.ops.csr_spmm import SEG_EDGES

    seg_ptr, seg_row, seg_slot = _np(part.seg_ptr), _np(part.seg_row), _np(part.seg_slot)
    split_row, split_ptr = _np(part.split_row), _np(part.split_ptr)
    slot_split, empty_row = _np(part.slot_split), _np(part.empty_row)
    n_rows, n_seg, n_split, n_slots = ptr.shape[0] - 1, seg_row.shape[0], split_row.shape[0], \
        part.n_slots
    if seg_ptr.shape != (n_seg + 1,) or seg_slot.shape != (n_seg,):
        raise ValueError(f"{tag} seg_ptr, seg_row and seg_slot disagree on the segment count")
    if seg_ptr[0] != 0 or seg_ptr[-1] != n_edge or np.any(np.diff(seg_ptr) < 0):
        raise ValueError(f"{tag} seg_ptr must tile the {n_edge} edges in order")
    if np.any(np.diff(seg_ptr) > SEG_EDGES):
        raise ValueError(f"{tag} a segment holds more than SEG_EDGES={SEG_EDGES} edges")
    _check_range(f"{tag} seg_row", seg_row, n_seg, n_rows)
    _check_range(f"{tag} empty_row", empty_row, empty_row.shape[0], n_rows)
    if np.any(seg_ptr[:-1] < ptr[seg_row]) or np.any(seg_ptr[1:] > ptr[seg_row + 1]):
        raise ValueError(f"{tag} a segment reaches outside its seg_row's span")
    if split_ptr.shape != (n_split + 1,) or split_ptr[0] != 0 or split_ptr[-1] != n_slots \
            or np.any(np.diff(split_ptr) < 0):
        raise ValueError(f"{tag} split_ptr must rise monotonically from 0 to n_slots={n_slots}")
    _check_range(f"{tag} split_row", split_row, n_split, n_rows)
    want = np.repeat(np.arange(n_split), np.diff(split_ptr))
    if slot_split.shape != (n_slots,) or np.any(slot_split != want):
        raise ValueError(f"{tag} slot_split disagrees with split_ptr")
    split = seg_slot >= 0
    slots, whole = seg_slot[split], seg_row[~split]
    _check_range(f"{tag} seg_slot", slots, slots.shape[0], n_slots)
    if np.unique(slots).shape[0] != n_slots or slots.shape[0] != n_slots \
            or np.any(split_row[slot_split[slots]] != seg_row[split]):
        raise ValueError(f"{tag} seg_slot must give each split segment a slot of its own row")
    if np.unique(whole).shape[0] != whole.shape[0] or np.isin(whole, split_row).any():
        raise ValueError(f"{tag} a row written whole (seg_slot -1) must have one segment")


def validate_tiling(csr) -> None:
    """Host-side checks of a ``CSRGraph`` (both views) or a ``CSRView``.

    Raises ``ValueError`` on the first broken invariant: row pointers that do
    not rise from 0 to the edge count; a gathered column (``senders``,
    ``t_receivers``, a view's ``col``) outside its table; ``t_perm`` not a
    permutation of the edges; warp segments that do not tile the edges in
    order, exceed ``SEG_EDGES``, leave their row's span, or whose split
    slots disagree with ``n_slots``.
    """
    from graph_odenet_tpu_torch.ops.csr_spmm import CSRGraph

    if isinstance(csr, CSRGraph):
        n, e = csr.n_node_pad, csr.n_edge
        for tag, ptr, col, w, part in (
            ("csr", csr.row_ptr, csr.senders, csr.weight, csr.part),
            ("csc", csr.t_row_ptr, csr.t_receivers, csr.t_weight, csr.t_part),
        ):
            ptr = _np(ptr)
            _check_ptr(tag, ptr, n, e)
            _check_range("senders" if tag == "csr" else "t_receivers", _np(col), e, n)
            if w.shape != (e,):
                raise ValueError(f"{tag} weight has {w.shape[0]} entries, not {e}")
            _check_partition(tag, part, ptr, e)
        _check_range("receivers", _np(csr.receivers), e, n)
        t_perm = _np(csr.t_perm)
        if t_perm.shape != (e,) or np.any(np.sort(t_perm) != np.arange(e)):
            raise ValueError(f"t_perm is not a permutation of [0, {e})")
        return
    ptr, e = _np(csr.row_ptr), csr.n_edge
    _check_ptr("view", ptr, csr.n_rows, e)
    _check_range("view col", _np(csr.col), e, csr.n_cols)
    if csr.weight.shape != (e,):
        raise ValueError(f"view weight has {csr.weight.shape[0]} entries, not {e}")
    _check_partition("view", csr.part, ptr, e)


def odeint_checked(func, y0, ts, *args, throw: bool = True, **kw):
    """``ode.odeint`` with numeric checks: every output state finite and, for
    the adaptive methods, every output time reached (``stats["success"]``).

    ``throw=True`` raises ``RuntimeError`` on the first failed check and
    returns ``(ys, stats)``; ``throw=False`` returns ``(err, (ys, stats))``
    with ``err`` the ``RuntimeError`` or None.
    """
    from graph_odenet_tpu_torch.ode import odeint

    ys, stats = odeint(func, y0, ts, *args, return_stats=True, **kw)
    err = None
    if not bool(torch.isfinite(ys).all()):
        err = RuntimeError(_NON_FINITE)
    elif "success" in stats and not bool(torch.as_tensor(stats["success"]).all()):
        err = RuntimeError(_EXHAUSTED)
    if throw:
        if err is not None:
            raise err
        return ys, stats
    return err, (ys, stats)
