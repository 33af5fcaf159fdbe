"""Segmented aggregation primitives (plain PyTorch).

Counterpart of ``graph_odenet_tpu/ops/segment.py``: the semantic ground truth
for the sparse ops.  ``spmm(adj, x)`` is exactly
``segment_sum(w * gather(x, senders), receivers)`` over a receiver-sorted
edge list, and the attention softmax is ``segment_softmax``.

Every segment op takes JAX's ``sorted_ids`` keyword and ignores it: it
only lets XLA pick a cheaper lowering for receiver-sorted ids, and
``index_add_`` and ``scatter_reduce`` need no such hint.
"""

from __future__ import annotations

import torch

__all__ = ["gather", "segment_sum", "segment_mean", "segment_max", "segment_softmax"]


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``x[idx]``: the per-edge view of node features."""
    return x.index_select(0, idx)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, *,
                sorted_ids: bool = True) -> torch.Tensor:
    """Sum the rows of ``data`` into ``num_segments`` buckets.  bf16 and f16
    rows are added in f32 and each sum rounded once, as ``index_add_`` does
    on the CPU; on the card it would add them with atomics of their own
    precision, and a hub bucket's sum would stop growing once its ulp
    exceeded the terms.  ``sorted_ids`` is accepted and ignored (see the
    module doc)."""
    wide = data.float() if data.dtype in (torch.bfloat16, torch.float16) else data
    out = wide.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, wide).to(data.dtype)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, *,
                 sorted_ids: bool = True) -> torch.Tensor:
    """Mean of the rows of ``data`` in each bucket; an empty bucket gives 0.
    ``sorted_ids`` is accepted and ignored."""
    total = segment_sum(data, segment_ids, num_segments)
    count = segment_sum(data.new_ones(data.shape[:1]), segment_ids, num_segments)
    return total / count.clamp_min(1.0).view((-1,) + (1,) * (data.dim() - 1))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, *,
                sorted_ids: bool = True) -> torch.Tensor:
    """Maximum of the rows of ``data`` in each bucket.  An empty bucket gives
    the dtype's lowest value (``-inf`` for floats), as ``jax.ops.segment_max``
    does: the buckets start there, not at 0.  ``sorted_ids`` is accepted and
    ignored."""
    lowest = -torch.inf if data.is_floating_point() else torch.iinfo(data.dtype).min
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), lowest)
    idx = segment_ids.long().view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, idx, data, "amax")


def segment_softmax(
    logits: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
    sorted_ids: bool = True,
) -> torch.Tensor:
    """Softmax of ``logits [E, ...]`` over the edges of each segment.

    ``mask`` (broadcast against ``logits``) marks the real edges: masked
    edges get probability 0.  An empty segment's max is taken as 0.  The
    max only shifts the exponent, so it is taken without gradient.
    ``sorted_ids`` is accepted and ignored.
    """
    if mask is not None:
        logits = torch.where(mask, logits, -torch.inf)
    idx = segment_ids.long().view((-1,) + (1,) * (logits.dim() - 1)).expand_as(logits)
    with torch.no_grad():
        seg_max = logits.new_full((num_segments,) + tuple(logits.shape[1:]), -torch.inf)
        seg_max = seg_max.scatter_reduce(0, idx, logits, "amax")
        seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    shifted = logits - seg_max.index_select(0, segment_ids)
    exp = torch.where(torch.isfinite(shifted), torch.exp(shifted), 0.0)
    denom = segment_sum(exp, segment_ids, num_segments).clamp_min(1e-30)
    return exp / denom.index_select(0, segment_ids)
