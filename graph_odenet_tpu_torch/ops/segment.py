"""Segmented aggregation primitives (plain PyTorch).

Counterpart of ``graph_odenet_tpu/ops/segment.py``: the semantic ground truth
for the sparse ops.  ``spmm(adj, x)`` is exactly
``segment_sum(w * gather(x, senders), receivers)`` over a receiver-sorted
edge list, and the attention softmax is ``segment_softmax``.
"""

from __future__ import annotations

import torch

__all__ = ["gather", "segment_sum", "segment_softmax"]


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``x[idx]``: the per-edge view of node features."""
    return x.index_select(0, idx)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum the rows of ``data`` into ``num_segments`` buckets."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def segment_softmax(
    logits: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Softmax of ``logits [E, ...]`` over the edges of each segment.

    ``mask`` (broadcast against ``logits``) marks the real edges: masked
    edges get probability 0.  An empty segment's max is taken as 0.  The
    max only shifts the exponent, so it is taken without gradient.
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
