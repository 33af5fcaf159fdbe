"""Segmented aggregation primitives (plain PyTorch).

Counterpart of ``graph_odenet_tpu/ops/segment.py``: the semantic ground truth
for the sparse ops.  ``spmm(adj, x)`` is exactly
``segment_sum(w * gather(x, senders), receivers)`` over a receiver-sorted
edge list.
"""

from __future__ import annotations

import torch

__all__ = ["gather", "segment_sum"]


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``x[idx]``: the per-edge view of node features."""
    return x.index_select(0, idx)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum the rows of ``data`` into ``num_segments`` buckets."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)
