"""Graph container and adjacency normalisation.

Counterpart of ``graph_odenet_tpu/graph.py``.  A ``Graph`` holds COO edges
sorted by receiver as int32/f32 tensors, padded to tile multiples, with the
real sizes as plain ints.  Padding edges carry sender 0, receiver
``n_node_pad - 1`` and weight 0, so linear aggregation needs no mask and the
receivers stay non-decreasing over the whole array.

Host preprocessing (symmetrise, deduplicate, self-loops, normalise, sort)
is numpy, the same pipeline as the JAX package's portable path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["Graph", "from_edges", "pad_graph", "normalize_graph", "to_dense"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Graph:
    """Static-shape COO graph, edges sorted by receiver.

    Attributes:
      senders:    int32[E_pad] source node of each directed edge.
      receivers:  int32[E_pad] destination node (non-decreasing; padding
                  edges point at ``n_node_pad - 1`` with weight 0).
      weight:     f32[E_pad] normalised adjacency value (0 on padding).
      n_node:     number of real nodes.
      n_edge:     number of real edges.
      n_node_pad: padded node count that node arrays are sized to.
    """

    senders: torch.Tensor
    receivers: torch.Tensor
    weight: torch.Tensor
    n_node: int
    n_edge: int
    n_node_pad: int

    @property
    def n_edge_pad(self) -> int:
        return self.senders.shape[0]

    @property
    def device(self) -> torch.device:
        return self.senders.device

    def to(self, device) -> "Graph":
        return dataclasses.replace(
            self,
            senders=self.senders.to(device),
            receivers=self.receivers.to(device),
            weight=self.weight.to(device),
        )

    def edge_mask(self) -> torch.Tensor:
        """bool[E_pad], True on real edges."""
        return torch.arange(self.n_edge_pad, device=self.device) < self.n_edge

    def node_mask(self) -> torch.Tensor:
        """bool[n_node_pad], True on real nodes."""
        return torch.arange(self.n_node_pad, device=self.device) < self.n_node

    def in_degree(self) -> torch.Tensor:
        """f32[n_node_pad] number of incoming real edges per node."""
        ones = self.edge_mask().to(torch.float32)
        out = torch.zeros(self.n_node_pad, dtype=torch.float32, device=self.device)
        return out.index_add_(0, self.receivers, ones)


def from_edges(
    senders,
    receivers,
    n_node: int,
    *,
    weight=None,
    add_self_loops: bool = True,
    symmetrize: bool = True,
    normalize: Optional[str] = "row",
    node_multiple: int = 128,
    edge_multiple: int = 1024,
) -> Graph:
    """Build a canonical Graph from raw COO edges (host-side, numpy).

    Args:
      normalize: "row" (``D^-1(A+I)``), "sym" (``D^-1/2(A+I)D^-1/2``) or
        None.
    """
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    if weight is None:
        weight = np.ones_like(senders, dtype=np.float64)
    weight = np.asarray(weight, dtype=np.float64)

    if symmetrize:
        senders, receivers = (
            np.concatenate([senders, receivers]),
            np.concatenate([receivers, senders]),
        )
        weight = np.concatenate([weight, weight])

    # Deduplicate: repeated or already-symmetric edges must not double
    # weights (the adjacency is binary).
    key = senders * n_node + receivers
    key, idx = np.unique(key, return_index=True)
    senders, receivers, weight = senders[idx], receivers[idx], weight[idx]

    if add_self_loops:
        loop = np.arange(n_node, dtype=np.int64)
        has_loop = np.isin(loop, senders[senders == receivers])
        new = loop[~has_loop]
        senders = np.concatenate([senders, new])
        receivers = np.concatenate([receivers, new])
        weight = np.concatenate([weight, np.ones_like(new, dtype=np.float64)])

    if normalize is not None:
        deg = np.zeros(n_node, dtype=np.float64)
        np.add.at(deg, receivers, weight)
        if normalize == "row":
            inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-30), 0.0)
            weight = weight * inv[receivers]
        elif normalize == "sym":
            inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-30)), 0.0)
            weight = weight * inv_sqrt[receivers] * inv_sqrt[senders]
        else:
            raise ValueError(f"unknown normalize={normalize!r}")

    # CSR order: sort by (receiver, sender).
    order = np.lexsort((senders, receivers))
    senders, receivers, weight = senders[order], receivers[order], weight[order]
    return _pack_graph(senders, receivers, weight, n_node, node_multiple, edge_multiple)


def _pack_graph(senders, receivers, weight, n_node, node_multiple, edge_multiple):
    """Pad (receiver, sender)-sorted COO arrays into a static-shape Graph."""
    n_edge = senders.shape[0]
    e_pad = _round_up(max(n_edge, 1), edge_multiple)
    n_pad = _round_up(max(n_node, 1), node_multiple)
    pad = e_pad - n_edge
    senders = np.concatenate([senders, np.zeros(pad, dtype=np.int64)])
    receivers = np.concatenate([receivers, np.full(pad, n_pad - 1, dtype=np.int64)])
    weight = np.concatenate([weight, np.zeros(pad, dtype=np.float64)])
    return Graph(
        senders=torch.from_numpy(senders.astype(np.int32)),
        receivers=torch.from_numpy(receivers.astype(np.int32)),
        weight=torch.from_numpy(weight.astype(np.float32)),
        n_node=int(n_node),
        n_edge=int(n_edge),
        n_node_pad=int(n_pad),
    )


def pad_graph(g: Graph, *, node_multiple: int = 128, edge_multiple: int = 1024) -> Graph:
    """Re-pad an existing Graph to (possibly larger) tile multiples."""
    n_pad = _round_up(g.n_node_pad, node_multiple)
    de = _round_up(g.n_edge_pad, edge_multiple) - g.n_edge_pad
    pad = torch.nn.functional.pad
    return Graph(
        senders=pad(g.senders, (0, de)),
        receivers=pad(g.receivers, (0, de), value=n_pad - 1),
        weight=pad(g.weight, (0, de)),
        n_node=g.n_node,
        n_edge=g.n_edge,
        n_node_pad=n_pad,
    )


def normalize_graph(g: Graph, kind: str = "row") -> Graph:
    """Re-normalise the edge weights on the graph's device."""
    mask = g.edge_mask()
    w = torch.where(mask, g.weight, 0.0)
    deg = torch.zeros(g.n_node_pad, dtype=w.dtype, device=w.device)
    deg.index_add_(0, g.receivers, w)
    if kind == "row":
        inv = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1e-30), 0.0)
        w = w * inv[g.receivers]
    elif kind == "sym":
        inv_sqrt = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-30)), 0.0)
        w = w * inv_sqrt[g.receivers] * inv_sqrt[g.senders]
    else:
        raise ValueError(f"unknown kind={kind!r}")
    return dataclasses.replace(g, weight=torch.where(mask, w, 0.0))


def to_dense(g: Graph) -> torch.Tensor:
    """Dense normalised adjacency f32[n_node_pad, n_node_pad], row = receiver.

    Padding rows and columns are zero.
    """
    w = torch.where(g.edge_mask(), g.weight, 0.0)
    a = torch.zeros((g.n_node_pad, g.n_node_pad), dtype=w.dtype, device=w.device)
    return a.index_put_((g.receivers.long(), g.senders.long()), w, accumulate=True)
