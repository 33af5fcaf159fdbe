"""Edge partitioning by receiver block, bucketed by sender block.

Counterpart of ``graph_odenet_tpu/parallel/partition.py``.  For P parts and
node-block size B = n_node_pad / P, bucket ``[p, b]`` holds the edges that
block p receives from senders in block b, so rank p writes only its own
rows and reads remote sender features one block at a time (the halo).

``partition_by_receiver`` gives each bucket two ``CSRView``s for the CSR
kernel's bucket mode, built from the bucket's real edges only:

  fwd  rows = local receivers, gathered column = local sender
  bwd  rows = local senders,   gathered column = local receiver (the CSC view)

and the permutation between their edge orders (``t_perm``), and each receiver
block its edges' global sender and local receiver ids (``BlockEdges``), for
the sharded GAT's per-edge softmax and dropout hash.

It leaves out the JAX package's padded ``[P, P, E_b]`` arrays, which only
the TPU kernel reads, and their tile layout (``tile_rel``,
``tile_blk_ptr``, ``t_tile_*``).  ``padded_buckets`` rebuilds the padded
arrays from the views, byte for byte, for comparison with the JAX package;
no device path reads them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from graph_odenet_tpu_torch.graph import Graph
from graph_odenet_tpu_torch.ops.csr_spmm import CSRView, csr_view

__all__ = ["Bucket", "BlockEdges", "PartitionedGraph", "PaddedBuckets", "partition_by_receiver", "padded_buckets"]


def _round_up(x, m):
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Bucket:
    """The CSR and CSC views of bucket ``[p, b]``, both ``B × B``, and
    ``t_perm`` (int64 ``[L]``): the CSR position of each CSC position, which
    carries per-edge data such as attention numerators into CSC order."""

    fwd: CSRView
    bwd: CSRView
    t_perm: torch.Tensor

    def to(self, device) -> "Bucket":
        return Bucket(self.fwd.to(device), self.bwd.to(device), self.t_perm.to(device))


@dataclasses.dataclass(frozen=True)
class BlockEdges:
    """Every edge of receiver block ``p``, its buckets ``[p, 0] … [p, P-1]``
    one after the other, each in its CSR order: what a per-edge pass over the
    block's edges (the sharded GAT's softmax, its dropout hash) indexes with.

      senders    int64[E_p]  global sender id
      receivers  int64[E_p]  receiver − p·B
      offsets    P + 1 ints  bucket ``b`` is ``[offsets[b], offsets[b + 1])``
    """

    senders: torch.Tensor
    receivers: torch.Tensor
    offsets: tuple

    def to(self, device) -> "BlockEdges":
        return BlockEdges(self.senders.to(device), self.receivers.to(device), self.offsets)

    def bucket(self, b: int) -> slice:
        return slice(self.offsets[b], self.offsets[b + 1])


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Edges grouped by (receiver block, sender block).

    ``bucket_edges [P, P]`` (host) counts each bucket's real edges,
    ``buckets[p][b]`` holds its views and ``blocks[p]`` the per-edge ids of
    receiver block ``p``; ``to`` moves both to a device.
    """

    bucket_edges: torch.Tensor
    buckets: tuple
    blocks: tuple
    block_size: int
    n_parts: int
    n_node_pad: int
    n_edge: int

    def bucket(self, p: int, b: int) -> Bucket:
        return self.buckets[p][b]

    def to(self, device) -> "PartitionedGraph":
        return dataclasses.replace(
            self, buckets=tuple(tuple(bk.to(device) for bk in row) for row in self.buckets),
            blocks=tuple(blk.to(device) for blk in self.blocks),
        )


def partition_by_receiver(g: Graph, n_parts: int) -> PartitionedGraph:
    """Split a Graph into P receiver blocks × P sender buckets (host-side).

    Raises ``ValueError`` unless ``n_parts`` divides ``g.n_node_pad``.
    """
    if g.n_node_pad % n_parts:
        raise ValueError(
            f"n_node_pad={g.n_node_pad} not divisible by n_parts={n_parts}; "
            "re-pad the graph (pad_graph with node_multiple=n_parts*k)"
        )
    B = g.n_node_pad // n_parts
    s = g.senders[: g.n_edge].cpu().numpy()
    r = g.receivers[: g.n_edge].cpu().numpy()
    w = g.weight[: g.n_edge].cpu().numpy()
    rb, sb = r // B, s // B

    bucket_edges = np.zeros((n_parts, n_parts), dtype=np.int64)
    views = [[None] * n_parts for _ in range(n_parts)]
    blocks = []
    for p in range(n_parts):
        senders, receivers = [], []
        for b in range(n_parts):
            sel = (rb == p) & (sb == b)
            rp = r[sel] - p * B
            order = np.argsort(rp, kind="stable")
            sp, rp, wp = (s[sel] - b * B)[order], rp[order], w[sel][order]
            bucket_edges[p, b] = len(sp)
            t_order = np.argsort(sp, kind="stable")  # CSC view: sorted by local sender
            views[p][b] = Bucket(
                fwd=csr_view(rp, sp, wp, B, B),
                bwd=csr_view(sp[t_order], rp[t_order], wp[t_order], B, B),
                t_perm=torch.from_numpy(t_order.astype(np.int64)),
            )
            senders.append(sp.astype(np.int64) + b * B)
            receivers.append(rp.astype(np.int64))
        blocks.append(BlockEdges(
            senders=torch.from_numpy(np.concatenate(senders)),
            receivers=torch.from_numpy(np.concatenate(receivers)),
            offsets=tuple(int(v) for v in np.r_[0, np.cumsum(bucket_edges[p])]),
        ))
    return PartitionedGraph(
        bucket_edges=torch.from_numpy(bucket_edges),
        buckets=tuple(tuple(row) for row in views), blocks=tuple(blocks),
        block_size=B, n_parts=n_parts, n_node_pad=g.n_node_pad, n_edge=g.n_edge,
    )


@dataclasses.dataclass(frozen=True)
class PaddedBuckets:
    """The JAX package's ``[P, P, E_b]`` host arrays of a partition:

      senders_rel      i32  sender − b·B (padding slots → 0)
      receivers_rel    i32  receiver − p·B
      weight           f32  0 on padding slots
      t_senders_rel    i32  the same edges sorted by local sender (CSC order)
      t_receivers_rel  i32
      t_weight         f32
      t_perm           i32  CSC position → CSR position; padding → itself

    Each bucket's L real edges come first, its padding slots after them.
    """

    senders_rel: torch.Tensor
    receivers_rel: torch.Tensor
    weight: torch.Tensor
    t_senders_rel: torch.Tensor
    t_receivers_rel: torch.Tensor
    t_weight: torch.Tensor
    t_perm: torch.Tensor
    block_size: int

    @property
    def e_bucket(self) -> int:
        return self.senders_rel.shape[2]

    def senders_global(self) -> torch.Tensor:
        """i32[P, P, E_b] global sender ids."""
        offs = torch.arange(self.senders_rel.shape[0], dtype=torch.int32) * self.block_size
        return self.senders_rel + offs[None, :, None]


def _rows(view: CSRView) -> np.ndarray:
    row_ptr = view.row_ptr.cpu().numpy()
    return np.repeat(np.arange(len(row_ptr) - 1), np.diff(row_ptr))


def padded_buckets(pg: PartitionedGraph, *, edge_multiple: int = 1024) -> PaddedBuckets:
    """The JAX layout of ``pg``: every bucket padded to the largest one
    rounded up to ``edge_multiple`` (host-side, numpy)."""
    P = pg.n_parts
    e_bucket = _round_up(max(1, int(pg.bucket_edges.max())), edge_multiple)
    shape = (P, P, e_bucket)
    arrays = {k: np.zeros(shape, dtype=np.float32 if "weight" in k else np.int32) for k in (
        "senders_rel", "receivers_rel", "weight", "t_senders_rel", "t_receivers_rel", "t_weight")}
    t_perm = np.tile(np.arange(e_bucket, dtype=np.int32), (P, P, 1))
    for p in range(P):
        for b in range(P):
            fwd, bwd = pg.bucket(p, b).fwd, pg.bucket(p, b).bwd
            L = fwd.n_edge
            cols = fwd.col.cpu().numpy()
            for name, v in (("receivers_rel", _rows(fwd)), ("senders_rel", cols),
                            ("weight", fwd.weight.cpu().numpy()),
                            ("t_senders_rel", _rows(bwd)),
                            ("t_receivers_rel", bwd.col.cpu().numpy()),
                            ("t_weight", bwd.weight.cpu().numpy())):
                arrays[name][p, b, :L] = v
            t_perm[p, b, :L] = pg.bucket(p, b).t_perm.cpu().numpy()
    return PaddedBuckets(
        **{k: torch.from_numpy(v) for k, v in arrays.items()},
        t_perm=torch.from_numpy(t_perm), block_size=pg.block_size,
    )
