"""CSR SpMM on Hopper: the counterpart of ``graph_odenet_tpu/ops/pallas_spmm.py``.

``spmm_csr(csr, x)`` computes ``out[r] = sum_p w[p] * x[col[p]]`` over the
row's CSR span, as ``spmm_pallas`` does.  The forward reduces over the
receiver-sorted (CSR) view; the backward ``dx = Âᵀ g`` is the same reduction
over the sender-sorted (CSC) view.  The adjacency gets no gradient.

On a CUDA tensor the reduction is the hand-written kernel in
``csrc/csr_spmm.cu``; on a CPU tensor it is the plain version
``_reduce_plain`` (gather + ``index_add_``).  There is no other path: a CUDA
tensor launches the kernel or raises.

``prepare`` also cuts each view into warp segments of at most
``SEG_EDGES`` edges, so that a hub row with many thousands of edges is
spread over many warps.  A row cut into several segments writes partial
sums to scratch, and a second pass adds them up.  Nothing is atomic, so the
result does not depend on scheduling.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from graph_odenet_tpu_torch.graph import Graph
from graph_odenet_tpu_torch.ops import _build

__all__ = [
    "CSRGraph", "Partition", "prepare", "csr_reduce", "spmm_csr",
    "spmm_csr_reference", "SEG_EDGES",
]

#: Most edges one warp reduces; longer rows are cut into several segments.
SEG_EDGES = 256

#: Number of kernel launches made by ``csr_reduce`` in this process.
launches = 0


@dataclasses.dataclass(frozen=True)
class Partition:
    """Warp segments of one CSR view (built on the host by ``prepare``).

    Segments tile the edge array in order; every row has at least one
    (an edgeless row has one empty segment, which writes zeros).
    """

    seg_ptr: torch.Tensor    # int64[S+1] edge span of each segment
    seg_row: torch.Tensor    # int32[S]   output row of each segment
    seg_slot: torch.Tensor   # int32[S]   -1: whole row, written to out;
                             #            else its row of the partial scratch
    split_row: torch.Tensor  # int32[R]   rows cut into several segments
    split_ptr: torch.Tensor  # int32[R+1] their spans of partial slots
    n_slots: int

    def to(self, device) -> "Partition":
        return dataclasses.replace(
            self, **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self) if f.name != "n_slots"
            },
        )


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Receiver-sorted (CSR) and sender-sorted (CSC) views of a Graph.

    fwd view: rows are receivers, ``senders`` are the gathered columns.
    bwd view: rows are senders, ``t_receivers`` are the gathered columns
              (Âᵀ through the same kernel).  ``t_perm`` maps a CSC
              position to its original edge id.
    Only real edges are stored; padding edges are dropped.
    """

    row_ptr: torch.Tensor      # int64[n_node_pad+1]
    senders: torch.Tensor      # int32[E]
    weight: torch.Tensor       # f32[E]
    t_row_ptr: torch.Tensor    # int64[n_node_pad+1]
    t_receivers: torch.Tensor  # int32[E]
    t_weight: torch.Tensor     # f32[E]
    t_perm: torch.Tensor       # int64[E]
    part: Partition
    t_part: Partition
    n_node_pad: int
    n_edge: int

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    def to(self, device) -> "CSRGraph":
        moved = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if f.name not in ("n_node_pad", "n_edge")
        }
        return dataclasses.replace(self, **moved)

    def view(self, transpose: bool):
        """(row_ptr, col, weight, partition) of the fwd or the bwd view."""
        if transpose:
            return self.t_row_ptr, self.t_receivers, self.t_weight, self.t_part
        return self.row_ptr, self.senders, self.weight, self.part


def _partition(row_ptr: np.ndarray) -> Partition:
    deg = np.diff(row_ptr)
    n_seg = np.maximum(1, -(-deg // SEG_EDGES))
    seg_row = np.repeat(np.arange(len(deg), dtype=np.int64), n_seg)
    first = np.zeros(len(deg) + 1, np.int64)
    np.cumsum(n_seg, out=first[1:])
    k = np.arange(first[-1], dtype=np.int64) - first[seg_row]
    seg_ptr = np.append(row_ptr[seg_row] + k * SEG_EDGES, row_ptr[-1])
    split = n_seg > 1
    is_split_seg = split[seg_row]
    seg_slot = np.full(len(seg_row), -1, np.int64)
    seg_slot[is_split_seg] = np.arange(int(is_split_seg.sum()))
    split_ptr = np.zeros(int(split.sum()) + 1, np.int64)
    np.cumsum(n_seg[split], out=split_ptr[1:])
    return Partition(
        seg_ptr=torch.from_numpy(seg_ptr),
        seg_row=torch.from_numpy(seg_row.astype(np.int32)),
        seg_slot=torch.from_numpy(seg_slot.astype(np.int32)),
        split_row=torch.from_numpy(np.nonzero(split)[0].astype(np.int32)),
        split_ptr=torch.from_numpy(split_ptr.astype(np.int32)),
        n_slots=int(split_ptr[-1]),
    )


def _build_view(dst, src, w, n_pad):
    """Sort edges by dst: (row_ptr, src sorted, w sorted, order)."""
    order = np.argsort(dst, kind="stable")
    row_ptr = np.zeros(n_pad + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n_pad), out=row_ptr[1:])
    return row_ptr, src[order], w[order], order


def prepare(g: Graph) -> CSRGraph:
    """Host-side, one-time CSR and CSC build of a Graph (on g's device)."""
    s = g.senders[: g.n_edge].cpu().numpy().astype(np.int64)
    r = g.receivers[: g.n_edge].cpu().numpy().astype(np.int64)
    w = g.weight[: g.n_edge].cpu().numpy()
    # Graph edges are receiver-sorted, so the fwd order is the identity.
    f_ptr, f_src, f_w, _ = _build_view(r, s, w, g.n_node_pad)
    b_ptr, b_src, b_w, b_order = _build_view(s, r, w, g.n_node_pad)
    csr = CSRGraph(
        row_ptr=torch.from_numpy(f_ptr),
        senders=torch.from_numpy(f_src.astype(np.int32)),
        weight=torch.from_numpy(f_w.astype(np.float32)),
        t_row_ptr=torch.from_numpy(b_ptr),
        t_receivers=torch.from_numpy(b_src.astype(np.int32)),
        t_weight=torch.from_numpy(b_w.astype(np.float32)),
        t_perm=torch.from_numpy(b_order.astype(np.int64)),
        part=_partition(f_ptr),
        t_part=_partition(b_ptr),
        n_node_pad=g.n_node_pad,
        n_edge=g.n_edge,
    )
    return csr.to(g.device)


def _reduce_plain(row_ptr, col, weight, x):
    """Plain PyTorch version of the kernel: ``out[r] = Σ_p w[p]·x[col[p]]``."""
    n_rows = row_ptr.shape[0] - 1
    rows = torch.repeat_interleave(
        torch.arange(n_rows, device=x.device), row_ptr.diff(),
        output_size=col.shape[0],
    )
    msgs = x.index_select(0, col) * weight[:, None]
    return x.new_zeros((n_rows, x.shape[1])).index_add_(0, rows, msgs)


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _launch(part: Partition, col, weight, x, n_rows):
    global launches
    fn = _build.load_library().gode_csr_spmm_f32
    f = x.shape[1]
    out = torch.empty((n_rows, f), dtype=torch.float32, device=x.device)
    partial = torch.empty((part.n_slots, f), dtype=torch.float32, device=x.device)
    rc = fn(
        _ptr(part.seg_ptr), _ptr(part.seg_row), _ptr(part.seg_slot),
        part.seg_row.shape[0],
        _ptr(part.split_row), _ptr(part.split_ptr), part.split_row.shape[0],
        _ptr(col), _ptr(weight), _ptr(x), _ptr(out),
        _ptr(partial) if part.n_slots else None,
        f, ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"csr_spmm kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def csr_reduce(csr: CSRGraph, x: torch.Tensor, *, transpose: bool = False) -> torch.Tensor:
    """The kernel's wrapper: one SpMM over the fwd (or, transposed, bwd) view.

    Takes f32, contiguous ``x [n_node_pad, F]`` on the adjacency's device.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if x.dtype != torch.float32:
        raise TypeError(f"csr_spmm takes float32 features, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] != csr.n_node_pad or x.shape[1] < 1:
        raise ValueError(
            f"csr_spmm takes x of shape [{csr.n_node_pad}, F>=1], got {tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError("csr_spmm takes contiguous features")
    if x.device != csr.device:
        raise ValueError(f"x is on {x.device} but the adjacency is on {csr.device}")
    row_ptr, col, weight, part = csr.view(transpose)
    if x.device.type == "cpu":
        return _reduce_plain(row_ptr, col, weight, x)
    if x.device.type != "cuda":
        raise ValueError(f"csr_spmm runs on CPU or CUDA tensors, not {x.device}")
    return _launch(part, col, weight, x, csr.n_node_pad)


class _SpMMCSR(torch.autograd.Function):
    @staticmethod
    def forward(ctx, csr, x):
        ctx.csr = csr
        return csr_reduce(csr, x)

    @staticmethod
    def backward(ctx, g):
        return None, csr_reduce(ctx.csr, g.contiguous(), transpose=True)


def spmm_csr(csr: CSRGraph, x: torch.Tensor) -> torch.Tensor:
    """Â x through the kernel; its gradient w.r.t. x is Âᵀ g through the kernel."""
    return _SpMMCSR.apply(csr, x)


def spmm_csr_reference(csr: CSRGraph, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``spmm_csr`` (autograd through index ops)."""
    return _reduce_plain(csr.row_ptr, csr.senders, csr.weight, x)
