"""CSR SpMM on Hopper: the counterpart of ``graph_odenet_tpu/ops/pallas_spmm.py``.

``spmm_csr(csr, x)`` computes ``out[r] = sum_p w[p] * x[col[p]]`` over the
row's CSR span, as ``spmm_pallas`` does.  The forward reduces over the
receiver-sorted (CSR) view; the backward ``dx = Âᵀ g`` is the same reduction
over the sender-sorted (CSC) view.  The adjacency gets no gradient.

``csr_reduce(..., alpha=[E, H], feat=F)`` is the weighted mode of the same
kernel (``_segment_reduce_sched``'s ``alpha3d`` mode): feature lane ``f`` of
edge ``p`` is scaled by ``alpha[p, f // F]`` instead of the edge weight.
The GAT backward without the score hint reduces ``dWh`` with it.

``bucket_reduce(view, x, out)`` is the bucket mode (B2, the counterpart of
``_segment_reduce``): ``out += A x`` over one ``CSRView``, a rectangular
block of the edge-partitioned graph whose gathered table ``x`` has its own
row count, or, positional, is the block's ``[E, F]`` message array itself.
With ``accumulate=False`` it writes ``out = A x`` instead, reading nothing
of ``out``: the first bucket of a receiver block.  With ``alpha=[L, H]`` and
``feat=`` it is the weighted bucket mode (B2-w, ``_segment_reduce`` with
``alpha3d``): lane ``f`` of edge ``p`` is scaled by ``alpha[p, f // feat]``,
the per-head softmax numerators of the edge-partitioned GAT.

On a CUDA tensor the reduction is the hand-written kernel in
``csrc/csr_spmm.cu``; on a CPU tensor it is the plain version
``_reduce_plain`` (gather + ``index_add_``).  There is no other path: a CUDA
tensor launches the kernel or raises.

Features are float32 or bfloat16 (JAX's bf16-training tier: ``spmm_pallas``
on bf16 messages adds them in f32 and writes the messages' dtype).  In
bf16, ``csr_reduce``, ``bucket_reduce`` and ``spmm_csr`` return bf16 (the
gradient of a bf16 ``x`` too): the kernel widens each feature to f32, takes
the f32 weights, products and sums, and rounds each output once; the plain
versions do the same (``widen``, then one ``.to``).  JAX rounds each
message to bf16 before its f32 sum, so the two differ by bf16 rounding.
The weighted modes (B1-w, B2-w) take float32 only, as their JAX callers
give them: a bf16 table there raises ``TypeError``.

``prepare`` also cuts each view into warp segments of at most
``SEG_EDGES`` edges, so that a hub row with many thousands of edges is
spread over many warps.  A row cut into several segments writes partial
sums to scratch, and the last of its warps to arrive adds them up in slot
order, so the result does not depend on scheduling.

Each call is one launch.  What never changes for a view (its device
pointers and counts, and the split rows' arrival counters) is a
``LaunchPlan``, built at the view's first CUDA call and cached on the view
(``CSRGraph.plans``, ``CSRView.plan``); ``.to()`` makes a new view and so a
new plan.  A call passes the plan and only what varies.  The counters are
back at 0 after every launch, so a launch can be captured in a CUDA graph
after an eager call at the same width has built the plan and sized its
counters; calls on one view are ordered on one stream, as PyTorch orders
them.  The GAT kernels (``ops/gat_attn.py``) take the same plans, counters
included: ``gat_fwd`` and ``gat_bwd`` the fwd view's, ``gat_dwh`` the bwd
view's.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from graph_odenet_tpu_torch.graph import Graph
from graph_odenet_tpu_torch.ops import _build
from graph_odenet_tpu_torch.utils.profiling import annotate
from graph_odenet_tpu_torch.utils.sanitize import validate_tiling

__all__ = [
    "CSRGraph", "CSRView", "Partition", "LaunchPlan", "prepare", "csr_view", "csr_reduce",
    "bucket_reduce", "spmm_csr", "spmm_csr_reference", "SEG_EDGES", "widen",
]

#: Most edges one warp reduces; longer rows are cut into several segments.
SEG_EDGES = 256

#: Number of kernel launches made by ``csr_reduce`` in this process,
#: unweighted and weighted, and by ``bucket_reduce``, unweighted and weighted.
launches = 0
weighted_launches = 0
bucket_launches = 0
bucket_weighted_launches = 0
#: Of those, the launches on bf16 features (the unweighted modes' bf16 entry).
bf16_launches = {"csr": 0, "bucket": 0}


@dataclasses.dataclass(frozen=True)
class Partition:
    """Warp segments of one CSR view (built on the host by ``prepare``).

    Segments tile the edge array in order.  In a view that writes its
    output (``prepare``) every row has at least one segment: an edgeless
    row has one empty segment, which writes zeros.  In a view that adds
    into its output (``csr_view``) an edgeless row has none, and
    ``empty_row`` lists it, for the bucket mode's write form to zero.
    """

    seg_ptr: torch.Tensor    # int64[S+1] edge span of each segment
    seg_row: torch.Tensor    # int32[S]   output row of each segment
    seg_slot: torch.Tensor   # int32[S]   -1: whole row, written to out;
                             #            else its row of the partial scratch
    split_row: torch.Tensor  # int32[R]   rows cut into several segments
    split_ptr: torch.Tensor  # int32[R+1] their spans of partial slots
    slot_split: torch.Tensor  # int32[n_slots] split row (index into split_row) of each slot
    empty_row: torch.Tensor  # int32[K]   rows without a segment
    n_slots: int

    def to(self, device) -> "Partition":
        return dataclasses.replace(
            self, **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self) if f.name != "n_slots"
            },
        )


class _PlanStruct(ctypes.Structure):
    """``CsrPlan`` of ``csrc/segments.cuh``, field for field."""

    _fields_ = [
        (name, ctypes.c_void_p) for name in (
            "seg_ptr", "seg_row", "seg_slot", "split_row", "split_ptr", "slot_split",
            "empty_row", "col", "w", "arrivals")
    ] + [(name, ctypes.c_int64) for name in ("n_seg", "n_split", "n_empty", "n_arrivals")]


class LaunchPlan:
    """What the kernel reads of one view and what never changes between calls.

    Holds the view's tensors (so that their device pointers stay valid), the
    ``CsrPlan`` struct of their pointers and counts that the C entry takes
    by pointer, and the split rows' arrival counters (int32, zero between
    calls, one per split row and feature chunk).  Counters that a wider call
    outgrew stay referenced: a CUDA graph captured before holds their address.
    """

    def __init__(self, part: Partition, col: torch.Tensor, weight: torch.Tensor):
        self.part, self.col, self.weight = part, col, weight
        self.device = part.seg_ptr.device
        self.index = self.device.index
        self.n_seg = part.seg_row.shape[0]
        self.n_split = part.split_row.shape[0]
        self.n_empty = part.empty_row.shape[0]
        self.n_slots = part.n_slots
        self.arrivals = torch.zeros(self.n_split, dtype=torch.int32, device=self.device)
        self.outgrown = []
        self.struct = _PlanStruct(
            *(t.data_ptr() for t in (part.seg_ptr, part.seg_row, part.seg_slot, part.split_row,
                                     part.split_ptr, part.slot_split, part.empty_row, col, weight,
                                     self.arrivals)),
            self.n_seg, self.n_split, self.n_empty, self.n_split,
        )
        self.address = ctypes.addressof(self.struct)

    def reserve(self, n_chunks: int) -> None:
        """Arrival counters for ``n_chunks`` feature chunks (zeroed when new)."""
        need = self.n_split * n_chunks
        if need > self.struct.n_arrivals:
            if self.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"a call of {n_chunks} feature chunks needs new arrival counters, which "
                    "cannot be made during a CUDA graph capture: make one eager call of "
                    "this width on the view first")
            self.outgrown.append(self.arrivals)
            self.arrivals = torch.zeros(need, dtype=torch.int32, device=self.device)
            self.struct.arrivals, self.struct.n_arrivals = self.arrivals.data_ptr(), need


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Receiver-sorted (CSR) and sender-sorted (CSC) views of a Graph.

    fwd view: rows are receivers, ``senders`` are the gathered columns.
              CSR position ``p`` is the Graph's edge ``p`` (``prepare``
              takes receiver-sorted Graphs only), so per-edge data in Graph
              order is in CSR order.
    bwd view: rows are senders, ``t_receivers`` are the gathered columns
              (Âᵀ through the same kernel).  ``t_perm`` maps a CSC
              position to its original edge id.
    Only real edges are stored; padding edges are dropped.
    """

    row_ptr: torch.Tensor      # int64[n_node_pad+1]
    senders: torch.Tensor      # int32[E]
    receivers: torch.Tensor    # int32[E] receiver of each CSR position
    weight: torch.Tensor       # f32[E]
    t_row_ptr: torch.Tensor    # int64[n_node_pad+1]
    t_receivers: torch.Tensor  # int32[E]
    t_weight: torch.Tensor     # f32[E]
    t_perm: torch.Tensor       # int64[E]
    part: Partition
    t_part: Partition
    n_node_pad: int
    n_edge: int

    @functools.cached_property
    def device(self) -> torch.device:
        return self.row_ptr.device

    @functools.cached_property
    def plans(self) -> tuple:
        """(fwd, bwd) ``LaunchPlan``s, built at first use."""
        return (LaunchPlan(self.part, self.senders, self.weight),
                LaunchPlan(self.t_part, self.t_receivers, self.t_weight))

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


@dataclasses.dataclass(frozen=True)
class CSRView:
    """One sorted view of a rectangular sparse block, for ``bucket_reduce``.

    ``n_rows`` output rows gather from a table of ``n_cols`` rows.  Position
    ``p`` is the block's edge ``p`` (``csr_view`` takes row-sorted edges),
    so a message array in the block's edge order is in CSR order.  Only the
    block's real edges are stored.
    """

    row_ptr: torch.Tensor  # int64[n_rows+1]
    col: torch.Tensor      # int32[L] gathered table row of each position
    weight: torch.Tensor   # f32[L]
    part: Partition        # warp segments; edgeless rows have none
    n_cols: int

    @property
    def n_rows(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def n_edge(self) -> int:
        return self.col.shape[0]

    @functools.cached_property
    def device(self) -> torch.device:
        return self.row_ptr.device

    @functools.cached_property
    def plan(self) -> LaunchPlan:
        """The view's ``LaunchPlan``, built at first use."""
        return LaunchPlan(self.part, self.col, self.weight)

    def to(self, device) -> "CSRView":
        return dataclasses.replace(
            self, row_ptr=self.row_ptr.to(device), col=self.col.to(device),
            weight=self.weight.to(device), part=self.part.to(device),
        )


def _partition(row_ptr: np.ndarray, *, skip_empty: bool = False) -> Partition:
    deg = np.diff(row_ptr)
    n_seg = -(-deg // SEG_EDGES)
    if not skip_empty:
        n_seg = np.maximum(1, n_seg)
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
    slot_split = np.repeat(np.arange(len(split_ptr) - 1, dtype=np.int32), np.diff(split_ptr))
    return Partition(
        seg_ptr=torch.from_numpy(seg_ptr),
        seg_row=torch.from_numpy(seg_row.astype(np.int32)),
        seg_slot=torch.from_numpy(seg_slot.astype(np.int32)),
        split_row=torch.from_numpy(np.nonzero(split)[0].astype(np.int32)),
        split_ptr=torch.from_numpy(split_ptr.astype(np.int32)),
        slot_split=torch.from_numpy(slot_split),
        empty_row=torch.from_numpy(np.nonzero(n_seg == 0)[0].astype(np.int32)),
        n_slots=int(split_ptr[-1]),
    )


def _build_view(dst, src, w, n_pad):
    """Sort edges by dst: (row_ptr, src sorted, w sorted, order)."""
    order = np.argsort(dst, kind="stable")
    row_ptr = np.zeros(n_pad + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n_pad), out=row_ptr[1:])
    return row_ptr, src[order], w[order], order


def prepare(g: Graph) -> CSRGraph:
    """Host-side, one-time CSR and CSC build of a Graph (on g's device),
    checked by ``utils.sanitize.validate_tiling`` before it leaves the host.

    Raises ``ValueError`` unless the Graph's real edges are sorted by
    receiver (``from_edges`` sorts them): per-edge data such as attention
    logits arrives in Graph order and is read in CSR order.
    """
    s = g.senders[: g.n_edge].cpu().numpy().astype(np.int64)
    r = g.receivers[: g.n_edge].cpu().numpy().astype(np.int64)
    w = g.weight[: g.n_edge].cpu().numpy()
    if np.any(np.diff(r) < 0):
        raise ValueError(
            "prepare takes a Graph whose real edges are sorted by receiver "
            "(as from_edges builds it)"
        )
    f_ptr, f_src, f_w, _ = _build_view(r, s, w, g.n_node_pad)
    b_ptr, b_src, b_w, b_order = _build_view(s, r, w, g.n_node_pad)
    csr = CSRGraph(
        row_ptr=torch.from_numpy(f_ptr),
        senders=torch.from_numpy(f_src.astype(np.int32)),
        receivers=torch.from_numpy(r.astype(np.int32)),
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
    validate_tiling(csr)
    return csr.to(g.device)


def csr_view(rows, cols, weight, n_rows: int, n_cols: int) -> CSRView:
    """Host-side build of a ``CSRView`` from a block's real edges (numpy),
    checked by ``utils.sanitize.validate_tiling``.

    ``rows`` (non-decreasing) and ``cols`` index the output rows and the
    gathered table.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if np.any(np.diff(rows) < 0):
        raise ValueError("csr_view takes edges sorted by row")
    if rows.size and (rows.min() < 0 or rows.max() >= n_rows or cols.min() < 0
                      or cols.max() >= n_cols):
        raise ValueError(f"edge indices outside a [{n_rows}, {n_cols}] block")
    row_ptr, col, w, _ = _build_view(rows, cols, np.asarray(weight, dtype=np.float32), n_rows)
    view = CSRView(
        row_ptr=torch.from_numpy(row_ptr),
        col=torch.from_numpy(col.astype(np.int32)),
        weight=torch.from_numpy(w.astype(np.float32)),
        part=_partition(row_ptr, skip_empty=True),
        n_cols=int(n_cols),
    )
    validate_tiling(view)
    return view


def row_ids(row_ptr: torch.Tensor, n_edge: int) -> torch.Tensor:
    """The row of each edge position of a CSR (or CSC) view."""
    n_rows = row_ptr.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(n_rows, device=row_ptr.device), row_ptr.diff(), output_size=n_edge
    )


def _reduce_plain(row_ptr, col, weight, x, alpha=None, feat=None):
    """Plain PyTorch version of the kernel: ``out[r] = Σ_p w[p]·x[col[p]]``.

    Weighted mode (``alpha [E, H]``): lane ``f`` of edge ``p`` is scaled by
    ``alpha[p, f // feat]`` instead of ``w[p]``.
    """
    rows = row_ids(row_ptr, col.shape[0])
    xs = widen(x)
    gathered = xs.index_select(0, col)
    if alpha is None:
        msgs = gathered * weight[:, None]
    else:
        msgs = gathered * alpha.to(xs.dtype).repeat_interleave(feat, dim=1)
    out = xs.new_zeros((row_ptr.shape[0] - 1, x.shape[1])).index_add_(0, rows, msgs)
    return out.to(x.dtype)


_SCALED, _ALPHA, _POSITIONAL = 0, 1, 2  # the C entry's modes
#: Feature dtypes the kernel takes (the weighted modes: float32 only).
DTYPES = (torch.float32, torch.bfloat16)


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the type the kernel sums in: bf16 to f32; f32 (and the f64 of
    a reference) as it is."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _check_dtype(who, name, t, weighted):
    if t.dtype not in DTYPES:
        raise TypeError(f"{who} takes float32 or bfloat16 {name}, got {t.dtype}")
    if weighted and t.dtype != torch.float32:
        raise TypeError(
            f"the weighted {who} takes float32 {name}, got {t.dtype}: its callers reduce f32 "
            "tables (the GAT backward's dWh, as JAX casts g to f32 before it) or widen bf16 "
            "ones first (gat_sharded's ring_pallas)"
        )


def _lanes(f: int, vector: bool) -> tuple:
    """(G, V) of a call at F = ``f``: G feature lanes per edge slot, V features
    per lane.  ``vector`` (F a multiple of 4, rows aligned to 4 elements: 16
    bytes in f32, 8 in bf16; heads of a multiple of 4 lanes): at F >= 32 a
    lane loads 4 features (a float4, or 4 bf16), and G is the
    smallest power of two that covers F / 4, at most 32 (a chunk of 128
    features).  Otherwise V = 1 and G is the smallest power of two >= F, at
    most 32."""
    if vector and f >= 32:
        return min(32, 1 << (-(-f // 4) - 1).bit_length()), 4
    return min(32, 1 << (f - 1).bit_length()), 1


def _run(plan: LaunchPlan, x, out, alpha, feat, mode, accumulate):
    """One launch of the kernel over ``plan``'s view into ``out``."""
    f = x.shape[1]
    x_ptr, out_ptr = x.data_ptr(), out.data_ptr()
    lanes, vec = _lanes(f, f % 4 == 0 and (x_ptr | out_ptr) % (4 * x.element_size()) == 0
                        and (alpha is None or feat % 4 == 0))
    partial = None
    if plan.n_split:
        plan.reserve(-(-f // (lanes * vec)))
        partial = torch.empty((plan.n_slots, f), dtype=torch.float32, device=x.device)
    lib = _build.load_library("csr_spmm")
    partial_ptr = None if partial is None else partial.data_ptr()
    stream = torch.cuda.current_stream(plan.index).cuda_stream
    if x.dtype == torch.bfloat16:  # the wrappers pass no alpha with bf16
        rc = lib.gode_csr_reduce_bf16(plan.address, x_ptr, out_ptr, partial_ptr, f, mode, lanes,
                                      vec, accumulate, stream)
    else:
        rc = lib.gode_csr_reduce_f32(
            plan.address, x_ptr, None if alpha is None else alpha.data_ptr(), out_ptr,
            partial_ptr, f, feat or 1, mode, lanes, vec, accumulate, stream,
        )
    if rc != 0:
        raise RuntimeError(f"csr_spmm kernel launch failed: CUDA error {rc}")


def _check_alpha(who, alpha, feat, n_edge, f, device):
    """The weighted mode's checks: f32 contiguous ``alpha [n_edge, f / feat]``
    on ``device``, ``feat`` dividing ``f``."""
    if alpha.dtype != torch.float32:
        raise TypeError(f"{who} takes float32 alpha, got {alpha.dtype}")
    if feat is None or feat < 1 or f % feat or alpha.shape != (n_edge, f // feat):
        raise ValueError(
            f"weighted {who} takes alpha [{n_edge}, F/feat] and feat dividing "
            f"F={f}, got alpha {tuple(alpha.shape)}, feat={feat}"
        )
    if not alpha.is_contiguous():
        raise ValueError(f"{who} takes contiguous alpha")
    if alpha.device != device:
        raise ValueError(f"alpha is on {alpha.device} but the adjacency is on {device}")


def csr_reduce(
    csr: CSRGraph, x: torch.Tensor, *, transpose: bool = False,
    alpha: torch.Tensor | None = None, feat: int | None = None,
) -> torch.Tensor:
    """The kernel's wrapper: one SpMM over the fwd (or, transposed, bwd) view.

    Takes f32 or bf16, contiguous ``x [n_node_pad, F]`` on the adjacency's
    device, and returns ``x``'s dtype.  With ``alpha`` (f32, contiguous
    ``[E, H]`` in the view's edge order) and ``feat`` (``F = H * feat``),
    the weighted mode, f32 ``x`` only.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel, one launch.
    """
    global launches, weighted_launches
    _check_dtype("csr_spmm", "features", x, alpha is not None)
    if x.dim() != 2 or x.shape[0] != csr.n_node_pad or x.shape[1] < 1:
        raise ValueError(
            f"csr_spmm takes x of shape [{csr.n_node_pad}, F>=1], got {tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError("csr_spmm takes contiguous features")
    if x.device != csr.device:
        raise ValueError(f"x is on {x.device} but the adjacency is on {csr.device}")
    if alpha is not None:
        _check_alpha("csr_spmm", alpha, feat, csr.n_edge, x.shape[1], csr.device)
    if x.is_cuda:
        out = torch.empty_like(x)
        _run(csr.plans[transpose], x, out, alpha, feat, _SCALED if alpha is None else _ALPHA, 0)
        if alpha is None:
            launches += 1
        else:
            weighted_launches += 1
        if x.dtype == torch.bfloat16:
            bf16_launches["csr"] += 1
        return out
    if x.device.type != "cpu":
        raise ValueError(f"csr_spmm runs on CPU or CUDA tensors, not {x.device}")
    row_ptr, col, weight, _ = csr.view(transpose)
    return _reduce_plain(row_ptr, col, weight, x, alpha, feat)


def _bucket_reduce_plain(view: CSRView, x, out, positional=False, accumulate=True,
                         alpha=None, feat=None):
    """Plain PyTorch version of the bucket mode: gather, ``index_add_`` into
    ``out`` (zeroed first when not ``accumulate``).  With ``alpha [L, H]``
    lane ``f`` of edge ``p`` is scaled by ``alpha[p, f // feat]`` instead of
    the edge weight."""
    xs = widen(x)
    acc = widen(out) if accumulate else torch.zeros_like(out, dtype=xs.dtype)
    rows = row_ids(view.row_ptr, view.n_edge)
    if positional:
        msgs = xs[: view.n_edge]
    elif alpha is not None:
        msgs = xs.index_select(0, view.col) * alpha.to(xs.dtype).repeat_interleave(feat, dim=1)
    else:
        msgs = xs.index_select(0, view.col) * view.weight.to(xs.dtype)[:, None]
    acc = acc.index_add_(0, rows, msgs)
    return acc if acc is out else out.copy_(acc)


def bucket_reduce(
    view: CSRView, x: torch.Tensor, out: torch.Tensor, *, positional: bool = False,
    accumulate: bool = True, alpha: torch.Tensor | None = None, feat: int | None = None,
) -> torch.Tensor:
    """The bucket mode's wrapper: ``out += A x`` over ``view``, in place; or,
    with ``accumulate=False``, ``out = A x`` (every row written, none read).

    ``x`` is the gathered table, f32 or bf16 contiguous ``[view.n_cols,
    F]``; or, ``positional``, the block's message array ``[E >=
    view.n_edge, F]`` in the view's edge order (column = position, weight
    1; rows past ``view.n_edge`` are padding and never read).  ``out`` is
    contiguous ``[view.n_rows, F]`` of ``x``'s dtype on the same device (in
    bf16 the sum is f32 and each element of out is rounded once).  With ``alpha`` (f32,
    contiguous ``[view.n_edge, H]`` in the view's edge order) and ``feat``
    (``F = H * feat``), the weighted mode: ``out[r, h·feat + f] (+)= Σ_p
    alpha[p, h] · x[col[p], h·feat + f]``; it has no positional form.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel, one
    launch (none when an add form has no edge to add).  Returns ``out``.
    """
    global bucket_launches, bucket_weighted_launches
    device = view.device
    for name, t in (("x", x), ("out", out)):
        _check_dtype("bucket_reduce", name, t, alpha is not None)
        if t.dtype != x.dtype:
            raise TypeError(f"bucket_reduce takes x and out of one dtype, got {x.dtype} "
                            f"and {out.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"bucket_reduce takes a contiguous {name}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device} but the view is on {device}")
    f = out.shape[1] if out.dim() == 2 else 0
    table_ok = x.shape[0] >= view.n_edge if positional else x.shape[0] == view.n_cols
    if x.dim() != 2 or out.dim() != 2 or f < 1 or x.shape[1] != f or not table_ok \
            or out.shape[0] != view.n_rows:
        want = f"[>={view.n_edge}, F]" if positional else f"[{view.n_cols}, F]"
        raise ValueError(
            f"bucket_reduce takes x {want} and out [{view.n_rows}, F>=1], "
            f"got {tuple(x.shape)} and {tuple(out.shape)}"
        )
    if alpha is not None:
        if positional:
            raise ValueError("the weighted bucket mode has no positional form")
        _check_alpha("bucket_reduce", alpha, feat, view.n_edge, f, device)
    elif feat is not None:
        raise ValueError("bucket_reduce takes feat only with alpha")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"bucket_reduce runs on CPU or CUDA tensors, not {x.device}")
        with annotate("gode.bucket_reduce"):
            return _bucket_reduce_plain(view, x, out, positional, accumulate, alpha, feat)
    plan = view.plan
    if accumulate and plan.n_seg == 0:
        return out  # no edge: nothing to add, nothing launched
    mode = _POSITIONAL if positional else _SCALED if alpha is None else _ALPHA
    with annotate("gode.bucket_reduce"):
        _run(plan, x, out, alpha, feat, mode, int(accumulate))
    if alpha is None:
        bucket_launches += 1
    else:
        bucket_weighted_launches += 1
    if x.dtype == torch.bfloat16:
        bf16_launches["bucket"] += 1
    return out


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
