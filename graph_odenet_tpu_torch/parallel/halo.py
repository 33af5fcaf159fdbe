"""Sharded SpMM with halo exchange over the edge partition.

Counterpart of ``graph_odenet_tpu/parallel/halo.py``.  Every rank runs the
same program: it holds its node block's rows ``x_me [B, F]`` and returns
``(Â x)_me [B, F]``.  Each bucket reduction is the CSR kernel's bucket mode
(B2, ``ops.csr_spmm.bucket_reduce``) on a CUDA tensor and its plain version
on a CPU tensor.

  * ``mode="allgather"``: gather every block's rows, add the rank's P
    buckets into its output; the backward reduces the rank's buckets over
    their CSC views into a gathered ``[N, F]`` gradient (each bucket writes
    its own block) and reduce-scatters it.
  * ``mode="ring"`` and ``mode="ring_pallas"`` (one path; the JAX package's
    second name ran the Pallas tile kernel, and every port mode runs the
    kernel): at hop k the rank holds block (me + k) mod P's rows, posts the
    send of that chunk to rank me − 1 and the receive from rank me + 1, and
    adds bucket [me, (me + k) mod P] into its output while the chunk
    travels.  The backward is the reverse ring: a ``[B, F]`` accumulator
    destined for block b passes every rank, each adding its bucket
    [p, b]'s CSC reduction of its own output gradient, and ends at rank b.

The first bucket reduced into an output writes it (``accumulate=False``);
the others add into it, so no output is zero-filled and then read.  With
one part (no process group) every mode is one bucket reduction.

Every exchange runs on the process group it is given (``group=``; the
default group when None): the edge axis of a mesh (``mesh.make_mesh``).
Feature-axis tensor parallelism (``spmm_sharded(feat_axis=)``) runs the
same exchange on each rank's column slice, over its edge group alone.

For the sharded GAT (``parallel.sharded_gat``), whose per-edge weights are
traced, the ring is built from differentiable pieces instead of one
Function: ``_bucket_spmm_weighted`` (one hop's attention-weighted bucket
reduction, B2-w, with a hand-written backward: ``dchunk`` through B2-w over
the bucket's CSC view, ``dpv`` through ``ops.csr_spmm.edge_dot`` over its
CSR view), ``ring_hop`` (the exchange of one hop; its backward is the
reverse exchange) and ``all_gather_rows`` (its backward a reduce-scatter).
GRAND-nl (``parallel.sharded_grand``) scores its edges with
``bucket_scores``: ``ops.csr_spmm.edge_dot`` as a forward op over a
bucket's CSR view, its gradients two B2-w reductions (over the CSR view
for the queries, over the CSC view for the keys).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from graph_odenet_tpu_torch.ops.csr_spmm import bucket_reduce, edge_dot, gather_rows, row_ids, widen
from graph_odenet_tpu_torch.parallel.mesh import check_backend, global_rank, world
from graph_odenet_tpu_torch.parallel.partition import Bucket, PartitionedGraph
from graph_odenet_tpu_torch.utils.profiling import annotate

__all__ = ["spmm_sharded", "bucket_reduce_pallas", "bucket_scores", "ring_hop", "all_gather_rows",
           "MODES"]

MODES = ("allgather", "ring", "ring_pallas")


class _BucketReducePallas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msgs, bucket):
        ctx.bucket, ctx.e_pad = bucket, msgs.shape[0]
        out = msgs.new_empty((bucket.fwd.n_rows, msgs.shape[1]))
        return bucket_reduce(bucket.fwd, msgs, out, positional=True, accumulate=False)

    @staticmethod
    def backward(ctx, g):
        view = ctx.bucket.fwd
        dmsgs = g.new_zeros((ctx.e_pad, g.shape[1]))
        dmsgs[: view.n_edge] = g.index_select(0, row_ids(view.row_ptr, view.n_edge))
        return dmsgs, None


def bucket_reduce_pallas(msgs: torch.Tensor, bucket: Bucket) -> torch.Tensor:
    """Receiver-sorted reduction of one bucket's messages: ``out[r] =
    Σ_{e < L, r_e = r} msgs[e]``, ``[B, F]``, differentiable in ``msgs``.

    ``msgs [E_b, F]`` is in the bucket's CSR edge order.  The JAX function
    returns the TPU's full tile rows, of which callers keep the first B.
    Its gradient is the receiver gather ``dmsgs[e] = g[r_e]`` on the L real
    edges and zero on the padding slots, which the JAX function fills with
    ``g[0]``.
    """
    return _BucketReducePallas.apply(msgs, bucket)


class _BucketSpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, chunk, bucket):
        ctx.bucket = bucket
        out = chunk.new_empty((bucket.fwd.n_rows, chunk.shape[1]))
        return bucket_reduce(bucket.fwd, chunk, out, accumulate=False)

    @staticmethod
    def backward(ctx, g):
        bwd = ctx.bucket.bwd
        dx = g.new_empty((bwd.n_rows, g.shape[1]))
        return bucket_reduce(bwd, g.contiguous(), dx, accumulate=False), None


def _bucket_spmm(chunk: torch.Tensor, bucket: Bucket) -> torch.Tensor:
    """One bucket's SpMM ``out[r] = Σ_{e: r_e = r} w_e · chunk[s_e]``,
    differentiable in ``chunk``; the gradient reduces over the CSC view."""
    return _BucketSpMM.apply(chunk, bucket)


class _BucketSpMMWeighted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, chunk, pv_h, acc, bucket, rows, feat):
        ctx.bucket, ctx.rows, ctx.feat, ctx.added = bucket, rows, feat, acc is not None
        ctx.save_for_backward(chunk, pv_h)  # pv_h at [L, H], never the H·F-lane broadcast
        x, alpha = widen(chunk), widen(pv_h)  # B2-w sums f32 tables (its f32 entry)
        if acc is None:
            out = x.new_empty((bucket.fwd.n_rows, x.shape[1]))
            return bucket_reduce(bucket.fwd, x, out, accumulate=False, alpha=alpha, feat=feat)
        ctx.mark_dirty(acc)
        return bucket_reduce(bucket.fwd, x, acc, alpha=alpha, feat=feat)

    @staticmethod
    def backward(ctx, g):
        chunk, pv_h = ctx.saved_tensors
        bucket, feat = ctx.bucket, ctx.feat
        g = g.contiguous()
        dchunk = dpv = None
        if ctx.needs_input_grad[0]:
            # dchunk[s] = Σ_{e: s_e = s} pv[e] · g[r_e]: the numerators carried
            # into CSC order, the same kernel over the sender-sorted view.
            dchunk = g.new_empty((bucket.bwd.n_rows, g.shape[1]))
            bucket_reduce(bucket.bwd, g, dchunk, accumulate=False,
                          alpha=widen(pv_h.index_select(0, bucket.t_perm)), feat=feat)
            dchunk = dchunk.to(chunk.dtype)
        if ctx.needs_input_grad[1]:
            # dpv[e, h] = Σ_f chunk[s_e, hF+f] · g[r_e, hF+f]: the per-edge dot
            # over the bucket's CSR view, on the chunk widened at [B, H·F].
            with annotate("gode.b2w.dpv"):
                dpv = edge_dot(bucket.fwd, widen(chunk), g, pv_h.shape[1], feat,
                               rows=ctx.rows).to(pv_h.dtype)
        return dchunk, dpv, g if ctx.added else None, None, None, None


def _bucket_spmm_weighted(
    chunk: torch.Tensor, pv_h: torch.Tensor, bucket: Bucket, feat: int, *,
    rows: torch.Tensor | None = None, acc: torch.Tensor | None = None,
) -> torch.Tensor:
    """Attention-weighted bucket reduction (B2-w): ``out[r, h·F+f] = Σ_{e: r_e
    = r} pv_h[e, h] · chunk[s_e, h·F+f]``, differentiable in ``chunk [B,
    H·F]`` (the ring's value chunk) and in ``pv_h [L, H]`` (the bucket's
    softmax numerators, in its CSR edge order, real edges only).

    With ``acc`` the result is added into it in place and ``acc`` is
    returned (a later hop of the ring); without, a new ``[B, H·F]`` is
    written.  ``rows`` is the receiver of each edge (int64 ``[L]``), which
    the plain version of the backward's ``dpv`` reads (worked out from the
    view when not given; the kernel reads the view's segments).  The
    backward reduces ``dchunk`` through the bucket's CSC view with the same
    kernel and ``dpv`` with ``edge_dot`` over its CSR view.

    bf16 ``chunk`` and ``pv_h`` are widened to f32 for the kernel's f32
    entry (the wrapper takes no bf16 in its weighted mode), so ``out`` (and
    ``acc``) is f32: the caller rounds the sum over hops once.  Each
    gradient comes back in its input's dtype, ``dpv`` summed in f32.
    """
    return _BucketSpMMWeighted.apply(chunk.contiguous(), pv_h.contiguous(), acc, bucket, rows, feat)


class _BucketScores(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, bucket, rows, heads, feat):
        ctx.bucket, ctx.feat = bucket, feat
        ctx.save_for_backward(q, k)
        return edge_dot(bucket.fwd, k, q, heads, feat, rows=rows)

    @staticmethod
    def backward(ctx, ds):
        q, k = ctx.saved_tensors
        bucket, feat = ctx.bucket, ctx.feat
        ds = ds.contiguous()
        dq = dk = None
        if ctx.needs_input_grad[1]:
            ds_t = gather_rows(ds, bucket.t_perm)  # the scores' gradients in CSC order
        with annotate("gode.grand.score"):
            if ctx.needs_input_grad[0]:
                # dq[r] = Σ_{e: r_e = r} ds[e, h] · k[s_e]: B2-w over the CSR view.
                dq = bucket_reduce(bucket.fwd, k, torch.empty_like(q), accumulate=False,
                                   alpha=ds, feat=feat)
            if ctx.needs_input_grad[1]:
                # dk[s] = Σ_{e: s_e = s} ds[e, h] · q[r_e]: B2-w over the CSC view.
                dk = bucket_reduce(bucket.bwd, q, torch.empty_like(k), accumulate=False,
                                   alpha=ds_t, feat=feat)
        return dq, dk, None, None, None, None


def bucket_scores(
    q: torch.Tensor, k: torch.Tensor, bucket: Bucket, heads: int, feat: int, *,
    rows: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-edge, per-head dot products of one bucket: ``s[e, h] = Σ_f q[r_e,
    h·F+f] · k[s_e, h·F+f]``, f32 ``[L, H]`` in the bucket's CSR edge order,
    differentiable in ``q`` (the receiver block's rows, f32 ``[B, H·F]``) and
    ``k`` (the sender block's rows, f32 ``[B, H·F]``).

    The forward is one ``edge_dot`` over the CSR view; the backward reduces
    ``dq`` with B2-w over the CSR view and ``dk`` with B2-w over the CSC view
    (the scores' gradients carried into CSC order by ``t_perm``, with
    ``ops.csr_spmm.gather_rows``), inside a
    ``gode.grand.score`` span of its own.  ``rows`` is the receiver of each
    edge, which the plain version of ``edge_dot`` reads."""
    return _BucketScores.apply(q.contiguous(), k.contiguous(), bucket, rows, heads, feat)


def _exchange(send: torch.Tensor, recv: torch.Tensor, me: int, n_parts: int, step: int = -1,
              group=None):
    """Post the ring hop within ``group``: ``send`` to its rank me − 1,
    ``recv`` from its rank me + 1 (``step=1``: the reverse hop)."""
    return dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, global_rank(group, (me + step) % n_parts), group=group),
        dist.P2POp(dist.irecv, recv, global_rank(group, (me - step) % n_parts), group=group),
    ])


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, me, n_parts, pending, group):
        ctx.me, ctx.n_parts, ctx.group = me, n_parts, group
        nxt = torch.empty_like(t)
        pending.extend(_exchange(t, nxt, me, n_parts, group=group))
        return nxt

    @staticmethod
    def backward(ctx, g):
        back = torch.empty_like(g)
        for req in _exchange(g.contiguous(), back, ctx.me, ctx.n_parts, step=1, group=ctx.group):
            req.wait()
        return back, None, None, None, None


def ring_hop(t: torch.Tensor, pending: list, group=None) -> torch.Tensor:
    """One differentiable hop of the ring: sends ``t`` to rank me − 1 and
    returns what rank me + 1 sent.  The exchange is only posted: its
    requests are appended to ``pending``, and the caller waits for them
    before it reads the result, so the hop overlaps what runs in between.
    The backward sends the gradient to rank me + 1 and receives from rank
    me − 1 (what ``ppermute`` transposes to).  Every rank calls it in the
    same order of ``group`` (the default group when None)."""
    n_parts, me = world(group)
    return _RingHop.apply(t.contiguous(), me, n_parts, pending, group)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, n_parts, group):
        ctx.n_parts, ctx.group = n_parts, group
        full = t.new_empty((n_parts * t.shape[0], *t.shape[1:]))
        dist.all_gather_into_tensor(full, t, group=group)
        return full

    @staticmethod
    def backward(ctx, g):
        dt = g.new_empty((g.shape[0] // ctx.n_parts, *g.shape[1:]))
        dist.reduce_scatter_tensor(dt, g.contiguous(), op=dist.ReduceOp.SUM, group=ctx.group)
        return dt, None, None


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's rows of ``t [B, ...]`` in ``group``'s rank order (the
    default group when None), ``[P·B, ...]``, differentiable: the backward
    reduce-scatters the gathered gradient.  With one part it is ``t``
    itself and posts nothing."""
    n_parts, _ = world(group)
    if n_parts == 1:
        return t
    return _AllGatherRows.apply(t.contiguous(), n_parts, group)


class _RingSpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, me, n_parts, group):
        ctx.pg, ctx.me, ctx.n_parts, ctx.group = pg, me, n_parts, group
        out = torch.empty_like(x)
        chunk = x
        for k in range(n_parts):
            reqs = []
            if k < n_parts - 1:
                nxt = torch.empty_like(chunk)
                reqs = _exchange(chunk, nxt, me, n_parts, group=group)  # overlaps the reduction
            bucket_reduce(pg.bucket(me, (me + k) % n_parts).fwd, chunk, out, accumulate=k > 0)
            for req in reqs:
                req.wait()
            if reqs:
                chunk = nxt
        return out

    @staticmethod
    def backward(ctx, g):
        pg, me, n_parts = ctx.pg, ctx.me, ctx.n_parts
        g = g.contiguous()
        acc = torch.empty_like(g)  # destined for block (me + k + 1) mod P at hop k
        for k in range(n_parts):
            bucket_reduce(pg.bucket(me, (me + k + 1) % n_parts).bwd, g, acc, accumulate=k > 0)
            if k < n_parts - 1:
                nxt = torch.empty_like(acc)
                for req in _exchange(acc, nxt, me, n_parts, group=ctx.group):
                    req.wait()
                acc = nxt
        return acc, None, None, None, None


class _AllgatherSpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, me, n_parts, group):
        ctx.pg, ctx.me, ctx.n_parts, ctx.group = pg, me, n_parts, group
        B = pg.block_size
        x_full = x
        if n_parts > 1:
            x_full = x.new_empty((n_parts * B, x.shape[1]))
            dist.all_gather_into_tensor(x_full, x, group=group)
        out = torch.empty_like(x)
        for b in range(n_parts):
            bucket_reduce(pg.bucket(me, b).fwd, x_full[b * B:(b + 1) * B], out, accumulate=b > 0)
        return out

    @staticmethod
    def backward(ctx, g):
        pg, me, n_parts = ctx.pg, ctx.me, ctx.n_parts
        B = pg.block_size
        g = g.contiguous()
        dx_full = g.new_empty((n_parts * B, g.shape[1]))
        for b in range(n_parts):
            bucket_reduce(pg.bucket(me, b).bwd, g, dx_full[b * B:(b + 1) * B], accumulate=False)
        if n_parts == 1:
            return dx_full, None, None, None, None
        dx = torch.empty_like(g)
        dist.reduce_scatter_tensor(dx, dx_full, op=dist.ReduceOp.SUM, group=ctx.group)
        return dx, None, None, None, None


def _check_feat_slices(x: torch.Tensor, feat_axis) -> None:
    """Raise unless every rank along ``feat_axis`` holds a column slice of
    the same width as this rank's.  One gather of one integer a rank; no
    feature moves."""
    n_feat, _ = world(feat_axis)
    width = torch.tensor([x.shape[-1]], dtype=torch.int64, device=x.device)
    widths = width
    if n_feat > 1:
        widths = width.new_empty(n_feat)
        dist.all_gather_into_tensor(widths, width, group=feat_axis)
    if bool((widths != width).any()):
        raise ValueError(f"the feature slices along feat_axis differ in width: {widths.tolist()}")


def spmm_sharded(
    pg: PartitionedGraph,
    x: torch.Tensor,
    *,
    mode: str = "ring",
    group=None,
    feat_axis=None,
    check_vma=None,
) -> torch.Tensor:
    """``(Â x)`` of this rank's node block; ``x`` is the block's rows ``[B, F]``
    (or ``[b, B, F]``, below).

    ``group`` is the edge axis: the process group whose rank ``r`` holds
    node block ``r`` (the default group when None); ``pg.n_parts`` must
    equal its size (one part without a process group).

    ``feat_axis`` (feature-axis tensor parallelism, JAX's second mesh axis):
    the process group of the ranks that hold other column slices of the same
    block's rows.  ``x`` is then this rank's slice ``[B, F/PF]``; the halo
    exchange runs on ``group`` alone, over the slice, and the edge metadata
    ``pg`` is replicated along ``feat_axis``.  Along ``feat_axis`` nothing
    moves but a check that every slice has the same width.

    A leading batch axis, ``x [b, B, F]`` (what ``jax.vmap(...,
    spmd_axis_name=)`` gives the JAX call on a (data, edge) mesh), is folded
    into the columns: one reduction over ``[B, b·F]``, the launches of one
    call.

    ``check_vma`` steers the checker of JAX's ``shard_map`` and has no
    meaning here: it is accepted and ignored.
    """
    del check_vma
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    n_parts, me = world(group)
    if pg.n_parts != n_parts:
        raise ValueError(f"partitioning has {pg.n_parts} parts, the process group {n_parts}")
    if x.dim() not in (2, 3) or x.shape[-2] != pg.block_size:
        raise ValueError(f"spmm_sharded takes the block's rows [{pg.block_size}, F] "
                         f"or [b, {pg.block_size}, F], got {tuple(x.shape)}")
    if feat_axis is not None:
        _check_feat_slices(x, feat_axis)
    if n_parts > 1:
        check_backend(x, group)
    if x.dim() == 3:
        b, rows, f = x.shape
        out = spmm_sharded(pg, x.permute(1, 0, 2).reshape(rows, b * f), mode=mode, group=group)
        return out.view(rows, b, f).permute(1, 0, 2)
    fn = _AllgatherSpMM if mode == "allgather" else _RingSpMM
    return fn.apply(x.contiguous(), pg, me, n_parts, group)
