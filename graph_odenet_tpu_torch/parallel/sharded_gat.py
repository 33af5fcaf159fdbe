"""Edge-partitioned multi-head graph attention and the sharded GAT-ODE.

Counterpart of ``graph_odenet_tpu/parallel/sharded_gat.py``.  Receiver-block
partitioning keeps every receiver's incoming edges on its own rank, so the
masked softmax never crosses ranks; the sender features do, one block per
ring hop.  Every rank runs the same program on its node block's rows.

``gat_sharded`` has the JAX function's two modes:

  * ``"ring_pallas"``: the score table ``s_src`` is only ``[N, H]``, so it is
    all-gathered once; the rank then takes one exact softmax over all its
    edges (``edge_softmax``), and each ring hop is one
    attention-weighted bucket reduction (B2-w, ``halo._bucket_spmm_weighted``:
    the CSR kernel's weighted bucket mode on a CUDA tensor, its plain version
    on a CPU tensor), the first hop writing the output and the rest adding.
  * ``"ring"``: a flash-style online softmax folded over the hops, plain
    PyTorch segment ops.  Each hop carries one packed ``[B, H + H·F]`` tensor
    (``s_src`` beside ``Wh``), so every rank posts one exchange per hop, in
    one order, forward and backward.

The running maximum ``m`` only stabilises the exponentials: the output does
not depend on it, so it is computed without a gradient.  The softmax's
gathers and maxima, which do not depend on order, go through
``ops.csr_spmm.gather_rows`` and ``segment_max`` (kernels on a CUDA tensor,
``index_select`` and ``scatter_reduce`` on a CPU one); every sum stays on
``index_add_``.  Attention dropout
scales the numerators only (the denominator keeps every edge) by the counter
hash of ``ops/dropmask.py`` on global sender and receiver ids, so the mask
does not depend on the partitioning and equals the single-device paths'.

``ShardedGATODE`` holds the nine parameters of the JAX package's
``init_gatode_params`` by name and in its layouts
(``convert.params_from_sharded_gat``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from graph_odenet_tpu_torch.ops.csr_spmm import MAX_FLOOR, gather_rows, segment_max, widen
from graph_odenet_tpu_torch.ops.dropmask import attention_dropout_scale, draw_seed
from graph_odenet_tpu_torch.ops.segment import segment_sum
from graph_odenet_tpu_torch.parallel.halo import _bucket_spmm_weighted, all_gather_rows, ring_hop
from graph_odenet_tpu_torch.parallel.mesh import check_backend, world
from graph_odenet_tpu_torch.parallel.partition import PartitionedGraph
from graph_odenet_tpu_torch.parallel.sharded_gcn import _feature_dropout, _glorot
from graph_odenet_tpu_torch.utils.profiling import annotate

__all__ = ["gat_sharded", "edge_softmax", "weighted_ring", "ShardedGATODE", "init_gatode_params",
           "gatode_forward", "MODES"]

MODES = ("ring", "ring_pallas")


class _Denominators(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, receivers, n_rows):
        ctx.save_for_backward(receivers)
        return segment_sum(p, receivers, n_rows)

    @staticmethod
    def backward(ctx, g):
        (receivers,) = ctx.saved_tensors
        # index_add_'s own backward, each edge its receiver's row.
        return gather_rows(g, receivers), None, None


def edge_softmax(e: torch.Tensor, receivers: torch.Tensor, n_rows: int):
    """The exact softmax of each receiver's in-edges, unnormalised: the
    numerators ``p = exp(e − m[r_e])`` ``[E, H]`` (``m`` each row's maximum,
    ``ops.csr_spmm.segment_max``, without a gradient) and the denominators
    ``l [n_rows, H]``, each an f32 sum rounded once to ``e``'s dtype
    (``ops.segment.segment_sum``; its backward gathers the gradient by
    ``receivers`` with ``gather_rows``).  ``receivers`` is each edge's local
    row.  Shared by ``gat_sharded``'s ``ring_pallas`` mode and GRAND-nl
    (``parallel.sharded_grand``), each inside its own span."""
    m = segment_max(e, receivers, n_rows)
    p = torch.exp(e - gather_rows(m, receivers))
    return p, _Denominators.apply(p, receivers, n_rows)


def weighted_ring(pg: PartitionedGraph, chunk: torch.Tensor, pv: torch.Tensor, feat: int,
                  group=None) -> torch.Tensor:
    """``ring_pallas``'s ring: ``out[r] = Σ_e pv[e, h] · chunk[s_e, h·F+f]``
    over every edge of the rank's block, one B2-w reduction
    (``halo._bucket_spmm_weighted``) a hop, the first writing ``out`` and
    the rest adding, the next chunk's exchange in flight behind each.
    ``chunk`` is the rank's rows ``[B, H·F]``; ``pv [E_p, H]`` the per-edge
    weights in the block's edge order (``BlockEdges``).  Returns ``[B, H·F]``
    in the type B2-w sums in (f32 for a bf16 chunk).  Shared by
    ``gat_sharded`` and GRAND-nl (``parallel.sharded_grand``)."""
    n_parts, me = world(group)
    blk = pg.blocks[me]
    out = None
    for k in range(n_parts):
        b = (me + k) % n_parts
        pending = []
        if k < n_parts - 1:
            nxt = ring_hop(chunk, pending, group)
        span = blk.bucket(b)
        out = _bucket_spmm_weighted(chunk, pv[span], pg.bucket(me, b), feat,
                                    rows=blk.receivers[span], acc=out)
        for req in pending:
            req.wait()
        if pending:
            chunk = nxt
    return out


def gat_sharded(
    pg: PartitionedGraph,
    s_src: torch.Tensor,
    s_dst: torch.Tensor,
    wh: torch.Tensor,
    *,
    negative_slope: float = 0.2,
    attn_rate: float = 0.0,
    attn_seed: Optional[int] = None,
    mode: str = "ring",
    group=None,
) -> torch.Tensor:
    """Masked-softmax attention aggregation on this rank's node block.

    ``s_src``, ``s_dst``: the block's ``[B, H]`` source- and destination-side
    scores; ``wh``: its ``[B, H, F]`` per-head values.  Returns ``[B, H, F]``
    in ``wh``'s dtype.  ``attn_rate``/``attn_seed`` (an int in ``[0,
    2**32)``, the same on every rank): post-softmax attention dropout.
    ``group``: the process group the blocks are spread over, JAX's mesh
    ``axis`` (the default group when None); ``pg.n_parts`` must equal its
    size (one part without a process group).

    In bfloat16 every sum is taken in float32 and rounded once (JAX adds bf16
    messages): ``ring_pallas`` widens each hop's chunk and numerators for
    B2-w (its f32 entry) and rounds the output after the division by the
    denominators, ``ring`` forms its messages from widened values, and the
    gradients of the gathered scores add in f32.  The scores, numerators and
    denominators are held in the inputs' dtype, as JAX's are (each
    denominator an f32 sum rounded once, ``ops.segment.segment_sum``).
    Attention dropout's scale is f32, so the scaled numerators are f32 in
    both modes; the output is rounded to ``wh``'s dtype all the same (JAX's
    bf16 function raises there: the f32 scale promotes its loop carry).
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    n_parts, me = world(group)
    if pg.n_parts != n_parts:
        where = ("the default process group" if group is None else
                 f"the process group of ranks {dist.get_process_group_ranks(group)}")
        raise ValueError(f"partitioning has {pg.n_parts} parts, but {where} has {n_parts}")
    B = pg.block_size
    if wh.dim() != 3 or wh.shape[0] != B or s_src.shape != wh.shape[:2] or s_dst.shape != s_src.shape:
        raise ValueError(
            f"gat_sharded takes the block's s_src, s_dst [{B}, H] and wh [{B}, H, F], got "
            f"{tuple(s_src.shape)}, {tuple(s_dst.shape)}, {tuple(wh.shape)}"
        )
    if n_parts > 1:
        check_backend(wh, group)
    heads, feat = wh.shape[1], wh.shape[2]
    blk = pg.blocks[me]
    seed = attn_seed if attn_rate > 0.0 and attn_seed is not None else None

    def scale(senders, receivers):
        """The dropout scale of edges given by global sender and local receiver."""
        return attention_dropout_scale(seed, senders, me * B + receivers, heads, attn_rate)

    def logits(ssrc, senders, receivers):
        """The edges' logits in the scores' dtype, gathered from widened scores
        so that the backward sums each node's edges in f32 (bf16 scores)."""
        pair = gather_rows(widen(ssrc), senders) + gather_rows(widen(s_dst), receivers)
        return torch.nn.functional.leaky_relu(pair.to(s_dst.dtype), negative_slope)

    if mode == "ring_pallas":
        with annotate("gode.gat.softmax"):
            # 1. The score table is H lanes wide, not H·F: gather all of it.
            e = logits(all_gather_rows(s_src, group), blk.senders, blk.receivers)  # [E_p, H]
            # 2. Exact softmax over all the rank's edges at once.
            p, l = edge_softmax(e, blk.receivers, B)
            p_v = p * scale(blk.senders, blk.receivers) if seed is not None else p
        # 3. Ring over value chunks: one weighted bucket reduction per hop.
        out = weighted_ring(pg, wh.reshape(B, heads * feat), p_v, feat, group)
        out = out.view(B, heads, feat) / torch.clamp(l, min=1e-30)[..., None]
        return out.to(wh.dtype)

    # mode == "ring": fold each arriving bucket into an online softmax.  The
    # messages are formed from widened values, so they and their gradients
    # sum in f32 (bf16 values; f32 ones as they are).
    m = wh.new_full((B, heads), MAX_FLOOR)
    l = wh.new_zeros((B, heads))
    acc = widen(wh).new_zeros((B, heads, feat))
    packed = torch.cat([s_src, wh.reshape(B, heads * feat)], dim=1)
    for k in range(n_parts):
        b = (me + k) % n_parts
        pending = []
        if k < n_parts - 1:
            nxt = ring_hop(packed, pending, group)
        span = blk.bucket(b)
        s_b, r_b = pg.bucket(me, b).fwd.col, blk.receivers[span]
        with annotate("gode.gat.softmax"):
            e = logits(packed[:, :heads], s_b, r_b)
            m_new = torch.maximum(m, segment_max(e, r_b, B))
            p = torch.exp(e - gather_rows(m_new, r_b))
            p_v = p * scale(blk.senders[span], r_b) if seed is not None else p
            rescale = torch.exp(m - m_new)
        vals = widen(packed[:, heads:]).reshape(B, heads, feat)
        msgs = vals.index_select(0, s_b) * p_v[..., None]
        acc = acc * rescale[..., None] + segment_sum(msgs, r_b, B)
        with annotate("gode.gat.softmax"):
            l = l * rescale + segment_sum(p, r_b, B)
        m = m_new
        for req in pending:
            req.wait()
        if pending:
            packed = nxt
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(wh.dtype)


class ShardedGATODE(nn.Module):
    """The sharded GAT-ODE's parameters.  Per layer a weight ``w [in, H·F]``
    and the per-head attention vectors ``a_src``, ``a_dst`` ``[H, F]``: the
    encoder with ``heads`` heads of ``hidden``, the single-head dynamics and
    readout at width ``heads·hidden``.  Glorot uniform from ``generator`` on
    the CPU, drawn in the JAX package's order in float32 and rounded once to
    ``dtype``, the dtype of every leaf.  With bfloat16 parameters and
    features the whole forward runs in bf16 (``gat_sharded``'s rule for B2-w)
    and returns bf16 log-probs."""

    def __init__(self, f_in: int, hidden: int, heads: int, n_class: int, *, generator=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = heads * hidden
        self.w_enc = _glorot(f_in, d, generator, dtype)
        self.a_src_enc = _glorot(heads, hidden, generator, dtype)
        self.a_dst_enc = _glorot(heads, hidden, generator, dtype)
        self.w_dyn = _glorot(d, d, generator, dtype)
        self.a_src_dyn = _glorot(1, d, generator, dtype)
        self.a_dst_dyn = _glorot(1, d, generator, dtype)
        self.w_out = _glorot(d, n_class, generator, dtype)
        self.a_src_out = _glorot(1, n_class, generator, dtype)
        self.a_dst_out = _glorot(1, n_class, generator, dtype)


def init_gatode_params(
    f_in: int, hidden: int, heads: int, n_class: int, *, generator=None,
    dtype: torch.dtype = torch.float32,
) -> ShardedGATODE:
    return ShardedGATODE(f_in, hidden, heads, n_class, generator=generator, dtype=dtype)


def _att_layer(pg, h, w, a_src, a_dst, *, attn_rate=0.0, attn_seed=None, mode="ring",
               group=None):
    """One sharded GAT layer: scores per head, then masked-softmax attention."""
    heads, feat = a_src.shape
    wh = (h @ w).view(h.shape[0], heads, feat)
    s_src = (wh * a_src).sum(-1)
    s_dst = (wh * a_dst).sum(-1)
    out = gat_sharded(pg, s_src, s_dst, wh, attn_rate=attn_rate, attn_seed=attn_seed, mode=mode,
                      group=group)
    return out.reshape(h.shape[0], heads * feat)


def gatode_forward(
    params: ShardedGATODE, pg: PartitionedGraph, x: torch.Tensor, *, steps: int = 4,
    t1: float = 1.0, dropout: float = 0.0, generator: Optional[torch.Generator] = None,
    seed_generator: Optional[torch.Generator] = None, mode: str = "ring", remat: bool = False,
    group=None,
) -> torch.Tensor:
    """Log-probs of the rank's node block ``[B, C]``; ``x`` is its rows.

    ELU encoder with the parameters' heads, single-head tanh dynamics under
    classic rk4, single-head readout.  ``dropout`` with ``generator`` (on the
    features' device, seeded alike on every rank): feature dropout on the
    input and after the ODE block from one global mask, and attention
    dropout in the encoder, its seed drawn from ``seed_generator`` (a CPU
    generator, seeded alike on every rank).  Without ``generator`` nothing
    drops (evaluation).  ``remat`` recomputes each dynamics evaluation in the
    backward instead of keeping its per-edge activations.  ``group``: the
    process group the blocks are spread over (the default group when None),
    as in ``gat_sharded``.
    """
    p = params
    _, me = world(group)
    drop = dropout > 0.0 and generator is not None
    attn_seed = None
    if drop:
        if seed_generator is None:
            raise ValueError("attention dropout needs a CPU seed_generator")
        rows = slice(me * pg.block_size, (me + 1) * pg.block_size)
        x = _feature_dropout(x, dropout, generator, rows, pg.n_node_pad)
        attn_seed = draw_seed(seed_generator)
    h = torch.nn.functional.elu(_att_layer(
        pg, x, p.w_enc, p.a_src_enc, p.a_dst_enc,
        attn_rate=dropout if drop else 0.0, attn_seed=attn_seed, mode=mode, group=group,
    ))

    def dyn(h):
        return torch.tanh(_att_layer(pg, h, p.w_dyn, p.a_src_dyn, p.a_dst_dyn, mode=mode,
                                     group=group))

    if remat and torch.is_grad_enabled():
        plain_dyn = dyn

        def dyn(h):
            calls = 0

            def run(h):  # called once in the forward, again to recompute
                nonlocal calls
                calls += 1
                if calls == 1:
                    return plain_dyn(h)
                with annotate("gode.gat.recompute"):
                    return plain_dyn(h)

            # The dynamics draw no random numbers, so no generator state is kept.
            return checkpoint(run, h, use_reentrant=False, preserve_rng_state=False)

    dt = t1 / steps
    for _ in range(steps):
        k1 = dyn(h)
        k2 = dyn(h + 0.5 * dt * k1)
        k3 = dyn(h + 0.5 * dt * k2)
        k4 = dyn(h + dt * k3)
        h = h + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    if drop:
        h = _feature_dropout(h, dropout, generator, rows, pg.n_node_pad)
    logits = _att_layer(pg, h, p.w_out, p.a_src_out, p.a_dst_out, mode=mode, group=group)
    return torch.log_softmax(logits, dim=-1)
