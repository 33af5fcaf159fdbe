"""Edge-partitioned multi-head graph attention and the sharded GAT-ODE.

Counterpart of ``graph_odenet_tpu/parallel/sharded_gat.py``.  Receiver-block
partitioning keeps every receiver's incoming edges on its own rank, so the
masked softmax never crosses ranks; the sender features do, one block per
ring hop.  Every rank runs the same program on its node block's rows.

``gat_sharded`` has the JAX function's two modes:

  * ``"ring_pallas"``: the score table ``s_src`` is only ``[N, H]``, so it is
    all-gathered once; the rank then takes one exact softmax over all its
    edges (plain PyTorch segment ops), and each ring hop is one
    attention-weighted bucket reduction (B2-w, ``halo._bucket_spmm_weighted``:
    the CSR kernel's weighted bucket mode on a CUDA tensor, its plain version
    on a CPU tensor), the first hop writing the output and the rest adding.
  * ``"ring"``: a flash-style online softmax folded over the hops, all plain
    PyTorch segment ops.  Each hop carries one packed ``[B, H + H·F]`` tensor
    (``s_src`` beside ``Wh``), so every rank posts one exchange per hop, in
    one order, forward and backward.

The running maximum ``m`` only stabilises the exponentials: the output does
not depend on it, so it is computed without a gradient.  Attention dropout
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
from torch import nn
from torch.utils.checkpoint import checkpoint

from graph_odenet_tpu_torch.ops.dropmask import attention_dropout_scale, draw_seed
from graph_odenet_tpu_torch.parallel.halo import _bucket_spmm_weighted, all_gather_rows, ring_hop
from graph_odenet_tpu_torch.parallel.mesh import check_backend, world
from graph_odenet_tpu_torch.parallel.partition import PartitionedGraph
from graph_odenet_tpu_torch.parallel.sharded_gcn import _feature_dropout, _glorot

__all__ = ["gat_sharded", "ShardedGATODE", "init_gatode_params", "gatode_forward", "MODES"]

MODES = ("ring", "ring_pallas")
_NEG = -1e30


def _segment_max(e: torch.Tensor, rows: torch.Tensor, n_rows: int) -> torch.Tensor:
    """``[n_rows, H]`` per-row maximum of ``e [L, H]``, ``_NEG`` for a row
    without edges (not −inf, which would turn its output into NaN)."""
    m = e.new_full((n_rows, e.shape[1]), _NEG)
    return m.scatter_reduce(0, rows[:, None].expand_as(e), e, "amax", include_self=True)


def _segment_sum(v: torch.Tensor, rows: torch.Tensor, n_rows: int) -> torch.Tensor:
    return v.new_zeros((n_rows, *v.shape[1:])).index_add(0, rows, v)


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
) -> torch.Tensor:
    """Masked-softmax attention aggregation on this rank's node block.

    ``s_src``, ``s_dst``: the block's ``[B, H]`` source- and destination-side
    scores; ``wh``: its ``[B, H, F]`` per-head values.  Returns ``[B, H, F]``.
    ``attn_rate``/``attn_seed`` (an int in ``[0, 2**32)``, the same on every
    rank): post-softmax attention dropout.  ``pg.n_parts`` must equal the
    size of the default process group (one part without one).
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    n_parts, me = world()
    if pg.n_parts != n_parts:
        raise ValueError(f"partitioning has {pg.n_parts} parts, the process group {n_parts}")
    B = pg.block_size
    if wh.dim() != 3 or wh.shape[0] != B or s_src.shape != wh.shape[:2] or s_dst.shape != s_src.shape:
        raise ValueError(
            f"gat_sharded takes the block's s_src, s_dst [{B}, H] and wh [{B}, H, F], got "
            f"{tuple(s_src.shape)}, {tuple(s_dst.shape)}, {tuple(wh.shape)}"
        )
    if n_parts > 1:
        check_backend(wh)
    heads, feat = wh.shape[1], wh.shape[2]
    blk = pg.blocks[me]
    seed = attn_seed if attn_rate > 0.0 and attn_seed is not None else None

    def scale(senders, receivers):
        """The dropout scale of edges given by global sender and local receiver."""
        return attention_dropout_scale(seed, senders, me * B + receivers, heads, attn_rate)

    def logits(ssrc, senders, receivers):
        return torch.nn.functional.leaky_relu(
            ssrc.index_select(0, senders) + s_dst.index_select(0, receivers), negative_slope)

    if mode == "ring_pallas":
        # 1. The score table is H lanes wide, not H·F: gather all of it.
        e = logits(all_gather_rows(s_src), blk.senders, blk.receivers)  # [E_p, H]
        # 2. Exact softmax over all the rank's edges at once.
        m = _segment_max(e.detach(), blk.receivers, B)
        p = torch.exp(e - m.index_select(0, blk.receivers))
        l = _segment_sum(p, blk.receivers, B)
        p_v = p * scale(blk.senders, blk.receivers) if seed is not None else p
        # 3. Ring over value chunks: one weighted bucket reduction per hop,
        # the next chunk's exchange in flight behind it.
        out, chunk = None, wh.reshape(B, heads * feat)
        for k in range(n_parts):
            b = (me + k) % n_parts
            pending = []
            if k < n_parts - 1:
                nxt = ring_hop(chunk, pending)
            span = blk.bucket(b)
            out = _bucket_spmm_weighted(chunk, p_v[span], pg.bucket(me, b), feat,
                                        rows=blk.receivers[span], acc=out)
            for req in pending:
                req.wait()
            if pending:
                chunk = nxt
        return out.view(B, heads, feat) / torch.clamp(l, min=1e-30)[..., None]

    # mode == "ring": fold each arriving bucket into an online softmax.
    m = wh.new_full((B, heads), _NEG)
    l = wh.new_zeros((B, heads))
    acc = wh.new_zeros((B, heads, feat))
    packed = torch.cat([s_src, wh.reshape(B, heads * feat)], dim=1)
    for k in range(n_parts):
        b = (me + k) % n_parts
        pending = []
        if k < n_parts - 1:
            nxt = ring_hop(packed, pending)
        span = blk.bucket(b)
        s_b, r_b = pg.bucket(me, b).fwd.col, blk.receivers[span]
        e = logits(packed[:, :heads], s_b, r_b)
        m_new = torch.maximum(m, _segment_max(e.detach(), r_b, B))
        p = torch.exp(e - m_new.index_select(0, r_b))
        p_v = p * scale(blk.senders[span], r_b) if seed is not None else p
        rescale = torch.exp(m - m_new)
        msgs = packed[:, heads:].reshape(B, heads, feat).index_select(0, s_b) * p_v[..., None]
        acc = acc * rescale[..., None] + _segment_sum(msgs, r_b, B)
        l = l * rescale + _segment_sum(p, r_b, B)
        m = m_new
        for req in pending:
            req.wait()
        if pending:
            packed = nxt
    return acc / torch.clamp(l, min=1e-30)[..., None]


class ShardedGATODE(nn.Module):
    """The sharded GAT-ODE's parameters.  Per layer a weight ``w [in, H·F]``
    and the per-head attention vectors ``a_src``, ``a_dst`` ``[H, F]``: the
    encoder with ``heads`` heads of ``hidden``, the single-head dynamics and
    readout at width ``heads·hidden``.  Glorot uniform from ``generator`` on
    the CPU, drawn in the JAX package's order."""

    def __init__(self, f_in: int, hidden: int, heads: int, n_class: int, *, generator=None):
        super().__init__()
        d = heads * hidden
        self.w_enc = _glorot(f_in, d, generator)
        self.a_src_enc = _glorot(heads, hidden, generator)
        self.a_dst_enc = _glorot(heads, hidden, generator)
        self.w_dyn = _glorot(d, d, generator)
        self.a_src_dyn = _glorot(1, d, generator)
        self.a_dst_dyn = _glorot(1, d, generator)
        self.w_out = _glorot(d, n_class, generator)
        self.a_src_out = _glorot(1, n_class, generator)
        self.a_dst_out = _glorot(1, n_class, generator)


def init_gatode_params(
    f_in: int, hidden: int, heads: int, n_class: int, *, generator=None
) -> ShardedGATODE:
    return ShardedGATODE(f_in, hidden, heads, n_class, generator=generator)


def _att_layer(pg, h, w, a_src, a_dst, *, attn_rate=0.0, attn_seed=None, mode="ring"):
    """One sharded GAT layer: scores per head, then masked-softmax attention."""
    heads, feat = a_src.shape
    wh = (h @ w).view(h.shape[0], heads, feat)
    s_src = (wh * a_src).sum(-1)
    s_dst = (wh * a_dst).sum(-1)
    out = gat_sharded(pg, s_src, s_dst, wh, attn_rate=attn_rate, attn_seed=attn_seed, mode=mode)
    return out.reshape(h.shape[0], heads * feat)


def gatode_forward(
    params: ShardedGATODE, pg: PartitionedGraph, x: torch.Tensor, *, steps: int = 4,
    t1: float = 1.0, dropout: float = 0.0, generator: Optional[torch.Generator] = None,
    seed_generator: Optional[torch.Generator] = None, mode: str = "ring", remat: bool = False,
) -> torch.Tensor:
    """Log-probs of the rank's node block ``[B, C]``; ``x`` is its rows.

    ELU encoder with the parameters' heads, single-head tanh dynamics under
    classic rk4, single-head readout.  ``dropout`` with ``generator`` (on the
    features' device, seeded alike on every rank): feature dropout on the
    input and after the ODE block from one global mask, and attention
    dropout in the encoder, its seed drawn from ``seed_generator`` (a CPU
    generator, seeded alike on every rank).  Without ``generator`` nothing
    drops (evaluation).  ``remat`` recomputes each dynamics evaluation in the
    backward instead of keeping its per-edge activations.
    """
    p = params
    _, me = world()
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
        attn_rate=dropout if drop else 0.0, attn_seed=attn_seed, mode=mode,
    ))

    def dyn(h):
        return torch.tanh(_att_layer(pg, h, p.w_dyn, p.a_src_dyn, p.a_dst_dyn, mode=mode))

    if remat and torch.is_grad_enabled():
        plain_dyn = dyn
        # The dynamics draw no random numbers, so no generator state is kept.
        dyn = lambda h: checkpoint(plain_dyn, h, use_reentrant=False,  # noqa: E731
                                   preserve_rng_state=False)

    dt = t1 / steps
    for _ in range(steps):
        k1 = dyn(h)
        k2 = dyn(h + 0.5 * dt * k1)
        k3 = dyn(h + 0.5 * dt * k2)
        k4 = dyn(h + dt * k3)
        h = h + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    if drop:
        h = _feature_dropout(h, dropout, generator, rows, pg.n_node_pad)
    logits = _att_layer(pg, h, p.w_out, p.a_src_out, p.a_dst_out, mode=mode)
    return torch.log_softmax(logits, dim=-1)
