"""Fused GAT attention on Hopper: the counterpart of ``ops/pallas_gat.py``.

The sandwich ``α = segment_softmax(logits)``, ``out = Σ α·D·Wh[s]`` over the
receiver-sorted view, with its backward, runs through three kernels of
``csrc/gat_attn.cu``:

  gat_fwd  out, and the softmax state m (max logit) and l = Σ exp(logit − m)
           per receiver and head (every real edge counts in l, dropped ones
           too: D scales numerators only).  Edgeless rows: out = m = l = 0.
  gat_bwd  per edge α = exp(logit − m[r]) / l[r] and
           dlogit = α·(D·⟨g[r], Wh[s]⟩ − β[r]), β[r] = Σ_f g[r]·out[r];
           optionally α·D in CSR order.
  gat_dwh  dWh[s] = Σ_{e: sender s} α·D·g[r] over the CSC view, α recomputed
           from the score tables: exp(min(LeakyReLU(s_src[s] + s_dst[r]) −
           m[r], 0)) / l[r], D re-hashed.

The four autograd Functions mirror the JAX custom_vjps.  With the score
hint ``(s_src, s_dst)`` the backward takes ``gat_dwh``; without it,
``gat_bwd`` emits α·D, which is permuted to CSC order with ``t_perm`` and
reduced by the weighted mode of the SpMM kernel (``csr_reduce(alpha=...)``).
The hint tensors and the mask get no gradient: the gradient reaches s_src
and s_dst through ``logits`` and ``edge_scores``' autograd.

Each wrapper runs its plain PyTorch version (``*_plain``, beside it) on CPU
tensors and launches its kernel on CUDA tensors, nothing else.  The plain
versions take any float dtype; the wrappers take float32.  D is one of: no
dropout, an explicit ``dmask [E, H]`` in CSR order, or ``drop=(seed,
rate)``, the counter hash of ``ops/dropmask.py`` regenerated in every pass.
"""

from __future__ import annotations

import torch

from graph_odenet_tpu_torch.ops import _build, dropmask
from graph_odenet_tpu_torch.ops.csr_spmm import CSRGraph, _ptr, _stream, csr_reduce, row_ids

__all__ = [
    "gat_fwd", "gat_bwd", "gat_dwh",
    "gat_fwd_plain", "gat_bwd_plain", "gat_dwh_plain",
    "gat_aggregate_kernel", "gat_aggregate_kernel_dropout",
    "gat_aggregate_kernel_scores", "gat_aggregate_kernel_scores_dropout",
    "gat_aggregate_reference", "launches",
]

#: Kernel launches made by each wrapper in this process.
launches = {"gat_fwd": 0, "gat_bwd": 0, "gat_dwh": 0}

_NONE, _EXPLICIT, _HASH = 0, 1, 2


# ---------------------------------------------------------------- plain versions


def _scale(senders, receivers, heads, dmask, drop, dtype):
    """The [E, H] dropout scale D, or None without dropout."""
    if dmask is not None:
        return dmask[: senders.shape[0]].to(dtype)
    if drop is not None:
        seed, rate = drop
        return dropmask.attention_dropout_scale(seed, senders, receivers, heads, rate).to(dtype)
    return None


def gat_fwd_plain(csr: CSRGraph, logits, wh, *, dmask=None, drop=None):
    """Plain version of ``gat_fwd``: ``(out [N, H, F], m [N, H], l [N, H])``.

    Differentiable by autograd, so its ``out`` is also the plain path of the
    four Functions (``gat_aggregate_reference``).  The max only shifts the
    exponent, so it is taken without gradient, as ``segment_softmax`` does.
    """
    n, heads = wh.shape[0], wh.shape[1]
    e = csr.n_edge
    rcv = csr.receivers.long()
    lg = logits[:e]
    with torch.no_grad():
        m = lg.new_full((n, heads), -torch.inf).scatter_reduce(
            0, rcv[:, None].expand(e, heads), lg, "amax"
        )
        m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(lg - m.index_select(0, rcv))
    l = lg.new_zeros((n, heads)).index_add_(0, rcv, p)
    alpha = p / l.index_select(0, rcv)
    d = _scale(csr.senders, csr.receivers, heads, dmask, drop, lg.dtype)
    if d is not None:
        alpha = alpha * d
    msgs = wh.index_select(0, csr.senders) * alpha[..., None]
    return wh.new_zeros(wh.shape).index_add_(0, rcv, msgs), m, l


def gat_bwd_plain(csr: CSRGraph, logits, wh, g, m, l, beta, *, dmask=None, drop=None,
                  emit_alpha=False):
    """Plain version of ``gat_bwd``: ``(dlogits like logits, α·D [E, H] or None)``."""
    heads = wh.shape[1]
    e = csr.n_edge
    rcv = csr.receivers.long()
    alpha = torch.exp(logits[:e] - m.index_select(0, rcv)) / l.index_select(0, rcv)
    dot = (g.index_select(0, rcv) * wh.index_select(0, csr.senders)).sum(-1)
    d = _scale(csr.senders, csr.receivers, heads, dmask, drop, logits.dtype)
    if d is not None:
        dot = dot * d
        alpha_d = alpha * d
    else:
        alpha_d = alpha
    dlogits = torch.zeros_like(logits)
    dlogits[:e] = alpha * (dot - beta.index_select(0, rcv))
    return dlogits, (alpha_d if emit_alpha else None)


def gat_dwh_plain(csr: CSRGraph, s_src, s_dst, m, l, g, slope, *, drop=None):
    """Plain version of ``gat_dwh``: ``dWh [N, H, F]`` over the CSC view."""
    heads = g.shape[1]
    snd = row_ids(csr.t_row_ptr, csr.n_edge)
    rcv = csr.t_receivers.long()
    x = s_src.index_select(0, snd) + s_dst.index_select(0, rcv)
    x = torch.nn.functional.leaky_relu(x, slope)
    alpha = torch.exp(torch.clamp(x - m.index_select(0, rcv), max=0.0)) / l.index_select(0, rcv)
    d = _scale(snd, csr.t_receivers, heads, None, drop, g.dtype)
    if d is not None:
        alpha = alpha * d
    return g.new_zeros(g.shape).index_add_(0, snd, alpha[..., None] * g.index_select(0, rcv))


# ---------------------------------------------------------------- wrappers


def _check(name, csr: CSRGraph, **tensors):
    for key, t in tensors.items():
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 {key}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous {key}")
        if t.device != csr.device:
            raise ValueError(f"{key} is on {t.device} but the adjacency is on {csr.device}")
    if csr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not {csr.device}")


def _check_shapes(name, csr: CSRGraph, wh, logits=None, dmask=None, **node_tables):
    if wh.dim() != 3 or wh.shape[0] != csr.n_node_pad:
        raise ValueError(f"{name} takes [{csr.n_node_pad}, H, F] values, got {tuple(wh.shape)}")
    heads = wh.shape[1]
    for key, t in (("logits", logits), ("dmask", dmask)):
        if t is not None and (t.dim() != 2 or t.shape[0] < csr.n_edge or t.shape[1] != heads):
            raise ValueError(f"{name} takes {key} of shape [>={csr.n_edge}, {heads}], got {tuple(t.shape)}")
    for key, t in node_tables.items():
        if t.shape != (csr.n_node_pad, heads):
            raise ValueError(f"{name} takes {key} of shape [{csr.n_node_pad}, {heads}], got {tuple(t.shape)}")


def _mask_args(dmask, drop):
    """(mode, dmask pointer, seed, keep24, inv_keep) of the C interface."""
    if dmask is not None:
        return _EXPLICIT, _ptr(dmask), 0, 0, 1.0
    if drop is not None:
        seed, rate = drop
        return _HASH, None, int(seed) & 0xFFFFFFFF, dropmask.keep24(rate), dropmask.inv_keep(rate)
    return _NONE, None, 0, 0, 1.0


def _rc(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1


def gat_fwd(csr: CSRGraph, logits, wh, *, dmask=None, drop=None):
    """B4: ``(out [N, H, F], m [N, H], l [N, H])``; logits ``[>=E, H]`` in CSR order."""
    _check("gat_fwd", csr, logits=logits, wh=wh, dmask=dmask)
    _check_shapes("gat_fwd", csr, wh, logits=logits, dmask=dmask)
    if csr.device.type == "cpu":
        return gat_fwd_plain(csr, logits, wh, dmask=dmask, drop=drop)
    n, heads, feat = wh.shape
    part = csr.part
    out = torch.empty_like(wh)
    m = torch.empty((n, heads), dtype=torch.float32, device=wh.device)
    l = torch.empty_like(m)
    p_acc = torch.empty((part.n_slots, heads * feat), dtype=torch.float32, device=wh.device)
    p_m = torch.empty((part.n_slots, heads), dtype=torch.float32, device=wh.device)
    p_l = torch.empty_like(p_m)
    rc = _build.load_library("gat_attn").gode_gat_fwd_f32(
        _ptr(part.seg_ptr), _ptr(part.seg_row), _ptr(part.seg_slot), part.seg_row.shape[0],
        _ptr(part.split_row), _ptr(part.split_ptr), part.split_row.shape[0],
        _ptr(csr.senders), _ptr(logits), _ptr(wh), *_mask_args(dmask, drop),
        _ptr(out), _ptr(m), _ptr(l), _ptr(p_acc), _ptr(p_m), _ptr(p_l),
        heads, feat, _stream(wh.device),
    )
    _rc("gat_fwd", rc)
    return out, m, l


def gat_bwd(csr: CSRGraph, logits, wh, g, m, l, beta, *, dmask=None, drop=None, emit_alpha=False):
    """B5: ``(dlogits like logits, α·D [E, H] in CSR order or None)``."""
    _check("gat_bwd", csr, logits=logits, wh=wh, g=g, m=m, l=l, beta=beta, dmask=dmask)
    _check_shapes("gat_bwd", csr, wh, logits=logits, dmask=dmask, m=m, l=l, beta=beta)
    if g.shape != wh.shape:
        raise ValueError(f"gat_bwd takes g of shape {tuple(wh.shape)}, got {tuple(g.shape)}")
    if csr.device.type == "cpu":
        return gat_bwd_plain(
            csr, logits, wh, g, m, l, beta, dmask=dmask, drop=drop, emit_alpha=emit_alpha
        )
    _, heads, feat = wh.shape
    dlogits = torch.zeros_like(logits)
    alpha_d = (
        torch.empty((csr.n_edge, heads), dtype=torch.float32, device=wh.device)
        if emit_alpha else None
    )
    rc = _build.load_library("gat_attn").gode_gat_bwd_f32(
        csr.n_edge, _ptr(csr.senders), _ptr(csr.receivers),
        _ptr(logits), _ptr(wh), _ptr(g), _ptr(m), _ptr(l), _ptr(beta),
        *_mask_args(dmask, drop), _ptr(dlogits), None if alpha_d is None else _ptr(alpha_d),
        heads, feat, _stream(wh.device),
    )
    _rc("gat_bwd", rc)
    return dlogits, alpha_d


def gat_dwh(csr: CSRGraph, s_src, s_dst, m, l, g, slope: float, *, drop=None):
    """B3: ``dWh [N, H, F]``, α recomputed from the score tables over the CSC view."""
    _check("gat_dwh", csr, s_src=s_src, s_dst=s_dst, m=m, l=l, g=g)
    _check_shapes("gat_dwh", csr, g, s_src=s_src, s_dst=s_dst, m=m, l=l)
    if csr.device.type == "cpu":
        return gat_dwh_plain(csr, s_src, s_dst, m, l, g, slope, drop=drop)
    _, heads, feat = g.shape
    part = csr.t_part
    out = torch.empty_like(g)
    partial = torch.empty((part.n_slots, heads * feat), dtype=torch.float32, device=g.device)
    mode, _, seed, keep, inv = _mask_args(None, drop)
    rc = _build.load_library("gat_attn").gode_gat_dwh_f32(
        _ptr(part.seg_ptr), _ptr(part.seg_row), _ptr(part.seg_slot), part.seg_row.shape[0],
        _ptr(part.split_row), _ptr(part.split_ptr), part.split_row.shape[0],
        _ptr(csr.t_receivers), _ptr(s_src), _ptr(s_dst), _ptr(m), _ptr(l), _ptr(g),
        float(slope), mode, seed, keep, inv, _ptr(out),
        _ptr(partial) if part.n_slots else None, heads, feat, _stream(g.device),
    )
    _rc("gat_dwh", rc)
    return out


# ---------------------------------------------------------------- autograd


class _GATAggregate(torch.autograd.Function):
    """``out = Σ α·D·Wh[s]`` through the kernels; gradients for logits and wh."""

    @staticmethod
    def forward(ctx, csr, logits, wh, dmask, s_src, s_dst, slope, drop):
        out, m, l = gat_fwd(csr, logits, wh, dmask=dmask, drop=drop)
        ctx.csr, ctx.slope, ctx.drop = csr, slope, drop
        ctx.save_for_backward(logits, wh, out, m, l, dmask, s_src, s_dst)
        return out

    @staticmethod
    def backward(ctx, g):
        logits, wh, out, m, l, dmask, s_src, s_dst = ctx.saved_tensors
        csr = ctx.csr
        g = g.contiguous()
        beta = (g * out).sum(-1)
        hinted = s_src is not None
        dlogits, alpha_d = gat_bwd(
            csr, logits, wh, g, m, l, beta, dmask=dmask, drop=ctx.drop, emit_alpha=not hinted
        )
        if hinted:
            dwh = gat_dwh(csr, s_src, s_dst, m, l, g, ctx.slope, drop=ctx.drop)
        else:
            n, heads, feat = wh.shape
            dwh = csr_reduce(
                csr, g.view(n, heads * feat), transpose=True,
                alpha=alpha_d.index_select(0, csr.t_perm), feat=feat,
            ).view(n, heads, feat)
        return None, dlogits, dwh, None, None, None, None, None


def gat_aggregate_kernel(csr: CSRGraph, logits, wh):
    """Fused masked-softmax attention aggregation: ``[N, H, F]``."""
    return _GATAggregate.apply(csr, logits, wh, None, None, None, 0.0, None)


def gat_aggregate_kernel_dropout(csr: CSRGraph, logits, wh, dmask):
    """With post-softmax attention dropout given as an ``[E, H]`` α scale."""
    return _GATAggregate.apply(csr, logits, wh, dmask, None, None, 0.0, None)


def gat_aggregate_kernel_scores(csr: CSRGraph, slope: float, logits, wh, s_src, s_dst):
    """With the score hint: ``logits == leaky_relu(s_src[s] + s_dst[r], slope)``."""
    return _GATAggregate.apply(csr, logits, wh, None, s_src, s_dst, slope, None)


def gat_aggregate_kernel_scores_dropout(csr: CSRGraph, slope: float, rate: float, logits, wh,
                                        s_src, s_dst, seed: int):
    """Score hint plus the counter-hash dropout of ``seed``; no mask is stored."""
    return _GATAggregate.apply(csr, logits, wh, None, s_src, s_dst, slope, (int(seed), rate))


def gat_aggregate_reference(csr: CSRGraph, logits, wh, *, dmask=None, drop=None):
    """Plain PyTorch version of the four Functions (autograd through index ops)."""
    return gat_fwd_plain(csr, logits, wh, dmask=dmask, drop=drop)[0]
