"""What both references share: the graph from the benchmark's arrays,
matrix products in float32 or TF32, edge aggregations computed in blocks of
edges, the counter-hash attention dropout, feature dropout and Adam.

TF32 (the control's precision) is emulated: both operands of every product,
forward and backward, are rounded to TF32's 10-bit mantissa (to nearest,
ties to even) and multiplied in float32.  That is what a tensor core given
float32 operands in TF32 mode computes, and it reads the same on the card
and on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["RefGraph", "ref_graph", "Precision", "matmul", "aggregate", "attend",
           "segment_max", "segment_sum", "feature_dropout", "attention_dropout_scale",
           "draw_seed", "adam_step", "EDGE_BLOCK"]

#: Edges per block in the aggregations: a block of 2**20 edges at 256 features
#: holds 1 GiB of gathered rows.
EDGE_BLOCK = 1 << 20


@dataclasses.dataclass
class RefGraph:
    """The real edges of the benchmark's graph, on one device, and its sizes."""

    senders: torch.Tensor    # int64 [E]
    receivers: torch.Tensor  # int64 [E]
    weight: torch.Tensor     # f32 [E], the row-normalised adjacency
    n_pad: int


def ref_graph(arrays: dict, device) -> RefGraph:
    """The real edges of the twin's arrays (``harness.twin``), re-derived
    from them: the padding edges are dropped."""
    e = int(arrays["n_edge"])
    return RefGraph(
        senders=torch.from_numpy(arrays["senders"][:e].astype(np.int64)).to(device),
        receivers=torch.from_numpy(arrays["receivers"][:e].astype(np.int64)).to(device),
        weight=torch.from_numpy(arrays["weight"][:e]).to(device),
        n_pad=int(arrays["n_node_pad"]),
    )


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest, ties to even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        da = g @ round_tf32(b).t() if ctx.needs_input_grad[0] else None
        db = round_tf32(a).t() @ g if ctx.needs_input_grad[1] else None
        return da, db


@dataclasses.dataclass(frozen=True)
class Precision:
    """``"float32"`` (TF32 off) or ``"tf32"`` (the control)."""

    name: str = "float32"

    def __post_init__(self):
        if self.name not in ("float32", "tf32"):
            raise ValueError(f"unknown precision {self.name!r}")


def matmul(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    if prec.name == "tf32":
        return _TF32MatMul.apply(a, b)
    return a @ b


class _Aggregate(torch.autograd.Function):
    """``out[r] = Σ_{e: r_e = r} w_e · h[s_e]`` over blocks of edges; the
    backward is the same sum over the transposed edges."""

    @staticmethod
    def forward(ctx, h, g: RefGraph):
        ctx.g = g
        out = h.new_zeros((g.n_pad, h.shape[1]))
        for lo in range(0, g.senders.shape[0], EDGE_BLOCK):
            sl = slice(lo, lo + EDGE_BLOCK)
            out.index_add_(0, g.receivers[sl], h.index_select(0, g.senders[sl]) * g.weight[sl, None])
        return out

    @staticmethod
    def backward(ctx, go):
        g = ctx.g
        dh = go.new_zeros((g.n_pad, go.shape[1]))
        for lo in range(0, g.senders.shape[0], EDGE_BLOCK):
            sl = slice(lo, lo + EDGE_BLOCK)
            dh.index_add_(0, g.senders[sl], go.index_select(0, g.receivers[sl]) * g.weight[sl, None])
        return dh, None


def aggregate(h: torch.Tensor, g: RefGraph) -> torch.Tensor:
    """``Â h`` with the row-normalised adjacency, differentiable in ``h``."""
    return _Aggregate.apply(h, g)


class _Attend(torch.autograd.Function):
    """``out[r, k, f] = Σ_{e: r_e = r} p[e, k] · v[s_e, k, f]`` over blocks of
    edges, differentiable in ``v [N, H, F]`` and ``p [E, H]``; nothing of
    edge size is kept for the backward but ``p``."""

    @staticmethod
    def forward(ctx, v, p, g: RefGraph):
        ctx.g = g
        ctx.save_for_backward(v, p)
        out = v.new_zeros((g.n_pad, *v.shape[1:]))
        for lo in range(0, g.senders.shape[0], EDGE_BLOCK):
            sl = slice(lo, lo + EDGE_BLOCK)
            out.index_add_(0, g.receivers[sl], v.index_select(0, g.senders[sl]) * p[sl, :, None])
        return out

    @staticmethod
    def backward(ctx, go):
        v, p = ctx.saved_tensors
        g = ctx.g
        dv = torch.zeros_like(v)
        dp = torch.empty_like(p)
        for lo in range(0, g.senders.shape[0], EDGE_BLOCK):
            sl = slice(lo, lo + EDGE_BLOCK)
            gr = go.index_select(0, g.receivers[sl])
            dv.index_add_(0, g.senders[sl], gr * p[sl, :, None])
            dp[sl] = (gr * v.index_select(0, g.senders[sl])).sum(-1)
        return dv, dp, None


def attend(v: torch.Tensor, p: torch.Tensor, g: RefGraph) -> torch.Tensor:
    return _Attend.apply(v, p, g)


def segment_max(e: torch.Tensor, rows: torch.Tensor, n_rows: int):
    """Per-row maximum, -1e30 for a row without edges (as the program)."""
    m = e.new_full((n_rows, e.shape[1]), -1e30)
    return m.scatter_reduce(0, rows[:, None].expand_as(e), e, "amax", include_self=True)


def segment_sum(e: torch.Tensor, rows: torch.Tensor, n_rows: int):
    return e.new_zeros((n_rows, *e.shape[1:])).index_add_(0, rows, e)


def feature_dropout(h: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout from one ``[N_pad, F]`` draw of ``generator``."""
    u = torch.rand(h.shape, generator=generator, device=h.device)
    return torch.where(u >= rate, h / (1.0 - rate), 0.0)


# The attention-dropout hash: a murmur3 finaliser over a key mixed from the
# edge's global sender and receiver, the head and the seed (32-bit words held
# in int64).
_K_SND, _K_RCV, _K_HEAD = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35
_F1, _F2, _M32 = 0x7FEB352D, 0x846CA68B, 0xFFFFFFFF


def _mul32(x, k):
    lo = x * (k & 0xFFFF)
    hi = ((x * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix(x):
    x = x ^ (x >> 16)
    x = _mul32(x, _F1)
    x = x ^ (x >> 15)
    x = _mul32(x, _F2)
    return x ^ (x >> 16)


def attention_dropout_scale(seed: int, senders, receivers, heads: int, rate: float):
    """``[E, H]`` f32: ``1/(1-rate)`` (rounded as f32 division) where the
    edge and head are kept, 0 where dropped."""
    s = _mul32(senders & _M32, _K_SND)
    r = _mul32(receivers & _M32, _K_RCV)
    h = _mul32(torch.arange(heads, dtype=torch.int64, device=senders.device), _K_HEAD)
    x = _fmix((s ^ r)[:, None] ^ h[None, :] ^ (int(seed) & _M32))
    keep = (x >> 8) < int(round((1.0 - rate) * (1 << 24)))
    inv = float(np.float32(1.0) / np.float32(1.0 - rate))
    return torch.where(keep, inv, 0.0).to(torch.float32)


def draw_seed(generator: torch.Generator) -> int:
    """One dropout seed in ``[0, 2**32)`` from a CPU generator."""
    return int(torch.randint(0, 1 << 32, (), generator=generator, dtype=torch.int64))


def adam_step(params: dict, grads: dict, state: dict, *, lr: float, weight_decay: float,
              betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    """One Adam step with L2 weight decay added to the gradient; updates
    ``params`` and ``state`` in place and returns the gradients as Adam took
    them (weight decay included)."""
    b1, b2 = betas
    state["t"] = t = state.get("t", 0) + 1
    taken = {}
    for k, p in params.items():
        g = grads[k] + weight_decay * p
        taken[k] = g
        m = state.setdefault(("m", k), torch.zeros_like(p))
        v = state.setdefault(("v", k), torch.zeros_like(p))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (v / (1 - b2 ** t)).sqrt_().add_(eps)
        p.sub_(lr * (m / (1 - b1 ** t)) / denom)
    return taken
