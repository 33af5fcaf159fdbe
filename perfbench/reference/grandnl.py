"""GRAND-nl (Chamberlain et al. 2021, arXiv:2106.10934; the non-linear form
with attention recomputed at each evaluation), as one plain PyTorch model on
one device over the whole graph.

``dX/dt = σ(α) · (Ā(X) − I) X + β · X(0)``, with ``Ā(X)`` the mean over
H heads of each receiver's softmax over its in-edges of ``⟨Q_h x_r, K_h
x_s⟩ / √d_k`` (``Q``, ``K`` linear with bias, d_k = ``hidden``; the maximum
taken without a gradient).  Linear encoder, classic rk4 over ``[0, t1]``,
ReLU, linear readout, ``log_softmax``.  Feature dropout on the input and
after the ReLU, each one ``[N_pad, F]`` draw.  The edge scores and the
aggregation go over blocks of ``EDGE_BLOCK`` edges, keeping nothing of edge
size for the backward but the scores and weights.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.common import (
    EDGE_BLOCK, attend, feature_dropout, matmul, segment_max, segment_sum,
)

__all__ = ["param_shapes", "forward"]


def param_shapes(cfg: dict, f_in: int, n_class: int) -> dict:
    d = cfg["hidden"] * cfg["heads"]
    return {
        "w_enc": ((f_in, d), True), "b_enc": ((d,), False),
        "w_q": ((d, d), True), "b_q": ((d,), False),
        "w_k": ((d, d), True), "b_k": ((d,), False),
        "alpha": ((), False), "beta": ((), False),
        "w_out": ((d, n_class), True), "b_out": ((n_class,), False),
    }


class _Scores(torch.autograd.Function):
    """``s[e, h] = Σ_f q[r_e, h, f] · k[s_e, h, f]`` over blocks of edges,
    differentiable in ``q`` and ``k [N, H, F]``."""

    @staticmethod
    def forward(ctx, q, k, g):
        ctx.g = g
        ctx.save_for_backward(q, k)
        out = q.new_empty((g.senders.shape[0], q.shape[1]))
        for lo in range(0, g.senders.shape[0], EDGE_BLOCK):
            sl = slice(lo, lo + EDGE_BLOCK)
            qr, ks = q.index_select(0, g.receivers[sl]), k.index_select(0, g.senders[sl])
            out[sl] = (qr * ks).sum(-1)
        return out

    @staticmethod
    def backward(ctx, ds):
        q, k = ctx.saved_tensors
        g = ctx.g
        dq, dk = torch.zeros_like(q), torch.zeros_like(k)
        for lo in range(0, g.senders.shape[0], EDGE_BLOCK):
            sl = slice(lo, lo + EDGE_BLOCK)
            d = ds[sl, :, None]
            dq.index_add_(0, g.receivers[sl], d * k.index_select(0, g.senders[sl]))
            dk.index_add_(0, g.senders[sl], d * q.index_select(0, g.receivers[sl]))
        return dq, dk, None


def scores(q: torch.Tensor, k: torch.Tensor, g) -> torch.Tensor:
    return _Scores.apply(q, k, g)


def _dynamics(p, g, h, h0, heads, prec):
    n, d = h.shape
    d_k = d // heads
    q = (matmul(h, p["w_q"], prec) + p["b_q"]).view(n, heads, d_k)
    k = (matmul(h, p["w_k"], prec) + p["b_k"]).view(n, heads, d_k)
    e = scores(q, k, g) / math.sqrt(d_k)
    m = segment_max(e.detach(), g.receivers, g.n_pad)
    num = torch.exp(e - m.index_select(0, g.receivers))
    den = segment_sum(num, g.receivers, g.n_pad)
    a = (num / den.index_select(0, g.receivers)).mean(-1, keepdim=True)  # [E, 1]
    ah = attend(h[:, None, :], a, g).view(n, d)
    return torch.sigmoid(p["alpha"]) * (ah - h) + p["beta"] * h0


def forward(p: dict, g, x: torch.Tensor, cfg: dict, prec, drop_gen=None, seed_gen=None):
    rate = cfg["dropout"]
    if drop_gen is not None:
        x = feature_dropout(x, rate, drop_gen)
    h0 = matmul(x, p["w_enc"], prec) + p["b_enc"]
    h, dt = h0, cfg["t1"] / cfg["steps"]
    for _ in range(cfg["steps"]):
        k1 = _dynamics(p, g, h, h0, cfg["heads"], prec)
        k2 = _dynamics(p, g, h + 0.5 * dt * k1, h0, cfg["heads"], prec)
        k3 = _dynamics(p, g, h + 0.5 * dt * k2, h0, cfg["heads"], prec)
        k4 = _dynamics(p, g, h + dt * k3, h0, cfg["heads"], prec)
        h = h + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    h = torch.relu(h)
    if drop_gen is not None:
        h = feature_dropout(h, rate, drop_gen)
    return torch.log_softmax(matmul(h, p["w_out"], prec) + p["b_out"], dim=-1)
