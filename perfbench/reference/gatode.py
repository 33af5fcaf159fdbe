"""The edge-partitioned GAT-ODE, as one plain PyTorch model on one device
over the whole graph.

Each attention layer: ``Wh = h W`` split into H heads of F, scores
``s_src = Σ_f Wh·a_src`` and ``s_dst = Σ_f Wh·a_dst``, per edge ``e =
leaky_relu(s_src[sender] + s_dst[receiver], 0.2)``, the softmax over each
receiver's in-edges (the maximum taken without a gradient), attention dropout
on the numerators only (the counter hash on global sender and receiver ids,
its seed one draw of the CPU seed generator), output ``Σ_e p_e Wh[s_e] /
Σ_e p_e``.  ELU encoder with H heads (attention dropout), single-head tanh
dynamics under classic rk4, single-head readout, ``log_softmax``.  Feature
dropout on the input and after the ODE block, each one ``[N_pad, F]`` draw.
Each dynamics evaluation is recomputed in the backward, as the program's
``remat`` does; that changes no value.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from perfbench.reference.common import (
    attend, attention_dropout_scale, draw_seed, feature_dropout, matmul, segment_max, segment_sum,
)

__all__ = ["param_shapes", "forward"]


def param_shapes(cfg: dict, f_in: int, n_class: int) -> dict:
    h, k = cfg["hidden"], cfg["heads"]
    d = h * k
    return {
        "w_enc": ((f_in, d), True), "a_src_enc": ((k, h), True), "a_dst_enc": ((k, h), True),
        "w_dyn": ((d, d), True), "a_src_dyn": ((1, d), True), "a_dst_dyn": ((1, d), True),
        "w_out": ((d, n_class), True), "a_src_out": ((1, n_class), True),
        "a_dst_out": ((1, n_class), True),
    }


def _layer(g, h, w, a_src, a_dst, prec, rate=0.0, seed=None):
    heads, feat = a_src.shape
    wh = matmul(h, w, prec).view(h.shape[0], heads, feat)
    s_src = (wh * a_src).sum(-1)
    s_dst = (wh * a_dst).sum(-1)
    e = torch.nn.functional.leaky_relu(
        s_src.index_select(0, g.senders) + s_dst.index_select(0, g.receivers), 0.2)
    m = segment_max(e.detach(), g.receivers, g.n_pad)
    p = torch.exp(e - m.index_select(0, g.receivers))
    l = segment_sum(p, g.receivers, g.n_pad)
    if seed is not None:
        p_v = p * attention_dropout_scale(seed, g.senders, g.receivers, heads, rate)
    else:
        p_v = p
    out = attend(wh, p_v, g) / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(h.shape[0], heads * feat)


def forward(p: dict, g, x: torch.Tensor, cfg: dict, prec, drop_gen=None, seed_gen=None):
    rate = cfg["dropout"]
    seed = None
    if drop_gen is not None:
        x = feature_dropout(x, rate, drop_gen)
        seed = draw_seed(seed_gen)
    h = torch.nn.functional.elu(_layer(g, x, p["w_enc"], p["a_src_enc"], p["a_dst_enc"], prec,
                                       rate=rate, seed=seed))

    def dyn(h):
        return torch.tanh(_layer(g, h, p["w_dyn"], p["a_src_dyn"], p["a_dst_dyn"], prec))

    def f(h):
        return checkpoint(dyn, h, use_reentrant=False) if torch.is_grad_enabled() else dyn(h)

    dt = cfg["t1"] / cfg["steps"]
    for _ in range(cfg["steps"]):
        k1 = f(h)
        k2 = f(h + 0.5 * dt * k1)
        k3 = f(h + 0.5 * dt * k2)
        k4 = f(h + dt * k3)
        h = h + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    if drop_gen is not None:
        h = feature_dropout(h, rate, drop_gen)
    return torch.log_softmax(_layer(g, h, p["w_out"], p["a_src_out"], p["a_dst_out"], prec), dim=-1)
