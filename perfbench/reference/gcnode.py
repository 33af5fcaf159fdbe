"""The edge-partitioned GCN-ODE of config 4, as one plain PyTorch model on
one device over the whole graph.

ReLU encoder ``relu(Â x W_in + b_in)``, feature dropout, classic rk4 over
``t ∈ [0, t1]`` in ``steps`` steps of ``dh/dt = tanh(Â h W_dyn + b_dyn)``,
feature dropout, readout ``log_softmax(Â h W_out + b_out)``.  Each dropout
mask is one ``[N_pad, F]`` uniform draw of the dropout generator, in that
order.  Each dynamics evaluation is recomputed in the backward
(``torch.utils.checkpoint``), which keeps the reference small on the card
and changes none of its values.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from perfbench.reference.common import aggregate, feature_dropout, matmul

__all__ = ["param_shapes", "forward"]


def param_shapes(cfg: dict, f_in: int, n_class: int) -> dict:
    """``{name: (shape, glorot)}`` in the model's order; ``glorot`` False: zeros."""
    h = cfg["hidden"]
    return {
        "w_in": ((f_in, h), True), "b_in": ((h,), False),
        "w_dyn": ((h, h), True), "b_dyn": ((h,), False),
        "w_out": ((h, n_class), True), "b_out": ((n_class,), False),
    }


def forward(p: dict, g, x: torch.Tensor, cfg: dict, prec, drop_gen=None, seed_gen=None):
    """Log-probs ``[N_pad, C]``; dropout when ``drop_gen`` is given."""
    del seed_gen
    rate = cfg["dropout"]
    h = torch.relu(aggregate(matmul(x, p["w_in"], prec), g) + p["b_in"])
    if drop_gen is not None:
        h = feature_dropout(h, rate, drop_gen)

    def dyn(h):
        return torch.tanh(aggregate(matmul(h, p["w_dyn"], prec), g) + p["b_dyn"])

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
    return torch.log_softmax(aggregate(matmul(h, p["w_out"], prec), g) + p["b_out"], dim=-1)
