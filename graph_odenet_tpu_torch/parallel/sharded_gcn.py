"""Edge-parallel GCN-ODE: encoder conv → rk4 graph-conv dynamics → readout.

Counterpart of ``graph_odenet_tpu/parallel/sharded_gcn.py`` (config 4's
model).  Every aggregation goes through ``halo.spmm_sharded``; every rank
holds its node block's rows of every ``[N, F]`` array and a replica of the
parameters.  The parameters are the JAX package's, by name and in its
``[in, out]`` layout (``convert.params_from_sharded``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from graph_odenet_tpu_torch.parallel.halo import spmm_sharded
from graph_odenet_tpu_torch.parallel.mesh import world
from graph_odenet_tpu_torch.parallel.partition import PartitionedGraph

__all__ = [
    "ShardedGCNODE", "init_params", "forward", "forward_with", "loss_fn", "train_step",
    "shard_batch", "all_reduce_grads", "all_reduce_sum",
]


def _glorot(fan_in: int, fan_out: int, generator) -> nn.Parameter:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.empty(fan_in, fan_out).uniform_(-limit, limit, generator=generator)
    return nn.Parameter(w)


class ShardedGCNODE(nn.Module):
    """The parameters ``w_in [f_in, hidden]``, ``b_in``, ``w_dyn [hidden,
    hidden]``, ``b_dyn``, ``w_out [hidden, n_class]``, ``b_out``: Glorot
    uniform weights drawn from ``generator`` on the CPU, zero biases."""

    def __init__(self, f_in: int, hidden: int, n_class: int, *, generator=None):
        super().__init__()
        self.w_in = _glorot(f_in, hidden, generator)
        self.b_in = nn.Parameter(torch.zeros(hidden))
        self.w_dyn = _glorot(hidden, hidden, generator)
        self.b_dyn = nn.Parameter(torch.zeros(hidden))
        self.w_out = _glorot(hidden, n_class, generator)
        self.b_out = nn.Parameter(torch.zeros(n_class))


def init_params(f_in: int, hidden: int, n_class: int, *, generator=None) -> ShardedGCNODE:
    return ShardedGCNODE(f_in, hidden, n_class, generator=generator)


def _feature_dropout(h, rate, generator, rows: slice, n_global: int):
    """Inverted dropout with the rank's rows of one global ``[N_pad, F]``
    mask, so the mask does not depend on the partitioning: every rank draws
    the whole mask from an identically seeded generator."""
    u = torch.rand((n_global, h.shape[1]), generator=generator, device=h.device)[rows]
    return torch.where(u >= rate, h / (1.0 - rate), 0.0)


def forward_with(
    params: ShardedGCNODE, agg: Callable, x: torch.Tensor, *, steps: int = 4,
    t1: float = 1.0, drop: Optional[Callable] = None,
) -> torch.Tensor:
    """The model with any aggregation ``agg`` (``h -> Â h`` on the rank's
    rows) and feature dropout ``drop`` (after the encoder and after the ODE
    block; None in evaluation).  Classic rk4, as the JAX model."""
    p = params
    h = torch.relu(agg(x @ p.w_in) + p.b_in)
    if drop is not None:
        h = drop(h)

    def dyn(h):
        return torch.tanh(agg(h @ p.w_dyn) + p.b_dyn)

    dt = t1 / steps
    for _ in range(steps):
        k1 = dyn(h)
        k2 = dyn(h + 0.5 * dt * k1)
        k3 = dyn(h + 0.5 * dt * k2)
        k4 = dyn(h + dt * k3)
        h = h + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    if drop is not None:
        h = drop(h)
    return torch.log_softmax(agg(h @ p.w_out) + p.b_out, dim=-1)


def forward(
    params: ShardedGCNODE, pg: PartitionedGraph, x: torch.Tensor, *, steps: int = 4,
    t1: float = 1.0, mode: str = "ring", dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Log-probs of the rank's node block ``[B, C]``; ``x`` is its rows.

    ``dropout``/``generator``: feature dropout on training steps (pass a
    generator on the features' device, seeded alike on every rank).
    """
    _, me = world()
    drop = None
    if dropout > 0.0 and generator is not None:
        rows = slice(me * pg.block_size, (me + 1) * pg.block_size)
        drop = lambda h: _feature_dropout(h, dropout, generator, rows, pg.n_node_pad)  # noqa: E731
    agg = lambda h: spmm_sharded(pg, h, mode=mode)  # noqa: E731
    return forward_with(params, agg, x, steps=steps, t1=t1, drop=drop)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks in place (nothing with one part); returns ``t``."""
    if world()[0] > 1:
        dist.all_reduce(t)
    return t


def loss_fn(params, pg, x, labels_1h, weight, *, total_weight=None, **kw) -> torch.Tensor:
    """The rank's share of the masked NLL: its sum over its rows divided by
    the global weight (``total_weight``; all-reduced from ``weight`` when
    not given).  The shares sum to the JAX package's loss."""
    lp = forward(params, pg, x, **kw)
    if total_weight is None:
        total_weight = all_reduce_sum(weight.sum().detach())
    return -(lp * labels_1h).sum(-1).mul(weight).sum() / torch.clamp(total_weight, min=1.0)


def all_reduce_grads(params: nn.Module) -> None:
    """Sum every parameter gradient over the ranks (one collective)."""
    if world()[0] == 1:
        return
    grads = [p.grad for p in params.parameters()]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))


def train_step(params, pg, x, labels_1h, weight, *, lr: float = 0.01, **kw):
    """One SGD step on the global loss; returns ``(params, loss)``, with the
    loss all-reduced."""
    params.zero_grad(set_to_none=True)
    loss = loss_fn(params, pg, x, labels_1h, weight, **kw)
    loss.backward()
    all_reduce_grads(params)
    with torch.no_grad():
        for p in params.parameters():
            p -= lr * p.grad
    return params, all_reduce_sum(loss.detach())


def shard_batch(n_parts: int, rank: int, *arrays):
    """The rank's rows of each array (node block ``rank`` of ``n_parts``)."""
    out = []
    for a in arrays:
        b = a.shape[0] // n_parts
        out.append(a[rank * b:(rank + 1) * b])
    return tuple(out)
