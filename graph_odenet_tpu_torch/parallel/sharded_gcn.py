"""Edge-parallel GCN-ODE: encoder conv → rk4 graph-conv dynamics → readout.

Counterpart of ``graph_odenet_tpu/parallel/sharded_gcn.py`` (config 4's
model).  Every aggregation goes through ``halo.spmm_sharded``; every rank
holds its node block's rows of every ``[N, F]`` array and a replica of the
parameters.  The parameters are the JAX package's, by name and in its
``[in, out]`` layout (``convert.params_from_sharded``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from graph_odenet_tpu_torch.parallel.halo import spmm_sharded
from graph_odenet_tpu_torch.parallel.mesh import all_reduce_grads, all_reduce_sum, world
from graph_odenet_tpu_torch.parallel.model_parts import feature_dropout, glorot, rk4
from graph_odenet_tpu_torch.parallel.partition import PartitionedGraph

__all__ = [
    "ShardedGCNODE", "init_params", "forward", "forward_with", "loss_fn", "train_step",
    "shard_batch",
]


class ShardedGCNODE(nn.Module):
    """The parameters ``w_in [f_in, hidden]``, ``b_in``, ``w_dyn [hidden,
    hidden]``, ``b_dyn``, ``w_out [hidden, n_class]``, ``b_out``: Glorot
    uniform weights drawn from ``generator`` on the CPU, zero biases, every
    leaf in ``dtype`` (the weights drawn in float32 and rounded once: a
    bfloat16 model holds the float32 model's weights of the same seed,
    rounded).  With bfloat16 parameters and features every aggregation takes
    B2's bf16 entry; the log-probs are bf16 and ``loss_fn`` sums the NLL in
    float32 (the labels are float32)."""

    def __init__(self, f_in: int, hidden: int, n_class: int, *, generator=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w_in = glorot(f_in, hidden, generator, dtype)
        self.b_in = nn.Parameter(torch.zeros(hidden, dtype=dtype))
        self.w_dyn = glorot(hidden, hidden, generator, dtype)
        self.b_dyn = nn.Parameter(torch.zeros(hidden, dtype=dtype))
        self.w_out = glorot(hidden, n_class, generator, dtype)
        self.b_out = nn.Parameter(torch.zeros(n_class, dtype=dtype))


def init_params(f_in: int, hidden: int, n_class: int, *, generator=None,
                dtype: torch.dtype = torch.float32) -> ShardedGCNODE:
    return ShardedGCNODE(f_in, hidden, n_class, generator=generator, dtype=dtype)


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

    h = rk4(dyn, h, steps, t1)
    if drop is not None:
        h = drop(h)
    return torch.log_softmax(agg(h @ p.w_out) + p.b_out, dim=-1)


def forward(
    params: ShardedGCNODE, pg: PartitionedGraph, x: torch.Tensor, *, steps: int = 4,
    t1: float = 1.0, mode: str = "ring", dropout: float = 0.0,
    generator: Optional[torch.Generator] = None, group=None,
) -> torch.Tensor:
    """Log-probs of the rank's node block ``[B, C]``; ``x`` is its rows.

    ``dropout``/``generator``: feature dropout on training steps (pass a
    generator on the features' device, seeded alike on every rank).
    ``group``: the process group the blocks are spread over (the default
    group when None).
    """
    _, me = world(group)
    drop = lambda h: feature_dropout(h, dropout, generator, pg, me)  # noqa: E731
    agg = lambda h: spmm_sharded(pg, h, mode=mode, group=group)  # noqa: E731
    return forward_with(params, agg, x, steps=steps, t1=t1, drop=drop)


def loss_fn(params, pg, x, labels_1h, weight, *, total_weight=None, group=None,
            **kw) -> torch.Tensor:
    """The rank's share of the masked NLL: its sum over its rows divided by
    the global weight (``total_weight``; all-reduced from ``weight`` over
    ``group`` when not given).  The shares sum to the JAX package's loss."""
    lp = forward(params, pg, x, group=group, **kw)
    if total_weight is None:
        total_weight = all_reduce_sum(weight.sum().detach(), group)
    return -(lp * labels_1h).sum(-1).mul(weight).sum() / torch.clamp(total_weight, min=1.0)


def train_step(params, pg, x, labels_1h, weight, *, lr: float = 0.01, group=None, **kw):
    """One SGD step on the global loss over ``group`` (the default group
    when None); returns ``(params, loss)``, with the loss all-reduced."""
    params.zero_grad(set_to_none=True)
    loss = loss_fn(params, pg, x, labels_1h, weight, group=group, **kw)
    loss.backward()
    all_reduce_grads(params, group)
    with torch.no_grad():
        for p in params.parameters():
            p -= lr * p.grad
    return params, all_reduce_sum(loss.detach(), group)


def shard_batch(n_parts: int, rank: int, *arrays):
    """The rank's rows of each array (node block ``rank`` of ``n_parts``)."""
    out = []
    for a in arrays:
        b = a.shape[0] // n_parts
        out.append(a[rank * b:(rank + 1) * b])
    return tuple(out)
