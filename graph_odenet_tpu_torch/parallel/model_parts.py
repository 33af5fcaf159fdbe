"""What the sharded tier's models (``sharded_gcn``, ``sharded_gat``,
``sharded_grand``) share: Glorot weights, feature dropout, classic rk4."""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

__all__ = ["glorot", "feature_dropout", "rk4"]


def glorot(fan_in: int, fan_out: int, generator, dtype=torch.float32) -> nn.Parameter:
    """Glorot uniform, drawn in float32 and rounded once to ``dtype``."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.empty(fan_in, fan_out).uniform_(-limit, limit, generator=generator)
    return nn.Parameter(w.to(dtype))


def feature_dropout(h, rate, generator, pg, rank: int):
    """Inverted dropout at ``rate`` with node block ``rank``'s rows of one
    global ``[pg.n_node_pad, F]`` mask, so the mask does not depend on the
    partitioning: every rank draws the whole mask from an identically seeded
    ``generator``.  ``h`` itself at rate 0 or without a generator (evaluation)."""
    if not (rate > 0.0 and generator is not None):
        return h
    rows = slice(rank * pg.block_size, (rank + 1) * pg.block_size)
    u = torch.rand((pg.n_node_pad, h.shape[1]), generator=generator, device=h.device)[rows]
    return torch.where(u >= rate, h / (1.0 - rate), 0.0)


def rk4(dyn: Callable, h: torch.Tensor, steps: int, t1: float) -> torch.Tensor:
    """``steps`` steps of classic rk4 from ``h`` over ``[0, t1]``, four
    evaluations of ``dyn`` each, as the JAX package's sharded models take
    them (``ode.odeint``'s ``rk4`` is the 3/8 rule)."""
    dt = t1 / steps
    for _ in range(steps):
        k1 = dyn(h)
        k2 = dyn(h + 0.5 * dt * k1)
        k3 = dyn(h + 0.5 * dt * k2)
        k4 = dyn(h + dt * k3)
        h = h + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return h
