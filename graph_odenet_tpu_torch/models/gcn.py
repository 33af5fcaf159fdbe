"""GCN: graph convolution layer, 2-layer classifier and its residual variant.

Counterpart of ``graph_odenet_tpu/models/gcn.py``.  A layer is
``out = spmm(Â, x W) + b``: a bias-free ``Linear``, the aggregation, then a
separate bias, with Glorot-uniform weights and zero bias as in the JAX
package.  ``adj`` is any representation ``ops.spmm`` takes: a ``Graph``, a
``CSRGraph`` (the CUDA kernel) or a dense Â.

Initialisation draws from an explicit ``torch.Generator`` on the CPU (move
the module to its device afterwards); dropout draws from an explicit
generator on the features' device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from graph_odenet_tpu_torch.ops import spmm

__all__ = ["GCNLayer", "GCN", "ResGCN", "dropout"]


def dropout(
    x: torch.Tensor, rate: float, *, deterministic: bool, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """Inverted dropout: keep with probability ``1 - rate``, scale by its inverse."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs an explicit torch.Generator on the features' device")
    keep = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class GCNLayer(nn.Module):
    """``h' = Â (h W) + b``, one graph convolution."""

    def __init__(
        self, in_features: int, features: int, use_bias: bool = True,
        *, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.linear = nn.Linear(in_features, features, bias=False)
        limit = math.sqrt(6.0 / (in_features + features))  # Glorot uniform
        with torch.no_grad():
            self.linear.weight.uniform_(-limit, limit, generator=generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, adj, x: torch.Tensor) -> torch.Tensor:
        out = spmm(adj, self.linear(x))
        if self.bias is not None:
            out = out + self.bias
        return out


class GCN(nn.Module):
    """2-layer GCN: relu(gc1(x)) -> dropout -> gc2 -> log_softmax."""

    def __init__(
        self, in_features: int, hidden: int = 16, n_class: int = 7, dropout: float = 0.5,
        *, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dropout = dropout
        self.layers = nn.ModuleList([
            GCNLayer(in_features, hidden, generator=generator),
            GCNLayer(hidden, n_class, generator=generator),
        ])

    def forward(self, adj, x, *, deterministic: bool = True, generator=None):
        h = torch.relu(self.layers[0](adj, x))
        h = dropout(h, self.dropout, deterministic=deterministic, generator=generator)
        h = self.layers[1](adj, h)
        return torch.log_softmax(h, dim=-1)


class ResGCN(nn.Module):
    """Residual GCN: input conv, ``n_blocks`` blocks ``h <- h + relu(Â h W)``,
    readout conv.  Its continuous-depth limit is ``GCNODE``."""

    def __init__(
        self, in_features: int, hidden: int = 16, n_class: int = 7, n_blocks: int = 2,
        dropout: float = 0.5, *, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dropout = dropout
        self.layers = nn.ModuleList(
            [GCNLayer(in_features, hidden, generator=generator)]
            + [GCNLayer(hidden, hidden, generator=generator) for _ in range(n_blocks)]
            + [GCNLayer(hidden, n_class, generator=generator)]
        )

    def forward(self, adj, x, *, deterministic: bool = True, generator=None):
        kw = dict(deterministic=deterministic, generator=generator)
        h = torch.relu(self.layers[0](adj, x))
        for layer in self.layers[1:-1]:
            h = dropout(h, self.dropout, **kw)
            h = h + torch.relu(layer(adj, h))
        h = dropout(h, self.dropout, **kw)
        h = self.layers[-1](adj, h)
        return torch.log_softmax(h, dim=-1)
