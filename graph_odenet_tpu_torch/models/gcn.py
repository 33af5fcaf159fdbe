"""GCN: graph convolution layer, 2-layer classifier and its residual variant.

Counterpart of ``graph_odenet_tpu/models/gcn.py``.  A layer is
``out = spmm(Â, x W) + b``: a bias-free ``Linear``, the aggregation, then a
separate bias, with Glorot-uniform weights and zero bias as in the JAX
package.  ``adj`` is any representation ``ops.spmm`` takes: a ``Graph``, a
``CSRGraph`` (the CUDA kernel) or a dense Â.

Initialisation draws from an explicit ``torch.Generator`` on the CPU (move
the module to its device afterwards); dropout draws from an explicit
generator on the features' device.

``dtype`` and ``param_dtype`` are flax's: parameters are stored in
``param_dtype`` (initialised in float32, then rounded), and each layer
computes ``x W`` with both operands in ``dtype``.  With ``dtype=
torch.bfloat16`` the features, the aggregation (the CSR kernel in bf16)
and the layer outputs are bf16; the bias is cast to the output's dtype
before it is added, and ``log_softmax`` runs in float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from graph_odenet_tpu_torch.ops import spmm
from graph_odenet_tpu_torch.ops.csr_spmm import widen

__all__ = ["GCNLayer", "GCN", "ResGCN", "Typed", "dense", "dropout"]


class Typed(nn.Module):
    """A module that computes in ``self.dtype`` (flax's ``dtype``).

    A conversion of the whole module (``.double()``, ``.to(dtype)``)
    converts ``dtype`` as it converts the floating parameters, so a module
    held in float64 computes in float64."""

    dtype = torch.float32

    def _apply(self, fn, *args, **kwargs):
        module = super()._apply(fn, *args, **kwargs)
        self.dtype = fn(torch.zeros((), dtype=self.dtype)).dtype
        return module


def dense(x: torch.Tensor, linear: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax's ``Dense``: ``x W (+ b)`` with input, kernel and bias in ``dtype``."""
    bias = None if linear.bias is None else linear.bias.to(dtype)
    return nn.functional.linear(x.to(dtype), linear.weight.to(dtype), bias)


def dropout(
    x: torch.Tensor, rate: float, *, deterministic: bool, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """Inverted dropout: keep with probability ``1 - rate``, scale by its inverse."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs an explicit torch.Generator on the features' device")
    # The draw is at least float32, so a bf16 model drops what an f32 one does.
    draw = torch.promote_types(x.dtype, torch.float32)
    keep = torch.rand(x.shape, generator=generator, device=x.device, dtype=draw) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class GCNLayer(Typed):
    """``h' = Â (h W) + b``, one graph convolution."""

    def __init__(
        self, in_features: int, features: int, use_bias: bool = True,
        *, dtype: torch.dtype = torch.float32, param_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.linear = nn.Linear(in_features, features, bias=False)
        limit = math.sqrt(6.0 / (in_features + features))  # Glorot uniform
        with torch.no_grad():
            self.linear.weight.uniform_(-limit, limit, generator=generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.to(param_dtype)
        self.dtype = dtype

    def forward(self, adj, x: torch.Tensor) -> torch.Tensor:
        out = spmm(adj, dense(x, self.linear, self.dtype))
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out


class GCN(nn.Module):
    """2-layer GCN: relu(gc1(x)) -> dropout -> gc2 -> log_softmax."""

    def __init__(
        self, in_features: int, hidden: int = 16, n_class: int = 7, dropout: float = 0.5,
        *, dtype: torch.dtype = torch.float32, param_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dropout = dropout
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.layers = nn.ModuleList([
            GCNLayer(in_features, hidden, **kw),
            GCNLayer(hidden, n_class, **kw),
        ])

    def forward(self, adj, x, *, deterministic: bool = True, generator=None):
        h = torch.relu(self.layers[0](adj, x))
        h = dropout(h, self.dropout, deterministic=deterministic, generator=generator)
        h = self.layers[1](adj, h)
        return torch.log_softmax(widen(h), dim=-1)


class ResGCN(nn.Module):
    """Residual GCN: input conv, ``n_blocks`` blocks ``h <- h + relu(Â h W)``,
    readout conv.  Its continuous-depth limit is ``GCNODE``."""

    def __init__(
        self, in_features: int, hidden: int = 16, n_class: int = 7, n_blocks: int = 2,
        dropout: float = 0.5, *, dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dropout = dropout
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.layers = nn.ModuleList(
            [GCNLayer(in_features, hidden, **kw)]
            + [GCNLayer(hidden, hidden, **kw) for _ in range(n_blocks)]
            + [GCNLayer(hidden, n_class, **kw)]
        )

    def forward(self, adj, x, *, deterministic: bool = True, generator=None):
        kw = dict(deterministic=deterministic, generator=generator)
        h = torch.relu(self.layers[0](adj, x))
        for layer in self.layers[1:-1]:
            h = dropout(h, self.dropout, **kw)
            h = h + torch.relu(layer(adj, h))
        h = dropout(h, self.dropout, **kw)
        h = self.layers[-1](adj, h)
        return torch.log_softmax(widen(h), dim=-1)
