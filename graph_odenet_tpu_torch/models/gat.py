"""GAT: multi-head graph attention in edge-list (SDDMM) form.

Counterpart of ``graph_odenet_tpu/models/gat.py``.  Scores live only on the
edge list:

    e_ij = LeakyReLU(a_srcᵀWh_i + a_dstᵀWh_j)   (ops.edge_scores)
    α    = segment_softmax(e, receivers)
    h'   = segment_sum(α · Wh_src)               (ops.attention_aggregate)

``adj`` is a ``Graph`` (segment ops) or a ``CSRGraph`` (the GAT kernels).
Initialisation draws from an explicit CPU ``torch.Generator`` with flax's
Glorot fans; feature dropout draws from a generator on the features'
device; attention dropout takes one 32-bit seed per layer call, drawn from
``seed_generator``, a CPU generator, so a draw costs no device sync.

``dtype`` and ``param_dtype`` are flax's, as in ``models/gcn.py``: with
``dtype=torch.bfloat16``, Wh and the node scores are bf16 (the attention
vectors cast to Wh's dtype), the logits and the score tables become float32
before the aggregation, and the aggregation returns what its path returns:
float32 from the GAT kernels (a ``CSRGraph``), bf16 from the segment path
(a ``Graph``), as JAX's Pallas and segment paths do.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from graph_odenet_tpu_torch.models.gcn import Typed, dense, dropout
from graph_odenet_tpu_torch.ops import attention_aggregate, edge_scores
from graph_odenet_tpu_torch.ops.csr_spmm import widen
from graph_odenet_tpu_torch.ops.dropmask import draw_seed

__all__ = ["GATLayer", "GAT", "ResGAT"]


def _glorot_(t: torch.Tensor, fan_in: int, fan_out: int, generator) -> None:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.uniform_(-limit, limit, generator=generator)


class GATLayer(Typed):
    """Multi-head graph attention layer.

    Output is ``[N, heads*features]`` when ``concat`` else the head mean
    ``[N, features]``.  Parameters: ``linear.weight [H·F, in]`` (flax's
    DenseGeneral kernel ``[in, H, F]``, flattened and transposed),
    ``attn_src`` and ``attn_dst`` ``[1, H, F]``.
    """

    def __init__(
        self, in_features: int, features: int, heads: int = 8, concat: bool = True,
        negative_slope: float = 0.2, attn_dropout: float = 0.0,
        *, dtype: torch.dtype = torch.float32, param_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.heads, self.features = heads, features
        self.concat = concat
        self.negative_slope = negative_slope
        self.attn_dropout = attn_dropout
        self.linear = nn.Linear(in_features, heads * features, bias=False)
        self.attn_src = nn.Parameter(torch.empty(1, heads, features))
        self.attn_dst = nn.Parameter(torch.empty(1, heads, features))
        # flax's fans: DenseGeneral initialises its kernel flat as [in, H·F];
        # variance_scaling reads [1, H, F] as fan_in = H, fan_out = F.
        _glorot_(self.linear.weight, in_features, heads * features, generator)
        _glorot_(self.attn_src, heads, features, generator)
        _glorot_(self.attn_dst, heads, features, generator)
        self.to(param_dtype)
        self.dtype = dtype

    def forward(self, adj, x: torch.Tensor, *, deterministic: bool = True,
                seed_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n = x.shape[0]
        wh = dense(x, self.linear, self.dtype).view(n, self.heads, self.features)
        s_src = (wh * self.attn_src.to(wh.dtype)).sum(-1)
        s_dst = (wh * self.attn_dst.to(wh.dtype)).sum(-1)
        logits = edge_scores(adj, s_src, s_dst, negative_slope=self.negative_slope)
        seed = None
        if not deterministic and self.attn_dropout > 0.0:
            if seed_generator is None:
                raise ValueError("attention dropout needs a CPU seed_generator")
            seed = draw_seed(seed_generator)
        out = attention_aggregate(
            adj, widen(logits), wh, dropout_seed=seed,
            dropout_rate=0.0 if deterministic else self.attn_dropout,
            scores=(widen(s_src), widen(s_dst)), negative_slope=self.negative_slope,
        )
        if self.concat:
            return out.reshape(n, self.heads * self.features)
        return out.mean(1)


class GAT(nn.Module):
    """2-layer GAT classifier: 8×8 concat + ELU, then a head-averaged output
    layer and log_softmax."""

    def __init__(
        self, in_features: int, hidden: int = 8, heads: int = 8, out_heads: int = 1,
        n_class: int = 7, dropout: float = 0.6, *, dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dropout = dropout
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.layers = nn.ModuleList([
            GATLayer(in_features, hidden, heads=heads, attn_dropout=dropout, **kw),
            GATLayer(hidden * heads, n_class, heads=out_heads, concat=False,
                     attn_dropout=dropout, **kw),
        ])

    def forward(self, adj, x, *, deterministic: bool = True, generator=None, seed_generator=None):
        kw = dict(deterministic=deterministic, generator=generator)
        att = dict(deterministic=deterministic, seed_generator=seed_generator)
        x = dropout(x, self.dropout, **kw)
        h = nn.functional.elu(self.layers[0](adj, x, **att))
        h = dropout(h, self.dropout, **kw)
        h = self.layers[1](adj, h, **att)
        return torch.log_softmax(widen(h), dim=-1)


class ResGAT(nn.Module):
    """Residual GAT: projection, ``n_blocks`` of ``h ← h + elu(att(h))``,
    head-averaged readout."""

    def __init__(
        self, in_features: int, hidden: int = 8, heads: int = 8, n_class: int = 7,
        n_blocks: int = 2, dropout: float = 0.6, *, dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dropout = dropout
        dim = hidden * heads
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.layers = nn.ModuleList(
            [GATLayer(in_features, hidden, heads=heads, attn_dropout=dropout, **kw)]
            + [GATLayer(dim, dim, heads=1, concat=False, attn_dropout=dropout, **kw)
               for _ in range(n_blocks)]
            + [GATLayer(dim, n_class, heads=1, concat=False, **kw)]
        )

    def forward(self, adj, x, *, deterministic: bool = True, generator=None, seed_generator=None):
        kw = dict(deterministic=deterministic, generator=generator)
        att = dict(deterministic=deterministic, seed_generator=seed_generator)
        x = dropout(x, self.dropout, **kw)
        h = nn.functional.elu(self.layers[0](adj, x, **att))
        for layer in self.layers[1:-1]:
            h = dropout(h, self.dropout, **kw)
            h = h + nn.functional.elu(layer(adj, h, **att))
        h = dropout(h, self.dropout, **kw)
        h = self.layers[-1](adj, h, **att)
        return torch.log_softmax(widen(h), dim=-1)
