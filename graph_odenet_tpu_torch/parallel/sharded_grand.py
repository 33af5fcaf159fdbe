"""GRAND-nl, graph neural diffusion with attention recomputed at every
evaluation, over the edge partition.

GRAND (Chamberlain et al., "GRAND: Graph Neural Diffusion", ICML 2021,
arXiv:2106.10934), its non-linear form with a constant block (the authors'
``ODEFuncTransformerAtt``):

    dX/dt = σ(α) · (Ā(X) − I) X + β · X(0)
    Ā(X)_ij = mean_h softmax_{j ∈ N_in(i)} (⟨Q_h x_i, K_h x_j⟩ / √d_k)

``Q`` and ``K`` are linear maps with bias, split into H heads of d_k; α and
β are learned scalars.  Linear encoder, the ODE under classic rk4, ReLU,
linear readout, ``log_softmax``; feature dropout on the input and after the
ReLU, as the sharded GAT-ODE draws it (``sharded_gcn._feature_dropout``).

Each evaluation on a rank, ``Ā`` computed anew:

  1. Q and K of the block's rows (f32 products);
  2. K all-gathered once (``halo.all_gather_rows``: with one part nothing
     is posted; its backward reduce-scatters);
  3. every bucket scored by ``halo.bucket_scores`` (``edge_dot`` forward,
     two B2-w reductions backward), then one exact softmax a head over all
     the rank's edges (``sharded_gat.edge_softmax``), normalised and
     averaged over heads into one ``[E_p, 1]`` weight;
  4. ``ring_pallas``'s ring of B2-w over x(t) chunks at H = 1
     (``sharded_gat.weighted_ring``), with no division after it: ``Ā`` is
     normalised already;
  5. the σ(α) and β · X(0) terms.

Spans: ``gode.grand.score`` (step 2 and the scores, and the scores'
backward), ``gode.grand.softmax`` (step 3's scale, softmax, normalisation
and head mean), ``gode.grand.aggregate`` (step 4's forward ring).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from graph_odenet_tpu_torch.ops.csr_spmm import gather_rows
from graph_odenet_tpu_torch.parallel.halo import all_gather_rows, bucket_scores
from graph_odenet_tpu_torch.parallel.mesh import check_backend, world
from graph_odenet_tpu_torch.parallel.partition import PartitionedGraph
from graph_odenet_tpu_torch.parallel.sharded_gat import edge_softmax, weighted_ring
from graph_odenet_tpu_torch.parallel.sharded_gcn import _feature_dropout, _glorot
from graph_odenet_tpu_torch.utils.profiling import annotate

__all__ = ["ShardedGRANDNL", "init_grandnl_params", "grandnl_forward"]


class ShardedGRANDNL(nn.Module):
    """GRAND-nl's parameters at state width ``D = heads·hidden`` (d_k =
    ``hidden``): ``w_enc [f_in, D]``, ``b_enc``, ``w_q``, ``w_k [D, D]``,
    ``b_q``, ``b_k``, the scalars ``alpha`` and ``beta``, ``w_out [D,
    n_class]``, ``b_out``.  Glorot uniform weights drawn from ``generator``
    on the CPU in that order, zero biases, α = 0 and β = 1; float32."""

    def __init__(self, f_in: int, hidden: int, heads: int, n_class: int, *, generator=None):
        super().__init__()
        d = heads * hidden
        self.heads = heads
        self.w_enc = _glorot(f_in, d, generator)
        self.b_enc = nn.Parameter(torch.zeros(d))
        self.w_q = _glorot(d, d, generator)
        self.b_q = nn.Parameter(torch.zeros(d))
        self.w_k = _glorot(d, d, generator)
        self.b_k = nn.Parameter(torch.zeros(d))
        self.alpha = nn.Parameter(torch.tensor(0.0))
        self.beta = nn.Parameter(torch.tensor(1.0))
        self.w_out = _glorot(d, n_class, generator)
        self.b_out = nn.Parameter(torch.zeros(n_class))


def init_grandnl_params(f_in: int, hidden: int, heads: int, n_class: int, *,
                        generator=None) -> ShardedGRANDNL:
    return ShardedGRANDNL(f_in, hidden, heads, n_class, generator=generator)


def _attention(p: ShardedGRANDNL, pg: PartitionedGraph, h: torch.Tensor, group) -> torch.Tensor:
    """``Ā(h)`` on the rank's edges: ``[E_p, 1]`` weights in the block's edge order."""
    n_parts, me = world(group)
    B, heads = pg.block_size, p.heads
    d_k = h.shape[1] // heads
    blk = pg.blocks[me]
    q = h @ p.w_q + p.b_q
    k = h @ p.w_k + p.b_k
    with annotate("gode.grand.score"):
        k_all = all_gather_rows(k, group)
        s = [bucket_scores(q, k_all[b * B:(b + 1) * B], pg.bucket(me, b), heads, d_k,
                           rows=blk.receivers[blk.bucket(b)]) for b in range(n_parts)]
        s = s[0] if n_parts == 1 else torch.cat(s)  # [E_p, H]
    with annotate("gode.grand.softmax"):
        num, den = edge_softmax(s * (1.0 / math.sqrt(d_k)), blk.receivers, B)
        return (num / gather_rows(den, blk.receivers)).mean(-1, keepdim=True)


def grandnl_forward(
    params: ShardedGRANDNL, pg: PartitionedGraph, x: torch.Tensor, *, steps: int = 4,
    t1: float = 1.0, dropout: float = 0.0, generator: Optional[torch.Generator] = None,
    group=None,
) -> torch.Tensor:
    """Log-probs of the rank's node block ``[B, C]``; ``x`` is its rows (f32).

    ``steps`` rk4 steps over ``[0, t1]`` (4·steps evaluations, each
    recomputing the attention).  ``dropout`` with ``generator`` (on the
    features' device, seeded alike on every rank): feature dropout on the
    input and after the ODE block's ReLU from one global mask each; without
    ``generator`` nothing drops (evaluation).  ``group``: the process group
    the blocks are spread over (the default group when None); ``pg.n_parts``
    must equal its size (one part without a process group).
    """
    p = params
    n_parts, me = world(group)
    if pg.n_parts != n_parts:
        where = ("the default process group" if group is None else
                 f"the process group of ranks {dist.get_process_group_ranks(group)}")
        raise ValueError(f"partitioning has {pg.n_parts} parts, but {where} has {n_parts}")
    if x.shape[0] != pg.block_size:
        raise ValueError(f"grandnl_forward takes the block's rows [{pg.block_size}, F], "
                         f"got {tuple(x.shape)}")
    if n_parts > 1:
        check_backend(x, group)
    drop = dropout > 0.0 and generator is not None
    rows = slice(me * pg.block_size, (me + 1) * pg.block_size)
    if drop:
        x = _feature_dropout(x, dropout, generator, rows, pg.n_node_pad)
    h0 = x @ p.w_enc + p.b_enc
    d = h0.shape[1]

    def dyn(h):
        w = _attention(p, pg, h, group)
        with annotate("gode.grand.aggregate"):
            ah = weighted_ring(pg, h, w, d, group)
        return torch.sigmoid(p.alpha) * (ah - h) + p.beta * h0

    h, dt = h0, t1 / steps
    for _ in range(steps):
        k1 = dyn(h)
        k2 = dyn(h + 0.5 * dt * k1)
        k3 = dyn(h + 0.5 * dt * k2)
        k4 = dyn(h + dt * k3)
        h = h + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    h = torch.relu(h)
    if drop:
        h = _feature_dropout(h, dropout, generator, rows, pg.n_node_pad)
    return torch.log_softmax(h @ p.w_out + p.b_out, dim=-1)
