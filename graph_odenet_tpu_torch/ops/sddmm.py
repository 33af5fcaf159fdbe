"""SDDMM + masked softmax + SpMM: the sparse-attention sandwich.

Counterpart of ``graph_odenet_tpu/ops/sddmm.py``:

    Wh   = h @ W
    e_ij = LeakyReLU(a_srcᵀ Wh_i + a_dstᵀ Wh_j)      # edge_scores
    α    = softmax_j(e_ij)                            # per receiver
    h'_i = Σ_j α_ij · Wh_j                            # attention_aggregate

``attention_aggregate`` dispatches on the adjacency:

  * ``Graph``     -> ``segment_softmax`` + gather + ``segment_sum`` (plain
                     PyTorch), with the counter-hash dropout of
                     ``ops/dropmask.py``;
  * ``CSRGraph``  -> the autograd Functions of ``ops/gat_attn.py``, which
                     launch the CUDA kernels on the card and run their plain
                     versions on CPU tensors.

Both apply identical dropout masks for the same seed.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from graph_odenet_tpu_torch.graph import Graph
from graph_odenet_tpu_torch.ops import gat_attn
from graph_odenet_tpu_torch.ops.csr_spmm import CSRGraph
from graph_odenet_tpu_torch.ops.dropmask import attention_dropout_scale
from graph_odenet_tpu_torch.ops.segment import gather, segment_softmax, segment_sum

__all__ = ["edge_scores", "attention_aggregate"]


def edge_scores(
    g: Union[Graph, CSRGraph], s_src: torch.Tensor, s_dst: torch.Tensor, *,
    negative_slope: float = 0.2,
) -> torch.Tensor:
    """Per-edge logits ``LeakyReLU(s_src[sender] + s_dst[receiver])``.

    ``s_src``, ``s_dst``: ``[N_pad, H]``.  Returns ``[E_pad, H]`` for a Graph
    (padding edges included; they are masked downstream) and ``[E, H]`` in
    CSR order for a CSRGraph.
    """
    e = gather(s_src, g.senders) + gather(s_dst, g.receivers)
    return torch.nn.functional.leaky_relu(e, negative_slope)


def attention_aggregate(
    g: Union[Graph, CSRGraph],
    logits: torch.Tensor,
    values: torch.Tensor,
    *,
    dropout_seed: Optional[int] = None,
    dropout_rate: float = 0.0,
    dmask: Optional[torch.Tensor] = None,
    scores: Optional[tuple] = None,
    negative_slope: float = 0.2,
) -> torch.Tensor:
    """Softmax over incoming edges, then the attention-weighted value sum.

    Args:
      logits: ``[E, H]`` edge logits in Graph (= CSR) order.
      values: ``[N_pad, H, F]`` per-head node values.
      dropout_seed, dropout_rate: post-softmax attention dropout, the counter
        hash of ``ops/dropmask.py`` (GAT convention: D scales α after the
        softmax).
      dmask: an explicit ``[E, H]`` α scale instead.
      scores: optional ``(s_src, s_dst)`` with ``logits == edge_scores(g,
        s_src, s_dst, negative_slope=negative_slope)``: lets the kernel
        backward recompute α in CSC order.  A speed hint; gradients flow
        through ``logits``.

    Returns ``[N_pad, H, F]``.
    """
    drop = dropout_seed is not None and dropout_rate > 0.0
    if isinstance(g, CSRGraph):
        if drop and scores is not None:
            return gat_attn.gat_aggregate_kernel_scores_dropout(
                g, negative_slope, dropout_rate, logits, values, scores[0], scores[1],
                dropout_seed,
            )
        if drop:
            dmask = attention_dropout_scale(
                dropout_seed, g.senders, g.receivers, logits.shape[1], dropout_rate
            )
        if dmask is not None:
            return gat_attn.gat_aggregate_kernel_dropout(g, logits, values, dmask)
        if scores is not None:
            return gat_attn.gat_aggregate_kernel_scores(
                g, negative_slope, logits, values, scores[0], scores[1]
            )
        return gat_attn.gat_aggregate_kernel(g, logits, values)

    alpha = segment_softmax(logits, g.receivers, g.n_node_pad, mask=g.edge_mask()[:, None])
    if drop:
        alpha = alpha * attention_dropout_scale(
            dropout_seed, g.senders, g.receivers, alpha.shape[1], dropout_rate
        )
    elif dmask is not None:
        alpha = alpha * dmask
    msgs = gather(values, g.senders) * alpha[..., None].to(values.dtype)
    return segment_sum(msgs, g.receivers, g.n_node_pad)
