"""SpMM: sparse adjacency times dense features.

Counterpart of ``graph_odenet_tpu/ops/spmm.py``.  Dispatch on the adjacency
representation:

  * ``Graph``     -> gather + ``segment_sum`` (plain PyTorch);
  * ``CSRGraph``  -> ``spmm_csr``, the hand-written CUDA kernel
                     (``ops/csr_spmm.py``);
  * dense tensor  -> one ``torch.matmul`` against ``[N_pad, N_pad]`` Â.
"""

from __future__ import annotations

from typing import Union

import torch

from graph_odenet_tpu_torch.graph import Graph
from graph_odenet_tpu_torch.ops.csr_spmm import CSRGraph, spmm_csr
from graph_odenet_tpu_torch.ops.segment import gather, segment_sum

__all__ = ["spmm", "spmm_segment"]


def spmm_segment(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """out[r] = sum over edges e with receivers[e] = r of weight[e] * x[senders[e]].

    Padding edges have weight 0, so no mask is needed.
    """
    msgs = gather(x, g.senders) * g.weight[:, None].to(x.dtype)
    return segment_sum(msgs, g.receivers, g.n_node_pad)


def spmm(adj: Union[Graph, CSRGraph, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Aggregate node features ``x [N_pad, F]`` over the normalised adjacency."""
    if isinstance(adj, Graph):
        return spmm_segment(adj, x)
    if isinstance(adj, CSRGraph):
        return spmm_csr(adj, x)
    return torch.matmul(adj.to(x.dtype), x)
