"""Aggregation ops: segment primitives, the CSR SpMM kernel, GAT attention."""

from graph_odenet_tpu_torch.ops.csr_spmm import (  # noqa: F401
    CSRGraph,
    prepare,
    spmm_csr,
    spmm_csr_reference,
)
from graph_odenet_tpu_torch.ops.sddmm import attention_aggregate, edge_scores  # noqa: F401
from graph_odenet_tpu_torch.ops.segment import (  # noqa: F401
    gather,
    segment_max,
    segment_mean,
    segment_softmax,
    segment_sum,
)
from graph_odenet_tpu_torch.ops.spmm import spmm, spmm_segment  # noqa: F401
