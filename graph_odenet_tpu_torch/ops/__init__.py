"""Aggregation ops: segment primitives, the CSR SpMM kernel and its dispatch."""

from graph_odenet_tpu_torch.ops.csr_spmm import (  # noqa: F401
    CSRGraph,
    prepare,
    spmm_csr,
    spmm_csr_reference,
)
from graph_odenet_tpu_torch.ops.segment import gather, segment_sum  # noqa: F401
from graph_odenet_tpu_torch.ops.spmm import spmm, spmm_segment  # noqa: F401
