"""B2 (``csrc/csr_spmm.cu``, bucket mode): Σ bound / Σ device time of its launches."""

from perfbench.metrics._roofline import bucket_roofline


def read(ctx):
    return bucket_roofline(ctx, "b2")
