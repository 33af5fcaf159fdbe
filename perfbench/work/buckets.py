"""Bytes and FLOPs of one call of the CSR kernel's bucket modes (B2, B2-w),
copied from the port's ``chip_smoke.py`` (``spmm_work``,
``weighted_bucket_work``): each input read once, each output written once
(and read too when the call adds into it)."""


def b2(n_rows: int, n_edge: int, f: int, accumulate: bool):
    """``out (+)= A x``: f32 x and out, int64 row pointers, int32 columns, f32 weights."""
    n_bytes = (3 if accumulate else 2) * n_rows * f * 4 + (n_rows + 1) * 8 + n_edge * 8
    return n_bytes, 2 * n_edge * f + (n_rows * f if accumulate else 0)


def b2w(n_rows: int, n_edge: int, h: int, f: int, accumulate: bool):
    """``out (+)= A(pv) x`` at H = ``h``, F = ``f``: f32 x and out, int64 row
    pointers, int32 columns, the f32 ``[L, H]`` numerators."""
    n_bytes = ((3 if accumulate else 2) * n_rows * h * f * 4 + (n_rows + 1) * 8 + n_edge * 4
               + n_edge * h * 4)
    return n_bytes, 2 * n_edge * h * f + (n_rows * h * f if accumulate else 0)


def ring(parts: int, rank: int, bucket_edges, block: int, call, backward_accumulates=True):
    """The calls of one ring aggregation on ``rank``: forward hop k reduces
    bucket ``[rank, (rank + k) % P]``, adding from the second hop on; the
    backward hop k reduces bucket ``[rank, (rank + k + 1) % P]``'s CSC view,
    adding from the second hop on when ``backward_accumulates``.
    ``call(n_rows, n_edge, accumulate)`` gives one call's (bytes, flops)."""
    fwd = [call(block, int(bucket_edges[rank][(rank + k) % parts]), k > 0) for k in range(parts)]
    bwd = [call(block, int(bucket_edges[rank][(rank + k + 1) % parts]),
                backward_accumulates and k > 0) for k in range(parts)]
    return fwd, bwd
