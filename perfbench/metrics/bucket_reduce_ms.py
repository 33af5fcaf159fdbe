"""Device ms per epoch under ``gode.bucket_reduce``: every bucket-mode call
(B2, B2-w), forward and backward, whatever kernel it launches; the largest
over ranks."""

from perfbench.metrics._spans import span_ms


def read(ctx):
    return span_ms(ctx, "gode.bucket_reduce")
