"""Device ms per epoch under ``gode.b2w.dpv``: B2-w's backward for the
attention numerators (two gathers, their product and the per-head sum);
the largest over ranks."""

from perfbench.metrics._spans import span_ms


def read(ctx):
    return span_ms(ctx, "gode.b2w.dpv")
