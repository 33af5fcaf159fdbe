"""Device ms per epoch under ``gode.gat.recompute``: remat's recomputation of
the GAT-ODE's dynamics evaluations in the backward; the largest over ranks."""

from perfbench.metrics._spans import span_ms


def read(ctx):
    return span_ms(ctx, "gode.gat.recompute")
