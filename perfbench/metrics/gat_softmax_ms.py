"""Device ms per epoch under ``gode.gat.softmax``: the sharded GAT's score
gather, logits, segment max, exp, denominators and dropout scale, their
backward, and their recomputation under remat; the largest over ranks."""

from perfbench.metrics._spans import span_ms


def read(ctx):
    return span_ms(ctx, "gode.gat.softmax")
