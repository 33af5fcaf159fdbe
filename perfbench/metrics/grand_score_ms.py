"""Device ms per epoch under ``gode.grand.score``: GRAND-nl's score pass, the
keys' all-gather and each bucket's per-edge dot (``edge_dot``) forward, and
the two B2-w reductions of the scores' gradients with their gather into CSC
order; the largest over ranks."""

from perfbench.metrics._spans import span_ms


def read(ctx):
    return span_ms(ctx, "gode.grand.score")
