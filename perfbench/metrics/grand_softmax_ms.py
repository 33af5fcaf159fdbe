"""Device ms per epoch under ``gode.grand.softmax``: GRAND-nl's scale of the
scores, segment max, exp, denominators, normalisation and mean over heads,
with their backward; the largest over ranks."""

from perfbench.metrics._spans import span_ms


def read(ctx):
    return span_ms(ctx, "gode.grand.softmax")
