"""Device ms per epoch under ``gode.grand.aggregate``: GRAND-nl's forward ring
of B2-w over x(t) chunks, ``Ā(X) X``.  Its backward launches count where the
GAT-ODE's do (``harness/spans.py``): the value gradient's B2-w under
``gode.bucket_reduce``, the weights' per-edge dot under ``gode.b2w.dpv``,
and only what they launch outside those spans (the gather of the weights
into CSC order) here; the largest over ranks."""

from perfbench.metrics._spans import span_ms


def read(ctx):
    return span_ms(ctx, "gode.grand.aggregate")
