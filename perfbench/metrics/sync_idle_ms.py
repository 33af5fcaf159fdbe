"""Device idle ms per epoch put down to the trainer's host reads
(``gode.train.loss_read``, ``gode.train.eval_read``): the device ran dry
while the host waited for a number; the largest over ranks."""

from perfbench.metrics._spans import span_ms


def read(ctx):
    return span_ms(ctx, "gode.train.loss_read", "gode.train.eval_read", key="idle_ns")
