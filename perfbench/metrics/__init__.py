"""One reader per per-layer metric, ``<metric>.py`` with ``read(ctx)``: the
metric's value, or None where the traced stretch holds nothing for it to
read (the harness then leaves the metric out of the line).

``ctx`` (``drivers/sharded.py``) holds for the traced stretch: ``chips``;
``steps`` and ``evaluations`` (training steps and evaluations in it);
``ranks``, each rank's ``harness.trace.summarise``; ``flops``, the model
FLOPs of a training step and of an evaluation (``work/<model>.py``);
``bucket``, each rank's bucket-kernel calls of a training step and of an
evaluation by mode (``"b2"``, ``"b2w"``)."""
