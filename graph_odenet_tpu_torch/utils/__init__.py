"""Metrics and logging."""

from graph_odenet_tpu_torch.utils.logging import MetricsLogger  # noqa: F401
from graph_odenet_tpu_torch.utils.metrics import accuracy, masked_accuracy, masked_nll  # noqa: F401
