"""Metrics, logging, the entry points' device, checkpoints, sanitizers and
profiling hooks."""

from graph_odenet_tpu_torch.utils.checkpoint import Checkpointer  # noqa: F401
from graph_odenet_tpu_torch.utils.device import resolve_device  # noqa: F401
from graph_odenet_tpu_torch.utils.logging import MetricsLogger  # noqa: F401
from graph_odenet_tpu_torch.utils.metrics import accuracy, masked_accuracy, masked_nll  # noqa: F401
from graph_odenet_tpu_torch.utils.profiling import annotate, debug_nans, trace  # noqa: F401
from graph_odenet_tpu_torch.utils.sanitize import odeint_checked, validate_tiling  # noqa: F401
