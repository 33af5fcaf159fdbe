"""Tracing and profiling hooks.

Counterpart of ``graph_odenet_tpu/utils/profiling.py``:

  ``trace(logdir)``   ``torch.profiler.profile`` around a block (the card's
                      kernels too, when there is one), written into
                      ``logdir`` as a Chrome trace (``chrome://tracing``,
                      Perfetto).
  ``annotate(name)``  ``torch.profiler.record_function``: the block shows as a
                      named range in the trace, as ``jax.named_scope`` does.
  ``debug_nans(on)``  ``torch.autograd.set_detect_anomaly(on, check_nan=True)``.
                      Anomaly mode checks the backward only: a function whose
                      gradient is NaN raises, naming the forward call that
                      made it.  JAX's ``jax_debug_nans`` checks every
                      operation; for the forward of a solve use
                      ``utils.sanitize.odeint_checked``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "annotate", "debug_nans"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; on exit write ``logdir/trace_<pid>_<ns>.json``.
    Yields the ``torch.profiler.profile`` object."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


def debug_nans(on: bool = True) -> None:
    torch.autograd.set_detect_anomaly(on, check_nan=True)
