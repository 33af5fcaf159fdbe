"""Tracing and profiling hooks.

Counterpart of ``graph_odenet_tpu/utils/profiling.py``:

  ``trace(logdir)``   ``torch.profiler.profile`` around a block (the card's
                      kernels too, when there is one), written into
                      ``logdir`` as a Chrome trace (``chrome://tracing``,
                      Perfetto).
  ``annotate(name)``  the program's span: while a torch profiler records,
                      ``torch.profiler.record_function(name)``, a named range
                      on the trace's host timeline, as ``jax.named_scope``
                      is; otherwise a shared no-op context behind one check
                      of a flag (a bare ``record_function`` costs tens of
                      times more with no profiler running).
  ``debug_nans(on)``  ``torch.autograd.set_detect_anomaly(on, check_nan=True)``.
                      Anomaly mode checks the backward only: a function whose
                      gradient is NaN raises, naming the forward call that
                      made it.  JAX's ``jax_debug_nans`` checks every
                      operation; for the forward of a solve use
                      ``utils.sanitize.odeint_checked``.

The program's spans (``SPANS``), every name beginning with ``gode.``, so
that no span reads as a CUDA call (``cu...``) or as the profiler's own
``ProfilerStep#``.  The profiler ties each kernel to the host range it was
launched in, and each backward node to the forward op it differentiates
(``sequence_nr``), so the kernels of a backward count under the spans of
its forward (``perfbench/harness/spans.py``):

  ``gode.train.step``      ``parallel.trainer``: one training step (zero_grad,
                           forward, backward, the gradients' all-reduce, Adam)
  ``gode.train.evaluate``  ``parallel.trainer``: one evaluation
  ``gode.train.loss_read`` ``parallel.trainer``: the epoch's read of its loss
                           on the host, which waits for the step
  ``gode.train.eval_read`` ``parallel.trainer``: the evaluation's reads of its
                           three numbers on the host
  ``gode.bucket_reduce``   ``ops.csr_spmm.bucket_reduce``: one bucket-mode
                           reduction (B2, B2-w), forward or backward, around
                           its launch (on a CPU tensor, its plain version)
  ``gode.gat.softmax``     ``parallel.sharded_gat.gat_sharded``: the attention's
                           softmax (score gather, logits, segment max, exp,
                           denominators, dropout scale); in ``ring`` mode two
                           a hop, the denominators' update apart
  ``gode.b2w.dpv``         ``parallel.halo``: B2-w's backward for the
                           numerators, ``dpv``
  ``gode.gat.recompute``   ``parallel.sharded_gat.gatode_forward`` under
                           ``remat``: each dynamics evaluation's recomputation
                           in the backward

What reads them: ``gode.train.step`` and ``gode.train.evaluate`` bound the
trainer's device time; the device's idle time under ``gode.train.loss_read``
and ``gode.train.eval_read`` is ``sync_idle_ms``; ``gode.bucket_reduce``,
``gode.gat.softmax``, ``gode.b2w.dpv`` and ``gode.gat.recompute`` give
``bucket_reduce_ms``, ``gat_softmax_ms``, ``gat_dpv_ms`` and
``gat_recompute_ms``, the device ms of an epoch under each.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["trace", "annotate", "debug_nans", "SPANS"]

SPANS = (
    "gode.train.step", "gode.train.evaluate", "gode.train.loss_read", "gode.train.eval_read",
    "gode.bucket_reduce", "gode.gat.softmax", "gode.b2w.dpv", "gode.gat.recompute",
)

_OFF = contextlib.nullcontext()


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
    """A named range while a torch profiler records; a no-op otherwise."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def debug_nans(on: bool = True) -> None:
    torch.autograd.set_detect_anomaly(on, check_nan=True)
