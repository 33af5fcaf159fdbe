"""Structured per-step metrics as JSONL with wall-clock stamps.

Counterpart of ``graph_odenet_tpu/utils/logging.py``.
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Optional

__all__ = ["MetricsLogger"]


class MetricsLogger:
    """Append-only JSONL metrics stream.

    >>> log = MetricsLogger("runs/gcn.jsonl", echo=True)
    >>> log.write(epoch=0, loss=1.94, val_acc=0.31)
    """

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._fh: Optional[IO] = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._t0 = time.time()

    def write(self, **metrics):
        """Record one step; tensors become floats (which waits for the device)."""
        rec = {"t": round(time.time() - self._t0, 4), **{
            k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()
        }}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
        if self.echo:
            print(" ".join(f"{k}={v}" for k, v in rec.items()))
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
