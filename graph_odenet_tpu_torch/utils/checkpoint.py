"""Checkpoint and resume.

Counterpart of ``graph_odenet_tpu/utils/checkpoint.py``, on ``torch.save`` /
``torch.load`` instead of orbax: a ``Checkpointer`` owns one directory, saves
a state (nested dicts, lists and tuples of tensors, numbers, strings and
``state_dict()``s, an optimizer's included) under a step number, and restores
the latest step or a given one.

One file a step, ``step_<n>.pt``.  A save writes a temporary file in the
same directory and renames it into place, so a process killed during a save
leaves the previous steps whole and no partial step visible.  Only the
newest ``max_to_keep`` steps are kept.  Tensors are saved from the host, and
loaded with ``weights_only=True``.

The port does not read orbax directories: weights trained by the JAX package
cross through ``graph_odenet_tpu_torch.convert``.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Optional

import torch

__all__ = ["Checkpointer"]

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _to_host(x):
    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _place(x, like):
    """``x`` with each tensor moved to the device of the tensor at the same
    place in ``like`` (where ``like`` has none, it stays on the host)."""
    if torch.is_tensor(x):
        return x.to(like.device) if torch.is_tensor(like) else x
    if isinstance(x, dict):
        like = like if isinstance(like, dict) else {}
        return {k: _place(v, like.get(k)) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        like = like if isinstance(like, (list, tuple)) and len(like) == len(x) else [None] * len(x)
        return type(x)(_place(v, w) for v, w in zip(x, like))
    return x


class Checkpointer:
    """Numbered checkpoints in ``directory``, the newest ``max_to_keep`` kept."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def steps(self) -> list[int]:
        """The saved steps, oldest first."""
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, state: Any, *, wait: bool = False) -> None:
        """Write ``state`` as ``step``.  Saves finish before they return, so
        ``wait`` (JAX's keyword, for orbax's asynchronous saves) changes nothing."""
        fd, tmp = tempfile.mkstemp(prefix=".step_", suffix=".tmp", dir=self.directory)
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(_to_host(state), f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(step))
        except BaseException:
            os.unlink(tmp)
            raise
        for old in self.steps()[: -self.max_to_keep]:
            os.unlink(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        """The state saved as ``step`` (default: the latest), each tensor on
        the device of its counterpart in ``state_like``.  Raises
        ``FileNotFoundError`` when the directory holds no step."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        state = torch.load(self._path(step), map_location="cpu", weights_only=True)
        return _place(state, state_like)

    def close(self) -> None:
        """Nothing is pending after a save; kept for JAX's interface."""
