"""The run's last lines: each number compared beside its limit on standard
error, then one JSON object on standard output."""

from __future__ import annotations

import json
import sys

__all__ = ["FORBIDDEN", "forbidden_modules", "emit"]

#: Top-level module names that no process of a run may hold, compared whole
#: (``graph_odenet_tpu_torch`` is the measured port, ``graph_odenet_tpu`` the
#: JAX package it was ported from).
FORBIDDEN = ("jax", "jaxlib", "flax", "graph_odenet_tpu")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def emit(result: dict, checks: dict) -> None:
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks}), flush=True)
