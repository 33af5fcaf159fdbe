"""One process per chip for a cell that asks for several.

Every rank runs ``drivers/<kind>.run_rank(spec, rank, world)`` in a process
of its own, started with the ``spawn`` method; the ranks join one process
group through a file store in a fresh directory under ``TMPDIR``.  The
parent waits for every rank, ends any that outlives ``timeout``, and
returns rank 0's exit code, or the first other rank's that failed.
"""

from __future__ import annotations

import importlib
import multiprocessing
import os
import sys
import tempfile

__all__ = ["run_ranks"]


def _rank_main(driver: str, spec, rank: int, world: int) -> None:
    mod = importlib.import_module(f"perfbench.drivers.{driver}")
    sys.exit(mod.run_rank(spec, rank, world))


def run_ranks(driver: str, spec, world: int, timeout: float = 900.0) -> int:
    if world == 1:
        mod = importlib.import_module(f"perfbench.drivers.{driver}")
        return mod.run_rank(spec, 0, 1)
    store = tempfile.mkdtemp(prefix="perfbench-store-")
    spec.init_method = f"file://{os.path.join(store, 'store')}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(driver, spec, r, world)) for r in range(world)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        for name in os.listdir(store):
            os.unlink(os.path.join(store, name))
        os.rmdir(store)
    codes = [p.exitcode for p in procs]
    return codes[0] if codes[0] else next((c for c in codes if c), 0)
