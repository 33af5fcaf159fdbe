"""Runs of the benchmark's cells on the CPU at a small size, for the tests:
the twin at a hundredth of arxiv, the models narrow, the harness's look for
a card skipped."""

import json
import sys
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parents[1]
if str(PERFBENCH) not in sys.path:
    sys.path.insert(0, str(PERFBENCH))

import run  # noqa: E402

GCN1 = "ogbn-arxiv-gcnode-sharded.train.1chip"
GAT1 = "ogbn-arxiv-gatode-sharded.train.1chip"
GCN4 = "ogbn-arxiv-gcnode-sharded.train.4chip"  # not in BENCHMARK.json yet (PERF.md §7)
WIDTH = {"gcnode": 16, "gatode": 8}


def small_config(name: str) -> dict:
    cfg = json.loads((PERFBENCH / "configs" / f"{name}.json").read_text())
    trainer = dict(cfg["trainer"], hidden=WIDTH[cfg["trainer"]["model"]])
    return dict(twin=dict(cfg["twin"], scale=0.01), trainer=trainer)


def _four_chip_manifest():
    """``BENCHMARK.json`` with config 4 over four parts (``traffic/train.4chip``)
    added as a cell, and that cell's own numbers: the one-chip cell's."""
    bench = json.loads((PERFBENCH.parent / "BENCHMARK.json").read_text())
    one = GCN4.replace("4chip", "1chip")
    bench["workloads"].append(dict(name=GCN4, config=one.split(".train")[0],
                                   traffic="train.4chip", chips=4, why="tests"))
    return bench, json.loads((PERFBENCH / "workloads" / f"{one}.json").read_text())


def run_small(cell: str, capfd, *, seed=3_000_000_001, trace=0, fault=None):
    """``(exit code, the result's JSON or None)``."""
    bench, own = _four_chip_manifest() if cell == GCN4 else (None, None)
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "1", "--trace", str(trace)],
                  require_cuda=False, device="cpu", fault=fault,
                  config_overrides=small_config(cell.split(".train")[0]), bench=bench, own=own)
    lines = capfd.readouterr().out.strip().splitlines()
    result = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
    return rc, result
