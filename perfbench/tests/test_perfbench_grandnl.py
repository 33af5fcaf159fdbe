"""GRAND-nl's cell (``ogbn-arxiv-grandnl-sharded.train.1chip``) on the CPU at a
small size: the twin at a hundredth of arxiv, 4 heads of 8.  A clean run is
correct; with the timed path broken underneath (``harness.faults``) it is
not, nor is the reference in TF32 (the control); ``work/grandnl.py`` counts the
bucket-kernel calls a traced run shows and the FLOPs by hand."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from perfbench.drivers.sharded import init_params
from perfbench.harness import compare
from perfbench.harness.faults import planted
from perfbench.harness.twin import load_twin
from perfbench.reference.train import run_steps
from perfbench.work import grandnl

PERFBENCH = Path(__file__).resolve().parents[1]
if str(PERFBENCH) not in sys.path:
    sys.path.insert(0, str(PERFBENCH))

import run  # noqa: E402

CELL = "ogbn-arxiv-grandnl-sharded.train.1chip"
CONFIG = json.loads((PERFBENCH / "configs" / "ogbn-arxiv-grandnl-sharded.json").read_text())
SMALL = dict(twin=dict(CONFIG["twin"], scale=0.01), trainer=dict(CONFIG["trainer"], hidden=8))
LIMITS = json.loads((PERFBENCH / "workloads" / f"{CELL}.json").read_text())["limits"]


def _run(capfd, *, trace=0, fault=None, seed=3_000_000_001):
    argv = ["--workload", CELL, "--seed", str(seed), "--seconds", "1", "--trace", str(trace)]
    rc = run.main(argv, require_cuda=False, device="cpu", fault=fault, config_overrides=SMALL)
    out = capfd.readouterr()
    lines = out.out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None), out.err


@pytest.fixture
def restore_program():
    with planted(None):
        yield


def test_clean_run_is_correct(capfd):
    rc, result, _ = _run(capfd)
    assert rc == 0 and result["correct"], result
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"epoch_ms", "peak_mem_gb", "setup_s"}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_path_is_not_correct(fault, capfd, restore_program):
    rc, result, _ = _run(capfd, fault=fault)
    assert rc == 0 and result is not None
    assert result["correct"] is False, result["checks"]


def test_traced_run_reads_the_three_spans_and_counts_every_bucket_call(capfd):
    """The per-layer metrics of the cell are the three span readers'; the
    stretch's ``gode.bucket_reduce`` instances equal ``work/grandnl.py``'s
    count for its steps and evaluations (the span check)."""
    rc, result, err = _run(capfd, trace=1)
    assert rc == 0 and result["correct"], result
    assert set(result["metrics"]) == {"grand_score_ms", "grand_softmax_ms", "grand_aggregate_ms"}
    (line,) = [ln for ln in err.splitlines() if ln.startswith("span check rank0.bucket_instances")]
    words = line.split()
    assert int(words[3]) == int(words[5]) > 0 and words[6] == "ok", line


@pytest.mark.parametrize("seed", [5, 4_294_967_311])
def test_tf32_control_is_not_correct(seed):
    """The reference in TF32 (the precision next below the configuration's
    float32) against itself in float32 at the small size: finite numbers,
    and not correct against the cell's own limits."""
    arrays = load_twin(SMALL["twin"])
    trainer = SMALL["trainer"]
    params0 = init_params("grandnl", trainer, arrays["features"].shape[1], int(arrays["n_class"]),
                          seed, "cpu")
    kw = dict(seed=seed, steps=3, device="cpu")
    ref = run_steps("grandnl", arrays, trainer, params0, **kw)
    control = run_steps("grandnl", arrays, trainer, params0, precision="tf32", **kw)
    numbers = compare.gaps(control, ref, params0)
    for k in ("loss", "grad1", "change"):
        assert np.isfinite(numbers[k]), numbers
    correct, checks = compare.judge(numbers, LIMITS)
    assert not correct, checks


def test_bucket_calls_by_hand():
    """At P = 1 a training step launches 64 B2-w (16 aggregations, 16 value
    gradients, 32 score gradients) and an evaluation 16; at P = 2 each
    evaluation's score gradients take two calls a bucket."""
    shape = dict(n_pad=8, n_edge=10, f_in=4, n_class=3, bucket_edges=[[10]])
    cfg = dict(hidden=2, heads=3, steps=4)
    ((train, evaluation),) = grandnl.bucket_calls(cfg, shape, 1, 0).values()
    assert (len(train), len(evaluation)) == (64, 16)
    assert train[:4] == [(2 * 8 * 6 * 4 + 72 + 40 + 40, 2 * 10 * 6),  # aggregation, H = 1
                         (2 * 8 * 6 * 4 + 72 + 40 + 40, 2 * 10 * 6),  # its value gradient
                         (2 * 8 * 6 * 4 + 72 + 40 + 120, 2 * 10 * 6),  # dq at H = 3, F = 2
                         (2 * 8 * 6 * 4 + 72 + 40 + 120, 2 * 10 * 6)]  # dk
    shape2 = dict(shape, bucket_edges=[[6, 4], [3, 7]])
    ((train, evaluation),) = grandnl.bucket_calls(cfg, shape2, 2, 1).values()
    assert (len(train), len(evaluation)) == (16 * 8, 16 * 2)


def test_flops_by_hand():
    cfg = dict(hidden=1, heads=2, steps=1)  # D = 2, 4 evaluations
    n, e, f_in, c, d = 8, 10, 4, 3, 2
    shape = dict(n_pad=n, n_edge=e, f_in=f_in, n_class=c, bucket_edges=[[e]])
    # forward: encoder and readout products; each evaluation Q and K, the
    # scores, 7 per edge and head, the aggregation
    fwd = 2 * n * f_in * d + 2 * n * d * c + 4 * (2 * 2 * n * d * d + 2 * e * d + 7 * e * 2
                                                   + 2 * e * d)
    # backward: the encoder's weight gradient alone, the readout's both, Q's
    # and K's both; the scores' and the aggregation's two gradients each
    bwd = 2 * n * f_in * d + 4 * n * d * c + 4 * (2 * 4 * n * d * d + 4 * e * d + 7 * e * 2
                                                  + 4 * e * d)
    assert grandnl.flops(cfg, shape) == (fwd + bwd, fwd)
