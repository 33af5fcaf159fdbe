"""Whole runs on the CPU at a small size: the program against the reference
comes out correct; with the timed path broken underneath (``harness.faults``),
``correct`` comes out false, once for each fault a training cell can have."""

import sys
import types

import pytest
import torch

from perfbench.harness.faults import planted
from perfbench.tests._cells import GAT1, GCN1, GCN4, run, run_small


@pytest.fixture
def restore_program():
    with planted(None):
        yield


@pytest.mark.parametrize("cell", [GCN1, GAT1, GCN4])
def test_clean_run_is_correct(cell, capfd):
    rc, result, _ = run_small(cell, capfd)
    assert rc == 0 and result["correct"], result
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"epoch_ms", "peak_mem_gb", "setup_s"}
    assert list(result)[-1] == "checks"
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell,fault", [
    (GCN1, "state_unchanged"), (GCN1, "half_batch"),
    (GAT1, "state_unchanged"), (GAT1, "half_batch"),
    (GCN4, "state_unchanged"), (GCN4, "half_batch"), (GCN4, "no_exchange"),
])
def test_a_broken_path_is_not_correct(cell, fault, capfd, restore_program):
    rc, result, _ = run_small(cell, capfd, fault=fault)
    assert rc == 0 and result is not None
    assert result["correct"] is False, result["checks"]


def test_a_module_of_jax_loaded_by_the_check_prints_no_result(capfd, monkeypatch):
    """The look for JAX's modules is made again after the check, which
    imports the reference once the window has closed."""
    from perfbench.drivers import sharded

    real = sharded.run_steps

    def loads_jax(*args, **kwargs):
        sys.modules["jax"] = types.ModuleType("jax")
        return real(*args, **kwargs)

    monkeypatch.setattr(sharded, "run_steps", loads_jax)
    try:
        rc, result, _ = run_small(GCN1, capfd)
    finally:
        sys.modules.pop("jax", None)
    assert rc == 4 and result is None


def test_traced_run_reports_per_layer_metrics_only(capfd):
    rc, result, _ = run_small(GCN1, capfd, trace=1)
    assert rc == 0 and result["correct"]
    assert not set(result["metrics"]) & {"epoch_ms", "peak_mem_gb", "setup_s"}
    assert result["device"]["window_s"] > 0 and "breakdown" in result


def test_no_card_no_result(capfd):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", GCN1, "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capfd.readouterr()
    assert rc == 3 and out.out == ""
