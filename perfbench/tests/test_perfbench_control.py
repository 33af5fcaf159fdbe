"""The control: the reference in the program's place, computed in TF32 (the
precision next below the configurations' float32 with TF32 off), comes out
not correct against the cells' own limits, on three seeds at a small size."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.drivers.sharded import init_params
from perfbench.harness import compare
from perfbench.harness.twin import load_twin
from perfbench.reference.common import round_tf32
from perfbench.reference.train import run_steps
from perfbench.tests._cells import GAT1, GCN1, GCN4, small_config

PERFBENCH = Path(__file__).resolve().parents[1]


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0 - 2 ** -12])
    assert round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0, 1.0 + 2 * 2 ** -10, -3.0]


@pytest.mark.parametrize("cell", [GCN1, GAT1, GCN4])
@pytest.mark.parametrize("seed", [5, 2_000_000_011, 4_294_967_311])
def test_tf32_control_is_not_correct(cell, seed):
    cfg = small_config(cell.split(".train")[0])
    limits = json.loads((PERFBENCH / "workloads" / f"{cell}.json").read_text())["limits"]
    arrays = load_twin(cfg["twin"])
    trainer = cfg["trainer"]
    params0 = init_params(trainer["model"], trainer, arrays["features"].shape[1],
                          int(arrays["n_class"]), seed, "cpu")
    kw = dict(seed=seed, steps=3, device="cpu")
    ref = run_steps(trainer["model"], arrays, trainer, params0, **kw)
    control = run_steps(trainer["model"], arrays, trainer, params0, precision="tf32", **kw)
    numbers = compare.gaps(control, ref, params0)
    correct, checks = compare.judge(numbers, limits)
    assert not correct, checks
    assert np.isfinite(numbers["grad1"])
