"""On a card: each one-chip cell runs end to end for a second and comes out
correct.  ``python -m pytest perfbench/tests -q -m cuda`` on the machine
with the card; skips without one."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ogbn-arxiv-gcnode-sharded.train.1chip",
                                  "ogbn-arxiv-gatode-sharded.train.1chip"])
def test_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed", "7",
                          "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
