"""No file the benchmark runs imports JAX or the JAX package, compared by the
whole top-level name (``graph_odenet_tpu_torch`` is the port, which begins
with the JAX package's name); the references import nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
PERFBENCH = REPO / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "graph_odenet_tpu"}
RUN_FILES = sorted(p for p in PERFBENCH.rglob("*.py") if "tests" not in p.parts)


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", RUN_FILES, ids=lambda p: str(p.relative_to(PERFBENCH)))
def test_no_forbidden_import(path):
    assert not (_imports(path) & FORBIDDEN)


@pytest.mark.parametrize("path", sorted((PERFBENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "graph_odenet_tpu_torch" not in _imports(path)


def test_a_run_holds_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, 'perfbench'); import run; "
            "import perfbench.drivers.sharded, perfbench.calibrate, graph_odenet_tpu_torch.parallel; "
            "from perfbench.harness.result import forbidden_modules; print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
