"""Guards of the port: no JAX inside it, CPU dispatch, wrapper checks, configs."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from graph_odenet_tpu_torch.configs import get_config, run_config
from graph_odenet_tpu_torch.graph import from_edges
from graph_odenet_tpu_torch.ops import csr_spmm, prepare, spmm_csr
from graph_odenet_tpu_torch.train import NodeClassConfig, build_model, choose_representation

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "graph_odenet_tpu"}


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = sorted((ROOT / "graph_odenet_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = {
        (str(f.relative_to(ROOT)), mod)
        for f in files for mod in _imported_roots(f) if mod in FORBIDDEN
    }
    assert not bad, bad


def _graph():
    rng = np.random.default_rng(0)
    return from_edges(rng.integers(0, 50, 200), rng.integers(0, 50, 200), n_node=50)


def test_spmm_csr_on_cpu_takes_the_plain_version():
    g = _graph()
    csr = prepare(g)
    assert csr.device.type == "cpu"
    before = csr_spmm.launches
    x = torch.randn(g.n_node_pad, 8, requires_grad=True)
    spmm_csr(csr, x).sum().backward()
    assert csr_spmm.launches == before
    ones = torch.ones(g.n_node_pad, 8)
    expected = csr_spmm._reduce_plain(csr.t_row_ptr, csr.t_receivers, csr.t_weight, ones)
    torch.testing.assert_close(x.grad, expected)  # Âᵀ·1 through the CSC view


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "wrong_rows", "no_features"])
def test_wrapper_rejects_bad_input(bad):
    g = _graph()
    csr = prepare(g)
    x = {
        "float64": torch.zeros(g.n_node_pad, 4, dtype=torch.float64),
        "non_contiguous": torch.zeros(4, g.n_node_pad).t(),
        "wrong_rows": torch.zeros(g.n_node_pad + 1, 4),
        "no_features": torch.zeros(g.n_node_pad, 0),
    }[bad]
    with pytest.raises(TypeError if bad == "float64" else ValueError):
        spmm_csr(csr, x)


def test_choose_representation():
    g = _graph()
    assert choose_representation(g, "gcnode") == "dense"
    big = from_edges([0], [1], n_node=20_000)
    assert big.n_node_pad > 16_384
    assert choose_representation(big, "gcnode") == "segment"  # CPU tensors


@pytest.mark.parametrize("name,item", [
    (2, "A12"), (3, "A15"), (4, "A16"), ("cora-gat", "A11"), ("pubmed-gatode", "A12"),
])
def test_unported_configs_name_their_roadmap_item(name, item):
    with pytest.raises(NotImplementedError, match=item):
        get_config(name)


@pytest.mark.parametrize("model,item", [("gat", "A11"), ("gatode", "A12")])
def test_unported_models_name_their_roadmap_item(model, item):
    with pytest.raises(NotImplementedError, match=item):
        build_model(NodeClassConfig(model=model), 3, 8)


def test_pubmed_gcnode_config():
    kind, cfg = get_config("pubmed-gcnode")
    assert kind == "node"
    assert (cfg.model, cfg.hidden, cfg.method, cfg.steps, cfg.lr, cfg.weight_decay) == (
        "gcnode", 16, "rk4", 4, 0.01, 5e-4
    )
    assert (cfg.dropout, cfg.epochs, cfg.patience) == (0.5, 200, 100)


def test_run_config_end_to_end_on_cpu():
    res = run_config(1, scale=0.1, calibrated=True)
    assert res["config"] == "cora-gcnode-rk4" and res["representation"] == "dense"
    assert 0 < res["epochs_run"] <= 200
    assert res["best"]["test_acc"] > 0.5
