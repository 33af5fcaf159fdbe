"""Guards of the port: no JAX inside it, CPU dispatch, wrapper checks, configs."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from graph_odenet_tpu_torch.configs import get_config, run_config
from graph_odenet_tpu_torch.graph import Graph, from_edges
from graph_odenet_tpu_torch.ops import csr_spmm, gat_attn, prepare, spmm_csr
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
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {
        f"graph_odenet_tpu_torch/{name}.py"
        for name in ("ops/dropmask", "ops/gat_attn", "ops/sddmm", "models/gat", "ode/adaptive",
                     "data/ogbn", "parallel/halo", "parallel/partition", "parallel/trainer")
    } <= names
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


@pytest.mark.parametrize("name,item", [(3, "A15"), ("nbody-inode-rollout", "A15")])
def test_unported_configs_name_their_roadmap_item(name, item):
    with pytest.raises(NotImplementedError, match=item):
        get_config(name)


@pytest.mark.parametrize("model,adjoint", [("gatode", True), ("gcnode", "checkpoint")])
def test_unported_models_name_their_roadmap_item(model, adjoint):
    with pytest.raises(NotImplementedError, match="A13"):
        build_model(NodeClassConfig(model=model, adjoint=adjoint), 3, 8)


def test_config_2_and_gat_extras():
    kind, cfg = get_config(2)
    assert kind == "node" and get_config("citeseer-gatode-dopri5")[1] == cfg
    assert (cfg.model, cfg.hidden, cfg.heads, cfg.method, cfg.steps) == (
        "gatode", 8, 8, "dopri5_scan", 32
    )
    assert (cfg.rtol, cfg.atol, cfg.dropout, cfg.lr, cfg.weight_decay) == (1e-3, 1e-4, 0.6, 0.005, 5e-4)
    assert (cfg.epochs, cfg.patience) == (300, 100)
    for name in ("cora-gat", "pubmed-resgat", "cora-gatode", "pubmed-gatode"):
        assert get_config(name)[1].model in ("gat", "resgat", "gatode")
    g = _graph()
    assert choose_representation(g, "gatode") == "segment"  # CPU tensors, any scale


def _unsorted_graph():
    """Two real edges, not sorted by receiver (from_edges would sort them)."""
    return Graph(
        senders=torch.tensor([0, 1, 0], dtype=torch.int32),
        receivers=torch.tensor([2, 0, 127], dtype=torch.int32),
        weight=torch.tensor([1.0, 1.0, 0.0]),
        n_node=3, n_edge=2, n_node_pad=128,
    )


def test_prepare_rejects_a_graph_not_sorted_by_receiver():
    with pytest.raises(ValueError, match="sorted by receiver"):
        prepare(_unsorted_graph())
    csr = prepare(_graph())
    np.testing.assert_array_equal(csr.receivers.numpy(), _graph().receivers[: csr.n_edge].numpy())


def _gat_inputs():
    g = _graph()
    csr = prepare(g)
    rng = np.random.default_rng(0)
    n, e, heads, feat = g.n_node_pad, csr.n_edge, 2, 3
    f32 = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    return csr, dict(
        logits=f32(e, heads), wh=f32(n, heads, feat), g=f32(n, heads, feat),
        m=f32(n, heads), l=f32(n, heads).abs() + 1, beta=f32(n, heads),
        s_src=f32(n, heads), s_dst=f32(n, heads), alpha=f32(e, heads),
    )


def _call(wrapper, csr, t):
    if wrapper == "gat_fwd":
        return gat_attn.gat_fwd(csr, t["logits"], t["wh"])
    if wrapper == "gat_bwd":
        return gat_attn.gat_bwd(csr, t["logits"], t["wh"], t["g"], t["m"], t["l"], t["beta"])
    if wrapper == "gat_dwh":
        return gat_attn.gat_dwh(csr, t["s_src"], t["s_dst"], t["m"], t["l"], t["g"], 0.2)
    x = t["wh"].reshape(csr.n_node_pad, -1)
    return csr_spmm.csr_reduce(csr, x, transpose=True, alpha=t["alpha"], feat=t["wh"].shape[2])


WRAPPER_INPUTS = {
    "gat_fwd": ("logits", "wh"), "gat_bwd": ("logits", "wh", "g", "m", "l", "beta"),
    "gat_dwh": ("s_src", "s_dst", "m", "l", "g"), "csr_reduce_weighted": ("alpha",),
}


@pytest.mark.parametrize("bad", ["float64", "non_contiguous"])
@pytest.mark.parametrize("wrapper", sorted(WRAPPER_INPUTS))
def test_new_wrappers_reject_bad_input(wrapper, bad):
    csr, t = _gat_inputs()
    _call(wrapper, csr, t)  # the good inputs pass
    for key in WRAPPER_INPUTS[wrapper]:
        broken = dict(t)
        if bad == "float64":
            broken[key] = t[key].double()
        else:
            broken[key] = t[key].transpose(0, 1).contiguous().transpose(0, 1)
        assert broken[key].is_contiguous() == (bad == "float64")
        with pytest.raises(TypeError if bad == "float64" else ValueError):
            _call(wrapper, csr, broken)


def test_cpu_csr_graph_leaves_every_launch_counter_at_zero():
    from graph_odenet_tpu_torch.models import GAT, GATODE

    g = _graph()
    csr = prepare(g)
    x = torch.randn(g.n_node_pad, 12)
    counts = (csr_spmm.launches, csr_spmm.weighted_launches, dict(gat_attn.launches))
    for model in (GATODE(12, n_class=3, steps=4), GAT(12, n_class=3)):
        model(csr, x).sum().backward()
    spmm_csr(csr, x).sum()
    assert (csr_spmm.launches, csr_spmm.weighted_launches, dict(gat_attn.launches)) == counts
    assert counts == (0, 0, {"gat_fwd": 0, "gat_bwd": 0, "gat_dwh": 0})


def test_pubmed_gcnode_config():
    kind, cfg = get_config("pubmed-gcnode")
    assert kind == "node"
    assert (cfg.model, cfg.hidden, cfg.method, cfg.steps, cfg.lr, cfg.weight_decay) == (
        "gcnode", 16, "rk4", 4, 0.01, 5e-4
    )
    assert (cfg.dropout, cfg.epochs, cfg.patience) == (0.5, 200, 100)


def test_run_config_end_to_end_on_cpu():
    res = run_config(1, scale=0.1, calibrated=True, device="cpu")
    assert res["config"] == "cora-gcnode-rk4" and res["representation"] == "dense"
    assert 0 < res["epochs_run"] <= 200
    assert res["best"]["test_acc"] > 0.5


def _entry_point_calls():
    from graph_odenet_tpu_torch.data import synthetic_ogbn_arxiv, synthetic_planetoid
    from graph_odenet_tpu_torch.parallel import ShardedTrainConfig, fit_sharded_node_classifier
    from graph_odenet_tpu_torch.train import fit_node_classifier

    return {
        "run_config(1)": lambda: run_config(1, scale=0.1),
        "run_config(4)": lambda: run_config(4, scale=0.004),
        "fit_node_classifier": lambda: fit_node_classifier(
            NodeClassConfig(epochs=1), synthetic_planetoid("cora", scale=0.1)),
        "fit_sharded_node_classifier": lambda: fit_sharded_node_classifier(
            ShardedTrainConfig(epochs=1), synthetic_ogbn_arxiv(scale=0.004)),
    }


@pytest.mark.parametrize("entry", sorted(_entry_point_calls()))
def test_entry_points_run_on_the_card_unless_asked(monkeypatch, entry):
    """Without a card the default device raises; nothing trains on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trained = []
    monkeypatch.setattr(torch.optim.Adam, "step", lambda *a, **k: trained.append(1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_point_calls()[entry]()
    assert not trained
