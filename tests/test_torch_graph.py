"""Port parity: graph building and the Planetoid twin against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.  Edge
lists must be equal; f32 weights agree to 1e-7 (the two host pipelines
normalise in float64 and may round differently).  The twin's features,
labels and splits must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_odenet_tpu import graph as jgraph
from graph_odenet_tpu.data import planetoid as jplanetoid
from graph_odenet_tpu_torch import graph as tgraph
from graph_odenet_tpu_torch.data import planetoid as tplanetoid

W_TOL = dict(rtol=1e-7, atol=1e-7)


def _edges(seed, n=150, e=600):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e), n


def _assert_graph_equal(tg, jg):
    assert (tg.n_node, tg.n_edge, tg.n_node_pad, tg.n_edge_pad) == (
        jg.n_node, jg.n_edge, jg.n_node_pad, jg.n_edge_pad
    )
    np.testing.assert_array_equal(tg.senders.numpy(), np.asarray(jg.senders))
    np.testing.assert_array_equal(tg.receivers.numpy(), np.asarray(jg.receivers))
    np.testing.assert_allclose(tg.weight.numpy(), np.asarray(jg.weight), **W_TOL)


@pytest.mark.parametrize("normalize", ["row", "sym", None])
def test_from_edges_matches_jax(normalize):
    s, r, n = _edges(0)
    kw = dict(n_node=n, normalize=normalize, node_multiple=128, edge_multiple=256)
    tg = tgraph.from_edges(s, r, **kw)
    jg = jgraph.from_edges(s, r, **kw)
    _assert_graph_equal(tg, jg)
    assert tg.senders.dtype == torch.int32 and tg.weight.dtype == torch.float32


def test_from_edges_directed_weighted_matches_jax():
    s, r, n = _edges(1)
    # Distinct edges: which duplicate's weight survives is not specified.
    key = np.unique(s * n + r)
    s, r = key // n, key % n
    w = np.random.default_rng(2).random(len(s))
    kw = dict(n_node=n, weight=w, symmetrize=False, add_self_loops=False, normalize="row")
    _assert_graph_equal(tgraph.from_edges(s, r, **kw), jgraph.from_edges(s, r, **kw))


def test_pad_normalize_dense_match_jax():
    s, r, n = _edges(3)
    tg = tgraph.from_edges(s, r, n_node=n, normalize=None)
    jg = jgraph.from_edges(s, r, n_node=n, normalize=None)
    tp = tgraph.pad_graph(tg, node_multiple=256, edge_multiple=2048)
    jp = jgraph.pad_graph(jg, node_multiple=256, edge_multiple=2048)
    _assert_graph_equal(tp, jp)
    # Padding: senders 0, receivers n_pad - 1, weight 0.
    assert torch.all(tp.senders[tp.n_edge:] == 0)
    assert torch.all(tp.receivers[tp.n_edge:] == tp.n_node_pad - 1)
    assert torch.all(tp.weight[tp.n_edge:] == 0)
    for kind in ("row", "sym"):
        _assert_graph_equal(tgraph.normalize_graph(tp, kind), jgraph.normalize_graph(jp, kind))
    np.testing.assert_allclose(
        tgraph.to_dense(tp).numpy(), np.asarray(jgraph.to_dense(jp)), **W_TOL
    )
    np.testing.assert_allclose(tp.in_degree().numpy(), np.asarray(jp.in_degree()))


@pytest.mark.parametrize(
    "name,kw",
    [("cora", dict(scale=0.1)), ("pubmed", dict(scale=0.05, calibrated=True))],
)
def test_synthetic_planetoid_equals_jax(name, kw):
    td = tplanetoid.synthetic_planetoid(name, seed=3, **kw)
    jd = jplanetoid.synthetic_planetoid(name, seed=3, **kw)
    assert td.name == jd.name and td.n_class == jd.n_class
    np.testing.assert_array_equal(td.features.numpy(), np.asarray(jd.features))
    np.testing.assert_array_equal(td.labels.numpy(), np.asarray(jd.labels))
    for split in ("idx_train", "idx_val", "idx_test"):
        np.testing.assert_array_equal(
            getattr(td, split).numpy(), np.asarray(getattr(jd, split))
        )
    _assert_graph_equal(td.graph, jd.graph)
    assert td.features.dtype == torch.float32 and jd.features.dtype == jnp.float32


def test_load_planetoid_equals_jax(tmp_path, monkeypatch):
    content = "n0 1 0 1 classA\nn1 0 1 0 classB\nn2 1 1 0 classA\nn3 0 0 1 classC\n"
    cites = "n0 n1\nn2 n0\nn3 n2\nn0 missing_id\n"
    (tmp_path / "toy.content").write_text(content)
    (tmp_path / "toy.cites").write_text(cites)
    splits = (range(2), range(2, 3), range(3, 4))
    monkeypatch.setitem(tplanetoid._SPLITS, "toy", splits)
    monkeypatch.setitem(jplanetoid._SPLITS, "toy", splits)
    td = tplanetoid.load_planetoid("toy", str(tmp_path))
    jd = jplanetoid.load_planetoid("toy", str(tmp_path))
    assert td.n_class == jd.n_class == 3
    np.testing.assert_array_equal(td.features.numpy(), np.asarray(jd.features))
    np.testing.assert_array_equal(td.labels.numpy(), np.asarray(jd.labels))
    np.testing.assert_array_equal(td.idx_train.numpy(), np.asarray(jd.idx_train))
    _assert_graph_equal(td.graph, jd.graph)
