"""The frozen twin equals the port's generator array for array."""

import numpy as np
import pytest

from perfbench.harness.twin import arxiv_twin, load_twin


@pytest.mark.parametrize("calibrated", [False, True])
def test_frozen_twin_equals_the_ports(calibrated):
    from graph_odenet_tpu_torch.data.ogbn import synthetic_ogbn_arxiv

    port = synthetic_ogbn_arxiv(seed=0, scale=0.01, calibrated=calibrated)
    mine = arxiv_twin(seed=0, scale=0.01, calibrated=calibrated)
    g = port.graph
    assert (int(mine["n_node"]), int(mine["n_edge"]), int(mine["n_node_pad"])) == (
        g.n_node, g.n_edge, g.n_node_pad)
    np.testing.assert_array_equal(mine["senders"], g.senders.numpy())
    np.testing.assert_array_equal(mine["receivers"], g.receivers.numpy())
    np.testing.assert_array_equal(mine["weight"], g.weight.numpy())
    np.testing.assert_array_equal(mine["features"], port.features.numpy())
    np.testing.assert_array_equal(mine["labels"], port.labels.numpy())
    tr, va, n = mine["split"]
    np.testing.assert_array_equal(np.arange(0, tr), port.idx_train.numpy())
    np.testing.assert_array_equal(np.arange(tr, va), port.idx_val.numpy())
    np.testing.assert_array_equal(np.arange(va, n), port.idx_test.numpy())
    assert int(mine["n_class"]) == port.n_class


def test_cache_returns_the_same_arrays(tmp_path, monkeypatch):
    from perfbench.harness import twin

    monkeypatch.setattr(twin, "CACHE_DIR", tmp_path)
    params = dict(seed=1, scale=0.005, calibrated=False)
    first = load_twin(params)
    assert len(list(tmp_path.glob("*.npz"))) == 1
    again = load_twin(params)
    for k, v in first.items():
        np.testing.assert_array_equal(v, again[k])
