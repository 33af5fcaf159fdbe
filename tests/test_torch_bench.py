"""The port's bench functions (``graph_odenet_tpu_torch.bench``) on the CPU,
after ``tests/test_bench.py``: ``powerlaw_graph`` equal to the JAX
package's array for array, the records' keys (JAX's, ``pallas_*`` as
``kernel_*``, plus ``device``), ``ode_bench``'s NFE equal to JAX's on the
same seed and size, and the card required by default.  The scaling bench
over 4 ranks runs in the gloo world of ``test_torch_gloo4.py``."""

import numpy as np
import pytest
import torch

from graph_odenet_tpu.bench import ode_bench as jode_bench
from graph_odenet_tpu.bench import powerlaw_graph as jpowerlaw_graph
from graph_odenet_tpu_torch import bench


def _keys(jax_keys):
    return {k.replace("pallas", "kernel") for k in jax_keys} | {"device"}


SPMM_KEYS = _keys({"n_edge", "segment_edges_per_s", "segment_ms", "pallas_edges_per_s",
                   "pallas_ms", "speedup", "edges_per_s"})
GAT_KEYS = SPMM_KEYS | {"heads", "feat", "mode", "dropout"}
ODE_KEYS = _keys({"method", "nfe", "seconds", "nfe_per_s", "edges_per_s", "representation"})
MODEL_KEYS = _keys({"model", "method", "representation", "mode", "dropout", "steps", "remat",
                    "adjoint", "n_node", "n_edge", "nfe", "seconds", "nfe_per_s", "edges_per_s"})
SCALING_KEYS = _keys({"n_devices", "t1_ms", "tn_ms", "speedup", "efficiency", "n_edge",
                      "platform", "harness_only"})


@pytest.mark.parametrize("kw", [dict(), dict(normalize=None), dict(seed=3, node_multiple=8)])
def test_powerlaw_graph_equals_jax(kw):
    g, j = bench.powerlaw_graph(512, 4_000, **kw), jpowerlaw_graph(512, 4_000, **kw)
    assert (g.n_node, g.n_edge, g.n_node_pad) == (j.n_node, j.n_edge, j.n_node_pad)
    for name in ("senders", "receivers", "weight"):
        np.testing.assert_array_equal(getattr(g, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)


def test_spmm_bench_smoke():
    r = bench.spmm_bench(n_nodes=512, n_edges=4_000, feat=32, iters=2, device="cpu")
    assert set(r) == SPMM_KEYS and r["device"] == "cpu"
    assert r["edges_per_s"] > 0 and r["kernel_edges_per_s"] > 0
    assert r["n_edge"] >= 4_000  # symmetrised + self loops


@pytest.mark.parametrize("kw", [dict(), dict(use_scores=False, dropout=0.6),
                                dict(mode="fwd", dropout=0.6)])
def test_gat_bench_smoke(kw):
    r = bench.gat_bench(n_nodes=512, n_edges=4_000, heads=2, feat=8, iters=2, device="cpu", **kw)
    assert set(r) == GAT_KEYS and r["device"] == "cpu"
    assert r["edges_per_s"] > 0 and r["kernel_edges_per_s"] > 0


@pytest.mark.parametrize("representation", ["dense", "segment", "kernel"])
def test_ode_bench_nfe_equals_jax(representation):
    r = bench.ode_bench(n_nodes=256, feat=16, iters=2, representation=representation,
                        device="cpu")
    assert set(r) == ODE_KEYS and r["representation"] == representation
    assert r["nfe"] >= 8  # at least two dopri5 steps
    assert r["nfe_per_s"] > 0
    assert r["nfe"] == jode_bench(n_nodes=256, feat=16, iters=1)["nfe"]


@pytest.mark.parametrize("model,mode", [("gcnode", "fwd"), ("gatode", "train_step")])
def test_ode_model_bench_smoke(model, mode):
    r = bench.ode_model_bench(model, n_nodes=256, feat_in=16, hidden=16, heads=4, iters=2,
                              steps=8, mode=mode, device="cpu")
    assert set(r) == MODEL_KEYS and r["device"] == "cpu"
    assert r["nfe"] > 0 and r["nfe_per_s"] > 0
    if mode == "train_step":  # direct backprop through the bounded _scan form, dropout live
        assert (r["method"], r["dropout"]) == ("dopri5_scan", 0.6)
        assert r["representation"] == "segment"


def test_scaling_bench_without_a_process_group():
    r = bench.scaling_bench(n_nodes=256, deg=8, feat=32, iters=2, device="cpu")
    assert set(r) == SCALING_KEYS
    assert r["n_devices"] == 1 and r["harness_only"] and r["platform"] == "cpu"
    assert r["t1_ms"] > 0 and r["speedup"] > 0


def test_bench_functions_need_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    for fn in (bench.spmm_bench, bench.gat_bench, bench.ode_bench, bench.ode_model_bench,
               bench.scaling_bench):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
