"""The edge-partitioned tier in a gloo world of 2 ranks (spawned processes,
``torch_dist_worlds``): ``spmm_sharded`` in every mode against the JAX
package's on a 2-device mesh, values and ``d sum(sin(·))/dx`` (rtol = atol
= 1e-5), and ``fit_sharded_node_classifier`` training on the tiny arxiv
twin with every rank returning the same result."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graph_odenet_tpu.data.ogbn import synthetic_ogbn_arxiv as jtwin
from graph_odenet_tpu.parallel import make_mesh
from graph_odenet_tpu.parallel import partition_by_receiver as jpartition
from graph_odenet_tpu.parallel import spmm_sharded as jspmm

from torch_dist_worlds import run_world

N_RANKS = 2
SCALE = 0.004
MODES = ("allgather", "ring", "ring_pallas")
TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_CFG = dict(model="gcnode", hidden=64, steps=2, epochs=60, eval_every=5, lr=0.02, dropout=0.5)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every check of this module in one world: (x, spmm results, training results)."""
    x = np.random.default_rng(0).standard_normal((768, 16)).astype(np.float32)
    store = tmp_path_factory.mktemp("gloo2")
    ranks = run_world(N_RANKS, store, {
        "spmm_modes": dict(scale=SCALE, x=x, modes=MODES),
        "train": dict(scale=SCALE, cfg=TRAIN_CFG),
    })
    return x, [r["spmm_modes"] for r in ranks], [r["train"] for r in ranks]


def jax_spmm(x, n_parts, mode):
    mesh = make_mesh(shape=(n_parts,), axis_names=("edge",), devices=jax.devices()[:n_parts])
    jpg = jpartition(jtwin(seed=0, scale=SCALE).graph, n_parts)
    out, vjp = jax.vjp(jax.jit(lambda v: jspmm(jpg, v, mesh, mode=mode)), jnp.asarray(x))
    (dx,) = vjp(jnp.cos(out))
    return np.asarray(out), np.asarray(dx)


@pytest.mark.parametrize("mode", MODES)
def test_spmm_sharded_matches_jax(world, mode):
    x, spmm, _ = world
    out = np.concatenate([r[mode][0] for r in spmm])
    dx = np.concatenate([r[mode][1] for r in spmm])
    jout, jdx = jax_spmm(x, N_RANKS, mode)
    np.testing.assert_allclose(out, jout, **TOL)
    np.testing.assert_allclose(dx, jdx, **TOL)


def test_trainer_two_ranks_trains_and_agrees(world):
    _, _, (r0, r1) = world
    assert r0["n_parts"] == 2 and r0["epochs_run"] == TRAIN_CFG["epochs"]
    assert r0["loss_final"] < r0["loss_first"], r0
    assert r0["test_acc"] > 2.0 / 40, r0  # twice chance, as the JAX trainer test
    for k in ("test_acc", "val_acc", "val_loss", "best_epoch", "epochs_run", "loss_first",
              "loss_final", "n_parts"):
        assert r0[k] == r1[k], k
    for k in r0["params"]:
        np.testing.assert_array_equal(r0["params"][k], r1["params"][k], err_msg=k)
