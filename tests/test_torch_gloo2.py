"""The edge-partitioned tier in a gloo world of 2 ranks (spawned processes,
``torch_dist_worlds``): ``spmm_sharded`` in every mode against the JAX
package's on a 2-device mesh, values and ``d sum(sin(·))/dx`` (rtol = atol
= 1e-5), and ``fit_sharded_node_classifier`` training on the tiny arxiv
twin with every rank returning the same result.  The same for the GAT
tier: ``gat_sharded`` in both modes with attention dropout (values 1e-5,
gradients 2e-5) and the sharded GAT-ODE's log-probs, loss and parameter
gradients (rtol 2e-4) against JAX's on the same mesh, and the GAT-ODE
trainer.  And a checkpointed run resumed in the same world."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graph_odenet_tpu.data.ogbn import synthetic_ogbn_arxiv as jtwin
from graph_odenet_tpu.parallel import gat_sharded as jgat_sharded
from graph_odenet_tpu.parallel import make_mesh
from graph_odenet_tpu.parallel import partition_by_receiver as jpartition
from graph_odenet_tpu.parallel import spmm_sharded as jspmm

from test_torch_sharded_gat import (
    HEADS, HIDDEN, STEPS, _gat_inputs, jax_gatode_params, jax_sharded_gatode,
)
from torch_dist_worlds import run_world

N_RANKS = 2
SCALE = 0.004
MODES = ("allgather", "ring", "ring_pallas")
TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_CFG = dict(model="gcnode", hidden=64, steps=2, epochs=60, eval_every=5, lr=0.02, dropout=0.5)
GAT_TRAIN_CFG = dict(model="gatode", hidden=16, heads=2, steps=2, epochs=8, eval_every=2,
                     lr=0.005, dropout=0.4, mode="ring_pallas", remat=True)
GAT_MODES = ("ring", "ring_pallas")
RESUME_CFG = dict(model="gcnode", hidden=16, steps=2, dropout=0.5, eval_every=2)
GAT_RATE, GAT_SEED = 0.4, 99
GRAD_TOL = dict(rtol=2e-5, atol=2e-5)
FWD_TOL = dict(rtol=2e-4, atol=1e-6)


@pytest.fixture(scope="module")
def jd():
    return jtwin(seed=0, scale=SCALE)


@pytest.fixture(scope="module")
def gat_params(jd):
    return jax_gatode_params(jd.features.shape[1], jd.n_class, seed=2)


@pytest.fixture(scope="module")
def gat_inputs(jd):
    return _gat_inputs(jd.graph, 2, 4, seed=31)


@pytest.fixture(scope="module")
def all_ranks(tmp_path_factory, gat_params, gat_inputs):
    """Every check of this module in one world: each rank's results by task."""
    x = np.random.default_rng(0).standard_normal((768, 16)).astype(np.float32)
    store = tmp_path_factory.mktemp("gloo2")
    return x, run_world(N_RANKS, store, {
        "spmm_modes": dict(scale=SCALE, x=x, modes=MODES),
        "train": dict(scale=SCALE, cfg=TRAIN_CFG),
        "gat_modes": dict(scale=SCALE, inputs=gat_inputs, modes=GAT_MODES, rate=GAT_RATE,
                          seed=GAT_SEED),
        "sharded_gatode": dict(scale=SCALE, params=gat_params, hidden=HIDDEN, heads=HEADS,
                               steps=STEPS, modes=GAT_MODES, remat=False, drop_seed=5),
        "train_gat": dict(scale=SCALE, cfg=GAT_TRAIN_CFG),
        "resume": dict(scale=SCALE, cfg=RESUME_CFG, epochs=5, first=3,
                       ckpt_dir=str(store / "ckpt")),
    })


@pytest.fixture(scope="module")
def world(all_ranks):
    x, ranks = all_ranks
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


def test_two_rank_resume_rank_0_writes_and_both_restore(all_ranks):
    """The bit-identical resume in a world of two: rank 0 alone saves (each
    epoch of both calls, 3 + 2), both ranks restore the latest step after a
    barrier, and both continue exactly as the uninterrupted run did."""
    r0, r1 = (r["resume"] for r in all_ranks[1])
    assert (r0["save"], r1["save"]) == (5, 0)
    assert r0["restore"] == r1["restore"] == 1
    for r in (r0, r1):
        assert r["epochs_run"] == 5 and r["resumed"] == r["straight"][3:]
    assert r0["straight"] == r1["straight"]


# ------------------------------------------------------------- the GAT tier


@pytest.mark.parametrize("mode", GAT_MODES)
def test_gat_sharded_matches_jax(all_ranks, jd, gat_inputs, mode):
    ranks = [r["gat_modes"][mode] for r in all_ranks[1]]
    got = [np.concatenate([r[i] for r in ranks]) for i in range(4)]
    mesh = make_mesh(shape=(N_RANKS,), axis_names=("edge",), devices=jax.devices()[:N_RANKS])
    jpg = jpartition(jd.graph, N_RANKS)

    def f(ss, sd, w):
        return jgat_sharded(jpg, ss, sd, w, mesh, mode=mode, attn_rate=GAT_RATE,
                            attn_seed=jnp.uint32(GAT_SEED))

    jout, vjp = jax.vjp(jax.jit(f), *(jnp.asarray(a) for a in gat_inputs))
    want = [np.asarray(v) for v in (jout, *vjp(jnp.cos(jout)))]
    for name, a, b, tol in zip(("out", "ds_src", "ds_dst", "dwh"), got, want,
                               (TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        np.testing.assert_allclose(a, b, err_msg=name, **tol)


@pytest.mark.parametrize("mode", GAT_MODES)
def test_sharded_gatode_matches_jax(all_ranks, jd, gat_params, mode):
    ranks = [r["sharded_gatode"][mode] for r in all_ranks[1]]
    jlp, jloss, jgrads = jax_sharded_gatode(jd, gat_params, N_RANKS, mode=mode)
    np.testing.assert_allclose(np.concatenate([r["lp"] for r in ranks]), jlp, **TOL)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], jloss, rtol=1e-5)
        for k, g in r["grads"].items():
            np.testing.assert_allclose(g, jgrads[k], err_msg=k, **FWD_TOL)


def test_gatode_trainer_two_ranks_trains_and_agrees(all_ranks):
    r0, r1 = (r["train_gat"] for r in all_ranks[1])
    assert r0["n_parts"] == 2 and r0["epochs_run"] == GAT_TRAIN_CFG["epochs"]
    assert r0["loss_final"] < r0["loss_first"], r0
    for k in ("test_acc", "val_acc", "val_loss", "best_epoch", "loss_first", "loss_final"):
        assert r0[k] == r1[k], k
    for k in r0["params"]:
        np.testing.assert_array_equal(r0["params"][k], r1["params"][k], err_msg=k)
