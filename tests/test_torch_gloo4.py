"""The edge-partitioned tier in a gloo world of 4 ranks (spawned processes,
``torch_dist_worlds``): ``spmm_sharded`` in every mode against the JAX
package's on a 4-device mesh (values and ``d sum(sin(·))/dx``, rtol = atol =
1e-5); the sharded GCN-ODE's log-probs, loss and parameter gradients with
converted JAX parameters against JAX's on the same mesh (dropout 0,
rtol 2e-4); and its dropout mask, which does not depend on the partitioning
(4 parts equal 1 part).  The same for the GAT tier: ``gat_sharded`` in both
modes with attention dropout against JAX's on the same mesh and against one
part (values 1e-5, gradients 2e-5), and the sharded GAT-ODE under ``remat``
(the recomputed forward posts its ring hops inside the backward) against
JAX's and against one part."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_odenet_tpu.data.ogbn import synthetic_ogbn_arxiv as jtwin
from graph_odenet_tpu.parallel import gat_sharded as jgat_sharded
from graph_odenet_tpu.parallel import make_mesh
from graph_odenet_tpu.parallel import partition_by_receiver as jpartition
from graph_odenet_tpu.parallel import sharded_gcn as jsg
from graph_odenet_tpu.parallel import spmm_sharded as jspmm
from graph_odenet_tpu_torch.convert import params_from_sharded
from graph_odenet_tpu_torch.data import synthetic_ogbn_arxiv
from graph_odenet_tpu_torch.parallel import partition_by_receiver, sharded_gcn

from test_torch_sharded_gat import (
    HEADS, HIDDEN, _gat_inputs, jax_gatode_params, jax_sharded_gatode, torch_sharded_gatode,
)
from torch_dist_worlds import _labels_weight, run_world

N_RANKS = 4
SCALE = 0.004
MODES = ("allgather", "ring", "ring_pallas")
TOL = dict(rtol=1e-5, atol=1e-5)
FWD_TOL = dict(rtol=2e-4, atol=1e-6)
STEPS, DROP_SEED = 2, 11
GAT_MODES = ("ring", "ring_pallas")
GAT_RATE, GAT_SEED = 0.4, 99
GRAD_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def jd():
    return jtwin(seed=0, scale=SCALE)


@pytest.fixture(scope="module")
def params(jd):
    return {k: np.asarray(v) for k, v in
            jsg.init_params(jax.random.PRNGKey(0), jd.features.shape[1], 16, jd.n_class).items()}


@pytest.fixture(scope="module")
def gat_params(jd):
    return jax_gatode_params(jd.features.shape[1], jd.n_class)


@pytest.fixture(scope="module")
def gat_inputs(jd):
    return _gat_inputs(jd.graph, 2, 4, seed=30)


@pytest.fixture(scope="module")
def all_ranks(tmp_path_factory, params, gat_params, gat_inputs):
    """Every check of this module in one world: each rank's results by task."""
    x = np.random.default_rng(1).standard_normal((768, 16)).astype(np.float32)
    store = tmp_path_factory.mktemp("gloo4")
    return x, run_world(N_RANKS, store, {
        "spmm_modes": dict(scale=SCALE, x=x, modes=MODES),
        "sharded_gcn": dict(scale=SCALE, params=params, steps=STEPS, mode="ring",
                            drop_seed=DROP_SEED),
        "gat_modes": dict(scale=SCALE, inputs=gat_inputs, modes=GAT_MODES, rate=GAT_RATE,
                          seed=GAT_SEED),
        "sharded_gatode": dict(scale=SCALE, params=gat_params, hidden=HIDDEN, heads=HEADS,
                               steps=STEPS, modes=GAT_MODES, remat=True, drop_seed=DROP_SEED),
    })


@pytest.fixture(scope="module")
def world(all_ranks):
    x, ranks = all_ranks
    return x, [r["spmm_modes"] for r in ranks], [r["sharded_gcn"] for r in ranks]


def _mesh(n_parts):
    return make_mesh(shape=(n_parts,), axis_names=("edge",), devices=jax.devices()[:n_parts])


@pytest.mark.parametrize("mode", MODES)
def test_spmm_sharded_matches_jax(world, jd, mode):
    x, spmm, _ = world
    out = np.concatenate([r[mode][0] for r in spmm])
    dx = np.concatenate([r[mode][1] for r in spmm])
    mesh, jpg = _mesh(N_RANKS), jpartition(jd.graph, N_RANKS)
    jout, vjp = jax.vjp(jax.jit(lambda v: jspmm(jpg, v, mesh, mode=mode)), jnp.asarray(x))
    (jdx,) = vjp(jnp.cos(jout))
    np.testing.assert_allclose(out, np.asarray(jout), **TOL)
    np.testing.assert_allclose(dx, np.asarray(jdx), **TOL)


def test_sharded_gcn_matches_jax(world, jd, params):
    _, _, ranks = world
    mesh, jpg = _mesh(N_RANKS), jpartition(jd.graph, N_RANKS)
    y1h, w = _labels_weight(synthetic_ogbn_arxiv(seed=0, scale=SCALE))
    x = jnp.asarray(jd.features)
    args = (jpg, x, jnp.asarray(y1h.numpy()), jnp.asarray(w.numpy()), mesh)

    @jax.jit
    def run(p):
        loss, grads = jax.value_and_grad(jsg.loss_fn)(p, *args, steps=STEPS, mode="ring")
        return jsg.forward(p, jpg, x, mesh, steps=STEPS, mode="ring"), loss, grads

    jlp, jloss, jgrads = run({k: jnp.asarray(v) for k, v in params.items()})
    np.testing.assert_allclose(np.concatenate([r["lp"] for r in ranks]), np.asarray(jlp), **FWD_TOL)
    for r in ranks:  # the loss and the gradients are all-reduced: every rank has them
        np.testing.assert_allclose(r["loss"], float(jloss), **FWD_TOL)
        for k, g in r["grads"].items():
            np.testing.assert_allclose(g, np.asarray(jgrads[k]), err_msg=k, **FWD_TOL)


def test_dropout_mask_does_not_depend_on_the_partitioning(world, params):
    _, _, ranks = world
    td = synthetic_ogbn_arxiv(seed=0, scale=SCALE)
    model = sharded_gcn.init_params(td.features.shape[1], 16, td.n_class)
    model.load_state_dict(params_from_sharded(params))
    with torch.no_grad():
        one = sharded_gcn.forward(model, partition_by_receiver(td.graph, 1), td.features,
                                  steps=STEPS, dropout=0.5,
                                  generator=torch.Generator().manual_seed(DROP_SEED))
        plain = sharded_gcn.forward(model, partition_by_receiver(td.graph, 1), td.features,
                                    steps=STEPS)
    four = np.concatenate([r["lp_drop"] for r in ranks])
    np.testing.assert_allclose(four, one.numpy(), rtol=1e-5, atol=1e-5)
    assert not np.allclose(four, plain.numpy(), atol=1e-3)  # the mask did drop


# ------------------------------------------------------------- the GAT tier


@pytest.mark.parametrize("mode", GAT_MODES)
def test_gat_sharded_matches_jax_and_one_part(all_ranks, jd, gat_inputs, mode):
    from graph_odenet_tpu_torch.parallel import gat_sharded

    ranks = [r["gat_modes"][mode] for r in all_ranks[1]]
    got = [np.concatenate([r[i] for r in ranks]) for i in range(4)]
    mesh, jpg = _mesh(N_RANKS), jpartition(jd.graph, N_RANKS)

    def f(ss, sd, w):
        return jgat_sharded(jpg, ss, sd, w, mesh, mode=mode, attn_rate=GAT_RATE,
                            attn_seed=jnp.uint32(GAT_SEED))

    jout, vjp = jax.vjp(jax.jit(f), *(jnp.asarray(a) for a in gat_inputs))
    want = [np.asarray(v) for v in (jout, *vjp(jnp.cos(jout)))]
    td = synthetic_ogbn_arxiv(seed=0, scale=SCALE)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in gat_inputs]
    y = gat_sharded(partition_by_receiver(td.graph, 1), *ts, attn_rate=GAT_RATE,
                    attn_seed=GAT_SEED, mode=mode)
    one = [y.detach().numpy()] + [g.numpy() for g in torch.autograd.grad(torch.sin(y).sum(), ts)]
    for name, a, b, c, tol in zip(("out", "ds_src", "ds_dst", "dwh"), got, want, one,
                                  (TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        np.testing.assert_allclose(a, b, err_msg=f"{name} vs JAX", **tol)
        np.testing.assert_allclose(a, c, err_msg=f"{name} vs one part", **tol)


@pytest.mark.parametrize("mode", GAT_MODES)
def test_sharded_gatode_under_remat_matches_jax_and_one_part(all_ranks, jd, gat_params, mode):
    ranks = [r["sharded_gatode"][mode] for r in all_ranks[1]]
    jlp, jloss, jgrads = jax_sharded_gatode(jd, gat_params, N_RANKS, mode=mode, remat=True)
    td = synthetic_ogbn_arxiv(seed=0, scale=SCALE)
    lp1, loss1, grads1 = torch_sharded_gatode(td, gat_params, mode=mode)
    lp = np.concatenate([r["lp"] for r in ranks])
    np.testing.assert_allclose(lp, jlp, **TOL)
    np.testing.assert_allclose(lp, lp1, **TOL)
    for r in ranks:  # the loss and the gradients are all-reduced: every rank has them
        np.testing.assert_allclose(r["loss"], jloss, rtol=1e-5)
        np.testing.assert_allclose(r["loss"], loss1, rtol=1e-5)
        for k, g in r["grads"].items():
            np.testing.assert_allclose(g, jgrads[k], err_msg=k, **FWD_TOL)
            np.testing.assert_allclose(g, grads1[k], err_msg=k, **FWD_TOL)


def test_gatode_dropout_masks_do_not_depend_on_the_partitioning(all_ranks, gat_params):
    from graph_odenet_tpu_torch.convert import params_from_sharded_gat
    from graph_odenet_tpu_torch.parallel import sharded_gat

    td = synthetic_ogbn_arxiv(seed=0, scale=SCALE)
    model = sharded_gat.init_gatode_params(td.features.shape[1], HIDDEN, HEADS, td.n_class)
    model.load_state_dict(params_from_sharded_gat(gat_params))
    pg = partition_by_receiver(td.graph, 1)
    for mode in GAT_MODES:
        with torch.no_grad():
            one = sharded_gat.gatode_forward(
                model, pg, td.features, steps=STEPS, mode=mode, dropout=0.4,
                generator=torch.Generator().manual_seed(DROP_SEED),
                seed_generator=torch.Generator().manual_seed(DROP_SEED))
            plain = sharded_gat.gatode_forward(model, pg, td.features, steps=STEPS, mode=mode)
        four = np.concatenate([r["sharded_gatode"][mode]["lp_drop"] for r in all_ranks[1]])
        np.testing.assert_allclose(four, one.numpy(), **TOL)
        assert not np.allclose(four, plain.numpy(), atol=1e-3)  # the masks did drop
