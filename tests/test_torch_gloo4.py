"""The edge-partitioned tier in a gloo world of 4 ranks (spawned processes,
``torch_dist_worlds``): ``spmm_sharded`` in every mode against the JAX
package's on a 4-device mesh (values and ``d sum(sin(·))/dx``, rtol = atol =
1e-5); the sharded GCN-ODE's log-probs, loss and parameter gradients with
converted JAX parameters against JAX's on the same mesh (dropout 0,
rtol 2e-4); and its dropout mask, which does not depend on the partitioning
(4 parts equal 1 part)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_odenet_tpu.data.ogbn import synthetic_ogbn_arxiv as jtwin
from graph_odenet_tpu.parallel import make_mesh
from graph_odenet_tpu.parallel import partition_by_receiver as jpartition
from graph_odenet_tpu.parallel import sharded_gcn as jsg
from graph_odenet_tpu.parallel import spmm_sharded as jspmm
from graph_odenet_tpu_torch.convert import params_from_sharded
from graph_odenet_tpu_torch.data import synthetic_ogbn_arxiv
from graph_odenet_tpu_torch.parallel import partition_by_receiver, sharded_gcn

from torch_dist_worlds import _labels_weight, run_world

N_RANKS = 4
SCALE = 0.004
MODES = ("allgather", "ring", "ring_pallas")
TOL = dict(rtol=1e-5, atol=1e-5)
FWD_TOL = dict(rtol=2e-4, atol=1e-6)
STEPS, DROP_SEED = 2, 11


@pytest.fixture(scope="module")
def jd():
    return jtwin(seed=0, scale=SCALE)


@pytest.fixture(scope="module")
def params(jd):
    return {k: np.asarray(v) for k, v in
            jsg.init_params(jax.random.PRNGKey(0), jd.features.shape[1], 16, jd.n_class).items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory, params):
    """Every check of this module in one world: (x, spmm results, model results)."""
    x = np.random.default_rng(1).standard_normal((768, 16)).astype(np.float32)
    store = tmp_path_factory.mktemp("gloo4")
    ranks = run_world(N_RANKS, store, {
        "spmm_modes": dict(scale=SCALE, x=x, modes=MODES),
        "sharded_gcn": dict(scale=SCALE, params=params, steps=STEPS, mode="ring",
                            drop_seed=DROP_SEED),
    })
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
