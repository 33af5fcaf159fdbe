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
JAX's and against one part.  And the meshes of two axes (``make_mesh``):
feature-axis tensor parallelism on a (edge, feat) = (2, 2) mesh and a
leading batch axis on a (data, edge) = (2, 2) mesh against JAX's
single-device ``spmm`` (the JAX tests' tolerances), slices of unequal width
refused, and two rings on subgroups of 2 ranks at once, each with its own
result; the GAT tier along the edge axis of a (data, edge) = (2, 2) mesh
(``group=``) against JAX's on a 2 × 2 mesh with ``axis="edge"`` and against
one part; and ``bench.scaling_bench`` over the 4 ranks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_odenet_tpu.data.ogbn import synthetic_ogbn_arxiv as jtwin
from graph_odenet_tpu.graph import from_edges as jfrom_edges
from graph_odenet_tpu.ops import spmm as jspmm_one
from graph_odenet_tpu.parallel import gat_sharded as jgat_sharded
from graph_odenet_tpu.parallel import make_mesh
from graph_odenet_tpu.parallel import partition_by_receiver as jpartition
from graph_odenet_tpu.parallel import sharded_gat as jsgat
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
SPMM_2D_MODES = ("ring", "allgather")


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


def _mesh_graph(seed, n, density, node_multiple):
    """The JAX 2-D mesh tests' graphs: edges of a random ``[n, n]`` mask."""
    rng = np.random.default_rng(seed)
    s, r = np.nonzero(rng.random((n, n)) < density)
    return rng, s, r, jfrom_edges(s, r, n_node=n, normalize="row", node_multiple=node_multiple)


@pytest.fixture(scope="module")
def mesh_inputs():
    """``test_spmm_sharded_feature_tp``'s graph and ``x [64, 32]``, and
    ``test_spmm_sharded_2d_mesh_data_by_edge``'s graph and ``xb [8, 96, 16]``."""
    rng, s, r, g = _mesh_graph(3, 64, 0.3, 4)
    x = rng.standard_normal((g.n_node_pad, 32)).astype(np.float32)
    rng, s2, r2, g2 = _mesh_graph(7, 96, 0.06, 8)
    xb = rng.standard_normal((8, g2.n_node_pad, 16)).astype(np.float32)
    return dict(feat=(s, r, 64, x, g), data=(s2, r2, 96, xb, g2))


@pytest.fixture(scope="module")
def all_ranks(tmp_path_factory, params, gat_params, gat_inputs, mesh_inputs):
    """Every check of this module in one world: each rank's results by task."""
    x = np.random.default_rng(1).standard_normal((768, 16)).astype(np.float32)
    store = tmp_path_factory.mktemp("gloo4")
    s, r, n, xf, _ = mesh_inputs["feat"]
    s2, r2, n2, xb, _ = mesh_inputs["data"]
    return x, run_world(N_RANKS, store, {
        "spmm_modes": dict(scale=SCALE, x=x, modes=MODES),
        "sharded_gcn": dict(scale=SCALE, params=params, steps=STEPS, mode="ring",
                            drop_seed=DROP_SEED),
        "gat_modes": dict(scale=SCALE, inputs=gat_inputs, modes=GAT_MODES, rate=GAT_RATE,
                          seed=GAT_SEED),
        "sharded_gatode": dict(scale=SCALE, params=gat_params, hidden=HIDDEN, heads=HEADS,
                               steps=STEPS, modes=GAT_MODES, remat=True, drop_seed=DROP_SEED),
        "feature_tp": dict(s=s, r=r, n=n, x=xf, modes=SPMM_2D_MODES),
        "data_edge": dict(s=s2, r=r2, n=n2, xb=xb, modes=SPMM_2D_MODES),
        "gat_data_edge": dict(scale=SCALE, inputs=gat_inputs, rate=GAT_RATE, seed=GAT_SEED,
                              params=gat_params, hidden=HIDDEN, heads=HEADS, steps=STEPS,
                              modes=GAT_MODES, drop_seed=DROP_SEED),
        "two_rings": dict(scale=SCALE, x=x, params=params, steps=STEPS),
        "scaling": dict(n_nodes=256, deg=8, feat=32, iters=2),
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


# ------------------------------------------------------ meshes of two axes


def _jax_rows_grad(g, x):
    """JAX's single-device ``spmm(g, x)`` and ``d sum(spmm(g, x)²)/dx``."""
    f = lambda v: jspmm_one(g, v)  # noqa: E731
    out = f(jnp.asarray(x))
    return np.asarray(out), np.asarray(jax.grad(lambda v: jnp.sum(f(v) ** 2))(jnp.asarray(x)))


@pytest.mark.parametrize("mode", SPMM_2D_MODES)
def test_spmm_sharded_feature_tp_matches_jax(all_ranks, mesh_inputs, mode):
    *_, x, g = mesh_inputs["feat"]
    want, want_dx = _jax_rows_grad(g, x)
    got, got_dx = np.zeros_like(want), np.zeros_like(want)
    b, w = want.shape[0] // 2, want.shape[1] // 2
    for rank in all_ranks[1]:
        res = rank["feature_tp"]
        e, f = res["coords"]
        part = (slice(e * b, (e + 1) * b), slice(f * w, (f + 1) * w))
        got[part], got_dx[part] = res[mode]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_dx, want_dx, rtol=1e-5, atol=1e-6)


def test_feature_slices_of_unequal_width_are_refused(all_ranks):
    for rank in all_ranks[1]:
        assert "differ in width" in rank["feature_tp"].get("mismatch", ""), rank["feature_tp"]


@pytest.mark.parametrize("mode", SPMM_2D_MODES)
def test_spmm_sharded_batch_axis_on_data_edge_mesh_matches_jax_vmap(all_ranks, mesh_inputs, mode):
    *_, xb, g = mesh_inputs["data"]
    f = jax.vmap(lambda v: jspmm_one(g, v))
    want = np.asarray(f(jnp.asarray(xb)))
    want_dx = np.asarray(jax.grad(lambda v: jnp.sum(f(v) ** 2))(jnp.asarray(xb)))
    got, got_dx = np.zeros_like(want), np.zeros_like(want)
    nb, b = want.shape[0] // 2, want.shape[1] // 2
    for rank in all_ranks[1]:
        res = rank["data_edge"]
        d, e = res["coords"]
        part = (slice(d * nb, (d + 1) * nb), slice(e * b, (e + 1) * b))
        got[part], got_dx[part] = res[mode]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_dx, want_dx, rtol=1e-5, atol=1e-5)


def _data_edge_rows(all_ranks, mode, pick):
    """``{d: [rows of edge blocks 0, 1 joined]}`` of ``pick(result)`` from
    each rank of data row d."""
    rows = {}
    for rank in all_ranks[1]:
        res = rank["gat_data_edge"]
        d, e = res["coords"]
        rows.setdefault(d, {})[e] = pick(res[mode])
    return {d: [np.concatenate([by_e[0][i], by_e[1][i]]) for i in range(len(by_e[0]))]
            for d, by_e in rows.items()}


def _mesh_2x2():
    return make_mesh(shape=(2, 2), axis_names=("data", "edge"), devices=jax.devices()[:4])


@pytest.mark.parametrize("mode", GAT_MODES)
def test_gat_sharded_on_data_edge_mesh_matches_jax(all_ranks, jd, gat_inputs, mode):
    """``gat_sharded(group=edge)`` with attention dropout on a (data, edge) = (2,
    2) mesh, data row d on d + 1 times the inputs: each row's blocks against
    JAX's ``gat_sharded`` on a 2 × 2 mesh with ``axis="edge"`` and against the
    port at one part (values 1e-5, gradients 2e-5)."""
    from graph_odenet_tpu_torch.parallel import gat_sharded

    got = _data_edge_rows(all_ranks, mode, lambda r: r["gat"])
    jpg, mesh = jpartition(jd.graph, 2), _mesh_2x2()
    f = jax.jit(lambda ss, sd, w: jgat_sharded(jpg, ss, sd, w, mesh, axis="edge", mode=mode,
                                               attn_rate=GAT_RATE, attn_seed=jnp.uint32(GAT_SEED)))
    pg1 = partition_by_receiver(synthetic_ogbn_arxiv(seed=0, scale=SCALE).graph, 1)
    for d in (0, 1):
        inputs = [a * (d + 1) for a in gat_inputs]
        jout, vjp = jax.vjp(f, *(jnp.asarray(a) for a in inputs))
        want = [np.asarray(v) for v in (jout, *vjp(jnp.cos(jout)))]
        ts = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
        y = gat_sharded(pg1, *ts, attn_rate=GAT_RATE, attn_seed=GAT_SEED, mode=mode)
        one = [y.detach().numpy()] + [g.numpy() for g in torch.autograd.grad(torch.sin(y).sum(), ts)]
        for name, a, b, c, tol in zip(("out", "ds_src", "ds_dst", "dwh"), got[d], want, one,
                                      (TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
            np.testing.assert_allclose(a, b, err_msg=f"data {d} {name} vs JAX", **tol)
            np.testing.assert_allclose(a, c, err_msg=f"data {d} {name} vs one part", **tol)


@pytest.mark.parametrize("mode", GAT_MODES)
def test_sharded_gatode_on_data_edge_mesh_matches_jax(all_ranks, jd, gat_params, mode):
    """``gatode_forward(group=edge)`` under ``remat`` on the same mesh: each
    data row's log-probs, and its loss and gradients (all-reduced over its
    edge group), against JAX's ``gatode_forward`` with ``axis="edge"`` on a
    2 × 2 mesh and against the port at one part (rtol 2e-4); the dropout
    masks of each row equal one part's (``group``'s rank picks the rows)."""
    from graph_odenet_tpu_torch.convert import params_from_sharded_gat
    from graph_odenet_tpu_torch.parallel import sharded_gat

    lps = _data_edge_rows(all_ranks, mode, lambda r: [r["lp"], r["lp_drop"]])
    jpg, mesh = jpartition(jd.graph, 2), _mesh_2x2()
    td = synthetic_ogbn_arxiv(seed=0, scale=SCALE)
    y1h, w = _labels_weight(td)
    jy, jw = jnp.asarray(y1h.numpy()), jnp.asarray(w.numpy())

    @jax.jit
    def run(p, x):
        def loss(p):
            lp = jsgat.gatode_forward(p, jpg, x, mesh, steps=STEPS, axis="edge", mode=mode,
                                      remat=True)
            return jnp.sum(-jnp.sum(lp * jy, axis=-1) * jw) / jnp.sum(jw), lp

        (val, lp), grads = jax.value_and_grad(loss, has_aux=True)(p)
        return lp, val, grads

    model = sharded_gat.init_gatode_params(td.features.shape[1], HIDDEN, HEADS, td.n_class)
    model.load_state_dict(params_from_sharded_gat(gat_params))
    pg1 = partition_by_receiver(td.graph, 1)
    for d in (0, 1):
        x = td.features * (d + 1)
        jlp, jloss, jgrads = run({k: jnp.asarray(v) for k, v in gat_params.items()},
                                 jnp.asarray(x.numpy()))
        with torch.no_grad():
            one_drop = sharded_gat.gatode_forward(
                model, pg1, x, steps=STEPS, mode=mode, dropout=0.4,
                generator=torch.Generator().manual_seed(DROP_SEED),
                seed_generator=torch.Generator().manual_seed(DROP_SEED))
        lp, lp_drop = lps[d]
        np.testing.assert_allclose(lp, np.asarray(jlp), err_msg=f"data {d}", **TOL)
        np.testing.assert_allclose(lp_drop, one_drop.numpy(), err_msg=f"data {d} dropout", **TOL)
        members = [r["gat_data_edge"] for r in all_ranks[1] if r["gat_data_edge"]["coords"][0] == d]
        for res in members:
            np.testing.assert_allclose(res[mode]["loss"], float(jloss), rtol=1e-5)
            for k, g in res[mode]["grads"].items():
                np.testing.assert_allclose(g, np.asarray(jgrads[k]), err_msg=f"data {d} {k}",
                                           **FWD_TOL)


def test_two_rings_on_subgroups_each_give_their_own_result(all_ranks, jd, params):
    x, ranks = all_ranks
    td = synthetic_ogbn_arxiv(seed=0, scale=SCALE)
    pg1 = partition_by_receiver(td.graph, 1)
    model = sharded_gcn.init_params(td.features.shape[1], 16, td.n_class)
    model.load_state_dict(params_from_sharded(params))
    y1h, w = _labels_weight(td)
    for ring in (0, 1):
        members = [r["two_rings"] for r in ranks if r["two_rings"]["coords"][0] == ring]
        assert [m["coords"][1] for m in members] == [0, 1]
        xr = x * (ring + 1)
        want, want_dx = _jax_rows_grad(jd.graph, xr)
        for mode in ("allgather", "ring", "ring_pallas"):
            np.testing.assert_allclose(np.concatenate([m[mode][0] for m in members]), want,
                                       err_msg=f"ring {ring} {mode}", **TOL)
            np.testing.assert_allclose(np.concatenate([m[mode][1] for m in members]), want_dx,
                                       err_msg=f"ring {ring} {mode} dx", **TOL)
        model.zero_grad(set_to_none=True)
        loss = sharded_gcn.loss_fn(model, pg1, td.features * (ring + 1), y1h, w, steps=STEPS)
        loss.backward()
        for m in members:
            np.testing.assert_array_equal(m["gathered"], xr)
            np.testing.assert_allclose(m["sum"], xr.sum(0), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(m["loss"], float(loss.detach()), **FWD_TOL)
            for k, p in model.named_parameters():
                np.testing.assert_allclose(m["grads"][k], p.grad.numpy(), err_msg=k, **FWD_TOL)


def test_scaling_bench_over_four_ranks(all_ranks):
    for rank in all_ranks[1]:
        r = rank["scaling"]
        assert (r["n_devices"], r["platform"], r["device"], r["harness_only"]) == (4, "cpu", "cpu",
                                                                                   True)
        assert r["t1_ms"] > 0 and r["tn_ms"] > 0 and r["efficiency"] > 0
