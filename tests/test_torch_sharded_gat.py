"""Port parity, the edge-partitioned GAT tier in one process: the weighted
bucket reduction (B2-w's plain version on the CPU), ``gat_sharded`` in both
modes, the sharded GAT-ODE and its trainer against the JAX package.

JAX runs as its own tests run it: the 8-device CPU mesh of
``tests/conftest.py``, the Pallas bucket kernel in interpret mode.  The gloo
worlds of 2 and 4 ranks are in ``test_torch_gloo2.py`` and
``test_torch_gloo4.py``.  Inputs are float32, made with numpy from a seed.

Tolerances: values rtol = atol = 1e-5 and gradients 2e-5 (the same f32 sums
in another order; the JAX package's own sharded-GAT tests use these);
parameter gradients of the whole model rtol 2e-4 (ten attention layers deep).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_odenet_tpu.data.ogbn import synthetic_ogbn_arxiv as jtwin
from graph_odenet_tpu.parallel import gat_sharded as jgat_sharded
from graph_odenet_tpu.parallel import halo as jhalo
from graph_odenet_tpu.parallel import make_mesh
from graph_odenet_tpu.parallel import partition_by_receiver as jpartition
from graph_odenet_tpu.parallel import sharded_gat as jsgat
from graph_odenet_tpu.parallel.sharded_gcn import shard_batch as jshard_batch
from graph_odenet_tpu.parallel.trainer import ShardedTrainConfig as JShardedTrainConfig
from graph_odenet_tpu.parallel.trainer import fit_sharded_node_classifier as jfit_sharded
from graph_odenet_tpu_torch.convert import params_from_sharded_gat
from graph_odenet_tpu_torch.data import synthetic_ogbn_arxiv
from graph_odenet_tpu_torch.ops import csr_spmm
from graph_odenet_tpu_torch.ops.csr_spmm import bucket_reduce
from graph_odenet_tpu_torch.ops.dropmask import attention_dropout_scale
from graph_odenet_tpu_torch.ops.sddmm import attention_aggregate, edge_scores
from graph_odenet_tpu_torch.parallel import (
    ShardedTrainConfig, fit_sharded_node_classifier, gat_sharded, padded_buckets,
    partition_by_receiver, sharded_gat,
)
from graph_odenet_tpu_torch.parallel.halo import _bucket_spmm_weighted

from torch_dist_worlds import _labels_weight

SCALE = 0.004  # 677 nodes, padded to 768
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-5, atol=2e-5)
PARAM_TOL = dict(rtol=2e-4, atol=1e-6)
HIDDEN, HEADS, STEPS = 8, 2, 2
MODES = ("ring", "ring_pallas")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small CPU work: one intra-op thread, so that the test workers' OpenMP
    threads do not spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def twins():
    return synthetic_ogbn_arxiv(seed=0, scale=SCALE), jtwin(seed=0, scale=SCALE)


def _mesh(n_parts):
    return make_mesh(shape=(n_parts,), axis_names=("edge",), devices=jax.devices()[:n_parts])


# ------------------------------------------------- (a) the bucket Function


@pytest.fixture(scope="module")
def weighted_buckets(twins):
    """Every bucket of an 8-part partition at H = 2, F = 3 through the JAX
    function (interpret-mode Pallas kernel) and through the port: values and
    the gradients of ``sum(sin(out))``.  ``pv`` is nonzero on the padding
    slots too; JAX gets it where-masked, as its one caller masks it, and the
    port gets the L real edges."""
    td, jd = twins
    n_parts, heads, feat = 8, 2, 3
    pg = partition_by_receiver(td.graph, n_parts)
    jpg = jpartition(jd.graph, n_parts)
    B, E = pg.block_size, padded_buckets(pg).e_bucket
    assert E == jpg.e_bucket

    @jax.jit
    def jrun(chunk, pv, *arrs):
        f = lambda c, a: jhalo._bucket_spmm_weighted(B, feat, c, a, *arrs)  # noqa: E731
        out, vjp = jax.vjp(f, chunk, pv)
        return (out, *vjp(jnp.cos(out)))

    rng = np.random.default_rng(7)
    results = []
    for p in range(n_parts):
        for b in range(n_parts):
            L = int(pg.bucket_edges[p, b])
            chunk = rng.standard_normal((B, heads * feat)).astype(np.float32)
            pv = (rng.random((E, heads)) + 0.1).astype(np.float32)
            real = np.asarray(jpg.weight[p, b]) != 0.0
            assert real.sum() == L and real[:L].all()
            arrs = [getattr(jpg, n)[p, b] for n in (
                "senders_rel", "receivers_rel", "tile_rel", "tile_blk_ptr", "t_receivers_rel",
                "t_tile_rel", "t_tile_blk_ptr", "t_perm")]
            jout, jdchunk, jdpv = jrun(jnp.asarray(chunk), jnp.asarray(np.where(real[:, None], pv, 0.0)),
                                       *arrs)
            ct = torch.from_numpy(chunk).requires_grad_(True)
            pt = torch.from_numpy(pv[:L]).requires_grad_(True)
            out = _bucket_spmm_weighted(ct, pt, pg.bucket(p, b), feat)
            torch.sin(out).sum().backward()
            results.append(dict(
                L=L, E=E, out=out.detach().numpy(), dchunk=ct.grad.numpy(), dpv=pt.grad.numpy(),
                jout=np.asarray(jout), jdchunk=np.asarray(jdchunk), jdpv=np.asarray(jdpv)))
    return results


@pytest.mark.parametrize("what,tol", [("out", TOL), ("dchunk", GRAD_TOL), ("dpv", GRAD_TOL)])
def test_bucket_spmm_weighted_matches_jax_on_every_bucket(weighted_buckets, what, tol):
    assert len(weighted_buckets) == 64 and max(r["L"] for r in weighted_buckets) > 100
    for r in weighted_buckets:
        want = r["j" + what][: r["L"]] if what == "dpv" else r["j" + what]
        np.testing.assert_allclose(r[what], want, **tol)


def test_jax_dpv_is_nonzero_on_padding_slots_and_the_port_has_none(weighted_buckets):
    """The hazard the JAX package records: its ``dpv`` on a padding slot is
    ``chunk[0]·g[0]``, not 0, so its caller has to mask.  The port's ``pv``
    covers the real edges only: there is no slot to leak through."""
    r = max(weighted_buckets, key=lambda r: r["E"] - r["L"])
    assert r["E"] > r["L"] and np.abs(r["jdpv"][r["L"]:]).max() > 0
    assert r["dpv"].shape[0] == r["L"]


def test_bucket_spmm_weighted_adds_into_an_accumulator(twins):
    """A later hop of the ring: ``acc`` is added into in place and the
    gradient passes through it."""
    td, _ = twins
    pg = partition_by_receiver(td.graph, 2)
    rng = np.random.default_rng(8)
    B, heads, feat = pg.block_size, 2, 4

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    chunks = [randn(B, heads * feat).requires_grad_(True) for _ in range(2)]
    pvs = [(randn(int(pg.bucket_edges[0, b]), heads).abs() + 0.1).requires_grad_(True)
           for b in range(2)]
    out = _bucket_spmm_weighted(chunks[0], pvs[0], pg.bucket(0, 0), feat)
    first = out.detach().clone()
    acc = _bucket_spmm_weighted(chunks[1], pvs[1], pg.bucket(0, 1), feat, acc=out)
    assert acc.data_ptr() == out.data_ptr()
    second = _bucket_spmm_weighted(chunks[1].detach(), pvs[1].detach(), pg.bucket(0, 1), feat)
    torch.testing.assert_close(acc.detach(), first + second, **TOL)
    torch.sin(acc).sum().backward()
    g = torch.cos(acc.detach())
    for b in range(2):
        c = chunks[b].detach().clone().requires_grad_(True)
        a = pvs[b].detach().clone().requires_grad_(True)
        _bucket_spmm_weighted(c, a, pg.bucket(0, b), feat).backward(g)
        torch.testing.assert_close(chunks[b].grad, c.grad, **GRAD_TOL)
        torch.testing.assert_close(pvs[b].grad, a.grad, **GRAD_TOL)


# --------------------------------------------------- (f) the wrapper's checks


def test_bucket_reduce_weighted_plain_version_and_bad_input(twins):
    td, _ = twins
    view = partition_by_receiver(td.graph, 2).bucket(1, 0).fwd
    heads, feat = 2, 3
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((view.n_cols, heads * feat)).astype(np.float32))
    alpha = torch.from_numpy(rng.random((view.n_edge, heads)).astype(np.float32))
    out0 = torch.from_numpy(rng.standard_normal((view.n_rows, heads * feat)).astype(np.float32))
    rows = csr_spmm.row_ids(view.row_ptr, view.n_edge)
    msgs = (x[view.col.long()].view(-1, heads, feat) * alpha[:, :, None]).view(-1, heads * feat)
    before = csr_spmm.bucket_weighted_launches
    got = bucket_reduce(view, x, out0.clone(), alpha=alpha, feat=feat)
    torch.testing.assert_close(got, out0.index_add(0, rows, msgs))
    got = bucket_reduce(view, x, torch.full_like(out0, float("nan")), accumulate=False,
                        alpha=alpha, feat=feat)
    torch.testing.assert_close(got, torch.zeros_like(out0).index_add(0, rows, msgs))
    assert csr_spmm.bucket_weighted_launches == before  # CPU tensors take the plain version
    bad = {
        "float64 alpha": (dict(alpha=alpha.double(), feat=feat), TypeError),
        "alpha rows": (dict(alpha=alpha[:-1], feat=feat), ValueError),
        "alpha heads": (dict(alpha=alpha[:, :1].contiguous(), feat=feat), ValueError),
        "non-contiguous alpha": (dict(alpha=alpha.t().contiguous().t(), feat=feat), ValueError),
        "feat not dividing F": (dict(alpha=alpha, feat=4), ValueError),
        "no feat": (dict(alpha=alpha), ValueError),
        "feat without alpha": (dict(feat=feat), ValueError),
        "alpha on another device": (dict(alpha=alpha.to("meta"), feat=feat), ValueError),
        "positional": (dict(alpha=alpha, feat=feat, positional=True), ValueError),
    }
    for name, (kw, err) in bad.items():
        with pytest.raises(err):
            bucket_reduce(view, x, out0.clone(), **kw)
            pytest.fail(name)


# ------------------------------------------------------- (b) gat_sharded


def _gat_inputs(g, heads, feat, seed):
    rng = np.random.default_rng(seed)
    n = g.n_node_pad
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((n, heads), (n, heads), (n, heads, feat)))


def _torch_probe(fn, inputs):
    """Values and the gradients of ``sum(sin(out))`` w.r.t. every input."""
    ts = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    out = fn(*ts)
    grads = torch.autograd.grad(torch.sin(out).sum(), ts)
    return [out.detach().numpy()] + [g.numpy() for g in grads]


@pytest.fixture(scope="module")
def jax_one_part_gat(twins):
    """JAX's ``gat_sharded`` on a one-device mesh: {(mode, rate): (inputs, results)}."""
    _, jd = twins
    jpg, mesh = jpartition(jd.graph, 1), _mesh(1)
    out = {}
    for mode in MODES:
        for rate in (0.0, 0.4):
            inputs = _gat_inputs(jd.graph, 2, 4, seed=20)
            kw = dict(attn_rate=rate, attn_seed=jnp.uint32(99)) if rate else {}

            def f(ss, sd, w):
                return jgat_sharded(jpg, ss, sd, w, mesh, mode=mode, **kw)

            jout, vjp = jax.vjp(jax.jit(f), *(jnp.asarray(a) for a in inputs))
            out[mode, rate] = (inputs, [np.asarray(v) for v in (jout, *vjp(jnp.cos(jout)))])
    return out


@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("mode", MODES)
def test_gat_sharded_one_part_matches_jax_and_single_device(twins, jax_one_part_gat, mode, rate):
    td, _ = twins
    pg = partition_by_receiver(td.graph, 1)
    inputs, want = jax_one_part_gat[mode, rate]
    kw = dict(attn_rate=rate, attn_seed=99) if rate else {}
    got = _torch_probe(lambda ss, sd, w: gat_sharded(pg, ss, sd, w, mode=mode, **kw), inputs)
    single = _torch_probe(lambda ss, sd, w: attention_aggregate(
        td.graph, edge_scores(td.graph, ss, sd), w, dropout_seed=99 if rate else None,
        dropout_rate=rate), inputs)
    for name, a, b, c, tol in zip(("out", "ds_src", "ds_dst", "dwh"), got, want, single,
                                  (TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        np.testing.assert_allclose(a, b, err_msg=f"{name} vs JAX", **tol)
        np.testing.assert_allclose(a, c, err_msg=f"{name} vs attention_aggregate", **tol)
    if rate:  # the mask did drop, and is the hash of global (sender, receiver, head, seed)
        plain = _torch_probe(lambda ss, sd, w: gat_sharded(pg, ss, sd, w, mode=mode), inputs)
        assert not np.allclose(got[0], plain[0], atol=1e-3)
        g = td.graph
        d = attention_dropout_scale(99, g.senders[: g.n_edge], g.receivers[: g.n_edge], 2, rate)
        assert 0.3 < float((d == 0).float().mean()) < 0.5


def test_gat_sharded_rows_without_edges_are_zero_and_checks(twins):
    td, _ = twins
    pg = partition_by_receiver(td.graph, 1)
    ss, sd, wh = (torch.from_numpy(a) for a in _gat_inputs(td.graph, 2, 4, seed=21))
    for mode in MODES:
        out = gat_sharded(pg, ss, sd, wh, mode=mode)
        assert torch.isfinite(out).all()
        assert torch.all(out[td.graph.n_node:] == 0)  # padding rows receive nothing
    with pytest.raises(ValueError, match="mode"):
        gat_sharded(pg, ss, sd, wh, mode="allgather")
    with pytest.raises(ValueError, match="parts"):
        gat_sharded(partition_by_receiver(td.graph, 2), ss[:384], sd[:384], wh[:384])
    with pytest.raises(ValueError, match="wh"):
        gat_sharded(pg, ss, sd, wh[:-1])


# ---------------------------------------------------- (c) the sharded GAT-ODE


def jax_gatode_params(f_in, n_class, seed=0, hidden=HIDDEN, heads=HEADS):
    return {k: np.asarray(v) for k, v in jsgat.init_gatode_params(
        jax.random.PRNGKey(seed), f_in, hidden, heads, n_class).items()}


def jax_sharded_gatode(jd, params, n_parts, *, mode, remat=False, steps=STEPS):
    """JAX's log-probs, loss and parameter gradients on an ``n_parts`` mesh."""
    mesh, jpg = _mesh(n_parts), jpartition(jd.graph, n_parts)
    y1h, w = _labels_weight(synthetic_ogbn_arxiv(seed=0, scale=SCALE))
    x, y1h, w = jshard_batch(mesh, "edge", jnp.asarray(jd.features), jnp.asarray(y1h.numpy()),
                             jnp.asarray(w.numpy()))

    @jax.jit
    def run(p):
        def loss(p):
            lp = jsgat.gatode_forward(p, jpg, x, mesh, steps=steps, mode=mode, remat=remat)
            return jnp.sum(-jnp.sum(lp * y1h, axis=-1) * w) / jnp.sum(w), lp

        (val, lp), grads = jax.value_and_grad(loss, has_aux=True)(p)
        return lp, val, grads

    lp, loss, grads = run({k: jnp.asarray(v) for k, v in params.items()})
    return np.asarray(lp), float(loss), {k: np.asarray(v) for k, v in grads.items()}


def torch_sharded_gatode(td, params, *, mode, remat=False, steps=STEPS):
    model = sharded_gat.init_gatode_params(td.features.shape[1], HIDDEN, HEADS, td.n_class)
    model.load_state_dict(params_from_sharded_gat(params))
    y1h, w = _labels_weight(td)
    pg = partition_by_receiver(td.graph, 1)
    lp = sharded_gat.gatode_forward(model, pg, td.features, steps=steps, mode=mode, remat=remat)
    loss = -(lp * y1h).sum(-1).mul(w).sum() / w.sum()
    loss.backward()
    return lp.detach().numpy(), loss.item(), {k: p.grad.numpy() for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def jax_gatode(twins):
    td, jd = twins
    params = jax_gatode_params(td.features.shape[1], td.n_class)
    return params, jax_sharded_gatode(jd, params, 1, mode="ring_pallas")


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_gatode_forward_matches_jax(twins, jax_gatode, mode, remat):
    td, _ = twins
    params, (jlp, jloss, jgrads) = jax_gatode
    lp, loss, grads = torch_sharded_gatode(td, params, mode=mode, remat=remat)
    np.testing.assert_allclose(lp, jlp, **TOL)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert sorted(grads) == sorted(jgrads) and len(grads) == 9
    for k, g in grads.items():
        np.testing.assert_allclose(g, jgrads[k], err_msg=k, **PARAM_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_gatode_remat_changes_nothing(twins, jax_gatode, mode):
    td, _ = twins
    params, _ = jax_gatode
    lp0, loss0, g0 = torch_sharded_gatode(td, params, mode=mode, remat=False)
    lp1, loss1, g1 = torch_sharded_gatode(td, params, mode=mode, remat=True)
    np.testing.assert_array_equal(lp0, lp1)
    assert loss0 == loss1
    for k in g0:  # the recomputed forward repeats the same f32 operations
        np.testing.assert_allclose(g1[k], g0[k], err_msg=k, rtol=2e-5, atol=1e-7)


def test_gatode_dropout_is_seeded_and_off_in_evaluation(twins):
    td, _ = twins
    model = sharded_gat.init_gatode_params(td.features.shape[1], HIDDEN, HEADS, td.n_class,
                                           generator=torch.Generator().manual_seed(0))
    pg = partition_by_receiver(td.graph, 1)

    def run(seed, **kw):
        gens = {} if seed is None else dict(
            generator=torch.Generator().manual_seed(seed),
            seed_generator=torch.Generator().manual_seed(seed))
        with torch.no_grad():
            return sharded_gat.gatode_forward(model, pg, td.features, steps=STEPS, dropout=0.4,
                                              **gens, **kw)

    torch.testing.assert_close(run(1), run(1))
    assert not torch.allclose(run(1), run(2))
    torch.testing.assert_close(run(1, mode="ring_pallas"), run(1, mode="ring"), **TOL)
    torch.testing.assert_close(  # no generator: evaluation, no dropout
        run(None), sharded_gat.gatode_forward(model, pg, td.features, steps=STEPS).detach())
    with pytest.raises(ValueError, match="seed_generator"):
        sharded_gat.gatode_forward(model, pg, td.features, dropout=0.4,
                                   generator=torch.Generator().manual_seed(0))


def test_params_from_sharded_gat_keeps_names_and_layouts(twins):
    td, _ = twins
    params = jax_gatode_params(td.features.shape[1], td.n_class)
    state = params_from_sharded_gat(params)
    model = sharded_gat.init_gatode_params(td.features.shape[1], HIDDEN, HEADS, td.n_class)
    assert [k for k, _ in model.named_parameters()] == list(params)  # JAX's order of draws
    for k, p in model.named_parameters():
        assert tuple(p.shape) == params[k].shape, k
        np.testing.assert_array_equal(state[k].numpy(), params[k])
        limit = np.sqrt(6.0 / sum(p.shape))  # Glorot uniform, as JAX's initialiser
        assert 0.5 * limit < float(p.detach().abs().max()) <= limit, k
    with pytest.raises(KeyError):
        params_from_sharded_gat({k: v for k, v in params.items() if k != "w_dyn"})


# ------------------------------------------------------------ (d) the trainer


TRAIN = dict(model="gatode", hidden=HIDDEN, heads=HEADS, steps=STEPS, epochs=3, dropout=0.0,
             eval_every=1, n_parts=1, seed=3)


@pytest.fixture(scope="module")
def jax_three_epochs(twins):
    _, jd = twins
    return jfit_sharded(JShardedTrainConfig(**TRAIN), jd)


@pytest.mark.parametrize("mode,remat", [("ring", False), ("ring_pallas", True)])
def test_three_adam_epochs_match_jax_trainer(twins, jax_three_epochs, mode, remat):
    """``fit_sharded_node_classifier(model="gatode")`` from the JAX
    initialisation (dropout 0, evaluation every epoch) against the JAX
    trainer: the losses, the best epoch's metrics and parameters."""
    td, _ = twins
    jres = jax_three_epochs
    params0 = jax_gatode_params(td.features.shape[1], td.n_class, seed=TRAIN["seed"])
    tres = fit_sharded_node_classifier(
        ShardedTrainConfig(**TRAIN, mode=mode, remat=remat), td, device="cpu",
        init_state=params_from_sharded_gat(params0))
    assert (tres["epochs_run"], tres["best_epoch"], tres["n_parts"]) == (
        jres["epochs_run"], jres["best_epoch"], 1)
    for k in ("loss_first", "loss_final", "val_loss", "val_acc", "test_acc"):
        np.testing.assert_allclose(tres[k], jres[k], err_msg=k, **PARAM_TOL)
    for k, v in tres["params"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jres["params"][k]), err_msg=k,
                                   rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("mode", MODES)
def test_sharded_gatode_trains_on_the_cpu(twins, mode):
    td, _ = twins
    cfg = ShardedTrainConfig(model="gatode", hidden=16, heads=2, steps=2, epochs=8,
                             eval_every=2, lr=0.005, dropout=0.4, mode=mode, remat=True)
    res = fit_sharded_node_classifier(cfg, td, device="cpu")
    assert res["epochs_run"] == 8 and res["n_parts"] == 1 and res["step_ms"] > 0
    assert res["loss_final"] < res["loss_first"], res
    assert sorted(res["params"]) == sorted(params_from_sharded_gat(
        jax_gatode_params(td.features.shape[1], td.n_class, hidden=16)))


def test_trainer_rejects_allgather_and_unknown_models_for_gatode(twins):
    td, _ = twins
    with pytest.raises(ValueError, match="mode"):
        fit_sharded_node_classifier(
            ShardedTrainConfig(model="gatode", mode="allgather"), td, device="cpu")
    with pytest.raises(ValueError, match="model"):
        fit_sharded_node_classifier(ShardedTrainConfig(model="gat"), td, device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fit_sharded_node_classifier(ShardedTrainConfig(model="gatode"), td)
