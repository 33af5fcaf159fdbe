"""Port parity, edge-partitioned tier, in one process: the arxiv twin, the
partition, the bucket reductions (B2's plain version on the CPU) and the
one-part sharded GCN-ODE against the JAX package; config 4 on the CPU.

JAX runs as its own tests run it: the 8-device CPU mesh of
``tests/conftest.py``, the Pallas bucket kernel in interpret mode.  The
gloo worlds of 2 and 4 ranks are in ``test_torch_gloo2.py`` and
``test_torch_gloo4.py``.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_odenet_tpu.data.ogbn import synthetic_ogbn_arxiv as jtwin
from graph_odenet_tpu.parallel import halo as jhalo
from graph_odenet_tpu.parallel import make_mesh
from graph_odenet_tpu.parallel import partition_by_receiver as jpartition
from graph_odenet_tpu.parallel import sharded_gcn as jsg
from graph_odenet_tpu.parallel.trainer import ShardedTrainConfig as JShardedTrainConfig
from graph_odenet_tpu.parallel.trainer import fit_sharded_node_classifier as jfit_sharded
from graph_odenet_tpu_torch.convert import params_from_sharded
from graph_odenet_tpu_torch.data import synthetic_ogbn_arxiv
from graph_odenet_tpu_torch.ops import csr_spmm
from graph_odenet_tpu_torch.ops.csr_spmm import SEG_EDGES, bucket_reduce, row_ids
from graph_odenet_tpu_torch.parallel import (
    padded_buckets, partition_by_receiver, sharded_gcn, spmm_sharded,
)
from graph_odenet_tpu_torch.parallel.halo import _bucket_spmm, bucket_reduce_pallas

from torch_dist_worlds import _labels_weight

SCALE = 0.004  # 677 nodes, padded to 768
TOL = dict(rtol=1e-5, atol=1e-5)  # f32 sums in another order; hub columns reach ~35
FWD_TOL = dict(rtol=2e-4, atol=1e-6)


@pytest.fixture(scope="module")
def twins():
    return synthetic_ogbn_arxiv(seed=0, scale=SCALE), jtwin(seed=0, scale=SCALE)


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("scale", [SCALE, 0.05])
def test_arxiv_twin_equals_jax(scale, calibrated):
    t = synthetic_ogbn_arxiv(seed=3, scale=scale, calibrated=calibrated)
    j = jtwin(seed=3, scale=scale, calibrated=calibrated)
    assert (t.name, t.n_class, t.graph.n_node, t.graph.n_edge, t.graph.n_node_pad) == (
        j.name, j.n_class, j.graph.n_node, j.graph.n_edge, j.graph.n_node_pad)
    pairs = [
        (t.features, j.features), (t.labels, j.labels), (t.graph.senders, j.graph.senders),
        (t.graph.receivers, j.graph.receivers), (t.graph.weight, j.graph.weight),
        (t.idx_train, j.idx_train), (t.idx_val, j.idx_val), (t.idx_test, j.idx_test),
    ]
    for a, b in pairs:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


ARRAYS = ("senders_rel", "receivers_rel", "weight", "t_senders_rel", "t_receivers_rel",
          "t_weight", "t_perm")


@pytest.mark.parametrize("edge_multiple", [8, 1024])
@pytest.mark.parametrize("n_parts", [1, 2, 4, 8])
def test_partition_is_byte_equal_and_views_match(twins, n_parts, edge_multiple):
    td, jd = twins
    pg = partition_by_receiver(td.graph, n_parts)
    pad = padded_buckets(pg, edge_multiple=edge_multiple)
    jpg = jpartition(jd.graph, n_parts, edge_multiple=edge_multiple)
    assert (pg.block_size, pg.n_parts, pg.n_node_pad, pg.n_edge, pad.e_bucket) == (
        jpg.block_size, jpg.n_parts, jpg.n_node_pad, jpg.n_edge, jpg.e_bucket)
    for name in ARRAYS:
        a, b = getattr(pad, name).numpy(), np.asarray(getattr(jpg, name))
        assert (a.dtype, a.shape) == (b.dtype, b.shape), name
        assert a.tobytes() == b.tobytes(), name
    np.testing.assert_array_equal(pad.senders_global().numpy(), np.asarray(jpg.senders_global()))

    B = pg.block_size
    assert int(pg.bucket_edges.sum()) == td.graph.n_edge
    for p in range(n_parts):
        for b in range(n_parts):
            L = int(pg.bucket_edges[p, b])
            bk = pg.bucket(p, b)
            for view, rows, cols, w in (
                (bk.fwd, pad.receivers_rel, pad.senders_rel, pad.weight),
                (bk.bwd, pad.t_senders_rel, pad.t_receivers_rel, pad.t_weight),
            ):
                assert (view.n_rows, view.n_cols, view.n_edge) == (B, B, L)
                np.testing.assert_array_equal(
                    view.row_ptr.numpy(), np.r_[0, np.cumsum(np.bincount(rows[p, b, :L], minlength=B))])
                np.testing.assert_array_equal(view.col.numpy(), cols[p, b, :L].numpy())
                np.testing.assert_array_equal(view.weight.numpy(), w[p, b, :L].numpy())
                seg = view.part.seg_ptr.numpy()
                assert seg[0] == 0 and seg[-1] == L and np.all(np.diff(seg) >= 1)
                assert np.all(np.diff(seg) <= SEG_EDGES)  # edgeless rows have no segment
                np.testing.assert_array_equal(  # ... and are listed for the write form
                    view.part.empty_row.numpy(), np.nonzero(np.diff(view.row_ptr.numpy()) == 0)[0])


def _bucket_arrays(jpg, p, b):
    pick = lambda name: getattr(jpg, name)[p, b]  # noqa: E731
    return [pick(n) for n in ("senders_rel", "receivers_rel", "weight", "tile_rel",
                              "tile_blk_ptr", "t_senders_rel", "t_receivers_rel",
                              "t_weight", "t_tile_rel", "t_tile_blk_ptr")]


@pytest.mark.parametrize("fn", ["bucket_reduce_pallas", "_bucket_spmm"])
def test_bucket_reductions_match_jax(twins, fn):
    """Values and ``d sum(sin(out))`` of every bucket of a 2-part partition,
    the JAX functions on the interpret-mode Pallas kernel.  Padding slots
    carry nonzero messages: JAX's forward and the port's ignore them."""
    td, jd = twins
    n_parts, f = 2, 12
    pg = partition_by_receiver(td.graph, n_parts)
    jpg = jpartition(jd.graph, n_parts)
    B, E = pg.block_size, padded_buckets(pg).e_bucket
    rng = np.random.default_rng(5)
    for p in range(n_parts):
        for b in range(n_parts):
            L = int(pg.bucket_edges[p, b])
            arrs = _bucket_arrays(jpg, p, b)
            if fn == "bucket_reduce_pallas":
                x = rng.standard_normal((E, f)).astype(np.float32)
                rel2d, blk_ptr, receivers = arrs[3], arrs[4], arrs[1]
                jfun = lambda m: jhalo.bucket_reduce_pallas(m, rel2d, blk_ptr, receivers)[:B]  # noqa: E731
                tf = lambda m: bucket_reduce_pallas(m, pg.bucket(p, b))  # noqa: E731
            else:
                x = rng.standard_normal((B, f)).astype(np.float32)
                jfun = lambda c: jhalo._bucket_spmm(True, B, c, *arrs)  # noqa: E731
                tf = lambda c: _bucket_spmm(c, pg.bucket(p, b))  # noqa: E731
            jout, vjp = jax.vjp(jfun, jnp.asarray(x))
            (jgrad,) = vjp(jnp.cos(jout))
            xt = torch.from_numpy(x).requires_grad_(True)
            out = tf(xt)
            torch.sin(out).sum().backward()
            np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
            if fn == "bucket_reduce_pallas":
                # JAX fills the padding slots' gradient with g[0]; the port with 0.
                np.testing.assert_allclose(xt.grad[:L].numpy(), np.asarray(jgrad)[:L], **TOL)
                assert torch.all(xt.grad[L:] == 0)
            else:
                np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), **TOL)


@pytest.mark.parametrize("fn", ["bucket_reduce_pallas", "_bucket_spmm"])
def test_bucket_padding_slots_contribute_nothing(twins, fn):
    """A caller that does not mask the padding slots: they add nothing to the
    output and get (``bucket_reduce_pallas``) or give (``_bucket_spmm``) no
    gradient.  Reference: the bucket as a dense matrix of its real edges."""
    td, _ = twins
    pg = partition_by_receiver(td.graph, 2)
    pad = padded_buckets(pg)
    B, E, f = pg.block_size, pad.e_bucket, 5
    rng = np.random.default_rng(6)
    for p, b in ((0, 0), (1, 0)):
        L = int(pg.bucket_edges[p, b])
        r = pad.receivers_rel[p, b].long()
        s = pad.senders_rel[p, b].long()
        w = pad.weight[p, b].double()
        assert E > L and torch.all(w[L:] == 0) and torch.all(r[L:] == 0)
        dense = torch.zeros(B, B if fn == "_bucket_spmm" else E, dtype=torch.float64)
        if fn == "_bucket_spmm":
            dense.index_put_((r[:L], s[:L]), w[:L], accumulate=True)
        else:
            dense[r[:L], torch.arange(L)] = 1.0
        x = torch.from_numpy(rng.standard_normal((dense.shape[1], f)).astype(np.float32) * 100)
        g = torch.from_numpy(rng.standard_normal((B, f)).astype(np.float32))
        xr = x.clone().requires_grad_(True)
        fun = _bucket_spmm if fn == "_bucket_spmm" else bucket_reduce_pallas
        out = fun(xr, pg.bucket(p, b))
        out.backward(g)
        torch.testing.assert_close(out.double(), dense @ x.double(), rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(xr.grad.double(), dense.T @ g.double(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("accumulate", [True, False])
def test_bucket_reduce_accumulates_or_writes_and_rejects_bad_input(twins, accumulate):
    td, _ = twins
    pg = partition_by_receiver(td.graph, 2)
    view = pg.bucket(1, 0).fwd
    assert view.part.empty_row.numel() > 0  # rows without edges: the write form zeroes them
    x = torch.randn(view.n_cols, 7)
    out0 = torch.randn(view.n_rows, 7)
    before = csr_spmm.bucket_launches
    start = out0.clone() if accumulate else torch.full_like(out0, float("nan"))
    got = bucket_reduce(view, x, start, accumulate=accumulate)
    rows = row_ids(view.row_ptr, view.n_edge)
    base = out0 if accumulate else torch.zeros_like(out0)
    want = base.index_add(0, rows, x[view.col.long()] * view.weight[:, None])
    torch.testing.assert_close(got, want)
    assert csr_spmm.bucket_launches == before  # CPU tensors take the plain version
    bad = {
        "float64 x": (x.double(), out0, TypeError),
        "float64 out": (x, out0.double(), TypeError),
        "non-contiguous x": (x.t().contiguous().t(), out0, ValueError),
        "wrong table rows": (x[:-1], out0, ValueError),
        "wrong out rows": (x, out0[:-1], ValueError),
        "wrong width": (x, out0[:, :3].contiguous(), ValueError),
    }
    for xb, ob, err in bad.values():
        with pytest.raises(err):
            bucket_reduce(view, xb, ob)
    with pytest.raises(ValueError, match="sorted by row"):
        csr_spmm.csr_view([1, 0], [0, 0], [1.0, 1.0], 2, 2)


def _jax_params(f_in, hidden, n_class, seed=0):
    return {k: np.asarray(v) for k, v in
            jsg.init_params(jax.random.PRNGKey(seed), f_in, hidden, n_class).items()}


def jax_sharded_gcn(jd, params, n_parts, steps):
    """JAX's log-probs, loss and parameter gradients on an ``n_parts`` mesh."""
    mesh = make_mesh(shape=(n_parts,), axis_names=("edge",), devices=jax.devices()[:n_parts])
    jpg = jpartition(jd.graph, n_parts)
    y1h, w = _labels_weight(synthetic_ogbn_arxiv(seed=0, scale=SCALE))
    x = jnp.asarray(jd.features)
    args = (jpg, x, jnp.asarray(y1h.numpy()), jnp.asarray(w.numpy()), mesh)

    @jax.jit
    def run(p):
        loss, grads = jax.value_and_grad(jsg.loss_fn)(p, *args, steps=steps, mode="ring")
        return jsg.forward(p, jpg, x, mesh, steps=steps, mode="ring"), loss, grads

    lp, loss, grads = run({k: jnp.asarray(v) for k, v in params.items()})
    return np.asarray(lp), float(loss), {k: np.asarray(v) for k, v in grads.items()}


@pytest.fixture(scope="module")
def jax_one_part(twins):
    td, jd = twins
    params = _jax_params(td.features.shape[1], 16, td.n_class)
    return params, jax_sharded_gcn(jd, params, 1, steps=2)


@pytest.mark.parametrize("mode", ["ring", "allgather"])
def test_one_part_sharded_gcn_matches_jax(twins, jax_one_part, mode):
    td, _ = twins
    params, (jlp, jloss, jgrads) = jax_one_part
    model = sharded_gcn.init_params(td.features.shape[1], 16, td.n_class)
    model.load_state_dict(params_from_sharded(params))
    y1h, w = _labels_weight(td)
    pg = partition_by_receiver(td.graph, 1)
    loss = sharded_gcn.loss_fn(model, pg, td.features, y1h, w, steps=2, mode=mode)
    loss.backward()
    with torch.no_grad():
        lp = sharded_gcn.forward(model, pg, td.features, steps=2, mode=mode)
    np.testing.assert_allclose(lp.numpy(), jlp, **FWD_TOL)
    np.testing.assert_allclose(loss.item(), jloss, **FWD_TOL)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[k], err_msg=k, **FWD_TOL)


def test_sharded_forward_dropout_draws_one_global_mask(twins):
    td, _ = twins
    model = sharded_gcn.init_params(td.features.shape[1], 8, td.n_class,
                                    generator=torch.Generator().manual_seed(0))
    pg = partition_by_receiver(td.graph, 1)

    def run(seed):
        return sharded_gcn.forward(model, pg, td.features, steps=2, dropout=0.5,
                                   generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(1), run(1))
    assert not torch.allclose(run(1), run(2))
    torch.testing.assert_close(  # no generator: evaluation, no dropout
        sharded_gcn.forward(model, pg, td.features, steps=2, dropout=0.5),
        sharded_gcn.forward(model, pg, td.features, steps=2))


def test_spmm_sharded_checks_and_unported_options(twins, monkeypatch):
    """The argument checks; ``check_vma`` ignored; ``feat_axis`` refusing
    slices of another width (a feature axis of two ranks, the other rank's
    width delivered by a stand-in gather; the 4-rank gloo world runs the
    real one)."""
    from graph_odenet_tpu_torch.parallel import halo

    td, _ = twins
    x = torch.randn(td.graph.n_node_pad, 4)
    pg1 = partition_by_receiver(td.graph, 1)
    with pytest.raises(ValueError, match="parts"):  # two parts, no process group
        spmm_sharded(partition_by_receiver(td.graph, 2), x[:384], mode="ring")
    with pytest.raises(ValueError, match="mode"):
        spmm_sharded(pg1, x, mode="scatter")
    with pytest.raises(ValueError, match="rows"):
        spmm_sharded(pg1, x[:-1])
    # One part: every mode is Â x, whatever check_vma says.
    want = csr_spmm.spmm_csr_reference(csr_spmm.prepare(td.graph), x)
    for mode in ("allgather", "ring", "ring_pallas"):
        for vma in (None, False, True):
            torch.testing.assert_close(spmm_sharded(pg1, x, mode=mode, check_vma=vma), want,
                                       rtol=1e-5, atol=1e-6)
    feat, other = object(), []
    monkeypatch.setattr(halo, "world", lambda group=None: (2, 0) if group is feat else (1, 0))
    monkeypatch.setattr(halo.dist, "all_gather_into_tensor",
                        lambda out, t, group: out.copy_(torch.tensor([int(t[0]), other[-1]])))
    other.append(3)
    with pytest.raises(ValueError, match="width"):
        spmm_sharded(pg1, x, feat_axis=feat)
    other.append(4)
    torch.testing.assert_close(spmm_sharded(pg1, x, feat_axis=feat), want, rtol=1e-5, atol=1e-6)


# The keys of graph_odenet_tpu.configs.run_config(4)'s result.
JAX_CONFIG4_KEYS = {
    "config", "dataset", "test_acc", "val_acc", "val_loss", "best_epoch", "epochs_run",
    "step_ms", "loss_first", "loss_final", "seconds", "n_parts",
}


def test_run_config_4_on_cpu():
    from graph_odenet_tpu_torch.configs import ShardedConfig, get_config, run_config

    kind, cfg = get_config(4)
    assert kind == "sharded" and cfg == ShardedConfig() and get_config("ogbn-arxiv-gcnode-sharded")[1] == cfg
    assert (cfg.hidden, cfg.steps, cfg.lr, cfg.weight_decay, cfg.dropout, cfg.epochs, cfg.n_parts,
            cfg.mode) == (256, 4, 0.01, 5e-4, 0.5, 30, 8, "ring")
    res = run_config(4, scale=SCALE, device="cpu")
    assert set(res) == JAX_CONFIG4_KEYS
    assert res["config"] == "ogbn-arxiv-gcnode-sharded" and res["dataset"] == "ogbn-arxiv-synthetic"
    assert res["epochs_run"] == 30 and res["n_parts"] == 1 and res["best_epoch"] >= 0
    assert np.isfinite(res["loss_final"]) and res["step_ms"] > 0 and 0.0 <= res["test_acc"] <= 1.0


RESUME_CFG = {
    "gcnode": dict(model="gcnode", hidden=16, steps=2, dropout=0.5, eval_every=2),
    "gatode": dict(model="gatode", hidden=8, heads=2, steps=2, dropout=0.5, eval_every=2,
                   mode="ring_pallas"),
}


@pytest.mark.parametrize("model", sorted(RESUME_CFG))
def test_resume_is_bit_identical(twins, tmp_path, model):
    """tests/test_fault_recovery.py:45-75 through the trainer, dropout
    included: 5 epochs straight, against 3 epochs, a lost process (nothing
    kept but the checkpoint directory) and a fresh call to 5.  The resumed
    epochs' losses and the last checkpoint (parameters, Adam state, both
    dropout generators) are bit-equal to the uninterrupted run's."""
    from graph_odenet_tpu_torch.parallel import ShardedTrainConfig, fit_sharded_node_classifier
    from graph_odenet_tpu_torch.utils import Checkpointer

    td = twins[0]
    cfg = dict(RESUME_CFG[model], ckpt_every=1)
    straight = fit_sharded_node_classifier(
        ShardedTrainConfig(**cfg, epochs=5, ckpt_dir=str(tmp_path / "a")), td, device="cpu")
    first = fit_sharded_node_classifier(
        ShardedTrainConfig(**cfg, epochs=3, ckpt_dir=str(tmp_path / "b")), td, device="cpu")
    assert first["losses"] == straight["losses"][:3]  # deterministic up to the fault
    del first  # the failure: the live state is lost
    resumed = fit_sharded_node_classifier(
        ShardedTrainConfig(**cfg, epochs=5, ckpt_dir=str(tmp_path / "b")), td, device="cpu")
    assert resumed["epochs_run"] == 5 and resumed["losses"] == straight["losses"][3:]
    a, b = Checkpointer(str(tmp_path / "a")), Checkpointer(str(tmp_path / "b"))
    assert a.latest_step() == b.latest_step() == 4
    sa, sb = a.restore(None), b.restore(None)
    assert sa["epoch"] == sb["epoch"] == 4
    for part in ("params", "drop_rng", "seed_rng"):
        for k, v in (sa[part].items() if isinstance(sa[part], dict) else [("", sa[part])]):
            w = sb[part][k] if k else sb[part]
            torch.testing.assert_close(v, w, rtol=0, atol=0, msg=lambda m: f"{part} {k}: {m}")
    for i, st in sa["opt_state"]["state"].items():
        for k, v in st.items():
            torch.testing.assert_close(v, sb["opt_state"]["state"][i][k], rtol=0, atol=0)


def test_trainer_restart_resumes_from_the_latest_step(twins, tmp_path):
    """tests/test_sharded_train.py:51-68: a fresh call with a larger epoch
    budget picks up after the last saved epoch instead of starting over."""
    from graph_odenet_tpu_torch.parallel import ShardedTrainConfig, fit_sharded_node_classifier

    ckpt = str(tmp_path / "ckpt")
    common = dict(model="gcnode", hidden=32, steps=2, ckpt_dir=ckpt, ckpt_every=1)
    fit_sharded_node_classifier(ShardedTrainConfig(**common, epochs=4), twins[0], device="cpu")
    res = fit_sharded_node_classifier(ShardedTrainConfig(**common, epochs=6), twins[0],
                                      device="cpu")
    assert res["epochs_run"] == 6 and len(res["losses"]) == 2  # epochs 4 and 5 only
    assert res["loss_first"] is not None and res["step_ms"] is not None


def test_checkpoint_every_and_the_last_epoch(twins, tmp_path):
    """JAX's schedule: every ``ckpt_every`` epochs and the last; the newest
    three are kept.  A call with nothing left to run runs nothing."""
    from graph_odenet_tpu_torch.parallel import ShardedTrainConfig, fit_sharded_node_classifier
    from graph_odenet_tpu_torch.utils import Checkpointer

    cfg = ShardedTrainConfig(model="gcnode", hidden=8, steps=2, epochs=8, ckpt_every=3,
                             ckpt_dir=str(tmp_path))
    fit_sharded_node_classifier(cfg, twins[0], device="cpu")
    assert Checkpointer(str(tmp_path)).steps() == [3, 6, 7]
    again = fit_sharded_node_classifier(cfg, twins[0], device="cpu")
    assert again["epochs_run"] == 8 and again["losses"] == []


def test_run_config_4_resumes_from_ckpt_dir(tmp_path):
    """``run_config(4, ckpt_dir=)``: the second call resumes after the latest
    step, here epoch 20 of 30 (the last step's file removed), and ends where
    the first ended, bit for bit, dropout 0.5 included."""
    from graph_odenet_tpu_torch.configs import run_config

    first = run_config(4, scale=SCALE, device="cpu", ckpt_dir=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["step_10.pt", "step_20.pt", "step_29.pt"]
    os.unlink(tmp_path / "step_29.pt")
    second = run_config(4, scale=SCALE, device="cpu", ckpt_dir=str(tmp_path))
    assert set(second) == JAX_CONFIG4_KEYS and second["epochs_run"] == 30
    assert second["loss_final"] == first["loss_final"]


def test_mesh_helpers_without_a_process_group(monkeypatch):
    from graph_odenet_tpu_torch.parallel import bootstrap_distributed, mesh, world

    assert world() == (1, 0) and bootstrap_distributed() == (1, 0)
    assert bootstrap_distributed("tcp://localhost:1", world_size=1, rank=0, device="cpu") == (1, 0)
    assert mesh.device_for("cpu", 3) == torch.device("cpu")
    # A CPU tensor needs gloo: an NCCL group would refuse it, and a card's
    # tensor is never staged through the host for gloo.
    monkeypatch.setattr(mesh.dist, "get_backend", lambda: "nccl")
    with pytest.raises(ValueError, match="gloo"):
        mesh.check_backend(torch.zeros(2))
    monkeypatch.setattr(mesh.dist, "get_backend", lambda: "gloo")
    mesh.check_backend(torch.zeros(2))


def test_check_parts_refuses_a_partition_of_another_size(twins, monkeypatch):
    """``mesh.check_parts``: the group's ``(size, rank)`` when the partition
    has as many parts, else one message; the backend is checked over several
    parts only (a 4-rank subgroup stood in by monkeypatching ``mesh.world``)."""
    from graph_odenet_tpu_torch.parallel import mesh

    td, _ = twins
    x = torch.zeros(4)
    monkeypatch.setattr(mesh.dist, "get_backend", lambda *group: "nccl")
    assert mesh.check_parts(partition_by_receiver(td.graph, 1), x) == (1, 0)
    with pytest.raises(ValueError, match=re.escape(
            "partitioning has 2 parts, but the default process group has 1")):
        mesh.check_parts(partition_by_receiver(td.graph, 2), x)
    grp = object()
    monkeypatch.setattr(mesh, "world", lambda group=None: (4, 1) if group is grp else (1, 0))
    monkeypatch.setattr(mesh.dist, "get_process_group_ranks", lambda group: [0, 2, 4, 6])
    with pytest.raises(ValueError, match=re.escape(
            "partitioning has 2 parts, but the process group of ranks [0, 2, 4, 6] has 4")):
        mesh.check_parts(partition_by_receiver(td.graph, 2), x, grp)
    pg4 = partition_by_receiver(td.graph, 4)
    with pytest.raises(ValueError, match="gloo"):
        mesh.check_parts(pg4, x, grp)
    monkeypatch.setattr(mesh.dist, "get_backend", lambda *group: "gloo")
    assert mesh.check_parts(pg4, x, grp) == (4, 1)


def _rk4_loop(dyn, h, steps, t1):
    """Classic rk4 as each sharded model wrote it out before ``model_parts.rk4``."""
    dt = t1 / steps
    for _ in range(steps):
        k1 = dyn(h)
        k2 = dyn(h + 0.5 * dt * k1)
        k3 = dyn(h + 0.5 * dt * k2)
        k4 = dyn(h + dt * k3)
        h = h + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return h


@pytest.mark.parametrize("steps", [1, 4])
def test_rk4_is_the_models_loop_bit_for_bit(steps):
    from graph_odenet_tpu_torch.parallel.model_parts import rk4

    gen = torch.Generator().manual_seed(steps)
    w, b = torch.randn(16, 16, generator=gen) / 4, torch.randn(16, generator=gen)
    h0 = torch.randn(32, 16, generator=gen)
    calls = []

    def dyn(h):
        calls.append(1)
        return torch.tanh(h @ w + b) * h - 0.3 * h * h

    got = rk4(dyn, h0, steps, 0.7)
    assert len(calls) == 4 * steps and got.dtype == torch.float32
    assert torch.equal(got, _rk4_loop(dyn, h0, steps, 0.7))


@pytest.mark.parametrize("model, change, message", [
    ("gcnode", dict(mode="scatter"),
     "unknown mode 'scatter'; one of ('allgather', 'ring', 'ring_pallas')"),
    ("gatode", dict(mode="allgather"),
     "unknown mode 'allgather' for gatode; one of ('ring', 'ring_pallas')"),
    ("grandnl", dict(mode="ring"),
     "grandnl runs mode='ring_pallas' without remat, got mode='ring', remat=False"),
    ("grandnl", dict(mode="ring_pallas", remat=True),
     "grandnl runs mode='ring_pallas' without remat, got mode='ring_pallas', remat=True"),
])
def test_trainer_table_refuses_each_models_other_modes(twins, model, change, message):
    """Each model's entry in the trainer's table refuses a ``mode`` or
    ``remat`` it does not take, with the message its code gave before."""
    from graph_odenet_tpu_torch.parallel import ShardedTrainConfig, fit_sharded_node_classifier

    cfg = ShardedTrainConfig(model=model, hidden=8, heads=2, steps=1, epochs=1, **change)
    with pytest.raises(ValueError, match=re.escape(message) + "$"):
        fit_sharded_node_classifier(cfg, twins[0], device="cpu")


def test_sgd_train_step_matches_jax(twins):
    """``sharded_gcn.train_step`` (one SGD step on the global loss) against
    the JAX package's on one part: the loss and the updated parameters."""
    td, jd = twins
    params = _jax_params(td.features.shape[1], 8, td.n_class, seed=1)
    mesh = make_mesh(shape=(1,), axis_names=("edge",), devices=jax.devices()[:1])
    y1h, w = _labels_weight(td)
    jnew, jloss = jax.jit(lambda p: jsg.train_step(
        p, jpartition(jd.graph, 1), jnp.asarray(jd.features), jnp.asarray(y1h.numpy()),
        jnp.asarray(w.numpy()), mesh, lr=0.5, steps=2))({k: jnp.asarray(v) for k, v in params.items()})
    model = sharded_gcn.init_params(td.features.shape[1], 8, td.n_class)
    model.load_state_dict(params_from_sharded(params))
    model, loss = sharded_gcn.train_step(model, partition_by_receiver(td.graph, 1), td.features,
                                         y1h, w, lr=0.5, steps=2)
    np.testing.assert_allclose(loss.item(), float(jloss), **FWD_TOL)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jnew[k]), err_msg=k, **FWD_TOL)


def test_three_adam_epochs_match_jax_trainer(twins):
    """``fit_sharded_node_classifier`` against the JAX package's on one part
    from the JAX initialisation (dropout 0, evaluation every epoch): Adam
    with L2 in the gradient, the losses, the best epoch's metrics and
    parameters."""
    td, jd = twins
    common = dict(hidden=16, steps=2, epochs=3, dropout=0.0, eval_every=1, n_parts=1, seed=3)
    jres = jfit_sharded(JShardedTrainConfig(**common), jd)
    jparams0 = _jax_params(td.features.shape[1], 16, td.n_class, seed=common["seed"])
    from graph_odenet_tpu_torch.parallel import ShardedTrainConfig, fit_sharded_node_classifier

    tres = fit_sharded_node_classifier(ShardedTrainConfig(**common), td, device="cpu",
                                       init_state=params_from_sharded(jparams0))
    assert (tres["epochs_run"], tres["best_epoch"], tres["n_parts"]) == (
        jres["epochs_run"], jres["best_epoch"], 1)
    for k in ("loss_first", "loss_final", "val_loss", "val_acc", "test_acc"):
        np.testing.assert_allclose(tres[k], jres[k], err_msg=k, **FWD_TOL)
    want = params_from_sharded({k: np.asarray(v) for k, v in jres["params"].items()})
    assert sorted(tres["params"]) == sorted(want)
    for k, v in tres["params"].items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **FWD_TOL)
