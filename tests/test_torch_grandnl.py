"""GRAND-nl through the edge-partitioned tier (``parallel.sharded_grand``) on
the CPU, against the benchmark's plain reference
(``perfbench/reference/grandnl.py``: plain PyTorch over the whole graph on
one device, which imports nothing of the port).

* ``halo.bucket_scores``: forward and both gradients against a float64
  gather, product and sum, on one bucket and on every bucket of a 2-part
  partition.
* ``grandnl_forward``: log-probs with and without feature dropout, the NLL
  over the training nodes and every parameter's gradient from seeded random
  weights (α, β and the biases away from their initial values), on one part
  in this process and on 2 and 4 gloo ranks (``torch_dist_worlds``).
* ``fit_sharded_node_classifier(model="grandnl")``: three epochs against the
  reference's three steps (``run_steps``), held by the benchmark's own
  measure (``harness.compare``): losses, first gradient, change.

Tolerances: every path here is float32 on the CPU, the program's sums in
another order than the reference's (per bucket, over the partition's edge
order), so the gaps are rounding: log-probs 1e-5 absolute (they read up to
12 here; the gaps 2e-6, through 8 evaluations), the NLL 1e-6 relative, each
gradient 2e-5 of its leaf's largest entry or of the median leaf's, whichever
is larger (sums over up to a few thousand edges).  Leaving out the 1/√d_k
scale, taking head 0's attention instead of the head mean, or dropping the
β·X(0) term each moves the log-probs by more than 0.2 at these sizes.
"""

import numpy as np
import pytest
import torch

from graph_odenet_tpu_torch.data.ogbn import synthetic_ogbn_arxiv
from graph_odenet_tpu_torch.graph import from_edges
from graph_odenet_tpu_torch.ops.csr_spmm import row_ids
from graph_odenet_tpu_torch.parallel import (
    ShardedTrainConfig, fit_sharded_node_classifier, partition_by_receiver,
)
from graph_odenet_tpu_torch.parallel.halo import bucket_scores
from graph_odenet_tpu_torch.parallel.sharded_grand import ShardedGRANDNL
from perfbench.reference import grandnl as ref
from perfbench.reference.common import Precision, RefGraph

from torch_dist_worlds import grandnl as grandnl_task
from torch_dist_worlds import run_world

SCALE = 0.004
HIDDEN, HEADS, STEPS = 8, 2, 2  # d_k 8, a state of 16, 8 evaluations
RATE, DROP_SEED = 0.5, 17
LP_ATOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_TOL = 2e-5


@pytest.fixture(scope="module")
def data():
    return synthetic_ogbn_arxiv(seed=0, scale=SCALE)


# Standard deviations of the random leaves.  The twin's features are about
# 0.006 in size: the encoder lifts them to a state of about 1, and the query
# and key maps give scaled scores of about 2, so that the attention is far
# from uniform and every term of the dynamics moves the result.
STD = dict(w_enc=15.0, w_q=0.35, w_k=0.35, w_out=0.05, alpha=1.0, beta=1.0)


def _random_params(f_in, n_class, seed):
    """Every leaf of the model drawn at random (numpy f32), α and β too."""
    rng = np.random.default_rng(seed)
    shapes = ref.param_shapes(dict(hidden=HIDDEN, heads=HEADS), f_in, n_class)
    return {k: np.asarray(rng.standard_normal(shape) * STD.get(k, 0.1), dtype=np.float32)
            for k, (shape, _) in shapes.items()}


@pytest.fixture(scope="module")
def params(data):
    return _random_params(data.features.shape[1], data.n_class, seed=3)


@pytest.fixture(scope="module")
def reference(data, params):
    return _reference(data, params)


def _reference(data, params):
    """The reference's log-probs without and with dropout, NLL over the
    training nodes and gradients, on the whole graph."""
    g = data.graph
    rg = RefGraph(senders=g.senders[:g.n_edge].long(), receivers=g.receivers[:g.n_edge].long(),
                  weight=g.weight[:g.n_edge], n_pad=g.n_node_pad)
    cfg = dict(hidden=HIDDEN, heads=HEADS, steps=STEPS, t1=1.0, dropout=RATE)
    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    with torch.no_grad():
        lp = ref.forward(p, rg, data.features, cfg, Precision())
    lp_drop = ref.forward(p, rg, data.features, cfg, Precision(),
                          drop_gen=torch.Generator().manual_seed(DROP_SEED))
    train = data.idx_train
    loss = -lp_drop[train].gather(1, data.labels[train][:, None]).sum() / train.numel()
    grads = torch.autograd.grad(loss, list(p.values()))
    return dict(lp=lp.numpy(), lp_drop=lp_drop.detach().numpy(), loss=loss.item(),
                grads={k: v.numpy() for k, v in zip(p, grads)})


def _assert_matches(ranks, want):
    for key in ("lp", "lp_drop"):
        got = np.concatenate([r[key] for r in ranks])
        np.testing.assert_allclose(got, want[key], rtol=0, atol=LP_ATOL, err_msg=key)
    top = {k: float(np.abs(g).max()) for k, g in want["grads"].items()}
    median = float(np.median(list(top.values())))
    # b_k adds ⟨q_r, b_k⟩ to every in-edge of r alike, which the softmax
    # cancels: its gradient is rounding, held to the median leaf's scale.
    assert top["b_k"] <= 1e-6 * median
    for r in ranks:
        assert abs(r["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
        assert set(r["grads"]) == set(want["grads"])
        for k, g in want["grads"].items():
            tol = GRAD_TOL * max(top[k], median)
            np.testing.assert_allclose(r["grads"][k], g, rtol=0, atol=tol, err_msg=k)
            assert k == "b_k" or top[k] > 1e-3 * median, k  # every other leaf takes part


# ---------------------------------------------------------------- the score op

def _hub_graph():
    rng = np.random.default_rng(11)
    n = 160
    s, r = np.nonzero(rng.random((n, n)) < 0.05)
    hub = np.arange(n)  # node 7 receives from everyone: one long row
    return from_edges(np.r_[s, hub], np.r_[r, np.full(n, 7)], n_node=n, normalize="row")


@pytest.mark.parametrize("n_parts", [1, 2])
def test_bucket_scores_and_their_gradients_match_float64(n_parts):
    """Every bucket's scores, ``dq`` (B2-w over the CSR view) and ``dk`` (B2-w
    over the CSC view) against a float64 gather, product and sum: within f32
    rounding of sums of up to 160 terms (rtol = atol = 1e-5)."""
    heads, feat = 3, 5
    pg = partition_by_receiver(_hub_graph(), n_parts)
    rng = np.random.default_rng(n_parts)
    seen = 0
    for p in range(n_parts):
        blk = pg.blocks[p]
        for b in range(n_parts):
            bucket = pg.bucket(p, b)
            view = bucket.fwd
            q0, k0 = (rng.standard_normal((pg.block_size, heads * feat)).astype(np.float32)
                      for _ in range(2))
            up = torch.from_numpy(rng.standard_normal((view.n_edge, heads)).astype(np.float32))
            q, k = (torch.from_numpy(a).requires_grad_(True) for a in (q0, k0))
            s = bucket_scores(q, k, bucket, heads, feat, rows=blk.receivers[blk.bucket(b)])
            s.backward(up)
            q64, k64 = (torch.from_numpy(a).double().requires_grad_(True) for a in (q0, k0))
            rows = row_ids(view.row_ptr, view.n_edge)
            s64 = (q64[rows] * k64[view.col.long()]).view(-1, heads, feat).sum(-1)
            s64.backward(up.double())
            for got, want in ((s, s64), (q.grad, q64.grad), (k.grad, k64.grad)):
                torch.testing.assert_close(got.detach().double(), want.detach(), rtol=1e-5,
                                           atol=1e-5)
            seen += view.n_edge
    assert seen == pg.n_edge


# ------------------------------------------------ the model against the reference

def test_model_holds_the_references_leaves_and_initialisation():
    """The parameters by the reference's names and shapes (so the benchmark's
    ``init_state`` loads), α = 0 and β = 1, zero biases, Glorot weights."""
    m = ShardedGRANDNL(12, HIDDEN, HEADS, 5, generator=torch.Generator().manual_seed(0))
    shapes = ref.param_shapes(dict(hidden=HIDDEN, heads=HEADS), 12, 5)
    assert list(m.state_dict()) == list(shapes)
    for k, (shape, glorot) in shapes.items():
        v = m.state_dict()[k]
        assert tuple(v.shape) == shape and v.dtype == torch.float32, k
        if glorot:
            assert float(v.abs().max()) <= np.sqrt(6.0 / sum(shape)) and float(v.std()) > 0, k
    assert m.alpha.item() == 0.0 and m.beta.item() == 1.0
    assert all(not m.state_dict()[k].any() for k in ("b_enc", "b_q", "b_k", "b_out"))


def test_one_part_matches_the_reference(data, params, reference):
    _assert_matches([grandnl_task(0, 1, scale=SCALE, params=params, heads=HEADS, steps=STEPS,
                                  rate=RATE, drop_seed=DROP_SEED)], reference)


def test_one_part_takes_the_softmax_passes_bit_for_bit(params):
    """Log-probs with and without dropout, the NLL and every gradient: the same
    bits through ``ops.csr_spmm.gather_rows``, ``segment_max`` and the
    denominators' Function as through ``index_select``, ``scatter_reduce``
    and ``segment_sum`` (``chip_smoke.plain_softmax_passes``)."""
    import chip_smoke

    kw = dict(scale=SCALE, params=params, heads=HEADS, steps=STEPS, rate=RATE,
              drop_seed=DROP_SEED)
    got = grandnl_task(0, 1, **kw)
    with chip_smoke.plain_softmax_passes():
        want = grandnl_task(0, 1, **kw)
    assert got["loss"] == want["loss"]
    for key in ("lp", "lp_drop"):
        np.testing.assert_array_equal(got[key].view(np.int32), want[key].view(np.int32))
    for k, g in want["grads"].items():
        np.testing.assert_array_equal(got["grads"][k].view(np.int32), g.view(np.int32), err_msg=k)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_gloo_ranks_match_the_reference(n_ranks, params, reference, tmp_path):
    """Each rank's rows, its all-reduced NLL and gradients: K all-gathered,
    x(t) around the ring, the keys' gradient reduce-scattered."""
    ranks = run_world(n_ranks, tmp_path, {"grandnl": dict(
        scale=SCALE, params=params, heads=HEADS, steps=STEPS, rate=RATE, drop_seed=DROP_SEED)},
        timeout=120.0)
    _assert_matches([r["grandnl"] for r in ranks], reference)


# ---------------------------------------------------------------- the trainer

def test_trainer_three_epochs_match_run_steps(tmp_path):
    """Three epochs through the trainer (dropout 0.5, Adam with L2) against the
    reference's three steps, by the benchmark's measure, from random leaves:
    the losses within 1e-6, the first gradient and the change within 2e-5
    (each a norm gap over the median leaf's norm; f32 rounding reads about
    1e-8 here)."""
    from perfbench.drivers.sharded import _program_steps, program_data
    from perfbench.harness import compare
    from perfbench.harness.twin import arxiv_twin
    from perfbench.reference.train import run_steps

    arrays = arxiv_twin(seed=0, scale=SCALE, calibrated=True)
    trainer = dict(model="grandnl", hidden=HIDDEN, heads=HEADS, steps=STEPS, t1=1.0,
                   mode="ring_pallas", remat=False, lr=0.01, weight_decay=5e-4, dropout=0.5)
    seed = 2_147_483_659
    params0 = {k: torch.from_numpy(v) for k, v in _random_params(
        arrays["features"].shape[1], int(arrays["n_class"]), seed=5).items()}
    ckpt = str(tmp_path / "ckpt")
    res = fit_sharded_node_classifier(
        ShardedTrainConfig(**trainer, epochs=3, patience=10 ** 9, seed=seed, ckpt_dir=ckpt,
                           ckpt_every=2),
        program_data(arrays), device="cpu", init_state=params0)
    prog = _program_steps(ckpt, 3, res["losses"])
    want = run_steps("grandnl", arrays, trainer, params0, seed=seed, steps=3, device="cpu")
    gaps = compare.gaps(prog, want, params0)
    assert gaps["loss"] <= 1e-6 and gaps["grad1"] <= 2e-5 and gaps["change"] <= 2e-5, gaps
    assert not gaps["left_out"]


@pytest.mark.parametrize("change", [dict(mode="ring"), dict(mode="allgather"),
                                    dict(mode="ring_pallas", remat=True)])
def test_trainer_takes_ring_pallas_without_remat_alone(change, data):
    cfg = ShardedTrainConfig(model="grandnl", hidden=HIDDEN, heads=HEADS, epochs=1, **change)
    with pytest.raises(ValueError, match="grandnl runs mode='ring_pallas' without remat"):
        fit_sharded_node_classifier(cfg, data, device="cpu")
