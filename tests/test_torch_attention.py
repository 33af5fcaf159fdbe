"""Port parity: GAT attention (dropout hash, softmax, the four Functions) against JAX.

Inputs are made with numpy from a seed and pinned to float32.  On the CPU
the port's Functions run the plain versions of their kernels; JAX runs its
segment path ``attention_aggregate(g, ...)``, and in one case the Pallas
kernel in interpret mode.  Values agree to 2e-5 and gradients of
``sum(sin(out))`` to 2e-4, the tolerances of ``tests/test_pallas_gat.py``.
A numpy model of the split-row softmax merge checks what the CPU cannot
run; the GAT kernels' schedules and lane layouts are modelled in
``tests/test_torch_gat_schedule.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_odenet_tpu import graph as jgraph
from graph_odenet_tpu.ops import dropmask as jdropmask
from graph_odenet_tpu.ops import segment as jsegment
from graph_odenet_tpu.ops.pallas_gat import gat_aggregate_pallas_scores_dropout
from graph_odenet_tpu.ops.pallas_spmm import prepare as jprepare
from graph_odenet_tpu.ops.sddmm import attention_aggregate as jattention
from graph_odenet_tpu.ops.sddmm import edge_scores as jedge_scores
from graph_odenet_tpu_torch import graph as tgraph
from graph_odenet_tpu_torch.ops import csr_spmm, dropmask, gat_attn, prepare
from graph_odenet_tpu_torch.ops.sddmm import attention_aggregate, edge_scores
from graph_odenet_tpu_torch.ops.segment import segment_softmax

VAL = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)
SLOPE = 0.2


def _random(rng):
    n = 300
    s, r = np.nonzero(rng.random((n, n)) < 0.03)
    return s, r, n


def _hub_receiver(rng):
    n = 200
    s = np.concatenate([rng.integers(0, n, 1500), rng.integers(0, n, 300)])
    r = np.concatenate([np.zeros(1500, np.int64), rng.integers(0, n, 300)])
    return s, r, n


def _hub_sender(rng):
    n = 200
    s = np.concatenate([np.full(2500, 60, np.int64), rng.integers(0, n, 400)])
    r = np.concatenate([rng.integers(0, n, 2500), rng.integers(0, n, 400)])
    return s, r, n


GRAPHS = {"random": _random, "hub_receiver": _hub_receiver, "hub_sender": _hub_sender}


def _split_hub(into: bool):
    """Node 0 with 1,500 distinct in- (or out-) neighbours: several warp segments."""
    rng = np.random.default_rng(12)
    far = rng.permutation(np.arange(1, 2000))[:1500]
    s, r = (far, np.zeros_like(far)) if into else (np.zeros_like(far), far)
    return tgraph.from_edges(s, r, n_node=2000, normalize=None, symmetrize=False)


def _case(name, heads, feat, seed=0):
    """Both packages' graphs and f32 inputs: s_src, s_dst, wh (numpy)."""
    rng = np.random.default_rng(seed)
    s, r, n = GRAPHS[name](rng)
    kw = dict(n_node=n, normalize=None, node_multiple=128)
    tg, jg = tgraph.from_edges(s, r, **kw), jgraph.from_edges(s, r, **kw)
    s_src = (rng.standard_normal((tg.n_node_pad, heads)) * 1.5).astype(np.float32)
    s_dst = (rng.standard_normal((tg.n_node_pad, heads)) * 1.5).astype(np.float32)
    wh = rng.standard_normal((tg.n_node_pad, heads, feat)).astype(np.float32)
    return tg, jg, s_src, s_dst, wh


# ---------------------------------------------------------------- dropout hash


@pytest.mark.parametrize("seed", [0, 1, 123, 2**31 + 5, 2**32 - 1])
@pytest.mark.parametrize("heads", [1, 8])
def test_dropout_scale_is_bit_equal_to_jax(seed, heads):
    tg, jg, *_ = _case("random", heads, 4)
    e = tg.n_edge
    want = np.asarray(jdropmask.attention_dropout_scale(
        jnp.uint32(seed), jg.senders, jg.receivers, heads, 0.6))[:e]
    got = dropmask.attention_dropout_scale(seed, tg.senders, tg.receivers, heads, 0.6)[:e]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    raw = np.asarray(jdropmask.hash_edge_head(
        jnp.uint32(seed), jg.senders, jg.receivers, heads))[:e]
    np.testing.assert_array_equal(
        dropmask.hash_edge_head(seed, tg.senders, tg.receivers, heads)[:e].numpy(),
        raw.astype(np.int64),
    )


def test_keep_threshold_and_scale():
    assert dropmask.keep24(0.6) == jdropmask.keep24(0.6)
    assert dropmask.inv_keep(0.6) == float(np.float32(1.0) / np.float32(0.4))
    a = dropmask.draw_seed(torch.Generator().manual_seed(3))
    b = dropmask.draw_seed(torch.Generator().manual_seed(3))
    assert a == b and 0 <= a < 2**32


def test_segment_softmax_matches_jax():
    tg, jg, s_src, s_dst, _ = _case("hub_receiver", 4, 1, seed=2)
    logits = np.array(jedge_scores(jg, jnp.asarray(s_src), jnp.asarray(s_dst)))
    mask = np.array(jg.edge_mask())[:, None]
    want = jsegment.segment_softmax(jnp.asarray(logits), jg.receivers, jg.n_node_pad,
                                    mask=jnp.asarray(mask))
    got = segment_softmax(torch.from_numpy(logits), tg.receivers, tg.n_node_pad,
                          mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)
    assert float(got[tg.n_edge:].abs().max()) == 0.0


def test_edge_scores_match_jax_on_both_adjacencies():
    tg, jg, s_src, s_dst, _ = _case("random", 8, 1, seed=3)
    want = np.asarray(jedge_scores(jg, jnp.asarray(s_src), jnp.asarray(s_dst), negative_slope=SLOPE))
    a, b = torch.from_numpy(s_src), torch.from_numpy(s_dst)
    np.testing.assert_array_equal(edge_scores(tg, a, b).numpy(), want)
    np.testing.assert_array_equal(edge_scores(prepare(tg), a, b).numpy(), want[: tg.n_edge])


# ---------------------------------------------------------------- the four Functions

VARIANTS = ("plain", "dropout", "scores", "scores_dropout")


def _port(variant, csr, logits, wh, s_src, s_dst, seed, rate, dmask):
    if variant == "plain":
        return gat_attn.gat_aggregate_kernel(csr, logits, wh)
    if variant == "dropout":
        return gat_attn.gat_aggregate_kernel_dropout(csr, logits, wh, dmask)
    if variant == "scores":
        return gat_attn.gat_aggregate_kernel_scores(csr, SLOPE, logits, wh, s_src, s_dst)
    return gat_attn.gat_aggregate_kernel_scores_dropout(
        csr, SLOPE, rate, logits, wh, s_src, s_dst, seed
    )


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_functions_match_jax_segment_path(graph, variant):
    heads, feat, rate = 4, 8, 0.6
    tg, jg, s_src, s_dst, wh = _case(graph, heads, feat, seed=5)
    key = jax.random.PRNGKey(11)
    seed = int(jdropmask.seed_from_key(key))
    drop = variant in ("dropout", "scores_dropout")

    def jloss(a, b, w):
        lg = jedge_scores(jg, a, b, negative_slope=SLOPE)
        out = jattention(jg, lg, w, edge_dropout_rng=key if drop else None,
                         edge_dropout_rate=rate if drop else 0.0)
        return jnp.sum(jnp.sin(out)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(s_src), jnp.asarray(s_dst), jnp.asarray(wh))

    csr = prepare(tg)
    a, b, w = (torch.from_numpy(x).requires_grad_(True) for x in (s_src, s_dst, wh))
    logits = edge_scores(csr, a, b, negative_slope=SLOPE)
    dmask = dropmask.attention_dropout_scale(seed, csr.senders, csr.receivers, heads, rate)
    before = dict(gat_attn.launches)
    out = _port(variant, csr, logits, w, a, b, seed, rate, dmask)
    torch.sin(out).sum().backward()
    assert gat_attn.launches == before  # CPU tensors: the plain versions

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **VAL)
    for name, t, jg_ in zip(("s_src", "s_dst", "wh"), (a, b, w), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg_), err_msg=name, **GRAD)


def test_hint_and_mask_get_no_gradient():
    tg, _, s_src, s_dst, wh = _case("random", 2, 4, seed=6)
    csr = prepare(tg)
    a, b = torch.from_numpy(s_src), torch.from_numpy(s_dst)
    logits = edge_scores(csr, a, b).requires_grad_(True)
    a2, b2 = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    out = gat_attn.gat_aggregate_kernel_scores(csr, SLOPE, logits, torch.from_numpy(wh), a2, b2)
    out.pow(2).sum().backward()
    assert a2.grad is None and b2.grad is None and logits.grad is not None
    dmask = torch.ones_like(logits).requires_grad_(True)
    gat_attn.gat_aggregate_kernel_dropout(csr, logits, torch.from_numpy(wh), dmask).sum().backward()
    assert dmask.grad is None


def test_pallas_interpret_in_kernel_dropout_matches_port():
    """JAX's Pallas kernel (interpret mode) regenerates the counter mask
    in-kernel; the port's plain versions regenerate the same one."""
    heads, feat, rate, seed = 8, 8, 0.6, 4242
    tg, jg, s_src, s_dst, wh = _case("random", heads, feat, seed=7)
    jcsr = jprepare(jg)

    def jloss(a, b, w):
        lg = jedge_scores(jg, a, b, negative_slope=SLOPE)
        out = gat_aggregate_pallas_scores_dropout(
            jcsr, SLOPE, rate, lg, w, a, b, jnp.uint32(seed))
        return jnp.sum(jnp.sin(out)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(s_src), jnp.asarray(s_dst), jnp.asarray(wh))
    csr = prepare(tg)
    a, b, w = (torch.from_numpy(x).requires_grad_(True) for x in (s_src, s_dst, wh))
    out = gat_attn.gat_aggregate_kernel_scores_dropout(
        csr, SLOPE, rate, edge_scores(csr, a, b), w, a, b, seed)
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **VAL)
    for name, t, jg_ in zip(("s_src", "s_dst", "wh"), (a, b, w), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg_), err_msg=name, **GRAD)


def test_attention_aggregate_graph_and_csr_paths_agree():
    tg, _, s_src, s_dst, wh = _case("hub_receiver", 8, 8, seed=8)
    a, b, w = (torch.from_numpy(x) for x in (s_src, s_dst, wh))
    csr = prepare(tg)
    for kw in (dict(), dict(dropout_seed=99, dropout_rate=0.6)):
        for scores in (None, (a, b)):
            seg = attention_aggregate(tg, edge_scores(tg, a, b), w, scores=scores, **kw)
            ker = attention_aggregate(csr, edge_scores(csr, a, b), w, scores=scores, **kw)
            np.testing.assert_allclose(ker.numpy(), seg.numpy(), **VAL)


# ---------------------------------------------------------------- kernel bookkeeping


@pytest.mark.parametrize("into", [True, False])
def test_split_row_softmax_merge_model(into):
    """gat_fwd's per-segment (m, l, acc) and its split-row merge, in numpy,
    equal the plain version (the CUDA kernel's bookkeeping)."""
    tg = _split_hub(into)
    rng = np.random.default_rng(9)
    s_src, s_dst = (rng.standard_normal((tg.n_node_pad, 2)).astype(np.float32) for _ in "ab")
    wh = rng.standard_normal((tg.n_node_pad, 2, 3)).astype(np.float32)
    csr = prepare(tg)
    logits = edge_scores(csr, torch.from_numpy(s_src), torch.from_numpy(s_dst)).numpy()
    part, snd = csr.part, csr.senders.numpy()
    n, heads, feat = wh.shape
    state = {}
    for k in range(len(part.seg_row)):
        p0, p1 = int(part.seg_ptr[k]), int(part.seg_ptr[k + 1])
        if p1 == p0:
            continue
        m = logits[p0:p1].max(0)
        e = np.exp(logits[p0:p1] - m)
        state.setdefault(int(part.seg_row[k]), []).append(
            (m, e.sum(0), (e[..., None] * wh[snd[p0:p1]]).sum(0)))
    out = np.zeros_like(wh)
    for row, parts in state.items():
        m = np.max([p[0] for p in parts], axis=0)
        l = sum(p[1] * np.exp(p[0] - m) for p in parts)
        acc = sum(p[2] * np.exp(p[0] - m)[:, None] for p in parts)
        out[row] = acc / l[:, None]
    assert any(len(v) > 1 for v in state.values()) == into
    ref, _, _ = gat_attn.gat_fwd(csr, torch.from_numpy(logits), torch.from_numpy(wh))
    np.testing.assert_allclose(out, ref.numpy(), **VAL)


def test_weighted_reduce_matches_expanded_weights():
    tg = _split_hub(into=False)
    csr = prepare(tg)
    assert csr.t_part.n_slots > 1
    rng = np.random.default_rng(1)
    wh = rng.standard_normal((tg.n_node_pad, 4, 3)).astype(np.float32)
    alpha = torch.from_numpy(rng.standard_normal((csr.n_edge, 4)).astype(np.float32))
    x = torch.from_numpy(wh.reshape(wh.shape[0], -1))
    got = csr_spmm.csr_reduce(csr, x, transpose=True, alpha=alpha, feat=3)
    snd = csr_spmm.row_ids(csr.t_row_ptr, csr.n_edge).numpy()
    msgs = x.numpy()[csr.t_receivers.numpy()] * np.repeat(alpha.numpy(), 3, axis=1)
    want = np.zeros_like(x.numpy())
    np.add.at(want, snd, msgs)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
