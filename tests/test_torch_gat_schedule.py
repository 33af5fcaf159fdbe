"""The schedules of the GAT kernels (``csrc/gat_attn.cu``), modelled in numpy.

The CPU cannot run the CUDA kernels, so their bookkeeping is modelled here
and held against the JAX package:

* ``_fwd_model``, ``gat_fwd``'s one-launch schedule: warp items (segment,
  feature chunk) in a shuffled arrival order; per segment a first pass over
  batches of 32 logits for the max and the sum per head (one rescale a
  batch), then the gather weighted by α·D = exp(logit − m) / l · D; a split
  row's partial states (each its segment's own softmax) merged in slot order,
  weighted by l_k·exp(m_k − m), by the last item of its (split row, chunk) to
  arrive, which resets its counter.  Bit-equal across
  arrival orders; ``out`` against JAX's ``attention_aggregate`` at the
  tolerances of ``tests/test_torch_attention.py`` (2e-5), ``m`` and ``l``
  against the plain version.
* ``_bwd_model``, ``gat_bwd``'s segment walk: the receiver's node tables
  read once per segment, ``Wh[s]`` gathered per edge; ``dlogits`` against
  the vjp of JAX's custom_vjp (``gat_aggregate_pallas*``, Pallas in
  interpret mode) at 2e-4, α·D against the plain version.
* ``_dwh_model``, ``gat_dwh``'s one-launch schedule over the CSC view:
  warp items (segment, feature chunk) in a shuffled arrival order; per batch
  of 32 edges α·D computed once per (edge, head) from the node tables, then
  the gather of ``g[r]`` per edge slot and a fixed tree over the slots; a
  split row's partial rows added in slot order by the last item of its
  (split row, chunk) to arrive, which resets its counter.  Bit-equal across
  arrival orders; ``dWh`` against the vjp of JAX's score-hinted custom_vjp
  (``gat_aggregate_pallas_scores*``, which reaches ``_dwh_csc_recompute``;
  Pallas in interpret mode) at 2e-4.
* The lane layouts ``_fwd_lanes`` (``gat_fwd`` and ``gat_dwh``) and
  ``_bwd_lanes``, and the wrappers' use of the views' cached
  ``LaunchPlan``s, through a stand-in for the C library.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_odenet_tpu import graph as jgraph
from graph_odenet_tpu.ops import dropmask as jdropmask
from graph_odenet_tpu.ops.pallas_gat import (
    gat_aggregate_pallas, gat_aggregate_pallas_dropout, gat_aggregate_pallas_scores,
    gat_aggregate_pallas_scores_dropout,
)
from graph_odenet_tpu.ops.pallas_spmm import prepare as jprepare
from graph_odenet_tpu.ops.sddmm import attention_aggregate as jattention
from graph_odenet_tpu_torch import graph as tgraph
from graph_odenet_tpu_torch.data import synthetic_planetoid
from graph_odenet_tpu_torch.ops import _build, dropmask, gat_attn, prepare
from graph_odenet_tpu_torch.ops.csr_spmm import row_ids
from graph_odenet_tpu_torch.ops.sddmm import edge_scores

VAL = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)
RATE = 0.6
F32 = np.float32


def _split_hub_edges():
    """Node 0 with 1,500 distinct in-neighbours: several warp segments."""
    rng = np.random.default_rng(12)
    far = rng.permutation(np.arange(1, 2000))[:1500]
    return far, np.zeros_like(far), 2000, dict(normalize=None, symmetrize=False)


def _citeseer_edges():
    """The calibrated Citeseer twin's real edges (config 2's graph), as they are."""
    g = synthetic_planetoid("citeseer", seed=42, calibrated=True).graph
    e = g.n_edge
    return (g.senders[:e].numpy(), g.receivers[:e].numpy(), g.n_node,
            dict(normalize=None, symmetrize=False, add_self_loops=False))


def _sender_hub_edges():
    """Node 0 with 1,500 distinct out-neighbours: several segments of the CSC view."""
    far, zeros, n, kw = _split_hub_edges()
    return zeros, far, n, kw


GRAPHS = {"split_hub": _split_hub_edges, "citeseer": _citeseer_edges,
          "sender_hub": _sender_hub_edges}


def _case(graph, heads, feat, seed):
    """Both packages' graphs, the port's CSR views and f32 inputs (numpy)."""
    s, r, n, kw = GRAPHS[graph]()
    tg, jg = tgraph.from_edges(s, r, n_node=n, **kw), jgraph.from_edges(s, r, n_node=n, **kw)
    s_src, s_dst, wh, up = _inputs(tg.n_node_pad, heads, feat, seed)
    logits = edge_scores(tg, torch.from_numpy(s_src), torch.from_numpy(s_dst)).numpy()
    return tg, jg, prepare(tg), logits, wh, up


def _inputs(n, heads, feat, seed):
    """(s_src, s_dst, wh, up) of ``_case``; its logits are the scores of s_src, s_dst."""
    rng = np.random.default_rng(seed)
    s_src = (rng.standard_normal((n, heads)) * 1.5).astype(F32)
    s_dst = (rng.standard_normal((n, heads)) * 1.5).astype(F32)
    wh = rng.standard_normal((n, heads, feat)).astype(F32)
    up = rng.standard_normal((n, heads, feat)).astype(F32)
    return s_src, s_dst, wh, up


def _scale(csr, heads, seed):
    """D in CSR order: the counter hash at RATE, or ones without dropout."""
    if seed is None:
        return np.ones((csr.n_edge, heads), F32)
    return dropmask.attention_dropout_scale(seed, csr.senders, csr.receivers, heads, RATE).numpy()


def _parts(part):
    return {k: getattr(part, k).numpy().astype(np.int64)
            for k in ("seg_ptr", "seg_row", "seg_slot", "split_row", "split_ptr", "slot_split")}


def _fwd_model(csr, logits, wh, d, rng):
    """``gat_fwd_kernel``'s schedule (see the module doc): (out, m, l, counters)."""
    pt = _parts(csr.part)
    col = csr.senders.numpy().astype(np.int64)
    n, heads, feat = wh.shape
    hf = heads * feat
    lanes, vec, n_chunks, _ = gat_attn._fwd_lanes(heads, feat, True)
    width = lanes * vec
    whf = wh.reshape(n, hf)

    def segment(s):  # the softmax state and row of one segment, the same in every chunk
        p0, p1 = pt["seg_ptr"][s], pt["seg_ptr"][s + 1]
        m = np.full(heads, -np.inf, F32)
        l = np.zeros(heads, F32)
        for pb in range(p0, p1, 32):  # pass 1: logits only
            x = logits[pb:min(pb + 32, p1)]
            m_new = np.maximum(m, x.max(0))
            lsum = np.exp(x - m_new).sum(0, dtype=F32)  # once per (edge, head)
            with np.errstate(invalid="ignore"):
                l = np.where(m == -np.inf, lsum, l * np.exp(m - m_new) + lsum).astype(F32)
            m = m_new
        acc = np.zeros(hf, F32)
        for pb in range(p0, p1, 32):  # pass 2: weights α·D, then the gather
            pe = min(pb + 32, p1)
            w = np.repeat(np.exp(logits[pb:pe] - m) / l * d[pb:pe], feat, axis=1)
            acc = acc + (w * whf[col[pb:pe]]).sum(0, dtype=F32)
        return m, l, acc
    state = [segment(s) for s in range(len(pt["seg_row"]))]
    out = np.full((n, hf), np.nan, F32)
    m_out = np.full((n, heads), np.nan, F32)
    l_out = np.full((n, heads), np.nan, F32)
    p_acc = np.full((csr.part.n_slots, hf), np.nan, F32)
    p_stat = np.full((csr.part.n_slots, n_chunks, 2, heads), np.nan, F32)
    arrivals = np.zeros((n_chunks, len(pt["split_row"])), np.int64)

    def write(row, c, acc, m, l):
        feats = np.arange(c * width, min(hf, (c + 1) * width))
        out[row, feats] = acc[feats]
        first = feats[feats % feat == 0] // feat  # heads whose first feature is here
        m_out[row, first] = np.where(l[first] > 0, m[first], 0)
        l_out[row, first] = l[first]

    items = [(s, c) for c in range(n_chunks) for s in range(len(pt["seg_row"]))]
    for i in rng.permutation(len(items)):
        s, c = items[i]
        m, l, acc = state[s]
        slot = pt["seg_slot"][s]
        if slot < 0:
            write(pt["seg_row"][s], c, acc, m, l)
            continue
        feats = np.arange(c * width, min(hf, (c + 1) * width))
        heads_c = np.unique(feats // feat)
        p_acc[slot, feats] = acc[feats]
        p_stat[slot, c, 0, heads_c], p_stat[slot, c, 1, heads_c] = m[heads_c], l[heads_c]
        j = pt["slot_split"][slot]
        arrivals[c, j] += 1
        k0, k1 = pt["split_ptr"][j], pt["split_ptr"][j + 1]
        if arrivals[c, j] < k1 - k0:
            continue
        arrivals[c, j] = 0  # the last to arrive merges, in slot order
        mm = p_stat[k0:k1, c, 0, heads_c].max(0)
        ll, aa = np.zeros(len(heads_c), F32), np.zeros(len(feats), F32)
        for k in range(k0, k1):  # slot k's row is its own softmax: it weighs l_k·exp(m_k − m)
            ck = p_stat[k, c, 1, heads_c] * np.exp(p_stat[k, c, 0, heads_c] - mm)
            ll = ll + ck
            aa = aa + p_acc[k, feats] * ck[np.searchsorted(heads_c, feats // feat)]
        aa = aa / ll[np.searchsorted(heads_c, feats // feat)]
        full_m, full_l, full_acc = (np.zeros(heads, F32), np.zeros(heads, F32),
                                    np.zeros(hf, F32))
        full_m[heads_c], full_l[heads_c], full_acc[feats] = mm, ll, aa
        write(pt["split_row"][j], c, full_acc, full_m, full_l)
    return out.reshape(n, heads, feat), m_out, l_out, arrivals


@pytest.mark.parametrize("heads,feat,dropout", [(8, 8, True), (1, 64, False)])
@pytest.mark.parametrize("graph", ["citeseer", "split_hub"])
def test_fwd_schedule_is_order_free_and_matches_jax(graph, heads, feat, dropout):
    """The model of ``gat_fwd``'s schedule in three arrival orders: bit-equal
    to each other, every counter back at 0, ``out`` equal to JAX's
    ``attention_aggregate`` (with the same hash dropout), ``m`` and ``l`` to
    the plain version."""
    tg, jg, csr, logits, wh, _ = _case(graph, heads, feat, seed=heads * feat)
    if graph == "split_hub":
        assert csr.part.split_row.numel() > 0
    key = jax.random.PRNGKey(11) if dropout else None
    d = _scale(csr, heads, int(jdropmask.seed_from_key(key)) if dropout else None)
    runs = []
    for order in range(3):
        *got, arrivals = _fwd_model(csr, logits, wh, d, np.random.default_rng(order))
        assert not arrivals.any()
        runs.append(got)
    for got in runs[1:]:
        for a, b in zip(got, runs[0]):
            np.testing.assert_array_equal(a, b)
    out, m, l = runs[0]
    jout = jattention(jg, jnp.asarray(logits), jnp.asarray(wh), edge_dropout_rng=key,
                      edge_dropout_rate=RATE if dropout else 0.0)
    np.testing.assert_allclose(out, np.asarray(jout), **VAL)
    _, pm, pl = gat_attn.gat_fwd_plain(csr, torch.from_numpy(logits), torch.from_numpy(wh))
    np.testing.assert_allclose(m, pm.numpy(), **VAL)
    np.testing.assert_allclose(l, pl.numpy(), **VAL)


def _bwd_model(csr, logits, wh, g, m, l, beta, d):
    """``gat_bwd_kernel``'s segment walk: (dlogits [len(logits), H], α·D)."""
    pt = _parts(csr.part)
    col = csr.senders.numpy().astype(np.int64)
    dl = np.full(logits.shape, np.nan, F32)
    dl[csr.n_edge:] = 0  # the extra warps' zeros
    ad = np.full((csr.n_edge, logits.shape[1]), np.nan, F32)
    for s in range(len(pt["seg_row"])):
        p0, p1 = pt["seg_ptr"][s], pt["seg_ptr"][s + 1]
        r = pt["seg_row"][s]
        g_r, m_r, l_r, b_r = g[r], m[r], l[r], beta[r]  # once per segment
        a = np.exp(logits[p0:p1] - m_r) / l_r
        dot = (g_r * wh[col[p0:p1]]).sum(-1, dtype=F32)  # Wh[s] gathered per edge
        dl[p0:p1] = a * (d[p0:p1] * dot - b_r)
        ad[p0:p1] = a * d[p0:p1]
    return dl, ad


@pytest.mark.parametrize("emit_alpha", [False, True])
@pytest.mark.parametrize("dropout", [False, True])
def test_bwd_schedule_matches_jax_custom_vjp(dropout, emit_alpha):
    """The segment walk's dlogits against the vjp of JAX's fused attention
    (Pallas, interpret mode) on the split hub, with and without the hash
    dropout; α·D against the plain version."""
    heads, feat, seed = 8, 8, 77
    tg, jg, csr, logits, wh, up = _case("split_hub", heads, feat, seed=3)
    d = _scale(csr, heads, seed if dropout else None)
    out, m, l, _ = _fwd_model(csr, logits, wh, d, np.random.default_rng(0))
    beta = (up * out).sum(-1, dtype=F32)
    dl, ad = _bwd_model(csr, logits, wh, up, m, l, beta, d)
    assert not np.isnan(dl).any() and not np.isnan(ad).any()

    jcsr = jprepare(jg)
    jdmask = jdropmask.attention_dropout_scale(jnp.uint32(seed), jg.senders, jg.receivers,
                                               heads, RATE)
    fn = ((lambda lg: gat_aggregate_pallas_dropout(jcsr, lg, jnp.asarray(wh), jdmask)) if dropout
          else (lambda lg: gat_aggregate_pallas(jcsr, lg, jnp.asarray(wh))))
    _, vjp = jax.vjp(fn, jnp.asarray(logits))
    (jdl,) = vjp(jnp.asarray(up))
    np.testing.assert_allclose(dl, np.asarray(jdl), **GRAD)
    if emit_alpha:
        _, pad = gat_attn.gat_bwd_plain(
            csr, *(torch.from_numpy(t) for t in (logits, wh, up, m, l, beta)),
            drop=(seed, RATE) if dropout else None, emit_alpha=True)
        np.testing.assert_allclose(ad, pad.numpy(), **VAL)


def _slot_tree(acc):
    """``sum_slots``: lane group k of 32/G edge slots ends with the slots'
    sum, added by a shuffle tree over xor offsets (half the slots first)."""
    off = acc.shape[0] // 2
    while off:
        acc = acc + acc[np.arange(acc.shape[0]) ^ off]
        off //= 2
    return acc[0]


def _dwh_model(csr, s_src, s_dst, m, l, g, slope, d, rng):
    """``gat_dwh_kernel``'s schedule (see the module doc): (dWh, counters).
    ``d`` is D ``[E, H]`` in CSC order."""
    pt = _parts(csr.t_part)
    col = csr.t_receivers.numpy().astype(np.int64)
    n, heads, feat = g.shape
    hf = heads * feat
    lanes, vec, n_chunks, _ = gat_attn._fwd_lanes(heads, feat, True)
    width, slots = lanes * vec, 32 // lanes
    gf = g.reshape(n, hf)

    def segment(s):  # the row of one segment, the same in every chunk
        p0, p1, snd = pt["seg_ptr"][s], pt["seg_ptr"][s + 1], pt["seg_row"][s]
        acc = np.zeros((slots, hf), F32)
        for pb in range(p0, p1, 32):
            r = col[pb:min(pb + 32, p1)]
            z = s_src[snd] + s_dst[r]
            z = np.where(z > 0, z, z * F32(slope))
            ad = np.exp(np.minimum(z - m[r], 0)) / l[r] * d[pb:pb + len(r)]  # once per (edge, head)
            rows = np.repeat(ad, feat, axis=1) * gf[r]
            for j in range(len(r)):  # edge j of the batch in edge slot j % slots, in order
                acc[j % slots] = acc[j % slots] + rows[j]
        return _slot_tree(acc)
    rows = [segment(s) for s in range(len(pt["seg_row"]))]
    out = np.full((n, hf), np.nan, F32)
    partial = np.full((csr.t_part.n_slots, hf), np.nan, F32)
    arrivals = np.zeros((n_chunks, len(pt["split_row"])), np.int64)
    items = [(s, c) for c in range(n_chunks) for s in range(len(pt["seg_row"]))]
    for i in rng.permutation(len(items)):
        s, c = items[i]
        feats = np.arange(c * width, min(hf, (c + 1) * width))
        slot = pt["seg_slot"][s]
        if slot < 0:
            out[pt["seg_row"][s], feats] = rows[s][feats]
            continue
        partial[slot, feats] = rows[s][feats]
        j = pt["slot_split"][slot]
        arrivals[c, j] += 1
        k0, k1 = pt["split_ptr"][j], pt["split_ptr"][j + 1]
        if arrivals[c, j] < k1 - k0:
            continue
        arrivals[c, j] = 0  # the last to arrive merges: slot group k adds slots k0+k, k0+k+slots, ...
        acc = np.zeros((slots, len(feats)), F32)
        for k in range(k0, k1):
            acc[(k - k0) % slots] = acc[(k - k0) % slots] + partial[k, feats]
        out[pt["split_row"][j], feats] = _slot_tree(acc)
    return out.reshape(n, heads, feat), arrivals


@pytest.mark.parametrize("heads,feat,dropout", [(8, 8, True), (1, 64, False)])
@pytest.mark.parametrize("graph", ["citeseer", "sender_hub"])
def test_dwh_schedule_is_order_free_and_matches_jax_custom_vjp(graph, heads, feat, dropout):
    """The model of ``gat_dwh``'s schedule in three arrival orders: bit-equal
    to each other, every counter back at 0, every row written (zeros on the
    padding rows), ``dWh`` equal to the vjp of JAX's score-hinted fused
    attention (with the same hash dropout; Pallas in interpret mode) and to
    the plain version."""
    slope, seed = 0.2, 41
    tg, jg, csr, logits, wh, up = _case(graph, heads, feat, seed=heads * feat + 1)
    s_src, s_dst = _inputs(tg.n_node_pad, heads, feat, heads * feat + 1)[:2]
    if graph == "sender_hub":
        assert csr.t_part.split_row.numel() > 0
    _, m, l = (t.numpy() for t in gat_attn.gat_fwd_plain(
        csr, torch.from_numpy(logits), torch.from_numpy(wh), drop=(seed, RATE) if dropout else None))
    snd = row_ids(csr.t_row_ptr, csr.n_edge)
    d = (dropmask.attention_dropout_scale(seed, snd, csr.t_receivers, heads, RATE).numpy()
         if dropout else np.ones((csr.n_edge, heads), F32))
    runs = []
    for order in range(3):
        got, arrivals = _dwh_model(csr, s_src, s_dst, m, l, up, slope, d,
                                   np.random.default_rng(order))
        assert not arrivals.any()
        runs.append(got)
    for got in runs[1:]:
        np.testing.assert_array_equal(got, runs[0])
    dwh = runs[0]
    assert not np.isnan(dwh).any() and not dwh[tg.n_node:].any()

    jcsr = jprepare(jg)
    args = (jnp.asarray(s_src), jnp.asarray(s_dst))
    if dropout:
        fn = lambda w: gat_aggregate_pallas_scores_dropout(  # noqa: E731
            jcsr, slope, RATE, jnp.asarray(logits), w, *args, jnp.uint32(seed))
    else:
        fn = lambda w: gat_aggregate_pallas_scores(  # noqa: E731
            jcsr, slope, jnp.asarray(logits), w, *args)
    _, vjp = jax.vjp(fn, jnp.asarray(wh))
    (jdwh,) = vjp(jnp.asarray(up))
    np.testing.assert_allclose(dwh, np.asarray(jdwh), **GRAD)
    plain = gat_attn.gat_dwh_plain(csr, *(torch.from_numpy(t) for t in (s_src, s_dst, m, l, up)),
                                   slope, drop=(seed, RATE) if dropout else None)
    np.testing.assert_allclose(dwh, plain.numpy(), **GRAD)


# (H, F) of tests/test_torch_cuda.py's ATT_SHAPES, (1, 6) (config 2's readout),
# and the wider or many-headed shapes that take several chunks.
LAYOUT_SHAPES = [(8, 8), (1, 64), (1, 6), (1, 128), (2, 96), (3, 5), (1, 256), (4, 64), (20, 3)]


@pytest.mark.parametrize("heads,feat", LAYOUT_SHAPES)
def test_lane_layouts_cover_every_head_feature_once(heads, feat):
    """``_fwd_lanes`` (``gat_fwd`` and ``gat_dwh``): the chunks' lanes cover
    every (h, f) once, a lane's V floats lie in one head, the weight tile
    holds every chunk's heads, and its (edge, head) pairs (j = l / Hp +
    k·32/Hp, head l % Hp) cover every edge of a batch and head of the chunk
    once.  ``_bwd_lanes``: every (h, f) once, a lane's V floats in one head,
    a head's lanes a power of two inside one warp (its dot is one shuffle
    tree), float4 lanes by ``gat_fwd``'s rule."""
    hf = heads * feat
    for aligned in (True, False):
        g, v, n_chunks, hp = gat_attn._fwd_lanes(heads, feat, aligned)
        assert v == (4 if aligned and feat % 4 == 0 and hf >= 32 else 1)
        assert g in (1, 2, 4, 8, 16, 32) and hp in (1, 2, 4, 8, 16, 32)
        seen = []
        for c in range(n_chunks):
            heads_c = set()
            for lane in range(g):
                f = c * g * v + lane * v
                if f < hf:
                    assert f // feat == (f + v - 1) // feat
                    seen += range(f, f + v)
                    heads_c.add(f // feat)
            assert len(heads_c) <= hp
            pairs = [(j, lane % hp) for lane in range(32) for j in range(lane // hp, 32, 32 // hp)
                     if lane % hp < len(heads_c)]
            assert sorted(pairs) == [(j, h) for j in range(32) for h in range(len(heads_c))]
        assert sorted(seen) == list(range(hf))

        v, lh, k, ge, n_chunks = gat_attn._bwd_lanes(heads, feat, aligned)
        assert v == (4 if aligned and feat % 4 == 0 and hf >= 32 else 1)
        assert lh in (1, 2, 4, 8, 16, 32) and ge in (1, 2, 4, 8, 16, 32) and ge % lh == 0
        q = feat // v
        assert lh * k >= q and lh * (k - 1) < q
        seen = []
        for c in range(n_chunks):
            for lane in range(ge):  # one edge slot of one warp
                h = c * (ge // lh) + lane // lh
                for kk in range(k):
                    qq = lane % lh + kk * lh
                    if h < heads and qq < q:
                        seen += [(h, qq * v + i) for i in range(v)]
        assert sorted(seen) == [(h, f) for h in range(heads) for f in range(feat)]


class _FakeLibrary:
    """Stands in for the C library: records what each entry was given."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def test_wrappers_use_the_views_cached_launch_plan(monkeypatch):
    """``gat_fwd`` and ``gat_bwd`` on a CUDA view pass the fwd view's
    ``LaunchPlan``, ``gat_dwh`` the bwd (CSC) view's (each built once, the
    same object on every call), and make one launch each; ``gat_fwd`` and
    ``gat_dwh`` grow their plan's counters to their chunks and allocate
    split-row scratch only where their view has split rows; the stream is
    taken by the plan's device index.  The card is simulated: the view
    reports a CUDA device, the tensor checks are skipped, and the C library
    is a stand-in that records its arguments."""
    fake = _FakeLibrary()
    monkeypatch.setattr(_build, "load_library", lambda name: fake)
    monkeypatch.setattr(gat_attn, "_check", lambda *a, **k: None)
    monkeypatch.setattr(gat_attn, "launches", dict.fromkeys(gat_attn.launches, 0))
    streams = []

    class _Stream:
        cuda_stream = 1234

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda index=None: streams.append(index) or _Stream())
    heads, feat = 2, 96
    for graph in ("split_hub", "citeseer", "sender_hub"):
        _, _, csr, logits, wh, up = _case(graph, heads, feat, seed=1)
        csr.__dict__["device"] = torch.device("cuda", 0)
        plans = csr.plans
        fake.calls.clear()
        before = dict(gat_attn.launches)
        lg, w, g = (torch.from_numpy(t) for t in (logits, wh, up))
        for _ in range(2):
            out, m, l = gat_attn.gat_fwd(csr, lg, w, drop=(5, RATE))
            gat_attn.gat_bwd(csr, lg, w, g, m, l, m.clone(), emit_alpha=True)
            gat_attn.gat_dwh(csr, m, l, m, l, g, 0.2, drop=(5, RATE))
        assert csr.plans is plans
        assert [name for name, _ in fake.calls] == [
            "gode_gat_fwd_f32", "gode_gat_bwd_f32", "gode_gat_dwh_f32"] * 2
        assert all(args[0] == plans[name == "gode_gat_dwh_f32"].address
                   for name, args in fake.calls)
        for k in ("gat_fwd", "gat_bwd", "gat_dwh"):
            assert gat_attn.launches[k] == before[k] + 2
        lanes, vec, n_chunks, hp = gat_attn._fwd_lanes(heads, feat, True)
        fwd_args, dwh_args = fake.calls[0][1], fake.calls[2][1]
        assert fwd_args[13:18] == (heads, feat, lanes, vec, hp)
        assert dwh_args[6] == 0.2 and dwh_args[13:18] == (heads, feat, lanes, vec, hp)
        p_acc, p_stat = fwd_args[11:13]
        if graph == "split_hub":
            assert plans[0].n_split and plans[0].struct.n_arrivals == n_chunks * plans[0].n_split
            assert p_stat - p_acc == 4 * plans[0].n_slots * heads * feat
        else:
            assert plans[0].n_split == 0 and p_acc is None and p_stat is None
        if graph == "sender_hub":
            assert plans[1].n_split and plans[1].struct.n_arrivals == n_chunks * plans[1].n_split
            assert dwh_args[12] is not None
        else:
            assert plans[1].n_split == 0 and dwh_args[12] is None
        assert m.data_ptr() + 4 * m.numel() == l.data_ptr()  # two rows of one allocation
        bwd_args = fake.calls[1][1]
        assert bwd_args[1:3] == (csr.n_edge, logits.shape[0])
        v, lh = gat_attn._bwd_lanes(heads, feat, True)[:2]
        assert bwd_args[-3:-1] == (lh, v)
    assert streams == [plans[0].index] * 18
