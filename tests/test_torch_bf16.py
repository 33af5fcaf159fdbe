"""Port parity: the bfloat16 tier of the kernels' wrappers against JAX.

JAX's bf16-training tier: ``spmm_pallas`` takes bf16 features, adds the
messages in f32 and returns bf16, with a bf16 gradient
(``tests/test_pallas.py::test_spmm_pallas_bf16_inputs``); its GAT kernels
take a bf16 Wh, compute in f32, return an f32 ``out`` and round dWh to
Wh's dtype.  JAX runs here as its own tests run it on the CPU: the Pallas
kernels in interpret mode.  The port runs its wrappers on CPU tensors,
that is the kernels' plain versions, which widen the bf16 features to f32,
sum in f32 and round once.

Inputs are drawn with numpy from a seed in float32 and rounded to bf16 by
both packages (round to nearest even, bit for bit the same).  Values and
gradients agree to ``rtol = atol = 2e-2`` (JAX's own bf16 test allows 5e-2
against f32): JAX rounds each message to bf16 before its f32 sum, the port
rounds the sum once, so the two differ by a few bf16 roundings.  The port's
single rounding is held on its own: every bf16 output lies within half a
bf16 ulp (bf16's unit roundoff, 2^-8 relative) of the float64 sum of the
same bf16 inputs, plus 1e-6 for the f32 sum's order.  Every dtype is JAX's: bf16 ``spmm`` outputs
and gradients, an f32 GAT ``out`` and ``dlogits``, a bf16 ``dWh``.  The last
test holds ``chip_smoke.py``'s bf16 check to the order of a cancelling sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_odenet_tpu import graph as jgraph
from graph_odenet_tpu.data.ogbn import synthetic_ogbn_arxiv as jtwin
from graph_odenet_tpu.ops import dropmask as jdropmask
from graph_odenet_tpu.ops import pallas_gat as jgat
from graph_odenet_tpu.ops.pallas_spmm import prepare as jprepare
from graph_odenet_tpu.ops.pallas_spmm import spmm_pallas
from graph_odenet_tpu.ops.sddmm import edge_scores as jedge_scores
from graph_odenet_tpu.parallel import halo as jhalo
from graph_odenet_tpu.parallel import make_mesh
from graph_odenet_tpu.parallel import partition_by_receiver as jpartition
from graph_odenet_tpu_torch import graph as tgraph
from graph_odenet_tpu_torch.data import synthetic_ogbn_arxiv
from graph_odenet_tpu_torch.ops import csr_spmm, dropmask, gat_attn, prepare
from graph_odenet_tpu_torch.ops.csr_spmm import bucket_reduce, csr_reduce, csr_view, spmm_csr
from graph_odenet_tpu_torch.parallel import partition_by_receiver, spmm_sharded
from graph_odenet_tpu_torch.parallel.halo import _bucket_spmm, bucket_reduce_pallas
from test_torch_parallel import _bucket_arrays

BF = torch.bfloat16
TOL = dict(rtol=2e-2, atol=2e-2)
ONE_ROUNDING = 2.0 ** -8  # bf16's unit roundoff: half an ulp, relative
SLOPE = 0.2


def _graph(seed=0):
    """300 random nodes and a receiver hub of 600 edges (split rows in the
    port's partition); both packages' Graphs."""
    rng = np.random.default_rng(seed)
    n = 300
    s, r = np.nonzero(rng.random((n, n)) < 0.03)
    s = np.concatenate([s, rng.integers(0, n, 600)])
    r = np.concatenate([r, np.zeros(600, np.int64)])
    kw = dict(n_node=n, normalize="row", node_multiple=128)
    return tgraph.from_edges(s, r, **kw), jgraph.from_edges(s, r, **kw), rng


def _bf16(a):
    """float32 numpy -> (torch bf16, jax bf16), the same bits."""
    t, j = torch.from_numpy(a).to(BF), jnp.asarray(a).astype(jnp.bfloat16)
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(j).view(np.int16))
    return t, j


def _f32(t):
    return t.detach().float().numpy()


def _assert_one_rounding(out, exact):
    """``out`` (bf16) is ``exact`` (float64) rounded once."""
    err = (out.double() - exact).abs()
    assert bool((err <= ONE_ROUNDING * exact.abs() + 1e-6).all()), float(err.max())


@pytest.mark.parametrize("feat", [6, 16, 128])
def test_spmm_csr_bf16_matches_spmm_pallas(feat):
    tg, jg, rng = _graph()
    csr, jcsr = prepare(tg), jprepare(jg)
    x, xj = _bf16(rng.standard_normal((tg.n_node_pad, feat)).astype(np.float32))
    jout = spmm_pallas(jcsr, xj)
    jgrad = jax.grad(lambda v: jnp.sum(jnp.sin(spmm_pallas(jcsr, v).astype(jnp.float32))))(xj)
    assert jout.dtype == jgrad.dtype == jnp.bfloat16

    xt = x.clone().requires_grad_(True)
    out = spmm_csr(csr, xt)
    torch.sin(out.float()).sum().backward()
    assert out.dtype == xt.grad.dtype == BF
    np.testing.assert_allclose(_f32(out), np.asarray(jout, np.float32), **TOL)
    np.testing.assert_allclose(_f32(xt.grad), np.asarray(jgrad, np.float32), **TOL)

    for transpose in (False, True):
        got = csr_reduce(csr, x, transpose=transpose)
        row_ptr, col, w, _ = csr.view(transpose)
        _assert_one_rounding(got, csr_spmm._reduce_plain(row_ptr, col, w.double(), x.double()))
    torch.testing.assert_close(out, csr_reduce(csr, x), rtol=0, atol=0)


def test_bucket_reduce_bf16_write_and_accumulate_forms():
    tg, jg, rng = _graph(1)
    jcsr = jprepare(jg)
    e = tg.n_edge
    view = csr_view(tg.receivers[:e].numpy(), tg.senders[:e].numpy(), tg.weight[:e].numpy(),
                    tg.n_node_pad, tg.n_node_pad)
    x, xj = _bf16(rng.standard_normal((tg.n_node_pad, 32)).astype(np.float32))
    out0, _ = _bf16(rng.standard_normal((tg.n_node_pad, 32)).astype(np.float32))
    want = np.asarray(spmm_pallas(jcsr, xj), np.float32)
    exact = csr_spmm._reduce_plain(view.row_ptr, view.col, view.weight.double(), x.double())

    written = bucket_reduce(view, x, out0.clone(), accumulate=False)
    assert written.dtype == BF
    np.testing.assert_allclose(_f32(written), want, **TOL)
    _assert_one_rounding(written, exact)
    added = bucket_reduce(view, x, out0.clone())
    np.testing.assert_allclose(_f32(added), want + _f32(out0), **TOL)
    _assert_one_rounding(added, exact + out0.double())


@pytest.mark.parametrize("fn", ["bucket_reduce_pallas", "_bucket_spmm"])
def test_bucket_functions_bf16_match_jax(fn):
    """Every bucket of a 2-part partition of the arxiv twin, the JAX
    functions on the interpret-mode kernel (``_segment_reduce`` writes the
    messages' dtype): values and ``d sum(sin(out))`` in bf16."""
    td, jd = synthetic_ogbn_arxiv(seed=0, scale=0.004), jtwin(seed=0, scale=0.004)
    n_parts, f = 2, 12
    pg, jpg = partition_by_receiver(td.graph, n_parts), jpartition(jd.graph, n_parts)
    B = pg.block_size
    rng = np.random.default_rng(5)
    for p in range(n_parts):
        for b in range(n_parts):
            L = int(pg.bucket_edges[p, b])
            arrs = _bucket_arrays(jpg, p, b)
            if fn == "bucket_reduce_pallas":
                rows = int(jpg.senders_rel.shape[-1])
                rel2d, blk_ptr, receivers = arrs[3], arrs[4], arrs[1]
                jfun = lambda m: jhalo.bucket_reduce_pallas(m, rel2d, blk_ptr, receivers)[:B]  # noqa: E731
                tf = lambda m: bucket_reduce_pallas(m, pg.bucket(p, b))  # noqa: E731
            else:
                rows = B
                jfun = lambda c: jhalo._bucket_spmm(True, B, c, *arrs)  # noqa: E731
                tf = lambda c: _bucket_spmm(c, pg.bucket(p, b))  # noqa: E731
            x, xj = _bf16(rng.standard_normal((rows, f)).astype(np.float32))
            jout, vjp = jax.vjp(jfun, xj)
            (jgrad,) = vjp(jnp.cos(jout.astype(jnp.float32)).astype(jnp.bfloat16))
            assert jout.dtype == jgrad.dtype == jnp.bfloat16
            xt = x.clone().requires_grad_(True)
            out = tf(xt)
            out.backward(torch.cos(out.detach().float()).to(BF))
            assert out.dtype == xt.grad.dtype == BF
            np.testing.assert_allclose(_f32(out), np.asarray(jout, np.float32), **TOL)
            n = L if fn == "bucket_reduce_pallas" else rows  # JAX fills padding slots with g[0]
            np.testing.assert_allclose(_f32(xt.grad)[:n], np.asarray(jgrad, np.float32)[:n], **TOL)


@pytest.fixture(scope="module")
def one_part():
    """The arxiv twin at one part, bf16 rows, and JAX's ``ring_pallas`` (the
    bucket kernel in interpret mode, partitioned with its default
    ``edge_multiple``): values and ``d sum(sin(out))``."""
    td, jd = synthetic_ogbn_arxiv(seed=0, scale=0.004), jtwin(seed=0, scale=0.004)
    pg, jpg = partition_by_receiver(td.graph, 1), jpartition(jd.graph, 1)
    mesh = make_mesh(shape=(1,), axis_names=("edge",), devices=jax.devices()[:1])
    x, xj = _bf16(np.random.default_rng(6).standard_normal((pg.block_size, 24)).astype(np.float32))

    def jax_mode(mode):
        def jloss(v):
            out = jhalo.spmm_sharded(jpg, v, mesh, mode=mode)
            return jnp.sum(jnp.sin(out.astype(jnp.float32))), out

        (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(xj)
        assert jout.dtype == jgrad.dtype == jnp.bfloat16
        return np.asarray(jout, np.float32), np.asarray(jgrad, np.float32)

    return pg, x, jax_mode, jax_mode("ring_pallas")


@pytest.mark.parametrize("mode", ["allgather", "ring", "ring_pallas"])
def test_spmm_sharded_bf16_one_part_matches_jax(one_part, mode):
    """Every port mode runs the bucket kernel (its plain version here): bf16
    out and gradient, as each JAX mode gives, and the values of JAX's kernel
    path ``ring_pallas`` to 2e-2.  JAX's ``allgather`` and ``ring`` add the
    bf16 messages with XLA's scatter-add in bf16, which drifts at the twin's
    hub rows (up to 0.32 relative here); where they stray beyond 2e-2 from
    the port, they are the farther of the two from the float64 sum."""
    pg, x, jax_mode, (kout, kgrad) = one_part
    jout, jgrad = jax_mode(mode)
    xt = x.clone().requires_grad_(True)
    out = spmm_sharded(pg, xt, mode=mode)
    torch.sin(out.float()).sum().backward()
    assert out.dtype == xt.grad.dtype == BF
    np.testing.assert_allclose(_f32(out), kout, **TOL)
    np.testing.assert_allclose(_f32(xt.grad), kgrad, **TOL)
    view = pg.bucket(0, 0).fwd
    exact = csr_spmm._reduce_plain(view.row_ptr, view.col, view.weight.double(), x.double())
    _assert_one_rounding(out, exact)
    exact = exact.numpy()
    off = np.abs(_f32(out) - jout) > TOL["atol"] + TOL["rtol"] * np.abs(jout)
    assert np.all(np.abs(jout - exact)[off] > np.abs(_f32(out) - exact)[off])


VARIANTS = ("plain", "dropout", "scores", "scores_dropout")


@pytest.mark.parametrize("variant", VARIANTS)
def test_gat_functions_bf16_wh_match_pallas(variant):
    """The four autograd Functions on a bf16 Wh against JAX's four Pallas
    ones: f32 ``out`` and ``dlogits``, bf16 ``dWh``.  The score hint routes
    dWh through ``gat_dwh`` (f32 inputs, rounded to bf16 by the Function),
    its absence through ``gat_bwd``'s α·D and the weighted CSR mode."""
    heads, feat, rate, seed = 4, 8, 0.6, 4242
    tg, jg, rng = _graph(2)
    csr, jcsr = prepare(tg), jprepare(jg)
    e = tg.n_edge
    s_src = (rng.standard_normal((tg.n_node_pad, heads)) * 1.5).astype(np.float32)
    s_dst = (rng.standard_normal((tg.n_node_pad, heads)) * 1.5).astype(np.float32)
    wh, whj = _bf16(rng.standard_normal((tg.n_node_pad, heads, feat)).astype(np.float32))
    logits = np.asarray(jedge_scores(jg, jnp.asarray(s_src), jnp.asarray(s_dst),
                                     negative_slope=SLOPE))
    dmask = np.asarray(jdropmask.attention_dropout_scale(
        jnp.uint32(seed), jg.senders, jg.receivers, heads, rate))
    a, b = jnp.asarray(s_src), jnp.asarray(s_dst)

    def jfun(lg, w):
        if variant == "plain":
            return jgat.gat_aggregate_pallas(jcsr, lg, w)
        if variant == "dropout":
            return jgat.gat_aggregate_pallas_dropout(jcsr, lg, w, jnp.asarray(dmask))
        if variant == "scores":
            return jgat.gat_aggregate_pallas_scores(jcsr, SLOPE, lg, w, a, b)
        return jgat.gat_aggregate_pallas_scores_dropout(
            jcsr, SLOPE, rate, lg, w, a, b, jnp.uint32(seed))

    (_, jout), (jdl, jdw) = jax.value_and_grad(
        lambda lg, w: (jnp.sum(jnp.sin(jfun(lg, w))), jfun(lg, w)), argnums=(0, 1),
        has_aux=True)(jnp.asarray(logits), whj)
    assert (jout.dtype, jdl.dtype, jdw.dtype) == (jnp.float32, jnp.float32, jnp.bfloat16)

    lg = torch.from_numpy(logits[:e]).requires_grad_(True)
    w = wh.clone().requires_grad_(True)
    ta, tb = torch.from_numpy(s_src), torch.from_numpy(s_dst)
    before = dict(gat_attn.launches)
    if variant == "plain":
        out = gat_attn.gat_aggregate_kernel(csr, lg, w)
    elif variant == "dropout":
        out = gat_attn.gat_aggregate_kernel_dropout(
            csr, lg, w, dropmask.attention_dropout_scale(seed, csr.senders, csr.receivers,
                                                         heads, rate))
    elif variant == "scores":
        out = gat_attn.gat_aggregate_kernel_scores(csr, SLOPE, lg, w, ta, tb)
    else:
        out = gat_attn.gat_aggregate_kernel_scores_dropout(csr, SLOPE, rate, lg, w, ta, tb, seed)
    torch.sin(out).sum().backward()
    assert gat_attn.launches == before  # CPU tensors: the plain versions
    assert (out.dtype, lg.grad.dtype, w.grad.dtype) == (torch.float32, torch.float32, BF)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(jdl)[:e], **TOL)
    np.testing.assert_allclose(_f32(w.grad), np.asarray(jdw, np.float32), **TOL)


def test_gat_kernel_wrappers_bf16_wh():
    """``gat_fwd`` and ``gat_bwd`` on a bf16 ``wh`` equal their f32 calls on
    the widened ``wh`` exactly (the plain versions widen it first), and
    return f32; ``gat_dwh`` takes f32 tables only."""
    heads, feat = 2, 6
    tg, _, rng = _graph(3)
    csr = prepare(tg)
    n, e = tg.n_node_pad, tg.n_edge
    logits = torch.from_numpy(rng.standard_normal((e, heads)).astype(np.float32))
    wh, _ = _bf16(rng.standard_normal((n, heads, feat)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((n, heads, feat)).astype(np.float32))
    got = gat_attn.gat_fwd(csr, logits, wh, drop=(7, 0.5))
    want = gat_attn.gat_fwd(csr, logits, wh.float(), drop=(7, 0.5))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    out, m, l = got
    beta = (g * out).sum(-1)
    got = gat_attn.gat_bwd(csr, logits, wh, g, m, l, beta, emit_alpha=True)
    want = gat_attn.gat_bwd(csr, logits, wh.float(), g, m, l, beta, emit_alpha=True)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(TypeError, match="float32 g"):
        gat_attn.gat_dwh(csr, m, l, m, l, g.to(BF), SLOPE)


@pytest.mark.parametrize("case", [
    "csr_weighted", "bucket_weighted", "csr_float16", "csr_float64", "bucket_mixed",
    "gat_fwd_logits", "gat_bwd_g", "gat_fwd_float16_wh",
])
def test_bf16_refusals(case):
    """B1-w and B2-w take f32 only (their callers hand them f32 g), as does
    every GAT input but ``wh``; no dtype but float32 and bfloat16 is taken.
    Each refusal is a ``TypeError`` before anything runs."""
    tg, _, rng = _graph(4)
    csr = prepare(tg)
    n, e = tg.n_node_pad, tg.n_edge
    x = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))
    alpha = torch.rand(e, 2)
    view = csr_view(tg.receivers[:e].numpy(), tg.senders[:e].numpy(), tg.weight[:e].numpy(),
                    n, n)
    logits, wh = torch.rand(e, 2), torch.rand(n, 2, 4)
    m = l = torch.ones(n, 2)
    calls = {
        "csr_weighted": lambda: csr_reduce(csr, x.to(BF), transpose=True, alpha=alpha, feat=4),
        "bucket_weighted": lambda: bucket_reduce(view, x.to(BF), x.to(BF), alpha=alpha, feat=4),
        "csr_float16": lambda: csr_reduce(csr, x.half()),
        "csr_float64": lambda: spmm_csr(csr, x.double()),
        "bucket_mixed": lambda: bucket_reduce(view, x.to(BF), x.clone()),
        "gat_fwd_logits": lambda: gat_attn.gat_fwd(csr, logits.to(BF), wh),
        "gat_bwd_g": lambda: gat_attn.gat_bwd(csr, logits, wh.to(BF), wh.to(BF), m, l, m),
        "gat_fwd_float16_wh": lambda: gat_attn.gat_fwd(csr, logits, wh.half()),
    }
    with pytest.raises(TypeError):
        calls[case]()


def test_smoke_bf16_check_allows_the_order_of_a_cancelling_sum():
    """``chip_smoke.py``'s bf16 check holds the kernel's bf16 output to the
    plain version's, two f32 sums of the same terms in other orders.  Where
    the terms cancel (16,001 terms of magnitude up to 4 summing to 1e-3), the
    two orders differ by many ulps of the result: one bf16 ulp plus 1e-5 fails
    correct sums, and the check's term ``BF16_SUM_RTOL · Σ|terms|`` admits
    them while a missing term still fails by two orders of magnitude."""
    import chip_smoke
    from graph_odenet_tpu_torch.ops.csr_spmm import _reduce_plain

    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.standard_normal((8000, 8)).astype(np.float32)).to(torch.bfloat16)
    x = torch.cat([v, -v, torch.full((1, 8), 1e-3).to(torch.bfloat16)])
    n = x.shape[0]
    row_ptr, ones = torch.tensor([0, n]), torch.ones(n)
    perm = torch.from_numpy(rng.permutation(n))
    in_order = _reduce_plain(row_ptr, torch.arange(n), ones, x)
    shuffled = _reduce_plain(row_ptr, perm, ones, x)
    scale = chip_smoke._term_sums(row_ptr, torch.arange(n), ones, x)
    assert chip_smoke._bf16_err(shuffled, in_order, torch.zeros_like(scale))[1] > 1.5
    assert chip_smoke._bf16_err(shuffled, in_order, scale)[1] < 0.01
    missing = _reduce_plain(torch.tensor([0, n - 1]), perm[perm != 0], ones[1:], x)
    assert chip_smoke._bf16_err(missing, in_order, scale)[1] > 100
