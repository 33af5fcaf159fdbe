"""Port parity: the edge-partitioned tier in bfloat16 against the JAX package.

Both sharded models take ``dtype=``: every leaf in it, the Glorot weights
drawn in float32 and rounded once (a float32 model's draw is the same as
without the argument).  JAX's bf16 parameters load through ``convert``
unchanged.  With bf16 parameters and features the sharded GCN-ODE runs every
mode in bf16 (B2's bf16 entry; its plain version here), and the sharded
GAT-ODE runs both modes in bf16: on ``ring_pallas`` each hop's chunk and
softmax numerators are widened to f32 for B2-w's f32 entry (whose wrapper
still refuses bf16, ``test_torch_bf16.py::test_bf16_refusals``), the sum over
hops is kept in f32 and rounded once after the division by the denominators.

JAX runs as its own tests run it: the 8-device CPU mesh of
``tests/conftest.py``, the Pallas bucket kernel in interpret mode, one part,
the arxiv twin at scale 0.004.  The port runs on CPU tensors, that is the
kernels' plain versions.  Every port mode is held to JAX's kernel path,
``ring_pallas``, whose reductions sum in f32 as the port's do (JAX's
``allgather`` and ``ring`` add bf16 messages with XLA's bf16 scatter-add,
``test_torch_bf16.py::test_spmm_sharded_bf16_one_part_matches_jax``).
Values and gradients agree to ``test_torch_bf16.py``'s ``rtol = atol =
2e-2``: JAX rounds each hop's messages to bf16, the port rounds once.

Last, the segment ops take JAX's ``sorted_ids`` keyword and ignore it.
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_odenet_tpu.data.ogbn import synthetic_ogbn_arxiv as jtwin
from graph_odenet_tpu.ops import segment as jsegment
from graph_odenet_tpu.parallel import gat_sharded as jgat_sharded
from graph_odenet_tpu.parallel import halo as jhalo
from graph_odenet_tpu.parallel import make_mesh
from graph_odenet_tpu.parallel import partition_by_receiver as jpartition
from graph_odenet_tpu.parallel import sharded_gat as jsgat
from graph_odenet_tpu.parallel import sharded_gcn as jsg
from graph_odenet_tpu_torch.convert import params_from_sharded, params_from_sharded_gat
from graph_odenet_tpu_torch.data import synthetic_ogbn_arxiv
from graph_odenet_tpu_torch.ops import segment
from graph_odenet_tpu_torch.parallel import (
    gat_sharded, padded_buckets, partition_by_receiver, sharded_gat, sharded_gcn,
)
from graph_odenet_tpu_torch.ops import csr_spmm
from graph_odenet_tpu_torch.ops.csr_spmm import _bucket_reduce_plain, _edge_dot_plain
from graph_odenet_tpu_torch.parallel import halo
from graph_odenet_tpu_torch.parallel.halo import _bucket_spmm_weighted

from torch_dist_worlds import _labels_weight

BF = torch.bfloat16
TOL = dict(rtol=2e-2, atol=2e-2)
SCALE = 0.004  # 677 nodes, padded to 768
GCN_HIDDEN = 16
HIDDEN, HEADS, STEPS = 8, 2, 2
GCN_MODES = ("allgather", "ring", "ring_pallas")
GAT_MODES = ("ring", "ring_pallas")


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


def _mesh():
    return make_mesh(shape=(1,), axis_names=("edge",), devices=jax.devices()[:1])


def _f32(t):
    return t.detach().float().numpy()


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bits(t):
    return t.detach().view(torch.int16).numpy()


@contextlib.contextmanager
def float64_sums():
    """Within the block ``parallel.halo`` reduces every bucket, and takes B2-w's
    per-edge dot, with the plain versions themselves, which sum float64
    tables too (the wrappers take f32, and bf16 for the bucket mode): the
    exact sums of a bf16 computation's inputs."""
    kernels = halo.bucket_reduce, halo.edge_dot
    halo.bucket_reduce, halo.edge_dot = _bucket_reduce_plain, _edge_dot_plain
    try:
        yield
    finally:
        halo.bucket_reduce, halo.edge_dot = kernels


# ------------------------------------------------------------ the inits


def _glorot_before(fan_in, fan_out, generator):
    """The float32 draw as the inits made it before they took ``dtype``."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(fan_in, fan_out).uniform_(-limit, limit, generator=generator)


def _init(model, dtype=None, seed=0):
    kw = {} if dtype is None else dict(dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    if model == "gcn":
        return sharded_gcn.init_params(20, GCN_HIDDEN, 5, generator=gen, **kw)
    return sharded_gat.init_gatode_params(20, HIDDEN, HEADS, 5, generator=gen, **kw)


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_default_float32_draw_is_unchanged(model):
    gen = torch.Generator().manual_seed(0)
    d = HIDDEN * HEADS
    if model == "gcn":
        shapes = {"w_in": (20, GCN_HIDDEN), "w_dyn": (GCN_HIDDEN, GCN_HIDDEN),
                  "w_out": (GCN_HIDDEN, 5)}
        want = {}
        for k in ("in", "dyn", "out"):
            want[f"w_{k}"] = _glorot_before(*shapes[f"w_{k}"], gen)
            want[f"b_{k}"] = torch.zeros(shapes[f"w_{k}"][1])
    else:
        shapes = [("w_enc", (20, d)), ("a_src_enc", (HEADS, HIDDEN)), ("a_dst_enc", (HEADS, HIDDEN)),
                  ("w_dyn", (d, d)), ("a_src_dyn", (1, d)), ("a_dst_dyn", (1, d)),
                  ("w_out", (d, 5)), ("a_src_out", (1, 5)), ("a_dst_out", (1, 5))]
        want = {k: _glorot_before(*s, gen) for k, s in shapes}
    got = dict(_init(model).named_parameters())
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k].detach(), w), k
        assert torch.equal(got[k].detach(), dict(_init(model, torch.float32).named_parameters())[k])


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_bf16_init_is_the_float32_draw_rounded_once(model):
    f32 = dict(_init(model).named_parameters())
    bf16 = dict(_init(model, BF).named_parameters())
    for k, p in bf16.items():
        assert p.dtype == BF and p.requires_grad, k
        np.testing.assert_array_equal(_bits(p), _bits(f32[k].detach().to(BF)), err_msg=k)


def _jax_params(model, f_in, n_class, dtype, seed=0):
    key = jax.random.PRNGKey(seed)
    if model == "gcn":
        p = jsg.init_params(key, f_in, GCN_HIDDEN, n_class, dtype=dtype)
    else:
        p = jsgat.init_gatode_params(key, f_in, HIDDEN, HEADS, n_class, dtype=dtype)
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_jax_bf16_params_load_unchanged(model):
    params = _jax_params(model, 20, 5, jnp.bfloat16)
    convert = params_from_sharded if model == "gcn" else params_from_sharded_gat
    state = convert(params)
    m = _init(model, BF)
    m.load_state_dict(state)
    for k, p in m.named_parameters():
        assert state[k].dtype == p.dtype == BF, k
        np.testing.assert_array_equal(_bits(p), params[k].view(np.int16), err_msg=k)


# ---------------------------------------------------- the sharded GCN-ODE


@pytest.fixture(scope="module")
def gcn_setup(twins):
    """JAX's bf16 sharded GCN-ODE on ``ring_pallas``: log-probs, loss and the
    six gradients, from JAX's bf16 parameters and bf16 features."""
    td, jd = twins
    params = _jax_params("gcn", td.features.shape[1], td.n_class, jnp.bfloat16)
    y1h, w = _labels_weight(td)
    jpg, mesh = jpartition(jd.graph, 1), _mesh()
    x = jnp.asarray(jd.features).astype(jnp.bfloat16)
    args = (jpg, x, jnp.asarray(y1h.numpy()), jnp.asarray(w.numpy()), mesh)

    @jax.jit
    def run(p):
        loss, grads = jax.value_and_grad(jsg.loss_fn)(p, *args, steps=STEPS, mode="ring_pallas")
        return jsg.forward(p, jpg, x, mesh, steps=STEPS, mode="ring_pallas"), loss, grads

    lp, loss, grads = run({k: jnp.asarray(v) for k, v in params.items()})
    assert lp.dtype == jnp.bfloat16 and all(g.dtype == jnp.bfloat16 for g in grads.values())
    return params, (_np(lp), float(loss), {k: _np(g) for k, g in grads.items()})


@pytest.mark.parametrize("mode", GCN_MODES)
def test_sharded_gcn_bf16_matches_jax(twins, gcn_setup, mode):
    td, _ = twins
    params, (jlp, jloss, jgrads) = gcn_setup
    model = sharded_gcn.init_params(td.features.shape[1], GCN_HIDDEN, td.n_class, dtype=BF)
    model.load_state_dict(params_from_sharded(params))
    y1h, w = _labels_weight(td)
    pg = partition_by_receiver(td.graph, 1)
    x = td.features.to(BF)
    loss = sharded_gcn.loss_fn(model, pg, x, y1h, w, steps=STEPS, mode=mode)
    loss.backward()
    lp = sharded_gcn.forward(model, pg, x, steps=STEPS, mode=mode)
    assert lp.dtype == BF and loss.dtype == torch.float32  # the NLL is summed in f32
    np.testing.assert_allclose(_f32(lp), jlp, **TOL)
    np.testing.assert_allclose(loss.item(), jloss, **TOL)
    assert sorted(jgrads) == sorted(k for k, _ in model.named_parameters()) and len(jgrads) == 6
    for k, p in model.named_parameters():
        assert p.grad.dtype == BF, k
        np.testing.assert_allclose(_f32(p.grad), jgrads[k], err_msg=k, **TOL)


def test_sharded_gcn_bf16_feature_dropout_keeps_bf16(twins):
    """The dropout mask is drawn in f32, so bf16 and f32 drop the same
    features; the bf16 features stay bf16."""
    td, _ = twins
    h = td.features[:, :8].contiguous()
    rows = slice(0, h.shape[0])

    def drop(t):
        return sharded_gcn._feature_dropout(t, 0.5, torch.Generator().manual_seed(3), rows,
                                            h.shape[0])

    got, want = drop(h.to(BF)), drop(h)
    assert got.dtype == BF
    assert torch.equal(got == 0, want == 0)
    np.testing.assert_array_equal(_bits(got), _bits((h.to(BF) / 0.5) * (want != 0)))


# --------------------------------------------------------- B2-w in bf16


def _numerators(rng, receivers, real, n_rows, heads):
    """Positive ``[E, H]`` weights that sum to 1 over each row's real edges
    (softmax weights: ``gat_sharded`` divides the sum by them), 0 on the
    padding slots, as float32."""
    u = np.where(real[:, None], rng.random((receivers.shape[0], heads)) + 0.5, 0.0)
    total = np.zeros((n_rows, heads))
    np.add.at(total, receivers, u)
    return (u / np.maximum(total[receivers], 1e-30)).astype(np.float32)


def _close_or_jax_farther(got, want, exact, name):
    """``got`` (the port) within ``TOL`` of ``exact``, the same function in
    float64 on the same bf16 inputs, and of ``want`` (JAX); where not of
    JAX's, JAX is the farther of the two from ``exact``: it rounds each
    message (and each product of ``dpv``'s sums) to bf16 and adds bf16
    gradients at hub nodes with XLA's bf16 scatter-add, which at a
    cancelling or long sum strays by more than 2e-2."""
    got = _f32(got)
    np.testing.assert_allclose(got, exact, err_msg=f"{name} vs float64", **TOL)
    off = np.abs(got - want) > TOL["atol"] + TOL["rtol"] * np.abs(want)
    assert off.mean() < 0.01, (name, off.mean())
    assert np.all(np.abs(want - exact)[off] > np.abs(got - exact)[off]), name


def test_bucket_spmm_weighted_bf16_matches_jax_on_every_bucket(twins):
    """Every bucket of a 2-part partition at H = 2, F = 4, softmax weights: the port widens
    the bf16 chunk and numerators for the f32 entry and returns an f32 sum
    (rounded by ``gat_sharded``), JAX sums bf16 messages and returns bf16;
    ``dchunk`` and ``dpv`` come back in their inputs' dtype (bf16) in both.
    The port's sums are held to JAX's and to the float64 sums of the same
    inputs (``_close_or_jax_farther``)."""
    td, jd = twins
    n_parts, heads, feat = 2, 2, 4
    pg, jpg = partition_by_receiver(td.graph, n_parts), jpartition(jd.graph, n_parts)
    B, E = pg.block_size, padded_buckets(pg).e_bucket
    rng = np.random.default_rng(11)

    @jax.jit
    def jrun(chunk, pv, *arrs):
        f = lambda c, a: jhalo._bucket_spmm_weighted(B, feat, c, a, *arrs)  # noqa: E731
        out, vjp = jax.vjp(f, chunk, pv)
        return (out, *vjp(jnp.cos(out.astype(jnp.float32)).astype(out.dtype)))

    for p in range(n_parts):
        for b in range(n_parts):
            L = int(pg.bucket_edges[p, b])
            chunk = rng.standard_normal((B, heads * feat)).astype(np.float32)
            real = np.asarray(jpg.weight[p, b]) != 0.0
            pv = _numerators(rng, np.asarray(jpg.receivers_rel[p, b]), real, B, heads)
            arrs = [getattr(jpg, n)[p, b] for n in (
                "senders_rel", "receivers_rel", "tile_rel", "tile_blk_ptr", "t_receivers_rel",
                "t_tile_rel", "t_tile_blk_ptr", "t_perm")]
            jout, jdchunk, jdpv = jrun(jnp.asarray(chunk).astype(jnp.bfloat16),
                                       jnp.asarray(pv).astype(jnp.bfloat16), *arrs)
            assert jout.dtype == jdchunk.dtype == jdpv.dtype == jnp.bfloat16
            results = []
            for dtype in (BF, torch.float64):  # the port, and the exact sums of its inputs
                ct = torch.from_numpy(chunk).to(BF).to(dtype).requires_grad_(True)
                pt = torch.from_numpy(pv[:L]).to(BF).to(dtype).requires_grad_(True)
                with float64_sums():
                    out = _bucket_spmm_weighted(ct, pt, pg.bucket(p, b), feat)
                    g = torch.cos(out.detach().to(BF).float()).to(BF)  # JAX's bf16 cotangent
                    out.backward(g.to(out.dtype))
                results.append([out.detach(), ct.grad, pt.grad])
            (out, dchunk, dpv), exact = results
            assert out.dtype == torch.float32 and dchunk.dtype == dpv.dtype == BF
            for name, got, want, x in zip(("out", "dchunk", "dpv"), (out, dchunk, dpv),
                                          (jout, jdchunk, jdpv[:L]), exact):
                _close_or_jax_farther(got, _np(want), x.numpy(), name)


def test_bucket_spmm_weighted_bf16_adds_into_an_f32_accumulator(twins):
    """A later hop: a bf16 chunk is added into the f32 sum in place, equal to
    the f32 Function on the widened inputs, bit for bit, gradients too."""
    td, _ = twins
    pg = partition_by_receiver(td.graph, 2)
    rng = np.random.default_rng(12)
    B, heads, feat = pg.block_size, 2, 4
    chunk = torch.from_numpy(rng.standard_normal((B, heads * feat)).astype(np.float32)).to(BF)
    pv = torch.from_numpy(rng.random((int(pg.bucket_edges[0, 1]), heads)).astype(np.float32))
    acc0 = torch.from_numpy(rng.standard_normal((B, heads * feat)).astype(np.float32))
    results = []
    for c, a in ((chunk, pv.to(BF)), (chunk.float(), pv.to(BF).float())):
        c, a = c.clone().requires_grad_(True), a.clone().requires_grad_(True)
        acc = acc0.clone().requires_grad_(True)
        base = acc * 1.0
        out = _bucket_spmm_weighted(c, a, pg.bucket(0, 1), feat, acc=base)
        assert out.data_ptr() == base.data_ptr() and out.dtype == torch.float32
        torch.sin(out).sum().backward()
        results.append([out.detach(), acc.grad, c.grad.to(BF), a.grad.to(BF)])
    for got, want in zip(*results):
        assert torch.equal(got, want)


# ------------------------------------------------------------ gat_sharded


def _gat_inputs(g, heads, feat, seed):
    rng = np.random.default_rng(seed)
    n = g.n_node_pad
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((n, heads), (n, heads), (n, heads, feat)))


@pytest.fixture(scope="module")
def jax_gat_bf16(twins):
    """JAX's ``gat_sharded(mode="ring_pallas")`` on bf16 inputs at one part:
    (inputs, [out, ds_src, ds_dst, dwh]), gradients of ``sum(sin(out))``."""
    _, jd = twins
    jpg, mesh = jpartition(jd.graph, 1), _mesh()
    inputs = _gat_inputs(jd.graph, 2, 4, seed=30)

    def f(ss, sd, w):
        return jgat_sharded(jpg, ss, sd, w, mesh, mode="ring_pallas")

    jout, vjp = jax.vjp(jax.jit(f), *(jnp.asarray(a).astype(jnp.bfloat16) for a in inputs))
    grads = vjp(jnp.cos(jout.astype(jnp.float32)).astype(jnp.bfloat16))
    assert jout.dtype == jnp.bfloat16 and all(g.dtype == jnp.bfloat16 for g in grads)
    return inputs, [_np(v) for v in (jout, *grads)]


def _port_gat(pg, inputs, dtype, mode, **kw):
    """The port's ``gat_sharded`` on ``inputs`` rounded to bf16, then cast to
    ``dtype`` (float64: with ``float64_sums``): values and the gradients of
    ``sum(sin(out))`` with a bf16 cotangent."""
    ts = [torch.from_numpy(a).to(BF).to(dtype).requires_grad_(True) for a in inputs]
    with float64_sums() if dtype == torch.float64 else contextlib.nullcontext():
        out = gat_sharded(pg, *ts, mode=mode, **kw)
        g = torch.cos(out.detach().to(BF).float()).to(BF)
        grads = torch.autograd.grad(out, ts, g.to(dtype))
    assert out.dtype == dtype and all(g.dtype == dtype for g in grads)
    return [out.detach(), *grads]


@pytest.mark.parametrize("mode", GAT_MODES)
def test_gat_sharded_bf16_matches_jax(twins, jax_gat_bf16, mode):
    """Every output within 2e-2 of the float64 call on the same bf16 inputs,
    and of JAX's bf16 ``ring_pallas`` where JAX is not the farther of the two
    (at the twin's hub senders JAX's ds_src strays from the float64 sum by
    more than 2e-2)."""
    td, _ = twins
    inputs, want = jax_gat_bf16
    pg = partition_by_receiver(td.graph, 1)
    got = _port_gat(pg, inputs, BF, mode)
    exact = _port_gat(pg, inputs, torch.float64, mode)
    for name, a, b, x in zip(("out", "ds_src", "ds_dst", "dwh"), got, want, exact):
        _close_or_jax_farther(a, b, x.numpy(), name)


@pytest.mark.parametrize("mode", GAT_MODES)
def test_gat_sharded_bf16_attention_dropout(twins, mode):
    """With attention dropout JAX's bf16 ``gat_sharded`` raises in both modes
    (its f32 dropout scale promotes the loop carry).  The port's runs, returns
    bf16, and agrees with its float64 call on the same bf16 values: the
    output to 2e-2, each gradient at rtol 2e-2 with atol 2e-2 of its largest
    entry (``chip_smoke.py``'s rule for a gradient: the softmax's backward
    subtracts nearly equal bf16 terms, and the dropout scale 1/0.6 enlarges
    them); the two modes agree bit for bit.  The float32 call is held to
    JAX's with dropout in ``test_torch_sharded_gat.py``."""
    td, jd = twins
    inputs = _gat_inputs(td.graph, 2, 4, seed=34)
    with pytest.raises(TypeError, match="carry"):
        jgat_sharded(jpartition(jd.graph, 1), *(jnp.asarray(a).astype(jnp.bfloat16)
                                                 for a in inputs),
                     _mesh(), mode=mode, attn_rate=0.4, attn_seed=jnp.uint32(99))
    pg = partition_by_receiver(td.graph, 1)
    kw = dict(attn_rate=0.4, attn_seed=99)
    got = _port_gat(pg, inputs, BF, mode, **kw)
    want = _port_gat(pg, inputs, torch.float64, mode, **kw)
    plain = _port_gat(pg, inputs, BF, mode)
    assert not np.allclose(_f32(got[0]), _f32(plain[0]), atol=0.1)  # the mask did drop
    np.testing.assert_allclose(_f32(got[0]), want[0].numpy(), err_msg="out", **TOL)
    for name, a, b in zip(("ds_src", "ds_dst", "dwh"), got[1:], want[1:]):
        b = b.numpy()
        np.testing.assert_allclose(_f32(a), b, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * np.abs(b).max(), err_msg=name)
    other = _port_gat(pg, inputs, BF, GAT_MODES[mode == "ring"], **kw)
    for a, b in zip(got, other):
        assert torch.equal(a, b)


def test_gat_sharded_bf16_ring_pallas_rounds_once(twins):
    """``ring_pallas`` in bf16 is the f32 sum over the widened inputs, divided
    by the bf16 denominators and rounded once: equal, bit for bit, to the
    same function on f32 chunks carrying the bf16 values, whose softmax
    pieces are computed from the same bf16 scores."""
    td, _ = twins
    pg = partition_by_receiver(td.graph, 1)
    ss, sd, wh = (torch.from_numpy(a).to(BF) for a in _gat_inputs(td.graph, 2, 4, seed=31))
    got = gat_sharded(pg, ss, sd, wh, mode="ring_pallas")
    blk = pg.blocks[0]
    e = torch.nn.functional.leaky_relu(ss[blk.senders] + sd[blk.receivers], 0.2)
    m = csr_spmm.segment_max(e, blk.receivers, pg.block_size)
    p = torch.exp(e - m[blk.receivers])
    l = segment.segment_sum(p, blk.receivers, pg.block_size)
    s = _bucket_spmm_weighted(wh.reshape(pg.block_size, -1).float(), p.float(), pg.bucket(0, 0),
                              4, rows=blk.receivers)
    want = (s.view(wh.shape) / torch.clamp(l, min=1e-30)[..., None]).to(BF)
    assert got.dtype == BF
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ---------------------------------------------------- the sharded GAT-ODE


@pytest.fixture(scope="module")
def jax_gatode_bf16(twins):
    """JAX's bf16 sharded GAT-ODE on ``ring_pallas``: log-probs, loss and the
    nine gradients, from JAX's bf16 parameters and bf16 features."""
    td, jd = twins
    params = _jax_params("gat", td.features.shape[1], td.n_class, jnp.bfloat16)
    y1h, w = _labels_weight(td)
    jpg, mesh = jpartition(jd.graph, 1), _mesh()
    x = jnp.asarray(jd.features).astype(jnp.bfloat16)
    y1h, w = jnp.asarray(y1h.numpy()), jnp.asarray(w.numpy())

    @jax.jit
    def run(p):
        def loss(p):
            lp = jsgat.gatode_forward(p, jpg, x, mesh, steps=STEPS, mode="ring_pallas")
            return jnp.sum(-jnp.sum(lp * y1h, axis=-1) * w) / jnp.sum(w), lp

        (val, lp), grads = jax.value_and_grad(loss, has_aux=True)(p)
        return lp, val, grads

    lp, loss, grads = run({k: jnp.asarray(v) for k, v in params.items()})
    assert lp.dtype == jnp.bfloat16 and all(g.dtype == jnp.bfloat16 for g in grads.values())
    return params, (_np(lp), float(loss), {k: _np(g) for k, g in grads.items()})


def _port_gatode(td, params, *, mode, remat):
    model = sharded_gat.init_gatode_params(td.features.shape[1], HIDDEN, HEADS, td.n_class,
                                           dtype=BF)
    model.load_state_dict(params_from_sharded_gat(params))
    y1h, w = _labels_weight(td)
    pg = partition_by_receiver(td.graph, 1)
    lp = sharded_gat.gatode_forward(model, pg, td.features.to(BF), steps=STEPS, mode=mode,
                                    remat=remat)
    loss = -(lp * y1h).sum(-1).mul(w).sum() / w.sum()
    loss.backward()
    assert lp.dtype == BF and loss.dtype == torch.float32
    grads = {}
    for k, p in model.named_parameters():
        assert p.grad.dtype == p.dtype == BF, k
        grads[k] = _f32(p.grad)
    return _f32(lp), loss.item(), grads


@pytest.fixture(scope="module")
def port_gatode_bf16(twins, jax_gatode_bf16):
    td, _ = twins
    params, _ = jax_gatode_bf16
    return {(mode, remat): _port_gatode(td, params, mode=mode, remat=remat)
            for mode in GAT_MODES for remat in (False, True)}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("mode", GAT_MODES)
def test_gatode_forward_bf16_matches_jax(jax_gatode_bf16, port_gatode_bf16, mode, remat):
    _, (jlp, jloss, jgrads) = jax_gatode_bf16
    lp, loss, grads = port_gatode_bf16[mode, remat]
    np.testing.assert_allclose(lp, jlp, **TOL)
    np.testing.assert_allclose(loss, jloss, **TOL)
    assert sorted(grads) == sorted(jgrads) and len(grads) == 9
    for k, g in grads.items():
        np.testing.assert_allclose(g, jgrads[k], err_msg=k, **TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_gatode_bf16_ring_pallas_agrees_with_ring(port_gatode_bf16, remat):
    lp_k, loss_k, g_k = port_gatode_bf16["ring_pallas", remat]
    lp_r, loss_r, g_r = port_gatode_bf16["ring", remat]
    np.testing.assert_allclose(lp_k, lp_r, **TOL)
    np.testing.assert_allclose(loss_k, loss_r, **TOL)
    for k in g_k:
        np.testing.assert_allclose(g_k[k], g_r[k], err_msg=k, **TOL)


def test_gatode_bf16_remat_changes_nothing(port_gatode_bf16):
    """The recomputed forward repeats the same bf16 operations: equal log-probs
    and loss; the gradients sum the same terms in the same order."""
    for mode in GAT_MODES:
        lp0, loss0, g0 = port_gatode_bf16[mode, False]
        lp1, loss1, g1 = port_gatode_bf16[mode, True]
        np.testing.assert_array_equal(lp0, lp1)
        assert loss0 == loss1
        for k in g0:
            np.testing.assert_array_equal(g0[k], g1[k], err_msg=f"{mode} {k}")


def test_group_none_is_the_default_group(twins):
    """``group=None`` at one part, given or not, is the same call, bit for
    bit, in both modes and both dtypes."""
    td, _ = twins
    pg = partition_by_receiver(td.graph, 1)
    for dtype in (torch.float32, BF):
        ss, sd, wh = (torch.from_numpy(a).to(dtype) for a in _gat_inputs(td.graph, 2, 4, seed=32))
        model = _init("gat", dtype)
        x = torch.from_numpy(np.random.default_rng(33).standard_normal(
            (pg.block_size, 20)).astype(np.float32)).to(dtype)
        with torch.no_grad():
            for mode in GAT_MODES:
                assert torch.equal(gat_sharded(pg, ss, sd, wh, mode=mode, group=None),
                                   gat_sharded(pg, ss, sd, wh, mode=mode))
                assert torch.equal(
                    sharded_gat.gatode_forward(model, pg, x, steps=1, mode=mode, group=None),
                    sharded_gat.gatode_forward(model, pg, x, steps=1, mode=mode))


# ------------------------------------------------ the segment ops' keyword


@pytest.mark.parametrize("op", ["segment_sum", "segment_mean", "segment_max", "segment_softmax"])
def test_segment_ops_take_jax_sorted_ids_keyword(op):
    """A call written to JAX's signature runs: ``sorted_ids=False`` (what JAX's
    own callers pass) gives the same result as without it, and both equal
    JAX's on ids that are not sorted."""
    rng = np.random.default_rng(40)
    data = rng.standard_normal((50, 3)).astype(np.float32)
    ids = rng.integers(0, 7, 50)
    td, ti = torch.from_numpy(data), torch.from_numpy(ids)
    fn = getattr(segment, op)
    got = fn(td, ti, 8, sorted_ids=False)
    assert torch.equal(got, fn(td, ti, 8)) and torch.equal(got, fn(td, ti, 8, sorted_ids=True))
    want = np.asarray(getattr(jsegment, op)(jnp.asarray(data), jnp.asarray(ids), 8,
                                            sorted_ids=False))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_segment_sum_of_bf16_rows_is_an_f32_sum_rounded_once():
    """bf16 (and f16) rows add in f32 and each sum is rounded once, on any
    device (the card's atomics would add them in bf16); 5,000 ones give
    bf16's 4,992, and the gradient comes back in the rows' dtype."""
    rng = np.random.default_rng(41)
    ids = torch.from_numpy(np.concatenate([np.zeros(5000), rng.integers(0, 9, 500)]).astype(np.int64))
    for dtype in (BF, torch.float16):
        rows = torch.from_numpy(rng.standard_normal((5500, 3)).astype(np.float32)).to(dtype)
        got = segment.segment_sum(rows, ids, 9)
        want = torch.zeros(9, 3).index_add_(0, ids, rows.float()).to(dtype)
        assert got.dtype == dtype and torch.equal(got, want)
    ones = torch.ones((5000, 1), dtype=BF, requires_grad=True)
    total = segment.segment_sum(ones, ids[:5000], 1)
    assert float(total) == 4992.0
    total.float().sum().backward()
    assert ones.grad.dtype == BF and torch.equal(ones.grad, torch.ones_like(ones))
