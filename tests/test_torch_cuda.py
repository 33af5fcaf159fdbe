"""The CUDA kernels (CSR SpMM, weighted SpMM, the bucket mode and its weighted
form, GAT forward, α/dlogit backward, recompute-α dWh) against their plain
PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one.  On the card
(which has no JAX, so the repo's conftest cannot load):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

The reference is the plain version run in float64 on the same f32 weights
and features, so that what is compared is the kernel's own rounding: the
plain version in float32 adds a hub row's terms one by one in atomic order,
and its error alone can exceed the tolerance.  Tolerance rtol = atol = 1e-5.
"""

import numpy as np
import pytest
import torch

from graph_odenet_tpu_torch.graph import from_edges
from graph_odenet_tpu_torch.ops import csr_spmm
from graph_odenet_tpu_torch.ops.csr_spmm import SEG_EDGES, prepare, spmm_csr, spmm_csr_reference

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _random_graph(rng):
    a = rng.random((300, 300)) < 0.03
    s, r = np.nonzero(a)
    return from_edges(s, r, n_node=300, normalize="row")


def _hub_graph(rng):
    n = 200
    s = np.concatenate([rng.integers(0, n, 1500), rng.integers(0, n, 300)])
    r = np.concatenate([np.zeros(1500, np.int64), rng.integers(0, n, 300)])
    return from_edges(s, r, n_node=n, normalize="row")


def _split_hub_graph(rng):
    # Node 0 has 2,000 distinct neighbours: its row spans several warp segments.
    s = rng.permutation(3000)[:2000]
    return from_edges(s, np.zeros_like(s), n_node=3000, normalize="row")


def _edgeless_blocks_graph(rng):
    s = rng.integers(0, 512, 300)
    r = rng.integers(0, 100, 300)
    return from_edges(s, r, n_node=512, normalize=None, add_self_loops=False, symmetrize=False)


GRAPHS = {
    "random": _random_graph, "hub": _hub_graph, "split_hub": _split_hub_graph,
    "edgeless": _edgeless_blocks_graph,
}


def _check(g, f, device, seed):
    rng = np.random.default_rng(seed)
    csr = prepare(g).to(device)
    x0 = torch.from_numpy(rng.standard_normal((g.n_node_pad, f)).astype(np.float32)).to(device)
    up = torch.from_numpy(rng.standard_normal((g.n_node_pad, f)).astype(np.float32)).to(device)
    x = x0.clone().requires_grad_(True)
    before = csr_spmm.launches
    out = spmm_csr(csr, x)
    (dx,) = torch.autograd.grad(out, x, up)
    torch.cuda.synchronize()
    assert csr_spmm.launches == before + 2
    xr = x0.double().requires_grad_(True)
    ref = spmm_csr_reference(csr, xr)
    (dxr,) = torch.autograd.grad(ref, xr, up.double())
    torch.testing.assert_close(out, ref.float(), **TOL)
    torch.testing.assert_close(dx, dxr.float(), **TOL)
    return out


@pytest.mark.parametrize("f", [1, 3, 16, 33, 128])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_kernel_matches_plain(cuda, name, f):
    g = GRAPHS[name](np.random.default_rng(0))
    out = _check(g, f, cuda, seed=f)
    if name == "edgeless":
        assert torch.all(out[128:] == 0)
    if name == "split_hub":
        assert int(g.n_edge) > SEG_EDGES and prepare(g).part.n_slots > 1


def test_wrapper_raises_on_cuda(cuda):
    g = _random_graph(np.random.default_rng(0))
    csr = prepare(g).to(cuda)
    with pytest.raises(TypeError):
        spmm_csr(csr, torch.zeros((g.n_node_pad, 4), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        spmm_csr(csr, torch.zeros((4, g.n_node_pad), device=cuda).t())


# ---------------------------------------------------------------- GAT kernels


def _att_inputs(g, heads, feat, device, seed):
    from graph_odenet_tpu_torch.ops.sddmm import edge_scores

    rng = np.random.default_rng(seed)
    csr = prepare(g).to(device)
    n = g.n_node_pad

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(device)

    s_src, s_dst = randn(n, heads, scale=1.5), randn(n, heads, scale=1.5)
    return csr, s_src, s_dst, edge_scores(csr, s_src, s_dst), randn(n, heads, feat), randn(n, heads, feat)


ATT_SHAPES = [(8, 8), (1, 64), (1, 6), (1, 128), (2, 96), (3, 5)]


@pytest.mark.parametrize("mode", ["none", "hash", "mask"])
@pytest.mark.parametrize("heads,feat", ATT_SHAPES)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_gat_kernels_match_plain(cuda, name, heads, feat, mode):
    from graph_odenet_tpu_torch.ops import gat_attn
    from graph_odenet_tpu_torch.ops.dropmask import attention_dropout_scale

    g = GRAPHS[name](np.random.default_rng(0))
    csr, s_src, s_dst, logits, wh, up = _att_inputs(g, heads, feat, cuda, seed=heads * feat)
    drop = (77, 0.6) if mode == "hash" else None
    dmask = (attention_dropout_scale(77, csr.senders, csr.receivers, heads, 0.6)
             if mode == "mask" else None)
    before = dict(gat_attn.launches)
    out, m, l = gat_attn.gat_fwd(csr, logits, wh, dmask=dmask, drop=drop)
    beta = (up * out).sum(-1)
    dlog, alpha_d = gat_attn.gat_bwd(csr, logits, wh, up, m, l, beta, dmask=dmask, drop=drop,
                                     emit_alpha=True)
    torch.cuda.synchronize()
    d = lambda t: None if t is None else t.double()  # noqa: E731
    ref = gat_attn.gat_fwd_plain(csr, d(logits), d(wh), dmask=d(dmask), drop=drop)
    for got, want in zip((out, m, l), ref):
        torch.testing.assert_close(got, want.float(), **TOL)
    dlog_r, alpha_r = gat_attn.gat_bwd_plain(
        csr, d(logits), d(wh), d(up), d(m), d(l), d(beta), dmask=d(dmask), drop=drop,
        emit_alpha=True)
    torch.testing.assert_close(dlog, dlog_r.float(), **TOL)
    torch.testing.assert_close(alpha_d, alpha_r.float(), **TOL)
    if mode != "mask":
        dwh = gat_attn.gat_dwh(csr, s_src, s_dst, m, l, up, 0.2, drop=drop)
        torch.testing.assert_close(dwh, gat_attn.gat_dwh_plain(
            csr, d(s_src), d(s_dst), d(m), d(l), d(up), 0.2, drop=drop).float(), **TOL)
    x = up.view(g.n_node_pad, heads * feat)
    a_csc = alpha_d.index_select(0, csr.t_perm)
    before_w = csr_spmm.weighted_launches
    got = csr_spmm.csr_reduce(csr, x, transpose=True, alpha=a_csc, feat=feat)
    torch.testing.assert_close(got, csr_spmm._reduce_plain(
        csr.t_row_ptr, csr.t_receivers, None, x.double(), a_csc.double(), feat).float(), **TOL)
    assert csr_spmm.weighted_launches == before_w + 1
    assert gat_attn.launches["gat_fwd"] == before["gat_fwd"] + 1
    assert gat_attn.launches["gat_bwd"] == before["gat_bwd"] + 1
    if name == "edgeless":
        assert torch.all(out[128:] == 0) and torch.all(l[128:] == 0)


@pytest.mark.parametrize("mode", ["hint", "hint_hash", "mask"])
def test_gat_functions_match_reference(cuda, mode):
    from graph_odenet_tpu_torch.ops import gat_attn
    from graph_odenet_tpu_torch.ops.dropmask import attention_dropout_scale
    from graph_odenet_tpu_torch.ops.sddmm import attention_aggregate, edge_scores

    g = _split_hub_graph(np.random.default_rng(1))
    csr, s_src, s_dst, _, wh, _ = _att_inputs(g, 8, 8, cuda, seed=3)
    dmask = (attention_dropout_scale(5, csr.senders, csr.receivers, 8, 0.6)
             if mode == "mask" else None)
    seed = 5 if mode == "hint_hash" else None

    def run(dtype, kernel):
        a, b, w = (t.to(dtype).requires_grad_(True) for t in (s_src, s_dst, wh))
        lg = edge_scores(csr, a, b)
        if kernel:
            out = attention_aggregate(csr, lg, w, dropout_seed=seed, dropout_rate=0.6,
                                      dmask=dmask, scores=None if mode == "mask" else (a, b))
        else:
            out = gat_attn.gat_aggregate_reference(
                csr, lg, w, dmask=None if dmask is None else dmask.double(),
                drop=None if seed is None else (seed, 0.6))
        return (out, *torch.autograd.grad(torch.sin(out).sum(), (a, b, w)))

    for got, want in zip(run(torch.float32, True), run(torch.float64, False)):
        torch.testing.assert_close(got.detach(), want.detach().float(), **TOL)


def test_gat_wrappers_raise_on_cuda(cuda):
    from graph_odenet_tpu_torch.ops import gat_attn

    g = _random_graph(np.random.default_rng(0))
    csr, _, _, logits, wh, _ = _att_inputs(g, 2, 4, cuda, seed=0)
    with pytest.raises(TypeError):
        gat_attn.gat_fwd(csr, logits.double(), wh)
    with pytest.raises(ValueError):
        gat_attn.gat_fwd(csr, logits, wh.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError):
        gat_attn.gat_fwd(csr, logits.cpu(), wh)


# ------------------------------------------------------- B2: the bucket mode


def _bucket_view(rng):
    """A 300 × 500 block: row 0 is a hub of 2,000 edges (split into warp
    segments), rows 1–4 and 200–299 have no edge.  Weights are positive and
    add up to 1 in each row, as in a row-normalised adjacency, so that no
    row's sum cancels to a value that f32 rounding of 2,000 terms cannot hold
    to 1e-5."""
    from graph_odenet_tpu_torch.ops.csr_spmm import csr_view

    n_rows, n_cols = 300, 500
    rows = np.sort(np.concatenate([np.zeros(2000, np.int64), rng.integers(5, 200, 1500)]))
    cols = rng.integers(0, n_cols, rows.shape[0])
    w = rng.random(rows.shape[0]) + 0.5
    w /= np.bincount(rows, weights=w, minlength=n_rows)[rows]
    return csr_view(rows, cols, w.astype(np.float32), n_rows, n_cols)


@pytest.mark.parametrize("accumulate", [True, False])
@pytest.mark.parametrize("positional", [False, True])
@pytest.mark.parametrize("f", [1, 3, 16, 40, 256])
def test_bucket_kernel_matches_plain(cuda, f, positional, accumulate):
    """``out += A x`` into a nonzero ``out``, or ``out = A x`` into an
    ``out`` of NaNs, against the plain version in float64 on the same
    inputs; a hub row split into segments, empty rows (left as they were,
    or zeroed)."""
    view = _bucket_view(np.random.default_rng(f)).to(cuda)
    assert view.part.n_slots > 1  # the hub row spans several segments
    rng = np.random.default_rng(100 + f)
    n_table = view.n_edge + 7 if positional else view.n_cols
    x = rng.standard_normal((n_table, f))
    if positional:  # messages: rows of x scaled by their edge's weight, as the caller makes them
        x[: view.n_edge] *= view.weight.cpu().numpy()[:, None]
    x = torch.from_numpy(x.astype(np.float32)).to(cuda)
    out0 = torch.from_numpy(rng.standard_normal((view.n_rows, f)).astype(np.float32)).to(cuda)
    if not accumulate:
        out0.fill_(float("nan"))
    before = csr_spmm.bucket_launches
    got = csr_spmm.bucket_reduce(view, x, out0.clone(), positional=positional,
                                 accumulate=accumulate)
    torch.cuda.synchronize()
    assert csr_spmm.bucket_launches == before + 1
    want = csr_spmm._bucket_reduce_plain(view, x.double(), out0.double(), positional, accumulate)
    torch.testing.assert_close(got, want.float(), **TOL)
    empty = out0 if accumulate else torch.zeros_like(out0)
    assert torch.equal(got[1:5], empty[1:5]) and torch.equal(got[200:], empty[200:])


def test_bucket_kernel_empty_bucket(cuda):
    from graph_odenet_tpu_torch.ops.csr_spmm import csr_view

    view = csr_view(np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0), 64, 64).to(cuda)
    out0 = torch.randn(64, 8, device=cuda)
    x = torch.randn(64, 8, device=cuda)
    before = csr_spmm.bucket_launches
    got = csr_spmm.bucket_reduce(view, x, out0.clone())
    assert torch.equal(got, out0) and csr_spmm.bucket_launches == before  # nothing to add
    got = csr_spmm.bucket_reduce(view, x, torch.full_like(out0, float("nan")), accumulate=False)
    assert torch.equal(got, torch.zeros_like(out0)) and csr_spmm.bucket_launches == before + 1


def test_bucket_functions_and_one_part_spmm_sharded(cuda):
    """``_bucket_spmm``, ``bucket_reduce_pallas`` and one-part ``spmm_sharded``
    through the kernel: values and ``d sum(sin(·))`` against the same
    functions on the CPU (the plain version; the wrappers take float32, and
    the split hub row's weights are 1/2,000, so the sums stay small)."""
    from graph_odenet_tpu_torch.parallel import padded_buckets, partition_by_receiver, spmm_sharded
    from graph_odenet_tpu_torch.parallel.halo import _bucket_spmm, bucket_reduce_pallas

    g = _split_hub_graph(np.random.default_rng(2))
    rng = np.random.default_rng(3)
    pg2, pg1 = partition_by_receiver(g, 2), partition_by_receiver(g, 1)
    cases = {
        "_bucket_spmm": (lambda x, pg: _bucket_spmm(x, pg.bucket(0, 1)), pg2, pg2.block_size),
        "bucket_reduce_pallas": (lambda x, pg: bucket_reduce_pallas(x, pg.bucket(0, 0)), pg2,
                                 padded_buckets(pg2).e_bucket),
        "spmm_sharded": (lambda x, pg: spmm_sharded(pg, x), pg1, g.n_node_pad),
    }
    for name, (fn, pg, rows) in cases.items():
        # bucket_reduce_pallas sums unweighted messages: scaled so that the hub
        # row's sum stays near 1 and the sin probe does not amplify rounding.
        scale = 0.01 if name == "bucket_reduce_pallas" else 1.0
        x0 = torch.from_numpy((rng.standard_normal((rows, 24)) * scale).astype(np.float32))
        results = []
        for dev in (cuda, torch.device("cpu")):
            x = x0.to(dev).requires_grad_(True)
            before = csr_spmm.bucket_launches
            out = fn(x, pg.to(dev))
            (dx,) = torch.autograd.grad(torch.sin(out).sum(), x)
            launched = csr_spmm.bucket_launches - before
            assert launched == (2 if dev.type == "cuda" and name != "bucket_reduce_pallas"
                                else 1 if dev.type == "cuda" else 0), (name, launched)
            results.append((out.detach().cpu(), dx.cpu()))
        for got, want in zip(*results):
            torch.testing.assert_close(got, want, **TOL, msg=name)


def test_config4_step_is_a_function_of_its_inputs(cuda):
    """One training step of config 4 on the arxiv twin (dropout 0), as
    ``chip_smoke.py`` checks it.  Through the kernel the gradients are
    bit-equal from run to run.  Through the plain version they are not:
    ``index_add_`` adds with atomics in the order the card schedules them,
    and where an encoder pre-activation cancels to a rounding residue
    (``b_in`` starts at 0) its sign, and with it the ReLU's slope, changes
    with the order.  With the sums in a fixed order the plain step repeats
    too and agrees with the kernel at rtol 1e-4 (atol relative to each
    gradient's largest entry).  ``-s`` prints how many of 24 atomic-order
    runs flip a ReLU against the kernel's, and where."""
    from graph_odenet_tpu_torch.configs import get_config
    from graph_odenet_tpu_torch.data import synthetic_ogbn_arxiv
    from graph_odenet_tpu_torch.parallel import partition_by_receiver, sharded_gcn, spmm_sharded

    data = synthetic_ogbn_arxiv(seed=0)
    _, cfg = get_config(4)
    pg = partition_by_receiver(data.graph, 1).to(cuda)
    csr = prepare(data.graph).to(cuda)
    model = sharded_gcn.init_params(data.features.shape[1], cfg.hidden, data.n_class,
                                    generator=torch.Generator().manual_seed(0)).to(cuda)
    x = data.features.to(cuda)
    y1h = torch.nn.functional.one_hot(data.labels.to(cuda).clamp(min=0), data.n_class).float()
    w = torch.zeros(data.graph.n_node_pad, device=cuda)
    w[data.idx_train.to(cuda)] = 1.0

    def step(agg):
        """(encoder pre-activation, parameter gradients) of one step."""
        seen = []

        def recording(h):
            seen.append(agg(h))
            return seen[-1]

        model.zero_grad(set_to_none=True)
        lp = sharded_gcn.forward_with(model, recording, x, steps=cfg.steps, t1=cfg.t1)
        (-(lp * y1h).sum(-1).mul(w).sum() / w.sum()).backward()
        z = (seen[0] + model.b_in).detach()
        return z, {k: p.grad.clone() for k, p in model.named_parameters()}

    def kernel(h):
        return spmm_sharded(pg, h, mode=cfg.mode)

    def plain(h):
        return spmm_csr_reference(csr, h)

    def plain_fixed_order(h):
        torch.use_deterministic_algorithms(True)
        try:
            return spmm_csr_reference(csr, h)
        finally:
            torch.use_deterministic_algorithms(False)

    z_k, g_k = step(kernel)
    for _ in range(3):
        z, g = step(kernel)
        assert torch.equal(z, z_k) and all(torch.equal(g[k], g_k[k]) for k in g_k)
    z_f, g_f = step(plain_fixed_order)
    for _ in range(3):
        assert torch.equal(step(plain_fixed_order)[0], z_f)
    assert torch.equal(z_f > 0, z_k > 0)
    for k, want in g_f.items():
        torch.testing.assert_close(g_k[k], want, rtol=1e-4, atol=1e-4 * float(want.abs().max()),
                                   msg=lambda m, k=k: f"{k}\n{m}")

    flipped, worst = [], 0.0
    for _ in range(24):
        z, g = step(plain)
        flips = ((z > 0) != (z_k > 0)).nonzero().tolist()
        if flips:
            flipped.append([(r, c, float(z_k[r, c]), float(z[r, c])) for r, c in flips])
            worst = max(worst, max(
                float(((g_k[k] - g[k]).abs() / (1e-4 * g[k].abs().max() + 1e-4 * g[k].abs())).max())
                for k in g))
    print(f"\n{len(flipped)} of 24 plain steps in atomic order flip a ReLU against the kernel's; "
          f"worst gradient error {worst} of the tolerance; (node, lane, z kernel, z plain): {flipped}")


# ------------------------------------------ B2-w: the weighted bucket mode


def _softmax_weights(view, heads, rng, device):
    """Positive ``[L, H]`` numerators that add up to 1 in each row, as a
    softmax's: the hub row's sum of 2,000 terms does not cancel."""
    rows = csr_spmm.row_ids(view.row_ptr, view.n_edge).cpu().numpy()
    u = rng.random((view.n_edge, heads)) + 0.5
    total = np.zeros((view.n_rows, heads))
    np.add.at(total, rows, u)
    return torch.from_numpy((u / total[rows]).astype(np.float32)).to(device)


@pytest.mark.parametrize("accumulate", [True, False])
@pytest.mark.parametrize("heads,feat", [(4, 64), (1, 256), (1, 40), (2, 3), (8, 8), (3, 5)])
def test_bucket_weighted_kernel_matches_plain(cuda, heads, feat, accumulate):
    """``out (+)= A(alpha) x`` on a block with a split hub row and empty rows,
    into a nonzero ``out`` or into NaNs, against the plain version in
    float64 on the same inputs."""
    view = _bucket_view(np.random.default_rng(heads * feat)).to(cuda)
    assert view.part.n_slots > 1
    rng = np.random.default_rng(200 + heads * feat)
    f = heads * feat
    x = torch.from_numpy(rng.standard_normal((view.n_cols, f)).astype(np.float32)).to(cuda)
    alpha = _softmax_weights(view, heads, rng, cuda)
    out0 = torch.from_numpy(rng.standard_normal((view.n_rows, f)).astype(np.float32)).to(cuda)
    if not accumulate:
        out0.fill_(float("nan"))
    before = csr_spmm.bucket_weighted_launches, csr_spmm.bucket_launches
    got = csr_spmm.bucket_reduce(view, x, out0.clone(), accumulate=accumulate, alpha=alpha,
                                 feat=feat)
    torch.cuda.synchronize()
    assert (csr_spmm.bucket_weighted_launches, csr_spmm.bucket_launches) == (
        before[0] + 1, before[1])
    want = csr_spmm._bucket_reduce_plain(view, x.double(), out0.double(), False, accumulate,
                                         alpha.double(), feat)
    torch.testing.assert_close(got, want.float(), **TOL)
    empty = out0 if accumulate else torch.zeros_like(out0)
    assert torch.equal(got[1:5], empty[1:5]) and torch.equal(got[200:], empty[200:])


def test_bucket_weighted_kernel_empty_bucket_and_bad_input(cuda):
    from graph_odenet_tpu_torch.ops.csr_spmm import csr_view

    view = csr_view(np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0), 64, 64).to(cuda)
    out0, x = torch.randn(64, 8, device=cuda), torch.randn(64, 8, device=cuda)
    alpha = torch.zeros(0, 2, device=cuda)
    before = csr_spmm.bucket_weighted_launches
    got = csr_spmm.bucket_reduce(view, x, out0.clone(), alpha=alpha, feat=4)
    assert torch.equal(got, out0) and csr_spmm.bucket_weighted_launches == before
    got = csr_spmm.bucket_reduce(view, x, torch.full_like(out0, float("nan")), accumulate=False,
                                 alpha=alpha, feat=4)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.zeros_like(out0))
    assert csr_spmm.bucket_weighted_launches == before + 1
    hub = _bucket_view(np.random.default_rng(0)).to(cuda)
    xh, oh = torch.randn(hub.n_cols, 8, device=cuda), torch.randn(hub.n_rows, 8, device=cuda)
    ah = torch.rand(hub.n_edge, 2, device=cuda)
    for kw, err in ((dict(alpha=ah.double(), feat=4), TypeError),
                    (dict(alpha=ah.cpu(), feat=4), ValueError),
                    (dict(alpha=ah, feat=3), ValueError),
                    (dict(alpha=ah, feat=4, positional=True), ValueError)):
        with pytest.raises(err):
            csr_spmm.bucket_reduce(hub, xh, oh, **kw)


@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_gat_sharded_kernel_path_matches_plain_path(cuda, rate):
    """One-part ``gat_sharded`` in ``ring_pallas`` mode through the kernel
    (two B2-w launches: forward, and ``dchunk`` in the backward) against the
    same function on the CPU (the plain version) and against ``mode="ring"``
    on the card (no kernel): values and the gradients of ``sum(sin(out))``."""
    from graph_odenet_tpu_torch.parallel import gat_sharded, partition_by_receiver

    g = _split_hub_graph(np.random.default_rng(5))
    rng = np.random.default_rng(6)
    n, heads, feat = g.n_node_pad, 4, 16
    inputs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in ((n, heads), (n, heads), (n, heads, feat))]
    kw = dict(attn_rate=rate, attn_seed=7) if rate else {}
    results = {}
    for name, dev, mode in (("kernel", cuda, "ring_pallas"), ("plain", torch.device("cpu"), "ring_pallas"),
                            ("ring", cuda, "ring")):
        pg = partition_by_receiver(g, 1).to(dev)
        ts = [t.to(dev).requires_grad_(True) for t in inputs]
        before = csr_spmm.bucket_weighted_launches
        out = gat_sharded(pg, *ts, mode=mode, **kw)
        grads = torch.autograd.grad(torch.sin(out).sum(), ts)
        assert csr_spmm.bucket_weighted_launches - before == (2 if name == "kernel" else 0), name
        results[name] = [out.detach().cpu()] + [t.cpu() for t in grads]
    for other in ("plain", "ring"):
        for got, want in zip(results["kernel"], results[other]):
            torch.testing.assert_close(got, want, **TOL, msg=other)


# ------------------------------------------- the ring over NCCL, across cards


def test_config4_across_cards_over_nccl(cuda, tmp_path):
    """One rank per card (at most 8): every ``spmm_sharded`` mode holds the
    one-part kernel at rtol = atol = 1e-5, and config 4's trainer over all
    ranks (dropout 0.5, whose mask does not depend on the partitioning)
    tracks the same trainer on one card: losses to rtol 1e-4, accuracies to
    2e-3.  Skips with fewer than two cards."""
    from graph_odenet_tpu_torch.data import synthetic_ogbn_arxiv
    from graph_odenet_tpu_torch.parallel import ShardedTrainConfig, fit_sharded_node_classifier

    from torch_dist_worlds import run_world

    n_cards = min(torch.cuda.device_count(), 8)
    if n_cards < 2:
        pytest.skip("needs two or more CUDA cards")
    cfg = dict(hidden=256, epochs=5, eval_every=1, dropout=0.5)
    ranks = [r["config4_world"] for r in run_world(
        n_cards, tmp_path, {"config4_world": dict(scale=1.0, f=256, cfg=cfg, device="cuda")},
        backend="nccl", timeout=600)]
    one = fit_sharded_node_classifier(ShardedTrainConfig(**cfg), synthetic_ogbn_arxiv(seed=0),
                                      device=cuda)
    print({"cards": n_cards, "one_card": {k: v for k, v in one.items() if k != "params"},
           "ranks": ranks})
    for r in ranks:
        assert max(r["err_over_tol"].values()) <= 1.0, r["err_over_tol"]
        assert r["n_parts"] == n_cards and r["launches"] >= 36 * cfg["epochs"]
        for k in ("loss_first", "loss_final", "val_loss"):
            np.testing.assert_allclose(r[k], one[k], rtol=1e-4, err_msg=k)
        for k in ("val_acc", "test_acc"):
            np.testing.assert_allclose(r[k], one[k], atol=2e-3, err_msg=k)


def test_sharded_gat_across_cards_over_nccl(cuda, tmp_path):
    """One rank per card (at most 8): ``gat_sharded`` in both modes with
    attention dropout holds one part on one card (values at rtol = atol =
    1e-5; gradients at rtol 1e-4 with atol 1e-4 of the largest entry, a hub
    sender's gradient being a sum over some 1e5 edges), and the GAT-ODE
    trainer over all ranks under ``remat`` tracks the same trainer on one
    card: losses to rtol 1e-4, accuracies to 2e-3.  Skips with fewer than
    two cards."""
    from graph_odenet_tpu_torch.data import synthetic_ogbn_arxiv
    from graph_odenet_tpu_torch.parallel import ShardedTrainConfig, fit_sharded_node_classifier

    from torch_dist_worlds import run_world

    n_cards = min(torch.cuda.device_count(), 8)
    if n_cards < 2:
        pytest.skip("needs two or more CUDA cards")
    cfg = dict(model="gatode", hidden=64, heads=4, epochs=3, eval_every=1, dropout=0.6,
               mode="ring_pallas", remat=True)
    ranks = [r["gat_world"] for r in run_world(
        n_cards, tmp_path, {"gat_world": dict(scale=1.0, heads=4, feat=64, cfg=cfg, device="cuda")},
        backend="nccl", timeout=900)]
    one = fit_sharded_node_classifier(
        ShardedTrainConfig(**cfg), synthetic_ogbn_arxiv(seed=0, calibrated=True), device=cuda)
    print({"cards": n_cards, "one_card": {k: v for k, v in one.items() if k != "params"},
           "ranks": ranks})
    for r in ranks:
        assert max(r["err_over_tol"].values()) <= 1.0, r["err_over_tol"]
        assert r["n_parts"] == n_cards and r["launches"] > 0
        for k in ("loss_first", "loss_final", "val_loss"):
            np.testing.assert_allclose(r[k], one[k], rtol=1e-4, err_msg=k)
        for k in ("val_acc", "test_acc"):
            np.testing.assert_allclose(r[k], one[k], atol=2e-3, err_msg=k)
