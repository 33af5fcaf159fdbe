"""The CUDA kernels (CSR SpMM, weighted SpMM, the bucket mode and its weighted
form, GAT forward, α/dlogit backward, recompute-α dWh) against their plain
PyTorch versions, on the card; config 3's batched adaptive solver on the
card (no kernel of its own: one batched solve against one solve per window
and against the CPU, and no host read inside an attempt), and the same of
the batched VCABM on adams_scan (one host read an attempt round); and the adjoints'
one-step check through the kernels (``chip_smoke.adjoint_step_check``), the
same check of the Adams family, config 4's bit-equal resume,
``validate_tiling`` inside ``prepare`` of a card graph, and one step of each
sharded model built in bf16 (``chip_smoke.sharded_step_check``).

Every test here needs a CUDA card and skips without one.  On the card
(which has no JAX, so the repo's conftest cannot load):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

The reference is the plain version run in float64 on the same f32 weights
and features, so that what is compared is the kernel's own rounding: the
plain version in float32 adds a hub row's terms one by one in atomic order,
and its error alone can exceed the tolerance.  Tolerance rtol = atol = 1e-5.
Each call of the CSR kernel's wrappers and of ``gat_fwd``, ``gat_bwd`` and
``gat_dwh`` is also held to one device launch, to bit-equal repeats on split
rows, and to bit-equal replays of a captured CUDA graph.  So are the bf16
entries (bf16 features through the CSR and bucket modes, a bf16 Wh through
``gat_fwd`` and ``gat_bwd``), each held to its plain version on the card in
its own dtype: a bf16 output within one bf16 ulp (plus 1e-5 for the order of
the f32 sums), an f32 output of the GAT kernels at rtol = atol = 1e-4.
"""

import time

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


# ---------------------------------- one launch per call, a plan per view
#
# The tests that count launches with the profiler come before those that
# capture CUDA graphs: after a capture the profiler showed no kernel at all.


def _device_kernels(fn):
    """Names of the device kernels that ``fn()`` launches, by ``torch.profiler``:
    the second of two calls, with idle time around it (the profiler can miss
    a kernel of its first round or near the ends of its window), again up to
    three times while it shows none; its step marks and the program's spans
    (``gode.*``, mirrored onto the device's timeline) are not kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                time.sleep(0.02)
                fn()
                torch.cuda.synchronize()
                time.sleep(0.02)
                prof.step()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not e.name.startswith(("ProfilerStep", "gode."))]
        if names:
            return names
    return names


def _split_calls(cuda, f):
    """Calls of every wrapper form on views with split rows (and, in the
    bucket, empty rows): name -> (make the output, fn(output) returning it)."""
    g = _split_hub_graph(np.random.default_rng(7))
    csr = prepare(g).to(cuda)
    view = _bucket_view(np.random.default_rng(8)).to(cuda)
    rng = np.random.default_rng(9)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)

    x, xt, out0 = randn(g.n_node_pad, f), randn(view.n_cols, f), randn(view.n_rows, f)
    heads = 2 if f % 2 == 0 else 1
    alpha = _softmax_weights(view, heads, rng, cuda)
    a_csr = torch.rand(csr.n_edge, heads, device=cuda)
    nothing, empty, copy = (lambda: None), (lambda: torch.empty_like(out0)), out0.clone
    return {
        "csr_fwd": (nothing, lambda _: csr_spmm.csr_reduce(csr, x)),
        "csr_bwd": (nothing, lambda _: csr_spmm.csr_reduce(csr, x, transpose=True)),
        "csr_weighted": (nothing, lambda _: csr_spmm.csr_reduce(csr, x, alpha=a_csr,
                                                                feat=f // heads)),
        "bucket_write": (empty, lambda o: csr_spmm.bucket_reduce(view, xt, o, accumulate=False)),
        "bucket_add": (copy, lambda o: csr_spmm.bucket_reduce(view, xt, o)),
        "bucket_weighted": (empty, lambda o: csr_spmm.bucket_reduce(
            view, xt, o, accumulate=False, alpha=alpha, feat=f // heads)),
    }, (csr, view)


@pytest.mark.parametrize("f", [3, 16, 40, 256])
def test_each_call_is_one_launch_and_repeats_bit_for_bit(cuda, f):
    """Every wrapper form on views with split rows is one device launch (by
    the profiler), 20 back-to-back calls give bit-equal results (the last
    warp of a split row adds its partial rows in slot order, whoever it is),
    and every arrival counter is back at 0 after the calls."""
    calls, (csr, view) = _split_calls(cuda, f)
    assert csr.part.split_row.numel() > 0 and view.part.split_row.numel() > 0
    for name, (make, call) in calls.items():
        first = call(make())  # builds the plan and its counters
        out = make()
        kernels = _device_kernels(lambda: call(out))
        assert len(kernels) == 1 and "csr_reduce_kernel" in kernels[0], (name, kernels)
        outs = [make() for _ in range(20)]
        for got in [call(o) for o in outs]:
            assert torch.equal(got, first), name
    torch.cuda.synchronize()
    for plan in (*csr.plans, view.plan):
        assert plan.arrivals.numel() >= plan.n_split and not plan.arrivals.any()


@pytest.mark.parametrize("heads,feat", ATT_SHAPES)
def test_gat_calls_are_one_launch_and_repeat_bit_for_bit(cuda, heads, feat):
    """On a split hub (split rows in both views), every ``gat_fwd``,
    ``gat_bwd`` and ``gat_dwh`` call (hash dropout, α·D emitted, logits with
    padding rows) is one launch of its own kernel by the profiler, 20 calls
    are bit-equal, the padding rows of dlogits and of dWh are zeros and
    every arrival counter is back at 0."""
    from graph_odenet_tpu_torch.ops import gat_attn

    g = _split_hub_graph(np.random.default_rng(20))
    csr, s_src, s_dst, logits, wh, up = _att_inputs(g, heads, feat, cuda, seed=21)
    assert csr.part.split_row.numel() > 0 and csr.t_part.split_row.numel() > 0
    logits = torch.cat([logits, torch.full((37, heads), 5.0, device=cuda)])
    drop = (9, 0.6)
    out, m, l = gat_attn.gat_fwd(csr, logits, wh, drop=drop)
    beta = (up * out).sum(-1)
    calls = {
        "gat_fwd": lambda: gat_attn.gat_fwd(csr, logits, wh, drop=drop),
        "gat_bwd": lambda: gat_attn.gat_bwd(csr, logits, wh, up, m, l, beta, drop=drop,
                                            emit_alpha=True),
        "gat_dwh": lambda: (gat_attn.gat_dwh(csr, s_src, s_dst, m, l, up, 0.2, drop=drop),),
    }
    firsts = {}
    for name, call in calls.items():
        first = firsts[name] = call()
        kernels = _device_kernels(call)
        assert len(kernels) == 1 and f"{name}_kernel" in kernels[0], (name, kernels)
        for got in [call() for _ in range(20)]:
            for a, b in zip(got, first):
                assert torch.equal(a, b), name
    torch.cuda.synchronize()
    assert not firsts["gat_bwd"][0][csr.n_edge:].any()
    assert not firsts["gat_dwh"][0][g.n_node:].any()
    assert not any(plan.arrivals.any() for plan in csr.plans)


def test_captured_graph_replays_bit_equal_to_eager_calls(cuda):
    """``spmm_csr`` forward and backward, and a ring of ``bucket_reduce`` calls
    (each block's first bucket written, the rest added), captured in a CUDA
    graph: its replays equal the eager calls bit for bit."""
    from graph_odenet_tpu_torch.parallel import partition_by_receiver

    g = _split_hub_graph(np.random.default_rng(10))
    rng = np.random.default_rng(11)
    csr, pg = prepare(g).to(cuda), partition_by_receiver(g, 2).to(cuda)
    n, f, B = g.n_node_pad, 256, pg.block_size
    x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)).to(cuda)
    up = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)).to(cuda)
    xr = x.clone().requires_grad_(True)

    def work():
        y = spmm_csr(csr, xr)
        (dx,) = torch.autograd.grad(y, xr, up)
        ring = torch.empty((n, f), device=cuda)
        for p in range(2):
            for k in range(2):
                b = (p + k) % 2
                csr_spmm.bucket_reduce(pg.bucket(p, b).fwd, x[b * B:(b + 1) * B],
                                       ring[p * B:(p + 1) * B], accumulate=k > 0)
        return y.detach(), dx, ring

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = work()  # builds every plan before the capture
        torch.cuda.synchronize()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = work()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert torch.equal(got, want)
    for got, want in zip(work(), eager):
        assert torch.equal(got, want)


def test_captured_graph_outlives_a_wider_eager_call(cuda):
    """A graph captured at F = 40 (one feature chunk) replays bit-equal after
    an eager call at F = 256 (two chunks) gave the same views new arrival
    counters; every counter is back at 0; a capture that would need new
    counters raises."""
    g = _split_hub_graph(np.random.default_rng(12))
    csr = prepare(g).to(cuda)
    view = _bucket_view(np.random.default_rng(13)).to(cuda)
    rng = np.random.default_rng(14)

    def inputs(f):
        return tuple(torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)).to(cuda)
                     for n in (g.n_node_pad, view.n_cols))

    def work(x, xt):
        out = torch.empty((view.n_rows, x.shape[1]), device=cuda)
        return csr_spmm.csr_reduce(csr, x), csr_spmm.bucket_reduce(view, xt, out, accumulate=False)

    narrow, wide = inputs(40), inputs(256)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = work(*narrow)  # builds the plans before the capture
        torch.cuda.synchronize()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = work(*narrow)
    wide_eager = work(*wide)
    plans = (csr.plans[0], view.plan)
    assert all(len(p.outgrown) == 1 for p in plans)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert torch.equal(got, want)
    for got, want in zip(work(*wide), wide_eager):
        assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert not any(t.any() for p in plans for t in (*p.outgrown, p.arrivals))
    widest = inputs(512)  # four chunks: more counters than the plans hold
    with pytest.raises(RuntimeError, match="eager call"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            work(*widest)


def _gat_fwd_bwd(csr, s_src, s_dst, wh, up):
    """``attention_aggregate`` with the score hint and hash dropout 0.6,
    forward and backward: (out, d logits, d wh), the kernels' outputs.  The
    logits are the leaf: the scores' own gradient goes on through
    ``edge_scores``' backward, whose ``index_add_`` adds with atomics, in no
    fixed order."""
    from graph_odenet_tpu_torch.ops.sddmm import attention_aggregate, edge_scores

    lg = edge_scores(csr, s_src, s_dst).requires_grad_(True)
    w = wh.detach().requires_grad_(True)
    out = attention_aggregate(csr, lg, w, dropout_seed=31, dropout_rate=0.6,
                              scores=(s_src, s_dst))
    return (out.detach(), *torch.autograd.grad(out, (lg, w), up))


def _capture(work, *args):
    """An eager call of ``work`` on a side stream (it builds every plan), then
    a CUDA graph captured around it: (graph, eager results, captured results)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = work(*args)
        torch.cuda.synchronize()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = work(*args)
    return graph, eager, captured


def test_gat_captured_graph_replays_bit_equal_to_eager_calls(cuda):
    """``attention_aggregate`` forward and backward on a split hub (score hint,
    hash dropout 0.6: one launch each of gat_fwd, gat_bwd and gat_dwh, split
    rows in both views) captured in a CUDA graph: its replays equal the
    eager calls bit for bit."""
    g = _split_hub_graph(np.random.default_rng(22))
    csr, s_src, s_dst, _, wh, up = _att_inputs(g, 8, 8, cuda, seed=23)
    graph, eager, captured = _capture(_gat_fwd_bwd, csr, s_src, s_dst, wh, up)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert torch.equal(got, want)
    for got, want in zip(_gat_fwd_bwd(csr, s_src, s_dst, wh, up), eager):
        assert torch.equal(got, want)


def test_gat_captured_graph_outlives_a_wider_eager_call(cuda):
    """A graph captured at H=1/F=64 (one feature chunk of gat_fwd and
    gat_dwh) replays bit-equal after an eager call at H=2/F=96 (two chunks)
    gave both views new arrival counters; every counter is back at 0; a
    capture that would need new counters (H=1/F=512, four chunks) raises."""
    g = _split_hub_graph(np.random.default_rng(24))
    csr = prepare(g).to(cuda)
    rng = np.random.default_rng(25)

    def inputs(heads, feat):
        def randn(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
        n = g.n_node_pad
        return randn(n, heads), randn(n, heads), randn(n, heads, feat), randn(n, heads, feat)

    narrow, wide = inputs(1, 64), inputs(2, 96)
    graph, eager, captured = _capture(_gat_fwd_bwd, csr, *narrow)
    wide_eager = _gat_fwd_bwd(csr, *wide)
    assert all(len(plan.outgrown) == 1 for plan in csr.plans)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert torch.equal(got, want)
    for got, want in zip(_gat_fwd_bwd(csr, *wide), wide_eager):
        assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert not any(t.any() for plan in csr.plans for t in (*plan.outgrown, plan.arrivals))
    widest = inputs(1, 512)
    with pytest.raises(RuntimeError, match="eager call"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            _gat_fwd_bwd(csr, *widest)


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


# ------------------------------------------- config 3: the batched adaptive solver


def _inode_and_windows(device, n_windows=8):
    """A freshly initialised full-width INODE of config 3 in float64 and
    ``n_windows`` windows of its data, on ``device``."""
    import copy

    from graph_odenet_tpu_torch.configs import get_config
    from graph_odenet_tpu_torch.data import SpringSystem, generate_trajectories
    from graph_odenet_tpu_torch.models import INODE
    from graph_odenet_tpu_torch.train.physics import trajectory_windows

    _, cfg = get_config(3)
    system = SpringSystem(n_bodies=cfg.n_bodies)
    trajs = generate_trajectories(system, n_windows, cfg.ode_window,
                                  generator=torch.Generator().manual_seed(0), device=device)
    wins = trajectory_windows(trajs, cfg.ode_window).double()
    model = INODE(effect_dim=cfg.effect_dim, relation_hidden=cfg.relation_hidden,
                  object_hidden=cfg.object_hidden, method=cfg.ode_method, steps=cfg.ode_steps,
                  remat=cfg.ode_remat, rtol=cfg.rtol, atol=cfg.atol,
                  generator=torch.Generator().manual_seed(0)).double().to(device)
    ts = torch.arange(cfg.ode_window + 1, dtype=torch.float64) * system.dt

    def solve(m, batch):
        senders, receivers = system.edges(batch.device)
        return m(batch[:, 0, :, 1:], ts, batch[:, 0, :, :1], senders, receivers)

    return model, wins, solve, copy.deepcopy


def test_batched_inode_equals_one_by_one_and_the_cpu(cuda):
    """Config 3's solver on the card in float64: one batched solve of 8
    windows equals 8 one-window solves (accept and reject counts equal,
    trajectories to 1e-10 of the largest value), and one training step's
    gradient equals the same step on the CPU to 1e-8 (the IN's ``index_add_``
    in a fixed order; cuBLAS rounds alike on one stream)."""
    model, wins, solve, deepcopy = _inode_and_windows(cuda)
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.no_grad():
            together = solve(model, wins)
            counts = [model.stats[k].tolist() for k in ("n_accept", "n_reject")]
            alone, alone_counts = [], [[], []]
            for i in range(wins.shape[0]):
                alone.append(solve(model, wins[i:i + 1]))
                for c, k in zip(alone_counts, ("n_accept", "n_reject")):
                    c.extend(model.stats[k].tolist())
        assert counts == alone_counts
        assert rel(together, torch.cat(alone)) <= 1e-10

        def step(m, batch):
            m.zero_grad(set_to_none=True)
            torch.mean((solve(m, batch) - batch[..., 1:]) ** 2).backward()
            return {k: p.grad.cpu() for k, p in m.named_parameters()}

        card = step(model, wins)
    finally:
        torch.use_deterministic_algorithms(False)
    cpu = step(deepcopy(model).cpu(), wins.cpu())
    errs = {k: rel(card[k], g) for k, g in cpu.items()}
    assert max(errs.values()) <= 1e-8, errs


def test_batched_attempt_reads_nothing_on_the_host(cuda):
    """An attempt of the batched solver keeps its accept decisions on the
    card; the host's one read an attempt is "every sample done?"."""
    from graph_odenet_tpu_torch.data import SpringSystem
    from graph_odenet_tpu_torch.ode import adaptive

    model, wins, _, _ = _inode_and_windows(cuda)
    assert model.remat  # the checkpointed field, as config 3 trains it
    f = model.field(wins[:, 0, :, :1], *SpringSystem(n_bodies=wins.shape[2]).edges(cuda))
    y0 = wins[:, 0, :, 1:].clone().requires_grad_()
    s = adaptive._init_batched(f, y0, torch.zeros((), dtype=y0.dtype, device=cuda),
                               adaptive.DOPRI5, model.rtol, model.atol, None)
    done = s.t >= 0.01
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        adaptive._attempt_batched(f, adaptive.DOPRI5, model.rtol, model.atol, s, done)
        with pytest.raises(RuntimeError, match="synchroniz"):
            bool(done.all())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(s.n_accept.sum() + s.n_reject.sum()) == wins.shape[0]
    s.y.sum().backward()
    assert torch.isfinite(y0.grad).all()


def test_batched_adams_inode_equals_each_window_alone(cuda):
    """Config 3's IN-ODE on the batched VCABM (adams_scan) on the card in
    float64: one batched solve of 8 windows equals each window solved alone
    (every count and the final order equal, trajectories to 1e-10 of the
    largest value), and its training step's gradient is finite.  Alone is a
    batch of copies of the window, so that every kernel rounds its row as in
    the batch: VCABM's order rule at this config turns the 1e-15 by which a
    batch of one rounds otherwise into other steps."""
    model, wins, solve, _ = _inode_and_windows(cuda)
    model.method = "adams_scan"
    keys = ("nfe", "n_accept", "n_reject", "final_order", "success")
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.no_grad():
            together = solve(model, wins)
            counts = {k: model.stats[k].tolist() for k in keys}
            alone, alone_counts = [], {k: [] for k in keys}
            for i in range(wins.shape[0]):
                alone.append(solve(model, wins[i:i + 1].expand_as(wins).contiguous())[0])
                for k in keys:
                    alone_counts[k].append(model.stats[k][0].item())
    finally:
        torch.use_deterministic_algorithms(False)
    assert counts == alone_counts
    assert rel(together, torch.stack(alone)) <= 1e-10
    torch.mean((solve(model, wins) - wins[..., 1:]) ** 2).backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_batched_adams_reads_once_an_attempt_round(cuda):
    """A batched VCABM attempt reads nothing on the host; a forward reads once
    an attempt round, plus the copies of ``ts`` and the γ* constants."""
    import warnings

    from graph_odenet_tpu_torch.data import SpringSystem
    from graph_odenet_tpu_torch.ode import vcabm

    model, wins, solve, _ = _inode_and_windows(cuda)
    model.method = "adams_scan"
    f = model.field(wins[:, 0, :, :1], *SpringSystem(n_bodies=wins.shape[2]).edges(cuda))
    y0 = wins[:, 0, :, 1:]
    t0 = torch.zeros(y0.shape[0], dtype=y0.dtype, device=cuda)
    f0 = f(t0, y0)
    phi = torch.cat([f0[None], f0.new_zeros((13,) + f0.shape)])
    s = vcabm._BatchState(y0, t0.expand(14, -1), t0 + 1e-3, phi, 1)
    gstar = torch.as_tensor(vcabm.gamma_star(14), dtype=y0.dtype, device=cuda)
    target = torch.tensor(0.01, dtype=y0.dtype, device=cuda)
    done = s.prev_t[0] >= target
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        vcabm._attempt_batched(f, model.rtol, model.atol, 12, gstar, target, s, done, 1)
        with pytest.raises(RuntimeError, match="synchroniz"):
            bool(done.all())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(s.n_accept.sum() + s.n_reject.sum()) == wins.shape[0]

    ts = torch.arange(11, dtype=y0.dtype) * 0.01
    edges = SpringSystem(n_bodies=wins.shape[2]).edges(cuda)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught, torch.no_grad():
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            model(y0, ts, wins[:, 0, :, :1], *edges)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("called a synchronizing" in str(w.message) for w in caught)
    assert syncs == model.stats["host_reads"] + 2


@pytest.mark.parametrize("adjoint", [True, "checkpoint"])
@pytest.mark.parametrize("name", ["citeseer-gcnode", "citeseer-gatode-dopri5"])
def test_adjoint_step_through_the_kernels_matches_plain_float64(cuda, name, adjoint):
    """``chip_smoke.py``'s one-step adjoint check on the calibrated Citeseer
    twin: GCN-ODE (B1) and config 2's GAT-ODE (B3-B5, hash attention dropout
    in the encoder), one training step with each adjoint through the kernels
    in float32 against the same adjoint through the plain path in float64
    (``ADJ_RTOL``, ``ADJ_F32``); the adjoint's backward launches the kernels
    and calls no plain version."""
    import chip_smoke

    from graph_odenet_tpu_torch.configs import get_config
    from graph_odenet_tpu_torch.data import synthetic_planetoid

    _, cfg = get_config(name)
    data = synthetic_planetoid("citeseer", seed=cfg.seed, calibrated=True).to(cuda)
    check = chip_smoke.adjoint_step_check(cfg, data, adjoint, cuda)
    assert check["max_err_over_tol"] <= 1.0
    assert check["backward_launches"]["csr" if cfg.model == "gcnode" else "gat_dwh"] > 0


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


def test_feature_tp_across_cards_over_nccl(cuda, tmp_path):
    """Feature-axis tensor parallelism across four cards over NCCL: a (edge,
    feat) = (2, 2) mesh (``make_mesh``; the halo exchange on each edge
    group, the width check on each feature group) on the full arxiv twin at
    F = 256, ``spmm_sharded`` in ``ring`` and ``allgather`` against the
    one-part ``spmm_csr`` on the same card (values and ``d sum(sin(·))/dx``,
    rtol = atol = 1e-5), through B2.  Skips with fewer than four cards."""
    from torch_dist_worlds import run_world

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    ranks = [r["feature_tp_world"] for r in run_world(
        4, tmp_path, {"feature_tp_world": dict(scale=1.0, f=256, device="cuda")},
        backend="nccl", timeout=600)]
    print({"ranks": ranks})
    assert sorted(r["coords"] for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        assert max(r["err_over_tol"].values()) <= 1.0, r["err_over_tol"]
        assert r["launches"] > 0


# ----------------------------------------- the Adams family, resume, sanitizers


@pytest.mark.parametrize("name,method", [
    ("citeseer-gcnode", "adams"), ("citeseer-gcnode", "adams_scan"),
    ("citeseer-gcnode", "implicit_adams"), ("citeseer-gatode-dopri5", "adams_scan"),
])
def test_adams_step_through_the_kernels_matches_plain_float64(cuda, name, method):
    """``chip_smoke.py``'s one-step solver check on the calibrated Citeseer
    twin: GCN-ODE (B1) and GAT-ODE (B3-B5) on the Adams family through the
    kernels in float32 against the plain path in float64 (``SOLVER_RTOL``);
    the backward launches the kernels and calls no plain version; and the
    solver takes the steps (and, for VCABM, ends at the order) that the same
    model takes on the CPU in float64."""
    import copy
    import dataclasses

    import chip_smoke

    from graph_odenet_tpu_torch.configs import get_config
    from graph_odenet_tpu_torch.data import synthetic_planetoid
    from graph_odenet_tpu_torch.train import build_model

    _, cfg = get_config(name)
    cfg = dataclasses.replace(cfg, method=method, steps=chip_smoke.VCABM_STEPS
                              if method.startswith("adams") else cfg.steps)
    data = synthetic_planetoid("citeseer", seed=cfg.seed, calibrated=True)
    check = chip_smoke.adjoint_step_check(cfg, data.to(cuda), False, cuda,
                                          rtol=chip_smoke.SOLVER_RTOL)
    assert check["max_err_over_tol"] <= 1.0
    model = build_model(cfg, data.n_class, data.features.shape[1],
                        generator=torch.Generator().manual_seed(0))
    model.dropout = 0.0
    cpu = copy.deepcopy(model).double()
    with torch.no_grad():
        cpu(data.graph, data.features.double(), **(  # the check's attention dropout
            dict(deterministic=False, seed_generator=torch.Generator().manual_seed(0))
            if cfg.model == "gatode" else {}))
    want = {k: v for k, v in cpu.odeblock.stats.items() if k != "t_reached"}
    assert {k: v for k, v in check["forward_stats"].items() if k != "t_reached"} == want


def test_config4_resume_is_bit_equal_on_the_card(cuda):
    """``chip_smoke.py``'s resume of config 4 at a tenth of the arxiv twin
    (hidden 256, dropout 0.5, B2): 3 epochs straight against 2, a stop and a
    fresh call to 3, the losses bit for bit."""
    import chip_smoke

    from graph_odenet_tpu_torch.configs import get_config, sharded_train_config
    from graph_odenet_tpu_torch.data import synthetic_ogbn_arxiv

    run = chip_smoke._resume_run(sharded_train_config(get_config(4)[1]),
                                 synthetic_ogbn_arxiv(seed=0, scale=0.1), cuda, 2, 3)
    assert run["first"] + run["resumed"] == run["straight"] and run["epochs_run"] == 3


def test_validate_tiling_runs_inside_prepare_on_a_card_graph(cuda, monkeypatch):
    """``prepare`` of a Graph on the card checks its views before they reach
    a kernel, and ``validate_tiling`` reads a view held on the card."""
    import dataclasses

    from graph_odenet_tpu_torch.utils import validate_tiling

    g = _split_hub_graph(np.random.default_rng(0)).to(cuda)
    seen = []
    real = csr_spmm.validate_tiling
    monkeypatch.setattr(csr_spmm, "validate_tiling", lambda c: seen.append(c) or real(c))
    csr = prepare(g)
    assert len(seen) == 1 and csr.device.type == "cuda" and csr.part.n_slots > 0
    validate_tiling(csr)
    bad = dataclasses.replace(csr, senders=csr.senders.clone().fill_(g.n_node_pad))
    with pytest.raises(ValueError, match="senders"):
        validate_tiling(bad)


# ---------------------------------------------------------------- bfloat16

BF = torch.bfloat16
BF16_F32_TOL = dict(rtol=1e-4, atol=1e-4)  # the f32 outputs of gat_fwd and gat_bwd


def _assert_within_bf16_ulp(got, want, atol=1e-5):
    """bf16 ``got`` within one bf16 ulp of bf16 ``want``, plus ``atol``: both
    round an f32 sum once, the two sums in other orders."""
    assert got.dtype == want.dtype == BF
    w = want.float()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - 8)  # |w| in [2^(e-1), 2^e), 8 bits
    err = (got.float() - w).abs()
    assert bool((err <= ulp + atol).all()), float((err - ulp).max())


@pytest.mark.parametrize("f", [3, 6, 16, 40, 128, 256])
def test_bf16_csr_and_bucket_calls(cuda, f):
    """The bf16 entry on views with split rows (and, in the bucket, empty
    rows): each call one launch of ``csr_reduce_kernel``, 20 calls bit-equal,
    within one ulp of the plain version on the card, every arrival counter
    back at 0; F = 6 and 3 take the single lanes (rows of 12 and 6 bytes)."""
    g = _split_hub_graph(np.random.default_rng(7))
    csr = prepare(g).to(cuda)
    view = _bucket_view(np.random.default_rng(8)).to(cuda)
    rng = np.random.default_rng(9)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda).to(BF)

    x, xt, out0 = randn(g.n_node_pad, f), randn(view.n_cols, f), randn(view.n_rows, f)
    empty, copy, nothing = (lambda: torch.empty_like(out0)), out0.clone, (lambda: None)
    calls = {
        "csr_fwd": (nothing, lambda _: csr_spmm.csr_reduce(csr, x),
                    lambda: csr_spmm._reduce_plain(csr.row_ptr, csr.senders, csr.weight, x)),
        "csr_bwd": (nothing, lambda _: csr_spmm.csr_reduce(csr, x, transpose=True),
                    lambda: csr_spmm._reduce_plain(csr.t_row_ptr, csr.t_receivers,
                                                   csr.t_weight, x)),
        "bucket_write": (empty, lambda o: csr_spmm.bucket_reduce(view, xt, o, accumulate=False),
                         lambda: csr_spmm._bucket_reduce_plain(view, xt, empty(),
                                                               accumulate=False)),
        "bucket_add": (copy, lambda o: csr_spmm.bucket_reduce(view, xt, o),
                       lambda: csr_spmm._bucket_reduce_plain(view, xt, copy())),
    }
    before = dict(csr_spmm.bf16_launches)
    for name, (make, call, plain) in calls.items():
        first = call(make())
        _assert_within_bf16_ulp(first, plain())
        out = make()
        kernels = _device_kernels(lambda: call(out))
        assert len(kernels) == 1 and "csr_reduce_kernel" in kernels[0], (name, kernels)
        for got in [call(o) for o in [make() for _ in range(20)]]:
            assert torch.equal(got, first), name
    torch.cuda.synchronize()
    assert csr_spmm.bf16_launches["csr"] > before["csr"]
    assert csr_spmm.bf16_launches["bucket"] > before["bucket"]
    for plan in (*csr.plans, view.plan):
        assert not plan.arrivals.any()


@pytest.mark.parametrize("heads,feat", ATT_SHAPES)
def test_bf16_gat_calls(cuda, heads, feat):
    """``gat_fwd`` and ``gat_bwd`` on a bf16 Wh over a split hub: f32 outputs
    against the plain versions in float64 on the same (widened) Wh at
    rtol = atol = 1e-4, one launch of their own kernel a call, 20 calls
    bit-equal; the Function's dWh is bf16."""
    from graph_odenet_tpu_torch.ops import gat_attn

    g = _split_hub_graph(np.random.default_rng(20))
    csr, s_src, s_dst, logits, wh, up = _att_inputs(g, heads, feat, cuda, seed=24)
    wh = wh.to(BF)
    drop = (9, 0.6)
    out, m, l = gat_attn.gat_fwd(csr, logits, wh, drop=drop)
    beta = (up * out).sum(-1)
    ref = gat_attn.gat_fwd_plain(csr, logits.double(), wh.double(), drop=drop)
    for got, want in zip((out, m, l), ref):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got.double(), want, **BF16_F32_TOL)
    dl, ad = gat_attn.gat_bwd(csr, logits, wh, up, m, l, beta, drop=drop, emit_alpha=True)
    ref = gat_attn.gat_bwd_plain(csr, logits.double(), wh.double(), up.double(), m.double(),
                                 l.double(), beta.double(), drop=drop, emit_alpha=True)
    for got, want in zip((dl, ad), ref):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got.double(), want, **BF16_F32_TOL)
    calls = {
        "gat_fwd": lambda: gat_attn.gat_fwd(csr, logits, wh, drop=drop),
        "gat_bwd": lambda: gat_attn.gat_bwd(csr, logits, wh, up, m, l, beta, drop=drop,
                                            emit_alpha=True),
    }
    before = dict(gat_attn.bf16_launches)
    for name, call in calls.items():
        first = call()
        kernels = _device_kernels(call)
        assert len(kernels) == 1 and f"{name}_kernel" in kernels[0], (name, kernels)
        for got in [call() for _ in range(20)]:
            for a, b in zip(got, first):
                assert torch.equal(a, b), name
        assert gat_attn.bf16_launches[name] > before[name]
    _, _, dwh = _gat_fwd_bwd(csr, s_src, s_dst, wh, up)
    assert dwh.dtype == BF


def test_bf16_captured_graph_replays_bit_equal_to_eager_calls(cuda):
    """``spmm_csr`` forward and backward on bf16 features and
    ``attention_aggregate`` on a bf16 Wh (score hint, hash dropout 0.6), on a
    split hub, captured in one CUDA graph: replays equal the eager calls."""
    g = _split_hub_graph(np.random.default_rng(25))
    csr, s_src, s_dst, _, wh, up = _att_inputs(g, 8, 8, cuda, seed=26)
    x = torch.from_numpy(np.random.default_rng(27).standard_normal(
        (g.n_node_pad, 16)).astype(np.float32)).to(cuda).to(BF)

    def work(x, wh):
        xr = x.detach().requires_grad_(True)
        y = spmm_csr(csr, xr)
        (dx,) = torch.autograd.grad(y, xr, torch.ones_like(y))
        return (y.detach(), dx, *_gat_fwd_bwd(csr, s_src, s_dst, wh, up))

    graph, eager, captured = _capture(work, x, wh.to(BF))
    assert [t.dtype for t in eager] == [BF, BF, torch.float32, torch.float32, BF]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert torch.equal(got, want)


def test_bf16_weighted_modes_raise_on_cuda(cuda):
    """B1-w and B2-w take f32 only: a bf16 table raises ``TypeError`` before
    any launch, and no plain version runs on a CUDA tensor."""
    g = _random_graph(np.random.default_rng(0))
    csr = prepare(g).to(cuda)
    view = _bucket_view(np.random.default_rng(1)).to(cuda)
    x = torch.zeros((g.n_node_pad, 8), device=cuda, dtype=BF)
    xt = torch.zeros((view.n_cols, 8), device=cuda, dtype=BF)
    before = (csr_spmm.weighted_launches, csr_spmm.bucket_weighted_launches)
    with pytest.raises(TypeError, match="weighted"):
        csr_spmm.csr_reduce(csr, x, transpose=True,
                            alpha=torch.ones(csr.n_edge, 2, device=cuda), feat=4)
    with pytest.raises(TypeError, match="weighted"):
        csr_spmm.bucket_reduce(view, xt, torch.zeros((view.n_rows, 8), device=cuda, dtype=BF),
                               alpha=torch.ones(view.n_edge, 2, device=cuda), feat=4)
    assert (csr_spmm.weighted_launches, csr_spmm.bucket_weighted_launches) == before


@pytest.mark.parametrize("model", ["gcnode", "gatode"])
def test_bf16_sharded_step_through_the_kernels_matches_plain(cuda, model):
    """``chip_smoke.py``'s one-step check of a sharded model built with
    ``dtype=torch.bfloat16`` (bf16 features, dropout 0), at one part on the
    full arxiv twins: config 4's GCN-ODE launches B2's bf16 entry, one launch
    a layer each way (36); the GAT-ODE (16 × 2 heads, rk4 × 2, ``ring_pallas``
    with ``remat``) launches B2-w's f32 entry on the widened chunk, two a
    layer and remat's 4 a substep (28), takes bf16 chunks and hands back a
    bf16 ``dchunk``.  No plain version is called; bf16 log-probs and
    gradients agree with the plain versions' (sums in a fixed order) at
    ``BF16_STEP_TOL`` (each gradient's atol relative to its largest entry)."""
    import dataclasses

    import chip_smoke

    from graph_odenet_tpu_torch.configs import get_config, sharded_train_config
    from graph_odenet_tpu_torch.data import synthetic_ogbn_arxiv

    if model == "gcnode":
        cfg, data = sharded_train_config(get_config(4)[1]), synthetic_ogbn_arxiv(seed=0)
        want = dict(bucket=36, bucket_bf16=36, bucket_weighted=0)
    else:
        cfg = dataclasses.replace(chip_smoke.sharded_gat_config(), hidden=16, heads=2, steps=2)
        data = synthetic_ogbn_arxiv(seed=0, calibrated=True)
        want = dict(bucket=0, bucket_bf16=0, bucket_weighted=2 * (2 + 4 * 2) + 4 * 2)
    check = chip_smoke.sharded_step_check(cfg, data, cuda)
    assert check["launches"] == want and check["plain_calls"] == 0
    assert max(check["err_over_tol"].values()) <= 1.0, check
    assert (check["lp_dtype"], check["grad_dtypes"], check["state"]) == (
        "bfloat16", ["bfloat16"], ["bfloat16"])
    if model == "gatode":
        assert (check["chunk"], check["dchunk"]) == (["bfloat16"], ["bfloat16"])


def test_bf16_segment_sum_adds_in_f32_on_the_card(cuda):
    """On the card ``index_add_`` adds bf16 terms with bf16 atomics, so a
    hub's sum stops growing once its ulp exceeds the terms (5,000 ones stop
    far below 5,000).  ``segment_sum`` (the sharded GAT's softmax
    denominators among its callers) adds bf16 rows in f32 and rounds once:
    5,000 to bf16's 4,992, and within one bf16 ulp of the CPU's sums (the
    f32 sums in another order)."""
    from graph_odenet_tpu_torch.ops.segment import segment_sum

    rng = np.random.default_rng(42)
    ids = torch.from_numpy(np.concatenate([np.zeros(5000), rng.integers(0, 9, 500)]).astype(np.int64))
    rows = torch.from_numpy(rng.standard_normal((5500, 2)).astype(np.float32)).to(BF)
    ones = torch.ones((5000, 2), dtype=BF, device=cuda)
    bf16_adds = torch.zeros((1, 2), dtype=BF, device=cuda).index_add_(0, ids[:5000].to(cuda), ones)
    assert float(bf16_adds.max()) < 1000.0
    assert float(segment_sum(ones, ids[:5000].to(cuda), 1).min()) == 4992.0
    got = segment_sum(rows.to(cuda), ids.to(cuda), 9)
    assert got.dtype == BF
    _assert_within_bf16_ulp(got.cpu(), segment_sum(rows, ids, 9))
