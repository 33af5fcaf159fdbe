"""Port parity: SpMM paths against the JAX package.

The port's ``spmm_csr`` runs on the CPU here, which is its plain version;
JAX's ``spmm_pallas`` runs its Pallas kernel in interpret mode, as
``tests/test_pallas.py`` runs it on the CPU.  Values and the gradient of
``sum(sin(spmm(x)))`` agree to rtol = atol = 1e-5 (f32, sums in another
order).  The warp-segment metadata that the CUDA kernel reads is checked by
a numpy model of the kernel's one-launch schedule (``_one_launch_model``),
and the launch plan that carries it by its counts and pointers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_odenet_tpu import graph as jgraph
from graph_odenet_tpu.ops import spmm as jspmm
from graph_odenet_tpu.ops.pallas_spmm import prepare as jprepare
from graph_odenet_tpu.ops.pallas_spmm import spmm_pallas
from graph_odenet_tpu_torch import graph as tgraph
from graph_odenet_tpu_torch.ops import csr_spmm, gather, prepare, segment_sum, spmm, spmm_csr
from graph_odenet_tpu_torch.ops import spmm_csr_reference

TOL = dict(rtol=1e-5, atol=1e-5)
F = 16


def _random(rng):
    a = rng.random((300, 300)) < 0.03
    s, r = np.nonzero(a)
    return (s, r), dict(n_node=300, normalize="row", node_multiple=128)


def _hub(rng):
    n = 200
    s = np.concatenate([rng.integers(0, n, size=1500), rng.integers(0, n, size=300)])
    r = np.concatenate([np.zeros(1500, dtype=np.int64), rng.integers(0, n, size=300)])
    return (s, r), dict(n_node=n, normalize="row", node_multiple=128)


def _edgeless_blocks(rng):
    s = rng.integers(0, 512, size=300)
    r = rng.integers(0, 100, size=300)
    return (s, r), dict(
        n_node=512, normalize=None, add_self_loops=False, symmetrize=False, node_multiple=128
    )


GRAPHS = {"random": _random, "hub": _hub, "edgeless_blocks": _edgeless_blocks}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def pair(request):
    rng = np.random.default_rng(0)
    (s, r), kw = GRAPHS[request.param](rng)
    tg, jg = tgraph.from_edges(s, r, **kw), jgraph.from_edges(s, r, **kw)
    x = rng.standard_normal((tg.n_node_pad, F)).astype(np.float32)
    return request.param, tg, jg, x


def test_spmm_csr_matches_spmm_pallas(pair):
    name, tg, jg, x = pair
    csr, jcsr = prepare(tg), jprepare(jg)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = spmm_csr(csr, xt)
    torch.sin(out).sum().backward()

    jx = jnp.asarray(x)
    jout = spmm_pallas(jcsr, jx)
    jgrad = jax.grad(lambda v: jnp.sum(jnp.sin(spmm_pallas(jcsr, v))))(jx)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), **TOL)
    if name == "edgeless_blocks":
        assert torch.all(out[128:] == 0)


def test_segment_dense_and_reference_paths_agree(pair):
    _, tg, jg, x = pair
    xt = torch.from_numpy(x)
    expected = np.asarray(jspmm(jg, jnp.asarray(x)))
    np.testing.assert_allclose(spmm(tg, xt).numpy(), expected, **TOL)
    np.testing.assert_allclose(spmm(tgraph.to_dense(tg), xt).numpy(), expected, **TOL)
    np.testing.assert_allclose(spmm_csr_reference(prepare(tg), xt).numpy(), expected, **TOL)


def test_prepare_views(pair):
    _, tg, _, _ = pair
    csr = prepare(tg)
    e = tg.n_edge
    assert int(csr.row_ptr[-1]) == e and int(csr.t_row_ptr[-1]) == e
    assert csr.row_ptr.shape == (tg.n_node_pad + 1,)
    # CSC holds the same edges: t_perm maps CSC positions to edge ids.
    perm = csr.t_perm
    np.testing.assert_array_equal(csr.t_receivers.numpy(), tg.receivers[:e][perm].numpy())
    np.testing.assert_array_equal(csr.t_weight.numpy(), tg.weight[:e][perm].numpy())
    t_rows = torch.repeat_interleave(torch.arange(tg.n_node_pad), csr.t_row_ptr.diff())
    np.testing.assert_array_equal(t_rows.numpy(), tg.senders[:e][perm].numpy())


def _one_launch_model(part, col, w, x, out0, accumulate, rng, width=None):
    """The one-launch schedule of the CUDA kernel, in numpy.

    Warp items (segment, feature chunk) of the chunk widths that ``_lanes``
    picks (or ``width``, the resident walk's), and in the write form one
    item per empty row, run in the order
    ``rng`` shuffles.  A whole row's item writes (or adds) its sum; a split
    row's item writes its partial row and counts its arrival, and the last
    item of a split row and chunk to arrive adds the row's partial rows in
    slot order and resets its counter.  Returns the output and the counters.
    """
    seg_ptr, seg_row, seg_slot = (t.numpy() for t in (part.seg_ptr, part.seg_row, part.seg_slot))
    split_row, split_ptr, slot_split, empty_row = (
        t.numpy() for t in (part.split_row, part.split_ptr, part.slot_split, part.empty_row))
    f = x.shape[1]
    if width is None:
        lanes, vec = csr_spmm._lanes(f, f % 4 == 0)
        width = lanes * vec
    n_chunks = -(-f // width)
    msgs = w[:, None] * x[col]
    seg_sum = np.zeros((len(seg_row), f), np.float32)
    for s in range(len(seg_row)):
        for p in range(seg_ptr[s], seg_ptr[s + 1]):
            seg_sum[s] += msgs[p]
    out = out0.copy()
    partial = np.full((part.n_slots, f), np.nan, np.float32)
    arrivals = np.zeros((n_chunks, len(split_row)), np.int64)
    items = [(k, s) for k in range(n_chunks) for s in range(len(seg_row))]
    if not accumulate:
        items += [(None, r) for r in empty_row]
    for i in rng.permutation(len(items)):
        k, s = items[i]
        if k is None:
            out[s] = 0.0
            continue
        cols = slice(k * width, min(f, (k + 1) * width))
        slot = seg_slot[s]
        if slot < 0:
            out[seg_row[s], cols] = seg_sum[s, cols] + (out[seg_row[s], cols] if accumulate else 0)
            continue
        partial[slot, cols] = seg_sum[s, cols]
        j = slot_split[slot]
        arrivals[k, j] += 1
        if arrivals[k, j] < split_ptr[j + 1] - split_ptr[j]:
            continue
        arrivals[k, j] = 0
        total = np.zeros(cols.stop - cols.start, np.float32)
        for slot_k in range(split_ptr[j], split_ptr[j + 1]):
            total += partial[slot_k, cols]
        out[split_row[j], cols] = total + (out[split_row[j], cols] if accumulate else 0)
    return out, arrivals


@pytest.mark.parametrize("transpose", [False, True])
def test_segment_partition_covers_every_row(transpose):
    # Node 0 has 2,000 distinct neighbours, so its rows span several segments.
    rng = np.random.default_rng(5)
    s = rng.permutation(3000)[:2000]
    g = tgraph.from_edges(s, np.zeros_like(s), n_node=3000, normalize="row")
    csr = prepare(g)
    row_ptr, col, w, part = csr.view(transpose)
    assert part.n_slots == -(-2001 // csr_spmm.SEG_EDGES)
    assert part.split_row.tolist() == [0]
    assert int(part.seg_ptr[-1]) == g.n_edge
    assert int((part.seg_ptr.diff()).max()) <= csr_spmm.SEG_EDGES
    x = rng.standard_normal((g.n_node_pad, 5)).astype(np.float32)
    out0 = np.full((g.n_node_pad, 5), np.nan, np.float32)
    got, arrivals = _one_launch_model(part, col.numpy().astype(np.int64), w.numpy(), x, out0,
                                      False, rng)
    ref = csr_spmm._reduce_plain(row_ptr, col, w, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    assert not arrivals.any()


def _split_hub_csr():
    """Node 0 has 2,000 distinct neighbours, so its rows span several segments."""
    rng = np.random.default_rng(5)
    s = rng.permutation(3000)[:2000]
    return prepare(tgraph.from_edges(s, np.zeros_like(s), n_node=3000, normalize="row"))


def _hub_bucket(transpose=False):
    """A 300 × 500 bucket whose row 0 and column 7 are hubs (split rows of its
    CSR and of its CSC view) and whose rows 1–4 and 200–299 have no edge; or,
    ``transpose``, its CSC view as a 500 × 300 block."""
    rng = np.random.default_rng(6)
    rows = np.concatenate([np.zeros(2000, np.int64), rng.integers(5, 200, 2100)])
    cols = np.concatenate([rng.integers(0, 500, 3500), np.full(600, 7)])
    shape = (300, 500)
    if transpose:
        rows, cols, shape = cols, rows, shape[::-1]
    order = np.argsort(rows, kind="stable")
    return csr_spmm.csr_view(rows[order], cols[order], np.ones(len(rows)), *shape)


def _model_views():
    """(name, row_ptr, col, part, n_cols) of views with split rows: both views
    of the split hub graph and both views of the hub bucket."""
    csr = _split_hub_csr()
    views = []
    for name, transpose in (("hub_csr", False), ("hub_csc", True)):
        row_ptr, col, _, part = csr.view(transpose)
        views.append((name, row_ptr, col, part, csr.n_node_pad))
    for name, transpose in (("bucket_csr", False), ("bucket_csc", True)):
        view = _hub_bucket(transpose)
        views.append((name, view.row_ptr, view.col, view.part, view.n_cols))
    return views


MODEL_VIEWS = _model_views()


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("f", [1, 3, 16, 128, 256])
@pytest.mark.parametrize("view", range(len(MODEL_VIEWS)),
                         ids=[v[0] for v in MODEL_VIEWS])
def test_one_launch_schedule_matches_plain(view, f, accumulate):
    """The model of the one-launch schedule against ``_reduce_plain``: bit for
    bit on values whose sums are exact in f32 (small integers, weights in
    {1/4, 1/2, 1, 2}), in three arrival orders; on random normal values, bit
    for bit from one arrival order to the next and at 1e-5 from the plain
    version.  Every arrival counter ends at 0; the write form zeroes the empty
    rows and the add form leaves them."""
    _, row_ptr, col, part, n_cols = MODEL_VIEWS[view]
    assert part.split_row.numel() > 0
    rng = np.random.default_rng(f)
    n_rows, n_edge = row_ptr.shape[0] - 1, col.shape[0]
    col_np = col.numpy().astype(np.int64)
    exact = (
        rng.integers(-8, 9, (n_cols, f)).astype(np.float32),
        rng.choice(np.float32([0.25, 0.5, 1.0, 2.0]), n_edge),
        rng.integers(-8, 9, (n_rows, f)).astype(np.float32),
    )
    rows = csr_spmm.row_ids(row_ptr, n_edge).numpy()
    u = rng.random(n_edge) + 0.5  # positive, adding up to 1 in each row: no sum cancels
    normal = (
        rng.standard_normal((n_cols, f)).astype(np.float32),
        (u / np.bincount(rows, weights=u, minlength=n_rows)[rows]).astype(np.float32),
        rng.standard_normal((n_rows, f)).astype(np.float32),
    )
    for kind, (x, w, out0) in (("exact", exact), ("normal", normal)):
        plain = csr_spmm._reduce_plain(row_ptr, col, torch.from_numpy(w), torch.from_numpy(x))
        want = plain.numpy() + (out0 if accumulate else 0)
        if not accumulate:
            out0 = np.full_like(out0, np.nan)  # the write form reads nothing of out
        runs = []
        for seed in range(3):
            got, arrivals = _one_launch_model(part, col_np, w, x, out0, accumulate,
                                              np.random.default_rng(seed))
            assert not arrivals.any()
            runs.append(got)
        for got in runs:
            if kind == "exact":
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_array_equal(got, runs[0])
                np.testing.assert_allclose(got, want, **TOL)
    empty = part.empty_row.numpy()
    if accumulate:
        np.testing.assert_array_equal(runs[0][empty], out0[empty])
    else:
        assert not runs[0][empty].any()


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("f", [128, 256])
@pytest.mark.parametrize("view", range(len(MODEL_VIEWS)),
                         ids=[v[0] for v in MODEL_VIEWS])
def test_resident_walk_schedule_matches_plain(view, f, accumulate):
    """The one-launch model at the resident walk's chunk width (``f`` / 32
    chunks, as many arrival counters a split row): bit for bit on values
    whose sums are exact in f32, in three arrival orders; every counter ends
    at 0."""
    _, row_ptr, col, part, n_cols = MODEL_VIEWS[view]
    width = csr_spmm.WALK_WIDTH
    rng = np.random.default_rng(f + 1)
    n_rows, n_edge = row_ptr.shape[0] - 1, col.shape[0]
    x = rng.integers(-8, 9, (n_cols, f)).astype(np.float32)
    w = rng.choice(np.float32([0.25, 0.5, 1.0, 2.0]), n_edge)
    out0 = rng.integers(-8, 9, (n_rows, f)).astype(np.float32)
    want = csr_spmm._reduce_plain(row_ptr, col, torch.from_numpy(w), torch.from_numpy(x)).numpy()
    want = want + (out0 if accumulate else 0)
    if not accumulate:
        out0 = np.full_like(out0, np.nan)
    for seed in range(3):
        got, arrivals = _one_launch_model(part, col.numpy().astype(np.int64), w, x, out0,
                                          accumulate, np.random.default_rng(seed), width=width)
        assert arrivals.shape[0] == f // width and not arrivals.any()
        np.testing.assert_array_equal(got, want)


TWIN_ROWS, FOUR_CARD_BLOCK = 169_344, 42_336  # the arxiv twin's table; one of four blocks
_F32, _BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("dtype,mode,f,n_cols,width", [
    (_F32, csr_spmm._SCALED, 256, TWIN_ROWS, 32),        # config 4's B2
    (_F32, csr_spmm._ALPHA, 256, TWIN_ROWS, 32),         # B2-w at H = 1 / F = 256 and H = 4 / F = 64
    (_F32, csr_spmm._SCALED, 128, TWIN_ROWS, 32),        # a 128-feature table of the twin
    (_F32, csr_spmm._SCALED, 96, TWIN_ROWS, 32),
    (_F32, csr_spmm._ALPHA, 40, TWIN_ROWS, 0),           # the readout
    (_F32, csr_spmm._SCALED, 64, TWIN_ROWS, 0),          # G = 16: edge slots, another association
    (_F32, csr_spmm._SCALED, 100, TWIN_ROWS, 0),         # no width divides F
    (_BF16, csr_spmm._SCALED, 256, TWIN_ROWS, 0),        # the bf16 entry
    (_F32, csr_spmm._POSITIONAL, 256, 2_150_475, 0),     # read in order, never gathered
    (_F32, csr_spmm._SCALED, 256, FOUR_CARD_BLOCK, 0),   # config 4's block on four cards
    (_F32, csr_spmm._SCALED, 256, 19_840, 0),            # a Pubmed-sized table
    (_F32, csr_spmm._SCALED, 256, 48_828, 0),            # a 128-feature slice of 24.99 MB
    (_F32, csr_spmm._SCALED, 256, 48_829, 32),           # and of 25.00 MB and 512 bytes
    (_F32, csr_spmm._SCALED, 256, 800_000, 32),          # past the budget at any width
])
def test_walk_width_of_a_call(dtype, mode, f, n_cols, width):
    """The resident walk takes f32 tables in a gathering mode on the G = 32,
    V = 4 schedule whose 128-feature slice outgrows ``L2_RESIDENT_BYTES``,
    in chunks of 32 features."""
    assert csr_spmm.L2_RESIDENT_BYTES == 25_000_000
    assert csr_spmm.walk_width(dtype, mode, f, n_cols) == width


def test_launch_plan_is_built_once_per_view():
    """A view's ``LaunchPlan`` is built at first use and reused; ``.to()``
    gives a new view and a new plan; its counts and pointers are the view's,
    and its arrival counters grow, zeroed, to the chunks a call needs."""
    csr, view = _split_hub_csr(), _hub_bucket()
    plans = csr.plans
    assert csr.plans is plans and csr.to("cpu").plans is not plans
    assert view.plan is view.plan and view.to("cpu").plan is not view.plan
    cases = [(plans[0], csr.part, csr.senders, csr.weight),
             (plans[1], csr.t_part, csr.t_receivers, csr.t_weight),
             (view.plan, view.part, view.col, view.weight)]
    assert view.part.empty_row.numel() > 0
    for plan, part, col, weight in cases:
        counts = (part.seg_row.numel(), part.split_row.numel(), part.empty_row.numel())
        assert counts[1] > 0
        assert (plan.n_seg, plan.n_split, plan.n_empty, plan.n_slots) == (*counts, part.n_slots)
        st = plan.struct
        assert (st.n_seg, st.n_split, st.n_empty, st.n_arrivals) == (*counts, counts[1])
        for name, t in (("seg_ptr", part.seg_ptr), ("slot_split", part.slot_split),
                        ("empty_row", part.empty_row), ("col", col), ("w", weight)):
            assert (getattr(st, name) or 0) == t.data_ptr(), name
        plan.reserve(3)
        assert st.n_arrivals == 3 * counts[1] == plan.arrivals.numel()
        assert st.arrivals == plan.arrivals.data_ptr() and not plan.arrivals.any()
        plan.reserve(2)  # enough already: kept
        assert st.n_arrivals == 3 * counts[1]
        assert len(plan.outgrown) == 1 and plan.outgrown[0].numel() == counts[1]


def test_launch_plan_keeps_outgrown_counters():
    """A call that needs more chunks gets new counters; the outgrown ones stay
    referenced (a graph captured before holds their address) and stay 0."""
    plan = _hub_bucket().plan
    first = plan.arrivals
    address = first.data_ptr()
    for n_chunks in (1, 2, 4, 4, 2):
        plan.reserve(n_chunks)
    assert [t.numel() for t in plan.outgrown] == [plan.n_split, 2 * plan.n_split]
    assert plan.outgrown[0] is first and first.data_ptr() == address
    assert plan.struct.arrivals == plan.arrivals.data_ptr() != address
    assert plan.arrivals.numel() == 4 * plan.n_split
    assert not any(t.any() for t in (*plan.outgrown, plan.arrivals))


@pytest.mark.parametrize("f,vector,lanes", [
    (1, False, (1, 1)), (3, False, (4, 1)), (16, True, (16, 1)), (31, False, (32, 1)),
    (32, True, (8, 4)), (33, False, (32, 1)), (40, True, (16, 4)), (40, False, (32, 1)),
    (256, True, (32, 4)),
])
def test_lanes_of_a_call(f, vector, lanes):
    """Float4 lanes only at F >= 32 with aligned rows, at most 128 features
    (32 lanes) to a chunk; below F = 32 the smallest power of two >= F;
    otherwise 32 single lanes."""
    assert csr_spmm._lanes(f, vector) == lanes


def test_gather_and_segment_sum():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((10, 3)).astype(np.float32))
    idx = torch.tensor([3, 3, 0, 9], dtype=torch.int32)
    np.testing.assert_array_equal(gather(x, idx).numpy(), x.numpy()[[3, 3, 0, 9]])
    out = segment_sum(x[:4], idx, 12)
    ref = np.zeros((12, 3), np.float32)
    np.add.at(ref, [3, 3, 0, 9], x.numpy()[:4])
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
