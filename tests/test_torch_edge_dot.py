"""``ops.csr_spmm.edge_dot`` on the CPU: B2-w's gradient for its numerators.

On a CPU tensor the wrapper runs its plain version, the gather, product and
sum that ``halo._BucketSpMMWeighted`` computed inline before the kernel; here
it is held to that form bit for bit, through the wrapper and through the
sharded GAT's bucket Function (f32, and bf16 whose ``dpv`` comes back in the
numerators' dtype), with no launch counted.  The kernel itself is tested on
the card in ``test_torch_cuda.py``; here a float64 model of its schedule
(``_kernel_model``: the lanes of ``_lanes``, one feature chunk at a time,
the segmented scan of each head's lanes and the chunk-ordered write and
adds of each head's sum) is held to the plain version for many shapes.
"""

import numpy as np
import pytest
import torch

from graph_odenet_tpu_torch.data import synthetic_ogbn_arxiv
from graph_odenet_tpu_torch.ops import csr_spmm
from graph_odenet_tpu_torch.ops.csr_spmm import csr_view, edge_dot, row_ids
from graph_odenet_tpu_torch.parallel import partition_by_receiver
from graph_odenet_tpu_torch.parallel.halo import _bucket_spmm_weighted

SHAPES = [(4, 64), (1, 256), (1, 40), (2, 3), (3, 5)]


def _hub_view(rng):
    """A 300 × 500 block whose row 0 holds 2,000 edges (over several warp
    segments) and whose rows 1–4 and 200–299 hold none."""
    rows = np.sort(np.concatenate([np.zeros(2000, np.int64), rng.integers(5, 200, 1500)]))
    cols = rng.integers(0, 500, rows.shape[0])
    return csr_view(rows, cols, np.ones(rows.shape[0], np.float32), 300, 500)


def _randn(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _gather_product_sum(view, x, g, heads, feat, rows):
    """The dpv of ``halo._BucketSpMMWeighted.backward`` as it was written
    inline: the gathered chunk widened, times the gathered gradient, summed by
    head."""
    prod = csr_spmm.widen(x.index_select(0, view.col)) * g.index_select(0, rows)
    return prod.view(prod.shape[0], heads, feat).sum(-1)


@pytest.mark.parametrize("given_rows", [True, False])
@pytest.mark.parametrize("heads,feat", SHAPES)
def test_plain_version_is_the_gather_product_and_sum(heads, feat, given_rows):
    rng = np.random.default_rng(heads * feat)
    view = _hub_view(rng)
    x, g = _randn(rng, view.n_cols, heads * feat), _randn(rng, view.n_rows, heads * feat)
    rows = row_ids(view.row_ptr, view.n_edge)
    before = csr_spmm.edge_dot_launches
    got = edge_dot(view, x, g, heads, feat, rows=rows if given_rows else None)
    assert got.dtype == torch.float32 and got.shape == (view.n_edge, heads)
    assert torch.equal(got, _gather_product_sum(view, x, g, heads, feat, rows))
    assert csr_spmm.edge_dot_launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_bucket_function_dpv_is_the_plain_form_in_pv_dtype(n_parts, dtype):
    """Every bucket of a 1- and 2-part partition of a small arxiv twin, at H =
    2, F = 8: ``pv_h``'s gradient from ``_bucket_spmm_weighted`` equals the
    gather, product and sum of the chunk and the upstream gradient, rounded
    once to ``pv_h``'s dtype; ``chunk``'s comes back in its dtype; nothing is
    launched on the CPU."""
    heads, feat = 2, 8
    pg = partition_by_receiver(synthetic_ogbn_arxiv(seed=0, scale=0.004).graph, n_parts)
    B, rng = pg.block_size, np.random.default_rng(n_parts)
    before = csr_spmm.edge_dot_launches, csr_spmm.bucket_weighted_launches
    for p in range(n_parts):
        blk = pg.blocks[p]
        for b in range(n_parts):
            bucket, span = pg.bucket(p, b), blk.bucket(b)
            chunk = _randn(rng, B, heads * feat, dtype=dtype).requires_grad_(True)
            pv = torch.rand(bucket.fwd.n_edge, heads, generator=torch.Generator().manual_seed(b))
            pv = pv.to(dtype).requires_grad_(True)
            up = _randn(rng, B, heads * feat)
            out = _bucket_spmm_weighted(chunk, pv, bucket, feat, rows=blk.receivers[span])
            assert out.dtype == torch.float32
            out.backward(up)
            want = _gather_product_sum(bucket.fwd, chunk.detach(), up, heads, feat,
                                       blk.receivers[span]).to(dtype)
            assert pv.grad.dtype == dtype and chunk.grad.dtype == dtype
            assert torch.equal(pv.grad, want), (p, b)
    assert (csr_spmm.edge_dot_launches, csr_spmm.bucket_weighted_launches) == before


def test_empty_view_gives_no_rows():
    view = csr_view(np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0), 64, 32)
    got = edge_dot(view, torch.ones(32, 8), torch.ones(64, 8), 2, 4)
    assert got.shape == (0, 2) and got.dtype == torch.float32


@pytest.mark.parametrize("case", ["float64", "bf16", "shape", "heads", "feat", "strided",
                                  "rows"])
def test_bad_input_raises(case):
    view = _hub_view(np.random.default_rng(0))
    x, g = torch.ones(view.n_cols, 8), torch.ones(view.n_rows, 8)
    args, kw, err = [view, x, g, 2, 4], {}, ValueError
    if case == "float64":
        args[1], err = x.double(), TypeError
    elif case == "bf16":
        args[2], err = g.bfloat16(), TypeError
    elif case == "shape":
        args[2] = torch.ones(view.n_rows + 1, 8)
    elif case == "heads":
        args[1:5] = [torch.ones(view.n_cols, 33), torch.ones(view.n_rows, 33), 33, 1]
    elif case == "feat":
        args[3:5] = [8, 0]
    elif case == "strided":
        args[1] = torch.ones(8, view.n_cols).t()
    else:
        kw["rows"] = torch.zeros(view.n_edge + 1, dtype=torch.int64)
    with pytest.raises(err):
        edge_dot(*args, **kw)


def _dot_lane(c, j, G, V, W, feat):
    """(f, live, head, j0, end, first) of lane ``j`` in chunk ``c``, as the
    kernel's ``dot_lane`` works them out."""
    base = c * G * V
    f = base + j * V
    if f >= W:
        return f, False, 0, j, False, False
    h = f // feat
    lo, hi = h * feat, h * feat + feat
    first = lo >= base
    return f, True, h, (lo - base) // V if first else 0, f == min(hi, base + G * V) - V, first


def _kernel_model(view, x, g, heads, feat, vector):
    """The kernel's arithmetic in float64, lane by lane: NaN where no lane
    wrote a head's sum."""
    w = heads * feat
    G, V = csr_spmm._lanes(w, vector)
    xs = x.double().numpy()[view.col.numpy()]
    gs = g.double().numpy()[row_ids(view.row_ptr, view.n_edge).numpy()]
    out = np.full((view.n_edge, heads), np.nan)
    for c in range(-(-w // (G * V))):
        lanes = [_dot_lane(c, j, G, V, w, feat) for j in range(G)]
        v = np.zeros((view.n_edge, G))
        for j, (f, live, *_) in enumerate(lanes):
            if live:
                v[:, j] = (xs[:, f:f + V] * gs[:, f:f + V]).sum(1)
        off = 1
        while off < G:  # shfl_up: every lane reads the step's old values
            old = v.copy()
            for j, (_, _, _, j0, _, _) in enumerate(lanes):
                if j - off >= j0:
                    v[:, j] = old[:, j] + old[:, j - off]
            off *= 2
        for j, (_, _, h, _, end, first) in enumerate(lanes):
            if end:
                out[:, h] = v[:, j] if first else out[:, h] + v[:, j]
    return out


@pytest.mark.parametrize("vector", [True, False])
@pytest.mark.parametrize("heads,feat", SHAPES + [(3, 100), (1, 70), (2, 8), (5, 12), (32, 1),
                                                 (7, 20), (1, 1)])
def test_kernel_schedule_model_matches_plain(heads, feat, vector):
    """Every head of every edge written once by its first chunk and added to by
    the later ones, to the plain version's float64 sums (float4 lanes when
    ``vector`` and feat % 4 == 0, as the wrapper picks them)."""
    rng = np.random.default_rng(heads * 1000 + feat)
    view = _hub_view(rng)
    x, g = _randn(rng, view.n_cols, heads * feat), _randn(rng, view.n_rows, heads * feat)
    got = _kernel_model(view, x, g, heads, feat, vector and feat % 4 == 0)
    want = csr_spmm._edge_dot_plain(view, x.double(), g.double(), heads, feat).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
