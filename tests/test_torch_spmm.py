"""Port parity: SpMM paths against the JAX package.

The port's ``spmm_csr`` runs on the CPU here, which is its plain version;
JAX's ``spmm_pallas`` runs its Pallas kernel in interpret mode, as
``tests/test_pallas.py`` runs it on the CPU.  Values and the gradient of
``sum(sin(spmm(x)))`` agree to rtol = atol = 1e-5 (f32, sums in another
order).  The warp-segment metadata that the CUDA kernel reads is checked by
a numpy model of the kernel.
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


def _kernel_model(part, col, w, x, n_rows):
    """What the CUDA kernel does with the segment metadata, in numpy."""
    seg_ptr, seg_row, seg_slot = part.seg_ptr.numpy(), part.seg_row.numpy(), part.seg_slot.numpy()
    out = np.full((n_rows, x.shape[1]), np.nan, np.float32)
    partial = np.full((part.n_slots, x.shape[1]), np.nan, np.float32)
    for s in range(len(seg_row)):
        p0, p1 = seg_ptr[s], seg_ptr[s + 1]
        acc = (w[p0:p1, None] * x[col[p0:p1]]).sum(0)
        if seg_slot[s] < 0:
            out[seg_row[s]] = acc
        else:
            partial[seg_slot[s]] = acc
    split_ptr = part.split_ptr.numpy()
    for j, row in enumerate(part.split_row.numpy()):
        out[row] = partial[split_ptr[j]:split_ptr[j + 1]].sum(0)
    return out


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
    got = _kernel_model(part, col.numpy(), w.numpy(), x, g.n_node_pad)
    ref = csr_spmm._reduce_plain(row_ptr, col, w, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_gather_and_segment_sum():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((10, 3)).astype(np.float32))
    idx = torch.tensor([3, 3, 0, 9], dtype=torch.int32)
    np.testing.assert_array_equal(gather(x, idx).numpy(), x.numpy()[[3, 3, 0, 9]])
    out = segment_sum(x[:4], idx, 12)
    ref = np.zeros((12, 3), np.float32)
    np.add.at(ref, [3, 3, 0, 9], x.numpy()[:4])
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
