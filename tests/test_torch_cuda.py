"""The CSR SpMM kernel against its plain PyTorch version, on the card.

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
