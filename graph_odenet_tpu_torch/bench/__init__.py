"""Benchmark functions, each returning one JSON-able record.

Counterpart of ``graph_odenet_tpu/bench/__init__.py``, with the same
signatures, defaults and record keys:

  * :func:`spmm_bench`       edges/s of SpMM forward+backward, the segment
                             path against the CSR kernel.
  * :func:`gat_bench`        edges/s of the GAT attention sandwich, the
                             segment path against the fused kernels.
  * :func:`ode_bench`        NFE/s of a dopri5 GCN-dynamics solve at Cora
                             scale.
  * :func:`ode_model_bench`  NFE/s of the GCN-ODE and GAT-ODE models, a
                             forward or a training step.
  * :func:`scaling_bench`    the edge-partitioned GCN-ODE's step time over
                             the default process group against one part.

Each runs on the card unless ``device="cpu"``; without a card the default
raises.  The JAX package's ``pallas_*`` keys are ``kernel_*`` here, after
the port's ``representation="kernel"``: the hand-written CUDA kernels.
Nothing catches a kernel's failure: on a CUDA tensor the kernel runs or the
call raises.  On a CPU tensor the kernel figures time the wrappers' plain
versions; every record names its ``device`` (the card's name, or
``"cpu"``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from graph_odenet_tpu_torch.utils.device import resolve_device

__all__ = [
    "spmm_bench", "gat_bench", "ode_bench", "ode_model_bench",
    "scaling_bench", "powerlaw_graph",
]


def powerlaw_graph(n_nodes, n_edges, seed=0, **kw):
    """OGBN-arxiv-shaped synthetic graph (zipf receiver popularity), on the CPU."""
    from graph_odenet_tpu_torch.graph import from_edges

    rng = np.random.default_rng(seed)
    pop = rng.zipf(1.8, size=n_edges).astype(np.int64) % n_nodes
    src = rng.integers(0, n_nodes, size=n_edges)
    kw.setdefault("normalize", "row")
    kw.setdefault("node_multiple", 128)
    kw.setdefault("edge_multiple", 1024)
    return from_edges(src, pop, n_node=n_nodes, **kw)


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _time(fn, *args, iters=20, warmup=2):
    """Mean wall seconds of ``fn(*args)`` after ``warmup`` calls, the card
    synchronised before each reading of the clock."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _randn(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)


def spmm_bench(n_nodes=169_343, n_edges=1_166_243, feat=128, iters=20, device="cuda"):
    """edges/s for SpMM fwd+bwd on the segment path and the CSR kernel."""
    from graph_odenet_tpu_torch.ops import prepare, spmm_csr, spmm_segment

    dev = resolve_device(device)
    g = powerlaw_graph(n_nodes, n_edges).to(dev)
    x = _randn(np.random.default_rng(1), (g.n_node_pad, feat), dev)

    def fwd_bwd(path, adj):
        def step(x):
            xr = x.detach().requires_grad_(True)
            return torch.autograd.grad(0.5 * torch.sum(path(adj, xr) ** 2), xr)[0]
        return step

    t_seg = _time(fwd_bwd(spmm_segment, g), x, iters=iters)
    t_ker = _time(fwd_bwd(spmm_csr, prepare(g)), x, iters=iters)
    rec = dict(
        n_edge=g.n_edge,
        segment_edges_per_s=g.n_edge / t_seg,
        segment_ms=t_seg * 1e3,
        kernel_edges_per_s=g.n_edge / t_ker,
        kernel_ms=t_ker * 1e3,
        speedup=t_seg / t_ker,
    )
    rec["edges_per_s"] = max(rec["segment_edges_per_s"], rec["kernel_edges_per_s"])
    rec["device"] = _device_name(dev)
    return rec


def gat_bench(
    n_nodes=169_343, n_edges=1_166_243, heads=1, feat=128, iters=20,
    mode="fwd_bwd", use_scores=True, dropout=0.0, device="cuda",
):
    """edges/s for the GAT attention sandwich (SDDMM → softmax → SpMM), the
    segment path against the fused kernels (forward, then the α/dlogit
    backward and dWh).

    ``use_scores``: logits come from node scores (``ops.sddmm.edge_scores``,
    the GAT layer's workload) and the score tables are passed as the
    backward's recompute-α hint (dWh by ``gat_dwh``); False takes random
    logits and no hint (dWh by the weighted SpMM).

    ``dropout``: post-softmax attention dropout rate, the counter hash of
    seed 7 (the JAX package's ``PRNGKey(7)``); ``dropout=0.6,
    mode="fwd_bwd"`` is the training path's measurement."""
    from graph_odenet_tpu_torch.ops import prepare
    from graph_odenet_tpu_torch.ops.sddmm import attention_aggregate, edge_scores

    dev = resolve_device(device)
    g = powerlaw_graph(n_nodes, n_edges, normalize=None).to(dev)
    rng = np.random.default_rng(1)
    scores = None
    if use_scores:
        scores = (_randn(rng, (g.n_node_pad, heads), dev), _randn(rng, (g.n_node_pad, heads), dev))
    else:
        logits = _randn(rng, (g.n_edge_pad, heads), dev)
    wh = _randn(rng, (g.n_node_pad, heads, feat), dev)
    drop_kw = dict(dropout_seed=7, dropout_rate=dropout) if dropout > 0.0 else {}

    def make(adj):
        # The kernels take the real edges' logits, in CSR (= Graph) order.
        lg = edge_scores(adj, *scores) if use_scores else logits[: adj.senders.shape[0]]

        def run(lg, w):
            return attention_aggregate(adj, lg, w, scores=scores, **drop_kw)

        if mode == "fwd":
            return run, lg

        def fwd_bwd(lg, w):
            lg, w = lg.detach().requires_grad_(True), w.detach().requires_grad_(True)
            return torch.autograd.grad(0.5 * torch.sum(run(lg, w) ** 2), (lg, w))
        return fwd_bwd, lg

    fn, lg = make(g)
    t_seg = _time(fn, lg, wh, iters=iters)
    fn, lg = make(prepare(g))
    t_ker = _time(fn, lg, wh, iters=iters)
    rec = dict(
        n_edge=g.n_edge, heads=heads, feat=feat, mode=mode, dropout=dropout,
        segment_edges_per_s=g.n_edge / t_seg, segment_ms=t_seg * 1e3,
        kernel_edges_per_s=g.n_edge / t_ker, kernel_ms=t_ker * 1e3,
        speedup=t_seg / t_ker,
    )
    rec["edges_per_s"] = max(rec["segment_edges_per_s"], rec["kernel_edges_per_s"])
    rec["device"] = _device_name(dev)
    return rec


def ode_bench(
    n_nodes=2_708, feat=128, method="dopri5", rtol=1e-3, atol=1e-4,
    representation="dense", iters=10, seed=0, device="cuda",
):
    """NFE/s of a GCN-dynamics ODE solve: NFE/s = dynamics evaluations /
    wall-clock, each evaluation one matmul and one aggregation over the
    whole graph.

    The JAX package runs the whole adaptive trajectory as one XLA program;
    the port's adaptive solver reads the host once or twice an attempt, and
    that cost is in the time.  ``representation``: "dense", "segment" or
    "kernel"."""
    from graph_odenet_tpu_torch.graph import from_edges
    from graph_odenet_tpu_torch.ode import odeint
    from graph_odenet_tpu_torch.ops import spmm
    from graph_odenet_tpu_torch.train import adjacency

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    # Cora-shaped random graph at the requested size.
    deg = 4
    src = rng.integers(0, n_nodes, size=deg * n_nodes)
    dst = rng.integers(0, n_nodes, size=deg * n_nodes)
    g = from_edges(src, dst, n_node=n_nodes, normalize="sym", node_multiple=128).to(dev)
    adj = adjacency(g, representation)
    w = torch.from_numpy((rng.standard_normal((feat, feat)) / np.sqrt(feat)).astype(np.float32))
    w = w.to(dev)
    y0 = _randn(rng, (g.n_node_pad, feat), dev)

    def dynamics(t, h):
        return torch.tanh(spmm(adj, h @ w))

    @torch.no_grad()
    def solve(y0):
        ys, stats = odeint(dynamics, y0, [0.0, 1.0], method=method, rtol=rtol, atol=atol,
                           return_stats=True)
        return ys[-1], stats["nfe"]

    _, nfe = solve(y0)
    t = _time(lambda y: solve(y)[0], y0, iters=iters)
    nfe = int(nfe)
    return dict(
        method=method, nfe=nfe, seconds=t, nfe_per_s=nfe / t,
        edges_per_s=nfe * g.n_edge / t, representation=representation,
        device=_device_name(dev),
    )


def scaling_bench(n_devices=None, n_nodes=8_192, deg=16, feat=128, iters=10, device="cuda"):
    """The edge-partitioned GCN-ODE's training-step time over ``n_devices``
    ranks against one part.

    Runs over the default process group, one rank per card: every rank
    calls it.  ``n_devices`` (default: every rank; 1 without a process
    group) must divide the group's size; the ranks run in groups of
    ``n_devices`` (``parallel.make_mesh``), and for one part each rank alone.
    Returns both step times and the parallel efficiency against one part.
    On the CPU the timings check the harness only (``harness_only``).
    """
    from graph_odenet_tpu_torch.graph import from_edges
    from graph_odenet_tpu_torch.parallel import make_mesh, partition_by_receiver
    from graph_odenet_tpu_torch.parallel.mesh import device_for, world
    from graph_odenet_tpu_torch.parallel.sharded_gcn import init_params, shard_batch, train_step

    n_world, rank = world()
    n_devices = n_devices or n_world
    if n_world % n_devices:
        raise ValueError(f"n_devices={n_devices} does not divide the {n_world} ranks")
    dev = device_for(device, rank)
    rng = np.random.default_rng(0)
    src = rng.integers(0, n_nodes, size=deg * n_nodes)
    dst = rng.integers(0, n_nodes, size=deg * n_nodes)
    results = {}
    for nd in (1, n_devices):
        mesh = make_mesh((n_world // nd, nd), ("data", "edge"))
        group, me = mesh.group("edge"), mesh.coord("edge")
        g = from_edges(src, dst, n_node=n_nodes, normalize="row", node_multiple=nd)
        pg = partition_by_receiver(g, nd).to(dev)
        x = _randn(rng, (g.n_node_pad, feat), dev)
        c = 8
        labels = np.eye(c, dtype=np.float32)[rng.integers(0, c, g.n_node_pad)]
        weight = (np.arange(g.n_node_pad) < g.n_node).astype(np.float32)
        x_s, y_s, w_s = shard_batch(nd, me, x, torch.from_numpy(labels).to(dev),
                                    torch.from_numpy(weight).to(dev))
        params = init_params(feat, 64, c, generator=torch.Generator().manual_seed(0)).to(dev)
        results[nd] = _time(
            lambda p: train_step(p, pg, x_s, y_s, w_s, steps=4, mode="ring", group=group)[1],
            params, iters=iters)
    return dict(
        n_devices=n_devices,
        t1_ms=results[1] * 1e3,
        tn_ms=results[n_devices] * 1e3,
        speedup=results[1] / results[n_devices],
        efficiency=results[1] / results[n_devices] / n_devices,
        n_edge=int(deg * n_nodes),
        platform=dev.type,
        device=_device_name(dev),
        # Processes that share the CPU's cores: timings there check the
        # harness only.
        harness_only=dev.type == "cpu",
    )


def ode_model_bench(
    model: str = "gcnode", n_nodes: int = 2_708, deg: int = 4,
    feat_in: int = 128, hidden: int = 64, heads: int = 8,
    method: str = "dopri5", rtol: float = 1e-3, atol: float = 1e-4,
    representation: str = "auto", iters: int = 10, seed: int = 0,
    mode: str = "fwd", dropout: float | None = None,
    steps: int = 32, remat: bool = False, adjoint: bool = False,
    device="cuda",
):
    """NFE/s of the flagship models (encoder → ODEBlock → readout).

    ``representation``: "dense" | "segment" | "kernel" | "auto" (the
    trainer's rule, ``choose_representation``: dense Â for the GCN family
    on small graphs, the kernels on the card otherwise).

    ``mode="train_step"`` measures the training loop's step: the NLL's
    gradient with dropout live (0.5 GCN family, 0.6 GAT family) and the
    Adam update (``lr=1e-2``) inside the timed step, a fresh dropout draw
    each step, adaptive methods switched to their ``_scan`` forms unless
    ``adjoint``.
    """
    from graph_odenet_tpu_torch.graph import from_edges
    from graph_odenet_tpu_torch.models import GATODE, GCNODE
    from graph_odenet_tpu_torch.train import adjacency, choose_representation

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, size=deg * n_nodes)
    dst = rng.integers(0, n_nodes, size=deg * n_nodes)
    norm = "sym" if model == "gcnode" else None
    g = from_edges(src, dst, n_node=n_nodes, normalize=norm, node_multiple=128).to(dev)
    if representation == "auto":
        representation = choose_representation(g, model)
    adj = adjacency(g, representation)
    n_class = 8
    train = mode == "train_step"
    # The adjoints differentiate through their own reverse solve, so the
    # forward keeps the adaptive solver; direct backprop needs the bounded
    # _scan forms.
    if train and not adjoint and method in (
        "dopri5", "dopri8", "bosh3", "adaptive_heun", "fehlberg2", "adams",
    ):
        method = method + "_scan"
    if dropout is None:
        dropout = (0.5 if model == "gcnode" else 0.6) if train else 0.0
    kw = dict(
        n_class=n_class, method=method, rtol=rtol, atol=atol,
        steps=steps, dropout=dropout, remat=remat, adjoint=adjoint,
        generator=torch.Generator().manual_seed(0),
    )
    if model == "gcnode":
        m = GCNODE(feat_in, hidden=hidden, **kw)
    elif model == "gatode":
        m = GATODE(feat_in, hidden=hidden // heads, heads=heads, **kw)
    else:
        raise ValueError(model)
    m.to(dev)
    x = _randn(rng, (g.n_node_pad, feat_in), dev)
    labels = torch.from_numpy(rng.integers(0, n_class, size=g.n_node_pad)).to(dev)

    if train:
        opt = torch.optim.Adam(m.parameters(), lr=1e-2)
        # Generators advance every step: each step draws fresh dropout.
        gens = dict(generator=torch.Generator(device=dev).manual_seed(3))
        if model == "gatode":
            gens["seed_generator"] = torch.Generator().manual_seed(3)

        def run(xx):
            m.train()
            opt.zero_grad(set_to_none=True)
            out = m(adj, xx, deterministic=False, **gens)
            logp = torch.log_softmax(out[: g.n_node], dim=-1)
            nll = -logp.gather(1, labels[: g.n_node, None]).mean()
            nll.backward()
            opt.step()
            return nll.detach()
    else:
        m.eval()

        @torch.no_grad()
        def run(xx):
            return m(adj, xx, deterministic=True)

    run(x)
    nfe = int(m.odeblock.stats["nfe"])
    t = _time(run, x, iters=iters)
    return dict(
        model=model, method=method, representation=representation,
        mode=mode, dropout=dropout, steps=steps, remat=remat,
        adjoint=adjoint,
        n_node=g.n_node, n_edge=g.n_edge, nfe=nfe, seconds=t,
        nfe_per_s=nfe / t, edges_per_s=nfe * g.n_edge / t,
        device=_device_name(dev),
    )
