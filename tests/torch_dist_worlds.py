"""Process-group worlds for the port's tests of the edge-partitioned tier.

``run_world(n_ranks, store_dir, tasks)`` starts ``n_ranks`` spawned
processes that join one process group (gloo on the CPU; NCCL with
``backend="nccl"``, rank r on ``cuda:r``) through a ``FileStore`` in
``store_dir`` (no TCP port, so parallel test workers cannot collide), run
``TASKS[name](rank, n_ranks, **kwargs)`` for each ``name: kwargs`` of
``tasks`` in order, and return each rank's ``{name: result}`` (numpy
arrays and plain values).  Rendezvous and collectives time out after
60 s; the parent gives the whole world ``timeout`` seconds, then kills what
is left and raises.  This module imports torch, numpy and the port only: the
spawned children import it to find their task.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

COLLECTIVE_TIMEOUT_S = 60


def run_world(n_ranks: int, store_dir, tasks: dict, *, timeout: float = 180.0,
              backend: str = "gloo"):
    ctx = multiprocessing.get_context("spawn")
    results_q = ctx.Queue()
    store = os.path.join(str(store_dir), f"store_{n_ranks}")
    procs = [
        ctx.Process(target=_rank_main, args=(tasks, r, n_ranks, store, backend, results_q),
                    daemon=True)
        for r in range(n_ranks)
    ]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < n_ranks:  # drain the queue before joining
            try:
                rank, ok, payload = results_q.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"{list(tasks)}: a rank exited with {dead} before reporting")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{list(tasks)}: world of {n_ranks} did not finish in {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"{list(tasks)}: rank {rank} failed:\n{payload}")
            results[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [results[r] for r in range(n_ranks)]


def _rank_main(tasks, rank, n_ranks, store, backend, results_q):
    torch.set_num_threads(1)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(
            backend, store=dist.FileStore(store, n_ranks), rank=rank, world_size=n_ranks,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
        )
        try:
            out = {name: TASKS[name](rank, n_ranks, **kw) for name, kw in tasks.items()}
        finally:
            dist.destroy_process_group()
        results_q.put((rank, True, out))
    except Exception:  # reported to the parent, which fails the test
        results_q.put((rank, False, traceback.format_exc()))


def _twin(scale):
    from graph_odenet_tpu_torch.data import synthetic_ogbn_arxiv

    return synthetic_ogbn_arxiv(seed=0, scale=scale)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def spmm_modes(rank, n_ranks, *, scale, x, modes):
    """Each mode's output rows and ``d sum(sin(out)) / dx`` rows of this rank."""
    from graph_odenet_tpu_torch.parallel import partition_by_receiver, spmm_sharded
    from graph_odenet_tpu_torch.parallel.sharded_gcn import shard_batch

    pg = partition_by_receiver(_twin(scale).graph, n_ranks)
    (xs,) = shard_batch(n_ranks, rank, torch.from_numpy(x))
    out = {}
    for mode in modes:
        xr = xs.clone().requires_grad_(True)
        y = spmm_sharded(pg, xr, mode=mode)
        torch.sin(y).sum().backward()
        out[mode] = (_np(y), _np(xr.grad))
    return out


def sharded_gcn(rank, n_ranks, *, scale, params, steps, mode, drop_seed):
    """Log-probs rows, loss and all-reduced parameter gradients of this rank
    (dropout 0), and log-prob rows with dropout 0.5 from ``drop_seed``."""
    from graph_odenet_tpu_torch.convert import params_from_sharded
    from graph_odenet_tpu_torch.parallel import partition_by_receiver, sharded_gcn as sg

    data = _twin(scale)
    pg = partition_by_receiver(data.graph, n_ranks)
    model = sg.init_params(params["w_in"].shape[0], params["w_in"].shape[1], data.n_class)
    model.load_state_dict(params_from_sharded(params))
    y1h, w = _labels_weight(data)
    x, y1h, w = sg.shard_batch(n_ranks, rank, data.features, y1h, w)
    loss = sg.loss_fn(model, pg, x, y1h, w, steps=steps, mode=mode)
    loss.backward()
    sg.all_reduce_grads(model)
    loss = loss.detach()
    dist.all_reduce(loss)
    with torch.no_grad():
        lp = sg.forward(model, pg, x, steps=steps, mode=mode)
        lp_drop = sg.forward(model, pg, x, steps=steps, mode=mode, dropout=0.5,
                             generator=torch.Generator().manual_seed(drop_seed))
    grads = {k: _np(p.grad) for k, p in model.named_parameters()}
    return dict(lp=_np(lp), loss=float(loss), grads=grads, lp_drop=_np(lp_drop))


def gat_modes(rank, n_ranks, *, scale, inputs, modes, rate, seed):
    """Each mode's ``gat_sharded`` rows of this rank and the rows of the
    gradients of ``sum(sin(out))`` (summed over every rank's rows) w.r.t.
    ``s_src``, ``s_dst`` and ``wh``, with attention dropout ``rate``."""
    from graph_odenet_tpu_torch.parallel import gat_sharded, partition_by_receiver
    from graph_odenet_tpu_torch.parallel.sharded_gcn import shard_batch

    pg = partition_by_receiver(_twin(scale).graph, n_ranks)
    out = {}
    for mode in modes:
        ts = [t.clone().requires_grad_(True)
              for t in shard_batch(n_ranks, rank, *(torch.from_numpy(a) for a in inputs))]
        y = gat_sharded(pg, *ts, attn_rate=rate, attn_seed=seed, mode=mode)
        torch.sin(y).sum().backward()
        out[mode] = [_np(y)] + [_np(t.grad) for t in ts]
    return out


def sharded_gatode(rank, n_ranks, *, scale, params, hidden, heads, steps, modes, remat,
                   drop_seed):
    """Per mode: log-prob rows, all-reduced loss and parameter gradients of
    this rank (dropout 0), and log-prob rows with dropout 0.4 from
    ``drop_seed``."""
    from graph_odenet_tpu_torch.convert import params_from_sharded_gat
    from graph_odenet_tpu_torch.parallel import partition_by_receiver, sharded_gat as sg
    from graph_odenet_tpu_torch.parallel.sharded_gcn import (
        all_reduce_grads, all_reduce_sum, shard_batch,
    )

    data = _twin(scale)
    pg = partition_by_receiver(data.graph, n_ranks)
    model = sg.init_gatode_params(data.features.shape[1], hidden, heads, data.n_class)
    model.load_state_dict(params_from_sharded_gat(params))
    y1h, w = _labels_weight(data)
    total = w.sum()
    x, y1h, w = shard_batch(n_ranks, rank, data.features, y1h, w)
    out = {}
    for mode in modes:
        model.zero_grad(set_to_none=True)
        lp = sg.gatode_forward(model, pg, x, steps=steps, mode=mode, remat=remat)
        loss = -(lp * y1h).sum(-1).mul(w).sum() / total
        loss.backward()
        all_reduce_grads(model)
        with torch.no_grad():
            lp_drop = sg.gatode_forward(
                model, pg, x, steps=steps, mode=mode, dropout=0.4,
                generator=torch.Generator().manual_seed(drop_seed),
                seed_generator=torch.Generator().manual_seed(drop_seed))
        out[mode] = dict(lp=_np(lp), loss=float(all_reduce_sum(loss.detach())),
                         grads={k: _np(p.grad) for k, p in model.named_parameters()},
                         lp_drop=_np(lp_drop))
    return out


def grandnl(rank, n_ranks, *, scale, params, heads, steps, rate, drop_seed):
    """GRAND-nl from ``params`` (numpy, by name) on this rank's block: the
    log-prob rows without dropout, and with feature dropout ``rate`` from a
    CPU generator seeded ``drop_seed`` the log-prob rows, the NLL over the
    training nodes (all-reduced) and the all-reduced parameter gradients."""
    from graph_odenet_tpu_torch.parallel import partition_by_receiver
    from graph_odenet_tpu_torch.parallel.sharded_gcn import (
        all_reduce_grads, all_reduce_sum, shard_batch,
    )
    from graph_odenet_tpu_torch.parallel.sharded_grand import grandnl_forward, init_grandnl_params

    data = _twin(scale)
    pg = partition_by_receiver(data.graph, n_ranks)
    d = params["w_q"].shape[0]
    model = init_grandnl_params(data.features.shape[1], d // heads, heads, data.n_class)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    y1h, w = _labels_weight(data)
    total = w.sum()
    x, y1h, w = shard_batch(n_ranks, rank, data.features, y1h, w)
    with torch.no_grad():
        lp = grandnl_forward(model, pg, x, steps=steps)
    lp_drop = grandnl_forward(model, pg, x, steps=steps, dropout=rate,
                              generator=torch.Generator().manual_seed(drop_seed))
    loss = -(lp_drop * y1h).sum(-1).mul(w).sum() / total
    loss.backward()
    all_reduce_grads(model)
    return dict(lp=_np(lp), lp_drop=_np(lp_drop), loss=float(all_reduce_sum(loss.detach())),
                grads={k: _np(p.grad) for k, p in model.named_parameters()})


def _edge_graph(s, r, n, node_multiple):
    from graph_odenet_tpu_torch.graph import from_edges

    return from_edges(s, r, n_node=n, normalize="row", node_multiple=node_multiple)


def _rows_grad(fn, x):
    """``fn(x)`` and ``d sum(fn(x)²)/dx`` (the JAX tests' loss), as numpy."""
    x = x.clone().requires_grad_(True)
    y = fn(x)
    (y ** 2).sum().backward()
    return _np(y), _np(x.grad)


def feature_tp(rank, n_ranks, *, s, r, n, x, modes):
    """A (edge, feat) = (2, 2) mesh: this rank's block rows of its column
    slice of ``x``, through ``spmm_sharded`` with ``feat_axis``; per mode the
    output and ``d sum(out²)/dx`` slices.  Then every rank of feat coordinate
    1 passes a slice one column narrower: the error each rank raised."""
    from graph_odenet_tpu_torch.parallel import make_mesh, partition_by_receiver, spmm_sharded

    mesh = make_mesh((2, 2), ("edge", "feat"))
    pg = partition_by_receiver(_edge_graph(s, r, n, 4), mesh.size("edge"))
    b, w = pg.block_size, x.shape[1] // mesh.size("feat")
    e, f = mesh.coord("edge"), mesh.coord("feat")
    xs = torch.from_numpy(x[e * b:(e + 1) * b, f * w:(f + 1) * w])
    kw = dict(group=mesh.group("edge"), feat_axis=mesh.group("feat"))
    out = {mode: _rows_grad(lambda v: spmm_sharded(pg, v, mode=mode, **kw), xs)
           for mode in modes}
    try:
        spmm_sharded(pg, xs[:, :w - f].contiguous(), **kw)
    except ValueError as err:
        out["mismatch"] = str(err)
    return dict(out, coords=(e, f))


def data_edge(rank, n_ranks, *, s, r, n, xb, modes):
    """A (data, edge) = (2, 2) mesh: this rank's batch slice of its block's
    rows of ``xb [b, N, F]`` through ``spmm_sharded`` (``check_vma=False``, as
    the JAX test passes it); per mode the output and ``d sum(out²)/dx``."""
    from graph_odenet_tpu_torch.parallel import make_mesh, partition_by_receiver, spmm_sharded

    mesh = make_mesh((2, 2), ("data", "edge"))
    pg = partition_by_receiver(_edge_graph(s, r, n, 8), mesh.size("edge"))
    b, nb = pg.block_size, xb.shape[0] // mesh.size("data")
    d, e = mesh.coord("data"), mesh.coord("edge")
    xs = torch.from_numpy(xb[d * nb:(d + 1) * nb, e * b:(e + 1) * b])
    out = {mode: _rows_grad(lambda v: spmm_sharded(pg, v, mode=mode, group=mesh.group("edge"),
                                                   check_vma=False), xs)
           for mode in modes}
    return dict(out, coords=(d, e))


def gat_data_edge(rank, n_ranks, *, scale, inputs, rate, seed, params, hidden, heads, steps,
                  modes, drop_seed):
    """A (data, edge) = (2, 2) mesh: the GAT tier along the edge axis
    (``group=mesh.group("edge")``), data row d on d + 1 times the inputs and
    the features.  Per mode: this rank's rows of ``gat_sharded`` (attention
    dropout ``rate``) and of the gradients of ``sum(sin(out))`` w.r.t. its
    rows of ``s_src``, ``s_dst`` and ``wh``; the sharded GAT-ODE's log-prob
    rows under ``remat``, its loss and parameter gradients all-reduced over
    the edge group (dropout 0), and its log-prob rows with dropout 0.4 from
    ``drop_seed``."""
    from graph_odenet_tpu_torch.convert import params_from_sharded_gat
    from graph_odenet_tpu_torch.parallel import gat_sharded, make_mesh, partition_by_receiver
    from graph_odenet_tpu_torch.parallel import sharded_gat as sgat
    from graph_odenet_tpu_torch.parallel.sharded_gcn import (
        all_reduce_grads, all_reduce_sum, shard_batch,
    )

    mesh = make_mesh((2, 2), ("data", "edge"))
    d, e, group = mesh.coord("data"), mesh.coord("edge"), mesh.group("edge")
    n_edge = mesh.size("edge")
    data = _twin(scale)
    pg = partition_by_receiver(data.graph, n_edge)
    model = sgat.init_gatode_params(data.features.shape[1], hidden, heads, data.n_class)
    model.load_state_dict(params_from_sharded_gat(params))
    y1h, w = _labels_weight(data)
    total = w.sum()
    x, y1h, w = shard_batch(n_edge, e, data.features * (d + 1), y1h, w)
    out = {}
    for mode in modes:
        ts = [t.clone().requires_grad_(True) for t in shard_batch(
            n_edge, e, *(torch.from_numpy(a) * (d + 1) for a in inputs))]
        y = gat_sharded(pg, *ts, attn_rate=rate, attn_seed=seed, mode=mode, group=group)
        torch.sin(y).sum().backward()
        model.zero_grad(set_to_none=True)
        lp = sgat.gatode_forward(model, pg, x, steps=steps, mode=mode, remat=True, group=group)
        loss = -(lp * y1h).sum(-1).mul(w).sum() / total
        loss.backward()
        all_reduce_grads(model, group)
        with torch.no_grad():
            lp_drop = sgat.gatode_forward(
                model, pg, x, steps=steps, mode=mode, dropout=0.4, group=group,
                generator=torch.Generator().manual_seed(drop_seed),
                seed_generator=torch.Generator().manual_seed(drop_seed))
        out[mode] = dict(gat=[_np(y)] + [_np(t.grad) for t in ts], lp=_np(lp),
                         loss=float(all_reduce_sum(loss.detach(), group)),
                         grads={k: _np(p.grad) for k, p in model.named_parameters()},
                         lp_drop=_np(lp_drop))
    return dict(out, coords=(d, e))


def two_rings(rank, n_ranks, *, scale, x, params, steps):
    """Two rings of 2 ranks at once, on the subgroups {0, 1} and {2, 3}; ring
    p works on ``p + 1`` times ``x`` (and the twin's features): ``spmm_sharded``
    in every mode with ``d sum(out²)/dx``, ``all_gather_rows`` and
    ``all_reduce_sum`` of its block's row sums, and the sharded GCN-ODE's loss
    and gradients all-reduced over the ring."""
    from graph_odenet_tpu_torch.convert import params_from_sharded
    from graph_odenet_tpu_torch.parallel import make_mesh, partition_by_receiver
    from graph_odenet_tpu_torch.parallel import sharded_gcn as sg
    from graph_odenet_tpu_torch.parallel import spmm_sharded
    from graph_odenet_tpu_torch.parallel.halo import MODES, all_gather_rows

    mesh = make_mesh((2, 2), ("ring", "edge"))
    ring, group = mesh.coord("ring"), mesh.group("edge")
    data = _twin(scale)
    pg = partition_by_receiver(data.graph, mesh.size("edge"))
    me, scale_ = mesh.coord("edge"), float(ring + 1)
    (xs,) = sg.shard_batch(2, me, torch.from_numpy(x) * scale_)
    out = {mode: _rows_grad(lambda v: spmm_sharded(pg, v, mode=mode, group=group), xs)
           for mode in MODES}
    out["gathered"] = _np(all_gather_rows(xs, group))
    out["sum"] = _np(sg.all_reduce_sum(xs.sum(0), group))
    model = sg.init_params(params["w_in"].shape[0], params["w_in"].shape[1], data.n_class)
    model.load_state_dict(params_from_sharded(params))
    y1h, w = _labels_weight(data)
    xf, y1h, w = sg.shard_batch(2, me, data.features * scale_, y1h, w)
    loss = sg.loss_fn(model, pg, xf, y1h, w, steps=steps, group=group)
    loss.backward()
    sg.all_reduce_grads(model, group)
    out["loss"] = float(sg.all_reduce_sum(loss.detach(), group))
    out["grads"] = {k: _np(p.grad) for k, p in model.named_parameters()}
    return dict(out, coords=(ring, me))


def scaling(rank, n_ranks, **kw):
    """``bench.scaling_bench`` over the world."""
    from graph_odenet_tpu_torch.bench import scaling_bench

    return scaling_bench(device="cpu", **kw)


def _labels_weight(data):
    """One-hot labels (zeros on padding) and the training-node weight."""
    n_pad = data.graph.n_node_pad
    y1h = torch.nn.functional.one_hot(data.labels.clamp(min=0), data.n_class).float()
    y1h *= (data.labels >= 0)[:, None]
    w = torch.zeros(n_pad)
    w[data.idx_train] = 1.0
    return y1h, w


def train(rank, n_ranks, *, scale, cfg):
    from graph_odenet_tpu_torch.parallel import ShardedTrainConfig, fit_sharded_node_classifier

    res = fit_sharded_node_classifier(ShardedTrainConfig(**cfg), _twin(scale), device="cpu")
    res["params"] = {k: _np(v) for k, v in res["params"].items()}
    return res


def resume(rank, n_ranks, *, scale, cfg, epochs, first, ckpt_dir):
    """``epochs`` straight, then ``first`` epochs saving to ``ckpt_dir`` and a
    fresh call resuming to ``epochs``; each rank's losses and its count of
    checkpoint saves and restores."""
    from graph_odenet_tpu_torch.parallel import ShardedTrainConfig, fit_sharded_node_classifier
    from graph_odenet_tpu_torch.utils.checkpoint import Checkpointer

    data, calls = _twin(scale), {"save": 0, "restore": 0}
    real = {k: getattr(Checkpointer, k) for k in calls}

    def counted(name):
        def call(self, *args, **kw):
            calls[name] += 1
            return real[name](self, *args, **kw)
        return call

    def fit(**kw):
        return fit_sharded_node_classifier(ShardedTrainConfig(**cfg, **kw), data, device="cpu")

    straight = fit(epochs=epochs)
    for k in calls:
        setattr(Checkpointer, k, counted(k))
    try:
        fit(epochs=first, ckpt_dir=ckpt_dir, ckpt_every=1)
        resumed = fit(epochs=epochs, ckpt_dir=ckpt_dir, ckpt_every=1)
    finally:
        for k, f in real.items():
            setattr(Checkpointer, k, f)
    return dict(straight=straight["losses"], resumed=resumed["losses"],
                epochs_run=resumed["epochs_run"], **calls)


def config4_world(rank, n_ranks, *, scale, f, cfg, device):
    """The arxiv twin over the world (on ``cuda:rank`` with ``device="cuda"``):
    each mode's output rows and ``d sum(sin(Â x))/dx`` rows (error over rtol
    = atol = 1e-5 against the one-part ``spmm_csr``), then config 4's
    trainer."""
    from graph_odenet_tpu_torch.ops import csr_spmm
    from graph_odenet_tpu_torch.parallel import (
        ShardedTrainConfig, fit_sharded_node_classifier, partition_by_receiver, spmm_sharded,
    )
    from graph_odenet_tpu_torch.parallel.mesh import device_for

    dev = device_for(device, rank)
    data = _twin(scale)
    g = data.graph
    pg = partition_by_receiver(g, n_ranks).to(dev)
    x, want, up, want_dx = _whole_graph_spmm(g, f, dev)
    rows = slice(rank * pg.block_size, (rank + 1) * pg.block_size)
    errs, ms = {}, {}
    for mode in ("allgather", "ring", "ring_pallas"):
        def fwd_bwd():
            xs = x[rows].clone().requires_grad_(True)
            y = spmm_sharded(pg, xs, mode=mode)
            return y, torch.autograd.grad(y, xs, up[rows])[0]

        y, dx = fwd_bwd()
        errs[mode] = max(_over_tol(y, want[rows]), _over_tol(dx, want_dx[rows]))
        ms[mode] = _wall_ms(fwd_bwd, dev)
    csr_spmm.bucket_launches = 0
    res = fit_sharded_node_classifier(ShardedTrainConfig(**cfg), data, device=device)
    res.pop("params")
    return dict(err_over_tol=errs, spmm_fwd_bwd_ms=ms, launches=csr_spmm.bucket_launches,
                device=str(dev), **res)


def _over_tol(a, b):
    """Largest |a − b| over rtol = atol = 1e-5."""
    a, b = a.detach(), b.detach()
    return float(((a - b).abs() / (1e-5 + 1e-5 * b.abs())).max())


def _whole_graph_spmm(g, f, dev):
    """``x [N, f]`` (seed 0), ``Â x`` through the one-part ``spmm_csr`` on
    ``dev``, the upstream ``cos(Â x)`` and ``d sum(sin(Â x))/dx``."""
    from graph_odenet_tpu_torch.ops import prepare, spmm_csr

    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((g.n_node_pad, f)).astype(np.float32)).to(dev)
    xr = x.clone().requires_grad_(True)
    want = spmm_csr(prepare(g).to(dev), xr)
    up = torch.cos(want).detach()
    return x, want.detach(), up, torch.autograd.grad(want, xr, up)[0]


def feature_tp_world(rank, n_ranks, *, scale, f, device):
    """A (edge, feat) = (ranks / 2, 2) mesh on the arxiv twin (on ``cuda:rank``
    with ``device="cuda"``): per mode, this rank's slice of ``Â x`` and of ``d
    sum(sin(Â x))/dx`` as error over rtol = atol = 1e-5 against the one-part
    ``spmm_csr`` on the same device, and the ms of a fwd+bwd; B2's launches."""
    from graph_odenet_tpu_torch.ops import csr_spmm
    from graph_odenet_tpu_torch.parallel import make_mesh, partition_by_receiver, spmm_sharded
    from graph_odenet_tpu_torch.parallel.mesh import device_for

    dev = device_for(device, rank)
    mesh = make_mesh((n_ranks // 2, 2), ("edge", "feat"))
    g = _twin(scale).graph
    pg = partition_by_receiver(g, mesh.size("edge")).to(dev)
    x, want, up, want_dx = _whole_graph_spmm(g, f, dev)
    e, c, b, w = mesh.coord("edge"), mesh.coord("feat"), pg.block_size, f // 2
    part = (slice(e * b, (e + 1) * b), slice(c * w, (c + 1) * w))
    kw = dict(group=mesh.group("edge"), feat_axis=mesh.group("feat"))
    csr_spmm.bucket_launches = 0
    errs, ms = {}, {}
    for mode in ("ring", "allgather"):
        def fwd_bwd():
            xs = x[part].contiguous().requires_grad_(True)
            y = spmm_sharded(pg, xs, mode=mode, **kw)
            return y, torch.autograd.grad(y, xs, up[part].contiguous())[0]

        y, dx = fwd_bwd()
        errs[mode] = max(_over_tol(y, want[part]), _over_tol(dx, want_dx[part]))
        ms[mode] = _wall_ms(fwd_bwd, dev)
    return dict(err_over_tol=errs, spmm_fwd_bwd_ms=ms, launches=csr_spmm.bucket_launches,
                coords=(e, c), device=str(dev))


def gat_world(rank, n_ranks, *, scale, heads, feat, cfg, device):
    """The calibrated arxiv twin over the world (on ``cuda:rank`` with
    ``device="cuda"``): each ``gat_sharded`` mode's rows and the rows of the
    gradients of ``sum(sin(out))``, with attention dropout 0.4, as error over
    tolerance against one part on the same device (values rtol = atol =
    1e-5; gradients rtol 1e-4, atol 1e-4 of the largest entry), then the
    GAT-ODE trainer."""
    from graph_odenet_tpu_torch.data import synthetic_ogbn_arxiv
    from graph_odenet_tpu_torch.ops import csr_spmm
    from graph_odenet_tpu_torch.ops.sddmm import attention_aggregate, edge_scores
    from graph_odenet_tpu_torch.parallel import (
        ShardedTrainConfig, fit_sharded_node_classifier, gat_sharded, partition_by_receiver,
    )
    from graph_odenet_tpu_torch.parallel.mesh import device_for
    from graph_odenet_tpu_torch.parallel.sharded_gat import MODES

    dev = device_for(device, rank)
    data = synthetic_ogbn_arxiv(seed=0, scale=scale, calibrated=True)
    g = data.graph
    pg = partition_by_receiver(g, n_ranks).to(dev)
    rng = np.random.default_rng(0)
    inputs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
              for s in ((g.n_node_pad, heads), (g.n_node_pad, heads), (g.n_node_pad, heads, feat))]
    rows = slice(rank * pg.block_size, (rank + 1) * pg.block_size)
    kw = dict(attn_rate=0.4, attn_seed=99)

    # One part on this device: the single-device segment path over the whole graph.
    ss, sd, wh = (t.clone().requires_grad_(True) for t in inputs)
    whole = data.to(dev).graph
    want = attention_aggregate(whole, edge_scores(whole, ss, sd), wh, dropout_seed=99,
                               dropout_rate=0.4)
    want_grads = torch.autograd.grad(torch.sin(want).sum(), (ss, sd, wh))

    def over_tol(a, b, rtol, atol):
        a, b = a.detach(), b.detach()
        return float(((a - b).abs() / (atol + rtol * b.abs())).max())

    errs = {}
    for mode in MODES:
        ts = [t[rows].clone().requires_grad_(True) for t in inputs]
        y = gat_sharded(pg, *ts, mode=mode, **kw)
        torch.sin(y).sum().backward()
        errs[mode] = max(
            [over_tol(y, want[rows], 1e-5, 1e-5)]
            + [over_tol(t.grad, w[rows], 1e-4, 1e-4 * float(w.abs().max()))
               for t, w in zip(ts, want_grads)])
    del want, want_grads, whole
    csr_spmm.bucket_weighted_launches = 0
    res = fit_sharded_node_classifier(ShardedTrainConfig(**cfg), data, device=device)
    res.pop("params")
    return dict(err_over_tol=errs, launches=csr_spmm.bucket_weighted_launches, device=str(dev),
                **res)


def _wall_ms(fn, dev, iters=10):
    """Mean wall ms of ``fn()`` after one warm-up call, synchronised around the loop."""
    fn()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / iters


TASKS = {"spmm_modes": spmm_modes, "sharded_gcn": sharded_gcn, "train": train, "train_gat": train,
         "resume": resume,
         "config4_world": config4_world, "gat_modes": gat_modes, "sharded_gatode": sharded_gatode,
         "gat_world": gat_world, "feature_tp": feature_tp, "data_edge": data_edge,
         "gat_data_edge": gat_data_edge, "grandnl": grandnl,
         "two_rings": two_rings, "scaling": scaling, "feature_tp_world": feature_tp_world}
