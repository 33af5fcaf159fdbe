#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Imports nothing of JAX.  Phases, one JSON line each; any failure raises,
so the exit code is non-zero:

  build    compiles ``graph_odenet_tpu_torch/csrc/csr_spmm.cu`` with nvcc
           into ``graph_odenet_tpu_torch/_build/``.
  kernel   ``spmm_csr`` forward and backward on the card against the plain
           version ``spmm_csr_reference`` run in float64 on the same inputs
           (rtol = atol = 1e-5; see ``check_kernel``), on the Pubmed twin at
           F = 16 and F = 3, a
           hub graph and the bench graph (169,343 nodes, zipf(1.8)
           receivers, F = 128); ms per fwd+bwd for the kernel and for the
           plain version in float32.
  slice    trains ``pubmed-gcnode`` (GCN-ODE, rk4, 200 epochs with early
           stop) on the card, checks that it went through the kernel and
           reached test accuracy >= 0.65, and holds the trained model's
           log-probs through the kernel against the segment path.
  dense    one GCN-ODE fwd+bwd at Pubmed size through dense Â, the kernel
           and the segment path.

Then the kernel table, the card's name and power limit, and as the last
line ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = dict(rtol=1e-5, atol=1e-5)
# The slice's log-probs pass through 18 aggregations, each summed in a
# different order by the kernel and by the segment path.
SLICE_TOL = dict(rtol=1e-4, atol=1e-4)
MIN_TEST_ACC = 0.65
SPMM_PER_EPOCH = 54  # 18 forward + 18 backward in training, 18 in evaluation


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def timed_ms(fn, iters):
    """Mean wall ms of ``fn()`` over ``iters`` calls, synchronised around the loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def alternate(fns, iters):
    """Time each of ``fns`` in the order a, b, b, a and average the two runs."""
    names = list(fns)
    runs = {n: [] for n in names}
    for n in names + names[::-1]:
        runs[n].append(timed_ms(fns[n], iters))
    return {n: sum(v) / len(v) for n, v in runs.items()}


def bench_graph(from_edges, n_nodes=169_343, n_edges=1_166_243, seed=0):
    """The graph of ``bench.py``'s ``build_graph``, built with the port."""
    rng = np.random.default_rng(seed)
    pop = rng.zipf(1.8, size=n_edges).astype(np.int64) % n_nodes
    src = rng.integers(0, n_nodes, size=n_edges)
    return from_edges(src, pop, n_node=n_nodes, normalize="row", node_multiple=128, edge_multiple=1024)


def hub_graph(from_edges):
    """Node 0 is cited by 1,500 random edges (as in tests/test_pallas.py)."""
    rng = np.random.default_rng(1)
    n = 200
    s = np.concatenate([rng.integers(0, n, size=1500), rng.integers(0, n, size=300)])
    r = np.concatenate([np.zeros(1500, dtype=np.int64), rng.integers(0, n, size=300)])
    return from_edges(s, r, n_node=n, normalize="row", node_multiple=128)


def phase_build():
    from graph_odenet_tpu_torch.ops import _build

    fresh = not _build.library_path().exists()
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    seconds = time.perf_counter() - t0
    report = lib.with_name(f"{lib.stem}.ptxas.txt")
    regs = [ln.strip() for ln in report.read_text().splitlines() if "registers" in ln or "spill" in ln]
    emit("build", seconds=seconds, compiled_now=fresh, library=os.path.relpath(lib, ROOT), ptxas=regs)


def check_kernel(name, g, f, dev, iters, seed):
    """Kernel vs plain version at one shape.

    Checked at TOL against the plain version in float64: the values and the
    gradient of ``sum(sin(spmm(x)))``, the probe of the CPU parity tests.
    Reported, not checked: the error of the gradient for a random normal
    upstream, for the kernel and for the plain version in float32.  On a
    hub row of the bench graph such a sum cancels from tens of thousands of
    terms to a value near 1, and f32 rounding in any order exceeds 1e-5.
    """
    from graph_odenet_tpu_torch.ops import prepare, spmm_csr, spmm_csr_reference

    rng = np.random.default_rng(seed)
    csr = prepare(g).to(dev)
    x0 = torch.from_numpy(rng.standard_normal((g.n_node_pad, f)).astype(np.float32)).to(dev)
    up = torch.from_numpy(rng.standard_normal((g.n_node_pad, f)).astype(np.float32)).to(dev)

    def sin_probe(fn, dtype):
        x = x0.to(dtype).requires_grad_(True)
        out = fn(csr, x)
        (dx,) = torch.autograd.grad(torch.sin(out).sum(), x)
        return out.detach(), dx

    def fwd_bwd(fn, dtype=torch.float32):
        x = x0.to(dtype).requires_grad_(True)
        return torch.autograd.grad(fn(csr, x), x, up.to(dtype))[0]

    def max_err(a, b):
        return float((a.double() - b).abs().max())

    def err_over_tol(a, b):  # <= 1 where assert_close passes
        return float(((a.double() - b).abs() / (TOL["atol"] + TOL["rtol"] * b.abs())).max())

    out, dx = sin_probe(spmm_csr, torch.float32)
    torch.cuda.synchronize()
    ref, dref = sin_probe(spmm_csr_reference, torch.float64)
    torch.testing.assert_close(out, ref.float(), **TOL)
    torch.testing.assert_close(dx, dref.float(), **TOL)
    stress_ref = fwd_bwd(spmm_csr_reference, torch.float64)
    times = alternate({
        "plain": lambda: fwd_bwd(spmm_csr_reference),
        "kernel": lambda: fwd_bwd(spmm_csr),
    }, iters)
    row = dict(
        graph=name, n_node_pad=g.n_node_pad, n_edge=g.n_edge, F=f,
        max_abs_err=max(max_err(out, ref), max_err(dx, dref)),
        max_err_over_tol=max(err_over_tol(out, ref), err_over_tol(dx, dref)),
        stress_bwd_max_abs_err=max_err(fwd_bwd(spmm_csr), stress_ref),
        plain_f32_stress_bwd_max_abs_err=max_err(fwd_bwd(spmm_csr_reference), stress_ref),
        ms=times["kernel"], plain_ms=times["plain"],
        max_row_edges=int(csr.row_ptr.diff().max()), split_rows=int(csr.part.split_row.numel()),
    )
    emit("kernel", **row)
    return row


def phase_kernel(dev, pubmed_graph):
    from graph_odenet_tpu_torch.graph import from_edges

    rows = [
        check_kernel("pubmed-twin", pubmed_graph, 16, dev, iters=200, seed=0),
        check_kernel("pubmed-twin", pubmed_graph, 3, dev, iters=200, seed=1),
        check_kernel("hub", hub_graph(from_edges), 128, dev, iters=200, seed=2),
        check_kernel("bench", bench_graph(from_edges), 128, dev, iters=20, seed=3),
    ]
    return rows


def phase_slice(dev, data):
    """Train through ``run_config``; ``data`` is the same twin, for the checks."""
    from graph_odenet_tpu_torch.configs import get_config, run_config
    from graph_odenet_tpu_torch.ops import csr_spmm, prepare
    from graph_odenet_tpu_torch.train import build_model

    csr_spmm.launches = 0
    res = run_config("pubmed-gcnode", calibrated=True, device=dev)
    launches = csr_spmm.launches

    if res["representation"] != "kernel":
        raise AssertionError(f"pubmed-gcnode took {res['representation']!r}, not the kernel")
    if launches < SPMM_PER_EPOCH * res["epochs_run"]:
        raise AssertionError(f"{launches} kernel launches for {res['epochs_run']} epochs")
    if not res["best"]["test_acc"] >= MIN_TEST_ACC:
        raise AssertionError(f"test accuracy {res['best']['test_acc']} < {MIN_TEST_ACC}")

    # The trained model through the kernel against the plain segment path.
    _, cfg = get_config("pubmed-gcnode")
    model = build_model(cfg, data.n_class, data.features.shape[1])
    model.load_state_dict(res["params"])
    model.to(dev).eval()
    with torch.no_grad():
        lp_kernel = model(prepare(data.graph), data.features)
        lp_segment = model(data.graph, data.features)
    if lp_kernel.shape != (data.graph.n_node_pad, data.n_class):
        raise AssertionError(f"log-probs of shape {tuple(lp_kernel.shape)}")
    if not torch.isfinite(lp_kernel).all():
        raise AssertionError("non-finite log-probs")
    torch.testing.assert_close(lp_kernel, lp_segment, **SLICE_TOL)

    emit(
        "slice", config=res["config"], dataset=res["dataset"], best=res["best"],
        epochs_run=res["epochs_run"], seconds=res["seconds"],
        seconds_per_epoch=res["seconds"] / res["epochs_run"],
        representation=res["representation"], launches=launches,
        logprob_max_abs_diff_vs_segment=float((lp_kernel - lp_segment).abs().max()),
    )
    return launches


def phase_dense(dev, data):
    from graph_odenet_tpu_torch.configs import get_config
    from graph_odenet_tpu_torch.ops import prepare
    from graph_odenet_tpu_torch.train import build_model
    from graph_odenet_tpu_torch.utils.metrics import masked_nll

    _, cfg = get_config("pubmed-gcnode")
    gen = torch.Generator().manual_seed(cfg.seed)
    model = build_model(cfg, data.n_class, data.features.shape[1], generator=gen).to(dev)
    drop = torch.Generator(device=dev).manual_seed(cfg.seed)
    adjs = {"dense": data.dense_adj(), "kernel": prepare(data.graph), "segment": data.graph}

    def step(adj):
        def run():
            out = model(adj, data.features, deterministic=False, generator=drop)
            loss = masked_nll(out, data.labels, data.idx_train)
            return torch.autograd.grad(loss, list(model.parameters()))
        return run

    times = alternate({k: step(a) for k, a in adjs.items()}, iters=20)
    emit(
        "dense", n_node_pad=data.graph.n_node_pad, what="GCN-ODE fwd+bwd ms",
        dense_ms=times["dense"], kernel_ms=times["kernel"], segment_ms=times["segment"],
    )


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from graph_odenet_tpu_torch.configs import get_config
    from graph_odenet_tpu_torch.data import synthetic_planetoid

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    emit("device", torch=torch.__version__, cuda=torch.version.cuda, card=card)

    phase_build()
    _, cfg = get_config("pubmed-gcnode")
    data = synthetic_planetoid("pubmed", seed=cfg.seed, calibrated=True).to(dev)
    rows = phase_kernel(dev, data.graph)
    launches = phase_slice(dev, data)
    phase_dense(dev, data)

    main_row = rows[0]  # the slice's shape: Pubmed twin, F = 16
    print(json.dumps({"kernels": [{
        "name": "csr_spmm",
        "route": "cuda",
        "source": "graph_odenet_tpu_torch/csrc/csr_spmm.cu",
        "replaces": "graph_odenet_tpu/ops/pallas_spmm.py:479",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_err_over_tol": max(r["max_err_over_tol"] for r in rows),
        "tolerance": "rtol=atol=1e-5 against the plain version in float64",
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "shape": "Pubmed twin, F=16, fwd+bwd",
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
