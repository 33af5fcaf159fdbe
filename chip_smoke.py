#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Imports nothing of JAX.  Phases, one JSON line each; any failure raises,
so the exit code is non-zero:

  build      compiles every ``graph_odenet_tpu_torch/csrc/*.cu`` with nvcc
             (one process per source, all at once) into
             ``graph_odenet_tpu_torch/_build/``; the ptxas register and
             spill lines of every kernel.
  kernel     ``spmm_csr`` forward and backward on the card against the plain
             version ``spmm_csr_reference`` run in float64 on the same inputs
             (rtol = atol = 1e-5; see ``check_kernel``), on the Pubmed twin at
             F = 16 and F = 3, a
             hub graph and the bench graph (169,343 nodes, zipf(1.8)
             receivers, F = 128); ms per fwd+bwd for the kernel and for the
             plain version in float32.
  attention  the GAT kernels (gat_fwd, gat_bwd, gat_dwh and the weighted
             SpMM) against their plain versions in float64 on the same
             inputs, and the Functions' values and gradients against the
             plain path in float64 (``ATT_TOL``; see ``check_attention``),
             on the Citeseer twin (H=8/F=8 with dropout 0.6, H=1/F=64,
             H=1/F=6), two hub graphs and the bench graph; ms per fwd+bwd
             of ``attention_aggregate`` through the kernels and through the
             plain version in float32.
  slice      trains ``pubmed-gcnode`` (GCN-ODE, rk4, 200 epochs with early
             stop) on the card, checks that it went through the kernel and
             reached test accuracy >= 0.65, and holds the trained model's
             log-probs through the kernel against the segment path.
  gat_slice  trains config 2 (GAT-ODE, dopri5_scan, on the Citeseer twin) on
             the card through the GAT kernels to test accuracy >= 0.60, and
             holds the trained model's log-probs against the segment path.
  dense      one GCN-ODE fwd+bwd at Pubmed size through dense Â, the kernel
             and the segment path.
  bucket     the CSR kernel's bucket mode (B2) on the full arxiv twin
             partitioned into P = 8 (64 buckets of 21,168 rows) and P = 1:
             every bucket's forward (CSR view), backward (CSC view) and
             positional form, written into NaNs, against the plain version
             in float64 at TOL, upstream the gradient of ``sum(sin(·))``;
             each receiver block's buckets in the ring's order (the first
             written, the rest added in place), forward and backward,
             against the single-device ``spmm_csr``; ms of fwd+bwd over all
             buckets, kernel and plain version (float32) and cuSPARSE, and
             the kernel with zero-filled outputs that every bucket adds
             into (``zero_fill_add_ms``), the form without the write.
  config4    ``run_config(4)`` (edge-partitioned GCN-ODE, one part on one
             card) on the full arxiv twin through the bucket kernel, after
             one training step through the kernel held against the same step
             through the plain versions (dropout 0; ``CONFIG4_RTOL``; the
             plain sums in a fixed order, see ``fixed_order_sums``), and a
             ``torch.profiler`` breakdown of three training steps.
  library    ``torch.sparse.mm`` on a CSR tensor (cuSPARSE) for the
             function B1 and B2 compute, fwd+bwd, at the bench shape, the
             Pubmed F = 16 shape and the arxiv F = 256 shape; used nowhere
             in the port.
  bucket_weighted
             the weighted bucket mode (B2-w) on the calibrated arxiv twin:
             at P = 1 the sharded GAT-ODE's three shapes (H=4/F=64, H=1/F=256,
             H=1/F=40), forward over the CSR view and backward over the CSC
             view with the numerators permuted, written into NaNs and added
             into a random output, and at P = 8 all 64 buckets at H=4/F=64,
             each receiver block's buckets also in the ring's order, against
             the plain version in float64 at TOL.  The numerators are each
             receiver's softmax (positive, summing to 1) and the backward's
             upstream is the gradient of ``sum(sin(·))``, so the hub rows'
             sums do not cancel.  ms of fwd+bwd at P = 1 for the kernel, the
             plain version (float32) and, for H = 1, cuSPARSE on CSR tensors
             whose values are the numerators; ms of the backward's plain
             ``dpv`` gathers.
  config4_gat
             the edge-partitioned GAT-ODE (hidden 64 × 4 heads, rk4 × 4,
             dropout 0.6, ``ring_pallas``, ``remat``) on the full calibrated
             arxiv twin through ``fit_sharded_node_classifier``, 6 epochs, one
             part on one card, after one training step (dropout 0) through the
             kernel held against the same step through the plain version of
             the bucket mode and against ``mode="ring"`` (``CONFIG4_RTOL``);
             peak device memory and ms of a step with ``remat`` on and off,
             and a ``torch.profiler`` breakdown of three training steps.

Then the kernel table (each kernel's launches on its main path, error,
ms, plain ms, the bound of its work on an H100 and the library call's ms),
the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``.
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
# The GAT kernels against their plain versions in float64: 1e-5 on the
# Citeseer twin and the hub graphs.  On the bench graph 1e-4: there a row of
# the CSC view holds up to 164,913 edges, and a sum of that many random
# terms cancels to values near 1, which float32 in any order misses by more
# than 1e-5 (the plain version in float32 is reported beside the kernel).
ATT_TOL = dict(rtol=1e-5, atol=1e-5)
BENCH_ATT_TOL = dict(rtol=1e-4, atol=1e-4)
GAT_MIN_TEST_ACC = 0.60  # config 2; the JAX package reaches 0.696 ± 0.019, chance is 1/6
GAT_LAYERS = 3  # encoder, dynamics and readout: each epoch launches every kernel >= 3 times
# Config 4's one training step through the kernel against the plain versions:
# 18 aggregations of f32 sums in two orders, then gradients through all of
# them; atol is relative to each gradient's largest entry.
CONFIG4_RTOL = 1e-4
BUCKET_PARTS = (8, 1)
ARXIV_HIDDEN = 256  # config 4's width: the encoder's and the dynamics' aggregations
# The sharded GAT-ODE at full width: 4 heads of 64 in the encoder, one head of
# 256 in the dynamics, one head of 40 classes in the readout.
GAT_HIDDEN, GAT_HEADS, GAT_STEPS, GAT_EPOCHS = 64, 4, 4, 6
GAT_SHAPES = ((GAT_HEADS, GAT_HIDDEN), (1, GAT_HEADS * GAT_HIDDEN), (1, 40))
# Per training step 1 + 4·steps + 1 attention layers: each launches B2-w once
# forward and once backward, and the dynamics' layers once more when remat
# recomputes them; an evaluation runs the forward alone.
GAT_LAYERS_PER_FORWARD = 2 + 4 * GAT_STEPS
GAT_MIN_TEST_ACC_SHARDED = 2.0 / 40
# Published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM and f32 outside the
# tensor cores.  A kernel's bound is the larger of its bytes and its flops over these.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


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


def bound(n_bytes, n_flops):
    """Least ms an H100 could take for work that moves ``n_bytes`` (each
    input read once, each output written once) and does ``n_flops`` f32
    operations, and which of the two bounds it."""
    t_bytes, t_flops = n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_F32_FLOPS
    return dict(bound_ms=max(t_bytes, t_flops) * 1e3,
                bound_by="bytes" if t_bytes >= t_flops else "operations")


def spmm_work(n_rows, n_edge, f, accumulate=False):
    """(bytes, flops) of one SpMM ``out (+)= A x`` over a CSR view: x and out
    (read too when added into), int64 row pointers, int32 columns, f32 weights."""
    n_bytes = (3 if accumulate else 2) * n_rows * f * 4 + (n_rows + 1) * 8 + n_edge * 8
    return n_bytes, 2 * n_edge * f + (n_rows * f if accumulate else 0)


def weighted_bucket_work(n_rows, n_edge, h, f, accumulate=False):
    """(bytes, flops) of one weighted bucket reduction ``out (+)= A(pv) x`` at H
    = ``h``, F = ``f``: x and out (read too when added into), int64 row
    pointers, int32 columns, the f32 ``[L, H]`` numerators."""
    n_bytes = ((3 if accumulate else 2) * n_rows * h * f * 4 + (n_rows + 1) * 8 + n_edge * 4
               + n_edge * h * 4)
    return n_bytes, 2 * n_edge * h * f + (n_rows * h * f if accumulate else 0)


def attention_work(kernel, n, e, h, f):
    """(bytes, flops) of one call of a GAT kernel or the weighted SpMM on a
    graph of ``n`` padded nodes and ``e`` edges at H = ``h``, F = ``f``: each
    input read once, each output written once; the f32 operations of the
    softmax and the weighted sums (the dropout hash's integer operations not
    counted)."""
    return {
        "csr_spmm_weighted": (2 * n * h * f * 4 + (n + 1) * 8 + e * 4 + e * h * 4,
                              2 * e * h * f),
        "gat_fwd": (e * h * 4 + 2 * n * h * f * 4 + (n + 1) * 8 + e * 4 + 2 * n * h * 4,
                    e * h * (2 * f + 5)),
        "gat_bwd": (e * h * 4 + 2 * n * h * f * 4 + 3 * n * h * 4 + 2 * e * 4 + e * h * 4,
                    e * h * (2 * f + 6)),
        "gat_dwh": (4 * n * h * 4 + 2 * n * h * f * 4 + (n + 1) * 8 + e * 4,
                    e * h * (2 * f + 8)),
    }[kernel]


def bench_graph(from_edges, n_nodes=169_343, n_edges=1_166_243, seed=0, normalize="row"):
    """The graph of ``bench.py``'s ``build_graph``, built with the port."""
    rng = np.random.default_rng(seed)
    pop = rng.zipf(1.8, size=n_edges).astype(np.int64) % n_nodes
    src = rng.integers(0, n_nodes, size=n_edges)
    return from_edges(
        src, pop, n_node=n_nodes, normalize=normalize, node_multiple=128, edge_multiple=1024
    )


def hub_graph(from_edges):
    """Node 0 is cited by 1,500 random edges (as in tests/test_pallas.py)."""
    rng = np.random.default_rng(1)
    n = 200
    s = np.concatenate([rng.integers(0, n, size=1500), rng.integers(0, n, size=300)])
    r = np.concatenate([np.zeros(1500, dtype=np.int64), rng.integers(0, n, size=300)])
    return from_edges(s, r, n_node=n, normalize="row", node_multiple=128)


def phase_build():
    from graph_odenet_tpu_torch.ops import _build

    fresh = [n for n in _build.SOURCES if not _build.library_path(n).exists()]
    t0 = time.perf_counter()
    libs = _build.build()
    for name in libs:
        _build.load_library(name)
    seconds = time.perf_counter() - t0
    ptxas = {}
    for name, lib in libs.items():
        report = lib.with_name(f"{lib.stem}.ptxas.txt").read_text().splitlines()
        ptxas[name] = [
            ln.strip() for ln in report
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln
        ]
    emit("build", seconds=seconds, compiled_now=fresh,
         libraries={n: os.path.relpath(p, ROOT) for n, p in libs.items()}, ptxas=ptxas)


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
        **bound(*(2 * v for v in spmm_work(g.n_node_pad, csr.n_edge, f))),
    )
    emit("kernel", **row)
    return row


def phase_kernel(dev, pubmed_graph, bench_row):
    from graph_odenet_tpu_torch.graph import from_edges

    rows = [
        check_kernel("pubmed-twin", pubmed_graph, 16, dev, iters=200, seed=0),
        check_kernel("pubmed-twin", pubmed_graph, 3, dev, iters=200, seed=1),
        check_kernel("hub", hub_graph(from_edges), 128, dev, iters=200, seed=2),
        check_kernel("bench", bench_row, 128, dev, iters=20, seed=3),
    ]
    return rows


def split_hub_graph(from_edges, into):
    """Node 0 with 1,500 distinct in- (or out-) neighbours, unsymmetrised, so
    that its row spans several warp segments of the CSR (or CSC) view."""
    rng = np.random.default_rng(4)
    far = rng.permutation(np.arange(1, 2000))[:1500]
    s, r = (far, np.zeros_like(far)) if into else (np.zeros_like(far), far)
    return from_edges(s, r, n_node=2000, normalize=None, symmetrize=False)


def _err(a, b, tol):
    """(max abs err, max err / tolerance) of float32 ``a`` against float64 ``b``;
    a NaN in ``a`` (a row left unwritten) counts as an infinite error."""
    d = (a.double() - b).abs().nan_to_num(nan=float("inf"))
    return float(d.max()), float((d / (tol["atol"] + tol["rtol"] * b.abs())).max())


def check_attention(name, g, heads, feat, mode, dev, iters, seed, tol=ATT_TOL):
    """The GAT kernels at one shape.  ``mode``: "hint" (score hint, the
    config-2 path), "hint_hash" (plus the counter-hash dropout 0.6) or
    "mask" (no hint, an explicit [E, H] dropout mask 0.6: the weighted SpMM
    computes dWh).

    1. Each kernel's wrapper against its plain version run in float64 on
       the same inputs (upstream gradient random normal; the backward
       kernels take the forward kernel's m and l).
    2. ``attention_aggregate`` through the kernels: values and the gradient
       of ``sum(sin(out))`` w.r.t. s_src, s_dst and wh, against the plain
       path (``gat_aggregate_reference``) in float64.
    Both at ``tol``; the plain version in float32 is held to the same
    references and reported.  Then ms per fwd+bwd through the entry point,
    for the kernels and for the plain version in float32, and of each kernel
    alone; the kernel launches of the timed entry-point runs are counted.
    """
    from graph_odenet_tpu_torch.ops import csr_spmm, gat_attn, prepare
    from graph_odenet_tpu_torch.ops.dropmask import attention_dropout_scale
    from graph_odenet_tpu_torch.ops.sddmm import attention_aggregate, edge_scores

    rng = np.random.default_rng(seed)
    csr = prepare(g).to(dev)
    n, rate, drop_seed, slope = g.n_node_pad, 0.6, 1234 + seed, 0.2

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    s_src0, s_dst0 = randn(n, heads, scale=1.5), randn(n, heads, scale=1.5)
    wh0, up = randn(n, heads, feat), randn(n, heads, feat)
    drop = (drop_seed, rate) if mode == "hint_hash" else None
    dmask = (
        attention_dropout_scale(drop_seed, csr.senders, csr.receivers, heads, rate)
        if mode == "mask" else None
    )
    dd = lambda t: None if t is None else t.double()  # noqa: E731
    errs, plain_errs = {}, {}

    # 1. Kernel by kernel.
    logits = edge_scores(csr, s_src0, s_dst0, negative_slope=slope)
    out, m, l = gat_attn.gat_fwd(csr, logits, wh0, dmask=dmask, drop=drop)
    beta = (up * out).sum(-1)
    dlog, alpha_d = gat_attn.gat_bwd(
        csr, logits, wh0, up, m, l, beta, dmask=dmask, drop=drop, emit_alpha=mode == "mask"
    )
    if mode == "mask":
        alpha_csc = alpha_d.index_select(0, csr.t_perm)
        x = up.view(n, heads * feat)
        dwh = csr_spmm.csr_reduce(csr, x, transpose=True, alpha=alpha_csc, feat=feat)
        dwh_ref = csr_spmm._reduce_plain(
            csr.t_row_ptr, csr.t_receivers, None, x.double(), alpha_csc.double(), feat)
        errs["csr_spmm_weighted"] = _err(dwh, dwh_ref, tol)
        plain_errs["csr_spmm_weighted"] = _err(csr_spmm._reduce_plain(
            csr.t_row_ptr, csr.t_receivers, None, x, alpha_csc, feat), dwh_ref, tol)
    else:
        dwh = gat_attn.gat_dwh(csr, s_src0, s_dst0, m, l, up, slope, drop=drop)
        dwh_ref = gat_attn.gat_dwh_plain(
            csr, s_src0.double(), s_dst0.double(), m.double(), l.double(), up.double(), slope,
            drop=drop)
        errs["gat_dwh"] = _err(dwh, dwh_ref, tol)
        plain_errs["gat_dwh"] = _err(gat_attn.gat_dwh_plain(
            csr, s_src0, s_dst0, m, l, up, slope, drop=drop), dwh_ref, tol)
    torch.cuda.synchronize()
    ref = gat_attn.gat_fwd_plain(csr, logits.double(), wh0.double(), dmask=dmask, drop=drop)
    errs["gat_fwd"] = max((_err(a, b, tol) for a, b in zip((out, m, l), ref)), key=lambda e: e[1])
    dlog_ref, alpha_ref = gat_attn.gat_bwd_plain(
        csr, logits.double(), wh0.double(), up.double(), m.double(), l.double(), beta.double(),
        dmask=dd(dmask), drop=drop, emit_alpha=mode == "mask")
    errs["gat_bwd"] = _err(dlog, dlog_ref, tol)
    if mode == "mask":
        errs["gat_bwd"] = max(errs["gat_bwd"], _err(alpha_d, alpha_ref, tol), key=lambda e: e[1])

    # 2. The entry point, values and gradients.
    def entry(dtype, kernel):
        a, b, w = (t.to(dtype).requires_grad_(True) for t in (s_src0, s_dst0, wh0))
        lg = edge_scores(csr, a, b, negative_slope=slope)
        if kernel:
            o = attention_aggregate(
                csr, lg, w, dropout_seed=drop_seed if drop else None,
                dropout_rate=rate if drop else 0.0, dmask=dmask,
                scores=None if mode == "mask" else (a, b), negative_slope=slope)
        else:
            o = gat_attn.gat_aggregate_reference(csr, lg, w, dmask=dd(dmask), drop=drop)
        return o, a, b, w

    def probe(dtype, kernel):
        o, a, b, w = entry(dtype, kernel)
        return (o.detach(), *torch.autograd.grad(torch.sin(o).sum(), (a, b, w)))

    got = probe(torch.float32, True)
    torch.cuda.synchronize()
    want = probe(torch.float64, False)
    errs["entry"] = max((_err(x, y, tol) for x, y in zip(got, want)), key=lambda e: e[1])
    plain_errs["entry"] = max(
        (_err(x, y, tol) for x, y in zip(probe(torch.float32, False), want)), key=lambda e: e[1])
    worst = max(errs.values(), key=lambda e: e[1])
    if worst[1] > 1.0:
        raise AssertionError(f"attention {name} H={heads} F={feat} {mode}: {errs}")

    # Each kernel alone against its plain version, both in float32.
    per_kernel = {
        "gat_fwd": {
            "plain": lambda: gat_attn.gat_fwd_plain(csr, logits, wh0, dmask=dmask, drop=drop),
            "kernel": lambda: gat_attn.gat_fwd(csr, logits, wh0, dmask=dmask, drop=drop),
        },
        "gat_bwd": {
            "plain": lambda: gat_attn.gat_bwd_plain(
                csr, logits, wh0, up, m, l, beta, dmask=dmask, drop=drop,
                emit_alpha=mode == "mask"),
            "kernel": lambda: gat_attn.gat_bwd(
                csr, logits, wh0, up, m, l, beta, dmask=dmask, drop=drop,
                emit_alpha=mode == "mask"),
        },
    }
    if mode == "mask":
        per_kernel["csr_spmm_weighted"] = {
            "plain": lambda: csr_spmm._reduce_plain(
                csr.t_row_ptr, csr.t_receivers, None, x, alpha_csc, feat),
            "kernel": lambda: csr_spmm.csr_reduce(
                csr, x, transpose=True, alpha=alpha_csc, feat=feat),
        }
    else:
        per_kernel["gat_dwh"] = {
            "plain": lambda: gat_attn.gat_dwh_plain(
                csr, s_src0, s_dst0, m, l, up, slope, drop=drop),
            "kernel": lambda: gat_attn.gat_dwh(csr, s_src0, s_dst0, m, l, up, slope, drop=drop),
        }
    kernel_ms = {k: alternate(fns, iters) for k, fns in per_kernel.items()}

    def fwd_bwd(kernel):
        def run():
            o, a, b, w = entry(torch.float32, kernel)
            torch.autograd.grad(o, (a, b, w), up)
        return run

    counts = [csr_spmm.weighted_launches, dict(gat_attn.launches)]
    times = alternate({"plain": fwd_bwd(False), "kernel": fwd_bwd(True)}, iters)
    launched = {k: v - counts[1][k] for k, v in gat_attn.launches.items()}
    launched["csr_spmm_weighted"] = csr_spmm.weighted_launches - counts[0]
    row = dict(
        graph=name, n_node_pad=n, n_edge=csr.n_edge, H=heads, F=feat, mode=mode,
        max_row_edges=int(csr.row_ptr.diff().max()), max_col_edges=int(csr.t_row_ptr.diff().max()),
        tolerance=tol,
        max_abs_err={k: e[0] for k, e in errs.items()},
        max_err_over_tol={k: e[1] for k, e in errs.items()},
        plain_f32_max_err_over_tol={k: e[1] for k, e in plain_errs.items()},
        ms=times["kernel"], plain_ms=times["plain"],
        edges_per_s=csr.n_edge / (times["kernel"] * 1e-3), launches=launched,
        kernel_ms={k: t["kernel"] for k, t in kernel_ms.items()},
        kernel_plain_ms={k: t["plain"] for k, t in kernel_ms.items()},
    )
    bounds = {k: bound(*attention_work(k, n, csr.n_edge, heads, feat)) for k in kernel_ms}
    row["bound_ms"] = {k: b["bound_ms"] for k, b in bounds.items()}
    row["bound_by"] = {k: b["bound_by"] for k, b in bounds.items()}
    emit("attention", **row)
    return row


def phase_attention(dev, bench, iters=50, bench_iters=10):
    """``bench``: the bench graph with unnormalised weights (attention ignores them)."""
    from graph_odenet_tpu_torch.data import synthetic_planetoid
    from graph_odenet_tpu_torch.graph import from_edges

    cite = synthetic_planetoid("citeseer", seed=42, calibrated=True).graph
    hub_in, hub_out = split_hub_graph(from_edges, True), split_hub_graph(from_edges, False)
    return [
        check_attention("citeseer-twin", cite, 8, 8, "hint_hash", dev, iters, seed=10),
        check_attention("citeseer-twin", cite, 1, 64, "hint", dev, iters, seed=11),
        check_attention("citeseer-twin", cite, 1, 6, "hint", dev, iters, seed=12),
        check_attention("hub-receiver", hub_in, 8, 8, "hint", dev, iters, seed=13),
        check_attention("hub-sender", hub_out, 8, 8, "hint", dev, iters, seed=14),
        check_attention("bench", bench, 8, 8, "hint_hash", dev, bench_iters, 15, BENCH_ATT_TOL),
        check_attention("bench", bench, 1, 128, "hint", dev, bench_iters, 16, BENCH_ATT_TOL),
        check_attention("bench", bench, 8, 8, "mask", dev, bench_iters, 17, BENCH_ATT_TOL),
    ]


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


def phase_gat_slice(dev):
    """Config 2 through ``run_config``: GAT-ODE (dopri5_scan) on the Citeseer twin."""
    from graph_odenet_tpu_torch.configs import get_config, run_config
    from graph_odenet_tpu_torch.data import synthetic_planetoid
    from graph_odenet_tpu_torch.ops import gat_attn, prepare
    from graph_odenet_tpu_torch.train import build_model

    for k in gat_attn.launches:
        gat_attn.launches[k] = 0
    res = run_config(2, calibrated=True, device=dev)
    launches = dict(gat_attn.launches)

    epochs = res["epochs_run"]
    if res["representation"] != "kernel":
        raise AssertionError(f"config 2 took {res['representation']!r}, not the kernels")
    if min(launches.values()) < GAT_LAYERS * epochs:
        raise AssertionError(f"{launches} GAT kernel launches for {epochs} epochs")
    if not res["best"]["test_acc"] >= GAT_MIN_TEST_ACC:
        raise AssertionError(f"test accuracy {res['best']['test_acc']} < {GAT_MIN_TEST_ACC}")
    if not res["ode_stats"]["success"]:
        raise AssertionError(f"the last forward's solver failed: {res['ode_stats']}")

    # The trained model through the kernels against the plain segment path.
    _, cfg = get_config(2)
    data = synthetic_planetoid("citeseer", seed=cfg.seed, calibrated=True).to(dev)
    model = build_model(cfg, data.n_class, data.features.shape[1])
    model.load_state_dict(res["params"])
    model.to(dev).eval()
    with torch.no_grad():
        lp_kernel = model(prepare(data.graph), data.features)
        stats = dict(model.odeblock.stats)
        lp_segment = model(data.graph, data.features)
    if lp_kernel.shape != (data.graph.n_node_pad, data.n_class):
        raise AssertionError(f"log-probs of shape {tuple(lp_kernel.shape)}")
    if not torch.isfinite(lp_kernel).all():
        raise AssertionError("non-finite log-probs")
    torch.testing.assert_close(lp_kernel, lp_segment, **SLICE_TOL)

    emit(
        "gat_slice", config=res["config"], dataset=res["dataset"], best=res["best"],
        epochs_run=epochs, seconds=res["seconds"], seconds_per_epoch=res["seconds"] / epochs,
        representation=res["representation"], launches=launches,
        last_train_ode_stats=res["ode_stats"], eval_ode_stats=stats,
        nfe_per_forward=stats["nfe"],
        logprob_max_abs_diff_vs_segment=float((lp_kernel - lp_segment).abs().max()),
    )
    return launches


def bench_path_launches(dev, bench, iters=5):
    """The GAT bench's path (``attention_aggregate`` without the score hint,
    H=8/F=8, dropout mask 0.6, at the bench shape): kernel launches per run."""
    from graph_odenet_tpu_torch.ops import csr_spmm, prepare
    from graph_odenet_tpu_torch.ops.dropmask import attention_dropout_scale
    from graph_odenet_tpu_torch.ops.sddmm import attention_aggregate

    rng = np.random.default_rng(20)
    csr = prepare(bench).to(dev)
    logits = torch.from_numpy(rng.standard_normal((csr.n_edge, 8)).astype(np.float32)).to(dev)
    wh = torch.from_numpy(rng.standard_normal((bench.n_node_pad, 8, 8)).astype(np.float32)).to(dev)
    dmask = attention_dropout_scale(5, csr.senders, csr.receivers, 8, 0.6)
    csr_spmm.weighted_launches = 0
    for _ in range(iters):
        lg, w = logits.clone().requires_grad_(True), wh.clone().requires_grad_(True)
        out = attention_aggregate(csr, lg, w, dmask=dmask)
        torch.autograd.grad(out.sum(), (lg, w))
    torch.cuda.synchronize()
    return csr_spmm.weighted_launches


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


def _randn(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)


def phase_bucket(dev, graph, f=ARXIV_HIDDEN, iters=10):
    """B2 on every bucket of the arxiv twin at P = 8 and P = 1 (see the module doc)."""
    from graph_odenet_tpu_torch.ops import prepare, spmm_csr
    from graph_odenet_tpu_torch.ops.csr_spmm import _bucket_reduce_plain, bucket_reduce
    from graph_odenet_tpu_torch.parallel import partition_by_receiver

    rng = np.random.default_rng(30)
    n = graph.n_node_pad
    x = _randn(rng, (n, f), dev)
    csr = prepare(graph).to(dev)
    xr = x.clone().requires_grad_(True)
    want = spmm_csr(csr, xr)
    up = torch.cos(want).detach()  # d sum(sin(Â x)) / d(Â x)
    (want_dx,) = torch.autograd.grad(want, xr, up)
    rows = {}
    for n_parts in BUCKET_PARTS:
        t0 = time.perf_counter()
        pg = partition_by_receiver(graph, n_parts).to(dev)
        partition_s = time.perf_counter() - t0
        B = pg.block_size
        errs = []

        def check(got, ref):
            errs.append(_err(got, ref, TOL))

        def nan(dtype=torch.float32):  # the write form must write every row
            return torch.full((B, f), float("nan"), device=dev, dtype=dtype)

        out = torch.full((n, f), float("nan"), device=dev)
        for p in range(n_parts):
            for k in range(n_parts):  # the ring's order: the own block first, written
                b = (p + k) % n_parts
                bk, chunk = pg.bucket(p, b), x[b * B:(b + 1) * B]
                y = bucket_reduce(bk.fwd, chunk, nan(), accumulate=False)
                y64 = _bucket_reduce_plain(bk.fwd, chunk.double(), nan(torch.float64),
                                           accumulate=False)
                g_b = torch.cos(y64).float()  # d sum(sin(y)) / dy
                d = bucket_reduce(bk.bwd, g_b, nan(), accumulate=False)
                d64 = _bucket_reduce_plain(bk.bwd, g_b.double(), nan(torch.float64),
                                           accumulate=False)
                msgs = chunk.index_select(0, bk.fwd.col) * bk.fwd.weight[:, None]
                pos = bucket_reduce(bk.fwd, msgs, nan(), positional=True, accumulate=False)
                pos64 = _bucket_reduce_plain(bk.fwd, msgs.double(), nan(torch.float64), True,
                                             accumulate=False)
                torch.cuda.synchronize()
                check(y, y64)
                check(d, d64)
                check(pos, pos64)
                bucket_reduce(bk.fwd, chunk, out[p * B:(p + 1) * B], accumulate=k > 0)
        # The reverse ring: block b's gradient gathers bucket [p, b] of every
        # rank p, from rank b + 1 on, written first and then added into.
        dx = torch.full((n, f), float("nan"), device=dev)
        for b in range(n_parts):
            for k in range(n_parts):
                p = (b + 1 + k) % n_parts
                bucket_reduce(pg.bucket(p, b).bwd, up[p * B:(p + 1) * B], dx[b * B:(b + 1) * B],
                              accumulate=k > 0)
        torch.cuda.synchronize()
        acc_err = max(_err(out, want.detach().double(), TOL), _err(dx, want_dx.double(), TOL),
                      key=lambda e: e[1])
        worst = max(errs, key=lambda e: e[1])
        if worst[1] > 1.0 or acc_err[1] > 1.0:
            raise AssertionError(f"bucket P={n_parts}: per bucket {worst}, accumulated {acc_err}")

        def fwd_bwd(reduce, write=True):
            """Each output's first bucket writes it and the rest add; or, not
            ``write``, outputs zero-filled and every bucket adds."""
            def run():
                new = torch.empty if write else torch.zeros
                o, dxx = new(n, f, device=dev), new(n, f, device=dev)
                for p in range(n_parts):
                    for b in range(n_parts):
                        bk = pg.bucket(p, b)
                        reduce(bk.fwd, x[b * B:(b + 1) * B], o[p * B:(p + 1) * B],
                               accumulate=b > 0 or not write)
                        reduce(bk.bwd, up[p * B:(p + 1) * B], dxx[b * B:(b + 1) * B],
                               accumulate=p > 0 or not write)
            return run

        # cuSPARSE for the same buckets: A_pb x_b and A_pbᵀ g_p.
        mats = [
            [(_sparse_csr(pg.bucket(p, b).fwd), _sparse_csr(pg.bucket(p, b).bwd))
             for b in range(n_parts)] for p in range(n_parts)
        ]

        def library():
            for p in range(n_parts):
                for b in range(n_parts):
                    a, at = mats[p][b]
                    torch.sparse.mm(a, x[b * B:(b + 1) * B])
                    torch.sparse.mm(at, up[p * B:(p + 1) * B])

        times = alternate({"plain": fwd_bwd(_bucket_reduce_plain), "kernel": fwd_bwd(bucket_reduce),
                           "zero_fill_add": fwd_bwd(bucket_reduce, write=False),
                           "library": library}, iters)
        work = [spmm_work(B, int(pg.bucket_edges[p, b]), f, accumulate=acc)
                for p in range(n_parts) for b in range(n_parts) for acc in (b > 0, p > 0)]
        n_bytes, n_flops = (sum(w[i] for w in work) for i in (0, 1))  # fwd and bwd
        rows[n_parts] = dict(
            n_parts=n_parts, block_rows=B, buckets=n_parts ** 2,
            largest_bucket=int(pg.bucket_edges.max()), n_edge=graph.n_edge, F=f,
            partition_s=partition_s, max_abs_err=worst[0], max_err_over_tol=worst[1],
            accumulated_max_err_over_tol=acc_err[1],
            split_rows=sum(int(pg.bucket(p, b).fwd.part.split_row.numel())
                           for p in range(n_parts) for b in range(n_parts)),
            ms=times["kernel"], plain_ms=times["plain"], library_ms=times["library"],
            zero_fill_add_ms=times["zero_fill_add"], **bound(n_bytes, n_flops),
        )
        emit("bucket", **rows[n_parts])
    return rows


def _sparse_csr(view):
    """A ``CSRView`` as a torch CSR tensor (cuSPARSE's operand)."""
    return torch.sparse_csr_tensor(view.row_ptr, view.col.long(), view.weight,
                                   (view.n_rows, view.n_cols))


class fixed_order_sums:
    """Within the block ``index_add_`` sums in a fixed order instead of with
    atomics in the order the card schedules them.

    Config 4's encoder is ``relu(Â x W + b)`` with ``b = 0`` at the start, and
    on the arxiv twin some of those pre-activations are sums that cancel to a
    rounding residue (7e-12 at one node through the kernel, exactly 0.0 through
    the plain version in about one run in twelve).  The sign of a residue
    picks the ReLU's slope, so the plain step's gradient of ``w_in`` and
    ``b_in`` jumped between two values 1.5 tolerances apart from run to run
    while the kernel's, whose sums have one order, never moved.  A check of a
    gradient across a kink needs both sides to be a function of their
    inputs: with the order fixed the plain step is one too."""

    def __enter__(self):
        torch.use_deterministic_algorithms(True)

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(False)


def _grads_close(got, want, rtol, what):
    """``got`` against ``want`` at ``rtol``, atol relative to each gradient's
    largest entry; the worst error over tolerance of each."""
    errs = {}
    for k, g in want.items():
        atol = rtol * float(g.abs().max())
        errs[k] = float(((got[k] - g).abs() / (atol + rtol * g.abs())).max())
        torch.testing.assert_close(
            got[k], g, rtol=rtol, atol=atol,
            msg=lambda m, k=k: f"{what} {k}: {errs[k]} of the tolerance\n{m}")
    return errs


def phase_config4(dev, data):
    """Config 4 through ``run_config``; ``data`` is the same twin, for the one-step check."""
    from graph_odenet_tpu_torch.configs import get_config, run_config
    from graph_odenet_tpu_torch.ops import csr_spmm, prepare, spmm_csr_reference
    from graph_odenet_tpu_torch.parallel import partition_by_receiver, sharded_gcn, spmm_sharded

    _, cfg = get_config(4)
    # One training step (dropout 0) through the kernel and through the plain versions.
    pg = partition_by_receiver(data.graph, 1).to(dev)
    csr = prepare(data.graph).to(dev)
    model = sharded_gcn.init_params(data.features.shape[1], cfg.hidden, data.n_class,
                                    generator=torch.Generator().manual_seed(0)).to(dev)
    x, labels = data.features.to(dev), data.labels.to(dev)
    y1h = torch.nn.functional.one_hot(labels.clamp(min=0), data.n_class).float()
    w = torch.zeros(data.graph.n_node_pad, device=dev)
    w[data.idx_train.to(dev)] = 1.0

    def step(agg):
        model.zero_grad(set_to_none=True)
        lp = sharded_gcn.forward_with(model, agg, x, steps=cfg.steps, t1=cfg.t1)
        loss = -(lp * y1h).sum(-1).mul(w).sum() / w.sum()
        loss.backward()
        return loss.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}

    kernel_agg = lambda h: spmm_sharded(pg, h, mode=cfg.mode)  # noqa: E731
    before = csr_spmm.bucket_launches
    loss_k, grads_k = step(kernel_agg)
    check_launches = csr_spmm.bucket_launches - before

    def plain_agg(h):
        with fixed_order_sums():
            return spmm_csr_reference(csr, h)

    loss_p, grads_p = step(plain_agg)
    torch.cuda.synchronize()
    step_err = {"loss": float((loss_k - loss_p).abs() / loss_p.abs())}
    torch.testing.assert_close(loss_k, loss_p, rtol=CONFIG4_RTOL, atol=0.0)
    step_err.update(_grads_close(grads_k, grads_p, CONFIG4_RTOL, "config4"))
    profile = profile_steps(model, lambda: step(kernel_agg), cfg)
    del model, csr, pg

    csr_spmm.bucket_launches = 0
    res = run_config(4, device=dev)
    launches = csr_spmm.bucket_launches

    epochs = res["epochs_run"]
    if not (np.isfinite(res["loss_first"]) and np.isfinite(res["loss_final"])):
        raise AssertionError(f"config 4: non-finite loss {res}")
    if not res["loss_final"] < res["loss_first"]:
        raise AssertionError(f"config 4: the loss did not fall: {res}")
    if not res["test_acc"] > 1.0 / data.n_class:
        raise AssertionError(f"config 4: test accuracy {res['test_acc']} at chance")
    if launches < 36 * epochs:  # 18 aggregations forward and 18 backward a step
        raise AssertionError(f"config 4: {launches} bucket kernel launches for {epochs} epochs")
    emit(
        "config4", config=res["config"], dataset=res["dataset"], n_parts=res["n_parts"],
        n_node_pad=data.graph.n_node_pad, n_edge=data.graph.n_edge, hidden=cfg.hidden,
        epochs_run=epochs, best_epoch=res["best_epoch"], test_acc=res["test_acc"],
        val_acc=res["val_acc"], val_loss=res["val_loss"], loss_first=res["loss_first"],
        loss_final=res["loss_final"], step_ms=res["step_ms"], seconds=res["seconds"],
        seconds_per_epoch=res["seconds"] / epochs, launches=launches,
        one_step_check=dict(rtol=CONFIG4_RTOL, launches=check_launches, err_over_tol=step_err),
        profile=profile,
    )
    return launches


# Device kernels by what they do, matched on the kernel's name in this order.
KERNEL_KINDS = (
    ("bucket_kernel", ("segment_reduce_kernel", "split_rows_kernel", "zero_rows_kernel")),
    ("matmul", ("gemm", "cutlass", "cublas")),
    ("gather", ("indexSelect", "index_select", "gather")),
    ("segment_ops", ("scatter", "indexFuncLargeIndex", "indexFuncSmallIndex", "index_add")),
    ("reduce", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized")),
)


def kernel_kind(name):
    return next((kind for kind, keys in KERNEL_KINDS if any(k in name for k in keys)), "other")


def profile_steps(model, loss_and_grads, cfg, steps=3, top=8):
    """``torch.profiler`` over ``steps`` training steps (dropout 0, then
    Adam): wall and device-busy ms per step, the kernels that take most of
    the device time (single stream, so their times add up to busy) and the
    device time by kind of kernel (``KERNEL_KINDS``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, weight_decay=cfg.weight_decay)

    def train_step():
        loss_and_grads()
        opt.step()

    train_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            train_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # Device events only: CPU ops also carry the device time of what they launched.
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    by_kind = {}
    for e in kernels:
        kind = kernel_kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    return dict(
        steps=steps, wall_ms_per_step=wall_ms, device_busy_ms_per_step=busy_ms,
        busy_share=busy_ms / wall_ms, ms_per_step_by_kind=by_kind,
        top_kernels_ms_per_step={e.key[:90]: e.self_device_time_total / 1e3 / steps for e in top},
    )


def _softmax_numerators(rng, rows, n_rows, heads, dev):
    """Positive ``[L, H]`` weights that sum to 1 over each row's edges."""
    u = torch.from_numpy((rng.random((rows.shape[0], heads)) + 0.5).astype(np.float32)).to(dev)
    total = torch.zeros((n_rows, heads), device=dev).index_add_(0, rows, u)
    return (u / total.index_select(0, rows)).contiguous()


def phase_bucket_weighted(dev, graph, iters=10):
    """B2-w on the arxiv twin at P = 1 and P = 8 (see the module doc)."""
    from graph_odenet_tpu_torch.ops import csr_spmm
    from graph_odenet_tpu_torch.ops.csr_spmm import _bucket_reduce_plain, bucket_reduce
    from graph_odenet_tpu_torch.parallel import partition_by_receiver

    rng = np.random.default_rng(50)
    n = graph.n_node_pad
    errs = []

    def check(view, x, pv, feat, out0):
        """Write form into NaNs and add form into ``out0`` against float64."""
        f = x.shape[1]
        ref = _bucket_reduce_plain(view, x.double(), torch.empty_like(out0, dtype=torch.float64),
                                   accumulate=False, alpha=pv.double(), feat=feat)
        wrote = bucket_reduce(view, x, torch.full_like(out0, float("nan")), accumulate=False,
                              alpha=pv, feat=feat)
        added = bucket_reduce(view, x, out0.clone(), alpha=pv, feat=feat)
        torch.cuda.synchronize()
        errs.append(_err(wrote, ref, TOL))
        errs.append(_err(added, out0.double() + ref, TOL))
        assert wrote.shape == (view.n_rows, f)
        return ref

    # P = 1: the three shapes of the sharded GAT-ODE's layers.
    pg = partition_by_receiver(graph, 1).to(dev)
    bk, blk = pg.bucket(0, 0), pg.blocks[0]
    rows = {}
    for heads, feat in GAT_SHAPES:
        f = heads * feat
        x, out0 = _randn(rng, (n, f), dev), _randn(rng, (n, f), dev)
        pv = _softmax_numerators(rng, blk.receivers, n, heads, dev)
        pv_t = pv.index_select(0, bk.t_perm)
        before = len(errs)
        y64 = check(bk.fwd, x, pv, feat, out0)
        g = torch.cos(y64).float()  # d sum(sin(y)) / dy
        check(bk.bwd, g, pv_t, feat, out0)
        worst = max(errs[before:], key=lambda e: e[1])

        def fwd_bwd(reduce):
            def run():
                o, dx = torch.empty(n, f, device=dev), torch.empty(n, f, device=dev)
                reduce(bk.fwd, x, o, accumulate=False, alpha=pv, feat=feat)
                reduce(bk.bwd, g, dx, accumulate=False, alpha=pv_t, feat=feat)
            return run

        def dpv():  # the backward's plain part: gathers and a per-head dot
            prod = x.index_select(0, bk.fwd.col) * g.index_select(0, blk.receivers)
            return prod.view(-1, heads, feat).sum(-1)

        fns = {"plain": fwd_bwd(_bucket_reduce_plain), "kernel": fwd_bwd(bucket_reduce), "dpv": dpv}
        if heads == 1:  # one library call computes the same function: cuSPARSE with pv as values
            a = torch.sparse_csr_tensor(bk.fwd.row_ptr, bk.fwd.col.long(), pv[:, 0].contiguous(), (n, n))
            at = torch.sparse_csr_tensor(bk.bwd.row_ptr, bk.bwd.col.long(), pv_t[:, 0].contiguous(), (n, n))
            lib_err = max(_err(torch.sparse.mm(a, x), y64, BENCH_ATT_TOL)[1],
                          _err(torch.sparse.mm(at, g), _bucket_reduce_plain(
                              bk.bwd, g.double(), torch.empty(n, f, device=dev, dtype=torch.float64),
                              accumulate=False, alpha=pv_t.double(), feat=feat), BENCH_ATT_TOL)[1])
            fns["library"] = lambda: (torch.sparse.mm(a, x), torch.sparse.mm(at, g))
        times = alternate(fns, iters)
        work = [weighted_bucket_work(n, bk.fwd.n_edge, heads, feat)] * 2  # fwd and bwd
        rows[heads, feat] = dict(
            n_parts=1, H=heads, F=feat, n_node_pad=n, n_edge=bk.fwd.n_edge,
            max_row_edges=int(bk.fwd.row_ptr.diff().max()),
            max_col_edges=int(bk.bwd.row_ptr.diff().max()),
            split_rows=int(bk.fwd.part.split_row.numel()),
            max_abs_err=worst[0], max_err_over_tol=worst[1],
            ms=times["kernel"], plain_ms=times["plain"], dpv_plain_ms=times["dpv"],
            library_ms=times.get("library"),
            library_max_err_over_1e4=lib_err if heads == 1 else None,
            **bound(sum(w[0] for w in work), sum(w[1] for w in work)),
        )
        emit("bucket_weighted", **rows[heads, feat])
        del x, out0, pv, pv_t, y64, g

    # P = 8: every bucket, and each receiver block's buckets in the ring's order.
    heads, feat = GAT_SHAPES[0]
    f = heads * feat
    pg = partition_by_receiver(graph, 8).to(dev)
    B = pg.block_size
    x, up = _randn(rng, (n, f), dev), _randn(rng, (n, f), dev)
    before, launched = len(errs), csr_spmm.bucket_weighted_launches
    ring_errs = []
    for p in range(8):
        blk = pg.blocks[p]
        pv = _softmax_numerators(rng, blk.receivers, B, heads, dev)
        out = torch.full((B, f), float("nan"), device=dev)
        ref = torch.zeros((B, f), device=dev, dtype=torch.float64)
        for k in range(8):
            b = (p + k) % 8
            bucket, chunk, pv_b = pg.bucket(p, b), x[b * B:(b + 1) * B], pv[blk.bucket(b)]
            y64 = check(bucket.fwd, chunk, pv_b, feat, up[p * B:(p + 1) * B])
            ref += y64
            check(bucket.bwd, torch.cos(y64).float(), pv_b.index_select(0, bucket.t_perm), feat,
                  chunk)
            bucket_reduce(bucket.fwd, chunk, out, accumulate=k > 0, alpha=pv_b, feat=feat)
        torch.cuda.synchronize()
        ring_errs.append(_err(out, ref, TOL))
    worst, ring = max(errs[before:], key=lambda e: e[1]), max(ring_errs, key=lambda e: e[1])
    rows["P8"] = dict(
        n_parts=8, H=heads, F=feat, buckets=64, block_rows=B,
        largest_bucket=int(pg.bucket_edges.max()), smallest_bucket=int(pg.bucket_edges.min()),
        launches=csr_spmm.bucket_weighted_launches - launched,
        max_abs_err=worst[0], max_err_over_tol=worst[1], ring_order_max_err_over_tol=ring[1],
    )
    emit("bucket_weighted", **rows["P8"])
    bad = max(errs, key=lambda e: e[1])
    if bad[1] > 1.0 or ring[1] > 1.0:
        raise AssertionError(f"bucket_weighted: worst {bad}, ring order {ring}")
    return rows


class plain_bucket_mode:
    """Within the block, ``parallel.halo`` reduces every bucket with the bucket
    mode's plain version instead of the kernel: the yardstick of a whole step."""

    def __enter__(self):
        from graph_odenet_tpu_torch.ops.csr_spmm import _bucket_reduce_plain
        from graph_odenet_tpu_torch.parallel import halo

        self.halo, self.kernel = halo, halo.bucket_reduce
        halo.bucket_reduce = lambda view, x, out, **kw: _bucket_reduce_plain(view, x, out, **kw)

    def __exit__(self, *exc):
        self.halo.bucket_reduce = self.kernel


def phase_config4_gat(dev, data):
    """The sharded GAT-ODE at full width through the trainer (see the module doc)."""
    from graph_odenet_tpu_torch.ops import csr_spmm
    from graph_odenet_tpu_torch.parallel import (
        ShardedTrainConfig, fit_sharded_node_classifier, partition_by_receiver, sharded_gat,
    )

    cfg = ShardedTrainConfig(
        model="gatode", hidden=GAT_HIDDEN, heads=GAT_HEADS, steps=GAT_STEPS, dropout=0.6, lr=0.01,
        weight_decay=5e-4, mode="ring_pallas", remat=True, epochs=GAT_EPOCHS)
    pg = partition_by_receiver(data.graph, 1).to(dev)
    model = sharded_gat.init_gatode_params(
        data.features.shape[1], cfg.hidden, cfg.heads, data.n_class,
        generator=torch.Generator().manual_seed(0)).to(dev)
    x, labels = data.features.to(dev), data.labels.to(dev)
    y1h = torch.nn.functional.one_hot(labels.clamp(min=0), data.n_class).float()
    w = torch.zeros(data.graph.n_node_pad, device=dev)
    w[data.idx_train.to(dev)] = 1.0

    def step(mode="ring_pallas", remat=True):
        model.zero_grad(set_to_none=True)
        lp = sharded_gat.gatode_forward(model, pg, x, steps=cfg.steps, t1=cfg.t1, mode=mode,
                                        remat=remat)
        loss = -(lp * y1h).sum(-1).mul(w).sum() / w.sum()
        loss.backward()
        return loss.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}

    # One training step (dropout 0): the kernel against the bucket mode's plain
    # version, and against the ring of online-softmax updates (no kernel).
    before = csr_spmm.bucket_weighted_launches
    loss_k, grads_k = step()
    check_launches = csr_spmm.bucket_weighted_launches - before
    with plain_bucket_mode():
        loss_p, grads_p = step()
    loss_r, grads_r = step(mode="ring")
    torch.cuda.synchronize()
    if csr_spmm.bucket_weighted_launches - before != check_launches:
        raise AssertionError("the plain step or the ring step launched the kernel")
    step_err = {}
    for name, loss, grads in (("plain", loss_p, grads_p), ("ring", loss_r, grads_r)):
        torch.testing.assert_close(loss_k, loss, rtol=CONFIG4_RTOL, atol=0.0, msg=name)
        step_err[name] = {"loss": float((loss_k - loss).abs() / loss.abs()),
                          **_grads_close(grads_k, grads, CONFIG4_RTOL, f"config4_gat {name}")}
    del grads_k, grads_p, grads_r

    # Peak device memory and ms of one step with and without remat; remat is
    # needed where the step without it does not fit the card.
    peak = {}
    for remat in (True, False):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        step(remat=remat)
        torch.cuda.synchronize()
        peak["remat" if remat else "no_remat"] = dict(
            resident_gb=resident / 1e9, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    card_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    peak.update(card_gb=card_gb, remat_needed=peak["no_remat"]["peak_gb"] > card_gb)
    remat_ms = alternate({"remat": lambda: step(remat=True),
                          "no_remat": lambda: step(remat=False)}, iters=2)
    profile = profile_steps(model, step, cfg, top=12)
    del model, pg, x, y1h, w

    csr_spmm.bucket_weighted_launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = fit_sharded_node_classifier(cfg, data)
    launches = csr_spmm.bucket_weighted_launches
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9

    epochs = res["epochs_run"]
    evals = len([e for e in range(epochs) if e % 5 == 0 or e == epochs - 1])
    per_step = 2 * GAT_LAYERS_PER_FORWARD + 4 * GAT_STEPS  # forward, backward, remat's recompute
    want = epochs * per_step + evals * GAT_LAYERS_PER_FORWARD
    if not (np.isfinite(res["loss_first"]) and np.isfinite(res["loss_final"])):
        raise AssertionError(f"config4_gat: non-finite loss {res}")
    if not res["loss_final"] < res["loss_first"]:
        raise AssertionError(f"config4_gat: the loss did not fall: {res}")
    if not res["test_acc"] > GAT_MIN_TEST_ACC_SHARDED:
        raise AssertionError(f"config4_gat: test accuracy {res['test_acc']} <= {GAT_MIN_TEST_ACC_SHARDED}")
    if launches != want or check_launches != per_step:
        raise AssertionError(
            f"config4_gat: {launches} B2-w launches for {epochs} epochs and {evals} evaluations "
            f"(expected {want}); {check_launches} in the checked step (expected {per_step})")
    emit(
        "config4_gat", model=cfg.model, hidden=cfg.hidden, heads=cfg.heads, steps=cfg.steps,
        mode=cfg.mode, remat=cfg.remat, dropout=cfg.dropout, n_parts=res["n_parts"],
        n_node_pad=data.graph.n_node_pad, n_edge=data.graph.n_edge, epochs_run=epochs,
        best_epoch=res["best_epoch"], test_acc=res["test_acc"], val_acc=res["val_acc"],
        val_loss=res["val_loss"], loss_first=res["loss_first"], loss_final=res["loss_final"],
        step_ms=res["step_ms"], seconds=res["seconds"], seconds_per_epoch=res["seconds"] / epochs,
        launches=launches, launches_per_step=per_step, train_peak_gb=train_peak_gb,
        one_step_check=dict(rtol=CONFIG4_RTOL, launches=check_launches, err_over_tol=step_err),
        step_peak_memory=peak, fwd_bwd_ms=remat_ms, profile=profile,
    )
    return launches


def phase_library(dev, graphs, iters=20):
    """cuSPARSE (``torch.sparse.mm`` on CSR tensors) for ``Â x`` and ``Âᵀ g``:
    ms per fwd+bwd at each ``(name, graph, F)``, checked against ``spmm_csr``."""
    from graph_odenet_tpu_torch.ops import prepare, spmm_csr

    rng = np.random.default_rng(40)
    out = {}
    for name, g, f in graphs:
        csr = prepare(g).to(dev)
        a = torch.sparse_csr_tensor(csr.row_ptr, csr.senders.long(), csr.weight,
                                    (g.n_node_pad, g.n_node_pad))
        at = torch.sparse_csr_tensor(csr.t_row_ptr, csr.t_receivers.long(), csr.t_weight,
                                     (g.n_node_pad, g.n_node_pad))
        x, up = _randn(rng, (g.n_node_pad, f), dev), _randn(rng, (g.n_node_pad, f), dev)
        xr = x.clone().requires_grad_(True)
        y = spmm_csr(csr, xr)
        (dx,) = torch.autograd.grad(y, xr, up)
        err = max(_err(torch.sparse.mm(a, x), y.detach().double(), BENCH_ATT_TOL),
                  _err(torch.sparse.mm(at, up), dx.double(), BENCH_ATT_TOL), key=lambda e: e[1])
        ms = timed_ms(lambda: (torch.sparse.mm(a, x), torch.sparse.mm(at, up)), iters)
        out[name] = dict(graph=name, n_node_pad=g.n_node_pad, n_edge=csr.n_edge, F=f,
                         ms=ms, max_err_over_tol_vs_kernel=err[1])
    emit("library", what="torch.sparse.mm fwd+bwd (cuSPARSE)", shapes=list(out.values()))
    return out


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from graph_odenet_tpu_torch.configs import get_config
    from graph_odenet_tpu_torch.data import synthetic_ogbn_arxiv, synthetic_planetoid
    from graph_odenet_tpu_torch.graph import from_edges

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    emit("device", torch=torch.__version__, cuda=torch.version.cuda, card=card)

    times = {}

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        times[phase] = time.perf_counter() - t0
        return out

    timed("build", phase_build)
    _, cfg = get_config("pubmed-gcnode")
    data = synthetic_planetoid("pubmed", seed=cfg.seed, calibrated=True).to(dev)
    bench_row = bench_graph(from_edges)
    rows = timed("kernel", phase_kernel, dev, data.graph, bench_row)
    bench = bench_graph(from_edges, normalize=None)
    att = timed("attention", phase_attention, dev, bench)
    launches = timed("slice", phase_slice, dev, data)
    gat_launches = timed("gat_slice", phase_gat_slice, dev)
    weighted = timed("bench_path", bench_path_launches, dev, bench)
    if weighted < 5:
        raise AssertionError(f"{weighted} weighted SpMM launches on the GAT bench path")
    timed("dense", phase_dense, dev, data)
    arxiv = synthetic_ogbn_arxiv(seed=0)  # run_config(4)'s twin
    buckets = timed("bucket", phase_bucket, dev, arxiv.graph)
    bucket_launches = timed("config4", phase_config4, dev, arxiv)
    library = timed("library", phase_library, dev, [
        ("bench", bench_row, 128), ("pubmed-twin", data.graph, 16),
        ("arxiv-twin", arxiv.graph, ARXIV_HIDDEN),
    ])
    del arxiv
    arxiv_cal = synthetic_ogbn_arxiv(seed=0, calibrated=True)  # the sharded GAT-ODE's twin
    weighted_buckets = timed("bucket_weighted", phase_bucket_weighted, dev, arxiv_cal.graph)
    gat_bucket_launches = timed("config4_gat", phase_config4_gat, dev, arxiv_cal)
    emit("seconds", **times)

    def att_entry(kernel, source, replaces, row, launched):
        checked = [r for r in att if kernel in r["max_abs_err"]]
        h, f = row["H"], row["F"]
        # Worst error over tolerance of all shapes, each at its own tolerance.
        return {
            "name": kernel, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launched,
            "max_abs_err": max(r["max_abs_err"][kernel] for r in checked),
            "max_err_over_tol": max(r["max_err_over_tol"][kernel] for r in checked),
            "tolerance": "rtol=atol=1e-5 against the plain version in float64 "
                         "(1e-4 on the bench graph)",
            "ms": row["kernel_ms"][kernel], "plain_ms": row["kernel_plain_ms"][kernel],
            "bound_ms": row["bound_ms"][kernel], "bound_by": row["bound_by"][kernel],
            "library_ms": None,
            "shape": f"{row['graph']}, H={h}, F={f}, {row['mode']}, one call",
        }

    main_row = rows[0]  # the slice's shape: Pubmed twin, F = 16
    cite_row, mask_row = att[0], att[7]  # config 2's encoder shape; the bench's no-hint shape
    dyn_row = weighted_buckets[GAT_SHAPES[1]]  # the sharded GAT-ODE's dynamics: H = 1, F = 256
    gat_src = "graph_odenet_tpu_torch/csrc/gat_attn.cu"
    spmm_src = "graph_odenet_tpu_torch/csrc/csr_spmm.cu"
    print(json.dumps({"kernels": [
        {
            "name": "csr_spmm",
            "route": "cuda",
            "source": spmm_src,
            "replaces": "graph_odenet_tpu/ops/pallas_spmm.py:479",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_err_over_tol": max(r["max_err_over_tol"] for r in rows),
            "tolerance": "rtol=atol=1e-5 against the plain version in float64",
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": library["pubmed-twin"]["ms"],
            "shape": "Pubmed twin, F=16, fwd+bwd",
        },
        {
            "name": "csr_spmm_bucket",
            "route": "cuda",
            "source": spmm_src,
            "replaces": "graph_odenet_tpu/ops/pallas_spmm.py:227",
            "launches": bucket_launches,
            "max_abs_err": max(r["max_abs_err"] for r in buckets.values()),
            "max_err_over_tol": max(max(r["max_err_over_tol"], r["accumulated_max_err_over_tol"])
                                    for r in buckets.values()),
            "tolerance": "rtol=atol=1e-5 against the plain version in float64, every bucket "
                         "at P=8 and P=1; accumulated blocks against spmm_csr",
            "ms": buckets[1]["ms"],
            "plain_ms": buckets[1]["plain_ms"],
            "bound_ms": buckets[1]["bound_ms"],
            "bound_by": buckets[1]["bound_by"],
            "library_ms": buckets[1]["library_ms"],
            "shape": f"arxiv twin, P=1 (config 4 on one card), F={ARXIV_HIDDEN}, fwd+bwd",
        },
        {
            "name": "csr_spmm_bucket_weighted",
            "route": "cuda",
            "source": spmm_src,
            "replaces": "graph_odenet_tpu/ops/pallas_spmm.py:227",
            "via": "weighted, graph_odenet_tpu/parallel/halo.py:147",
            "launches": gat_bucket_launches,
            "max_abs_err": max(r["max_abs_err"] for r in weighted_buckets.values()),
            "max_err_over_tol": max(
                max(r["max_err_over_tol"], r.get("ring_order_max_err_over_tol", 0.0))
                for r in weighted_buckets.values()),
            "tolerance": "rtol=atol=1e-5 against the plain version in float64: three shapes at "
                         "P=1, every bucket at P=8, written and added, CSR and CSC",
            "ms": dyn_row["ms"],
            "plain_ms": dyn_row["plain_ms"],
            "bound_ms": dyn_row["bound_ms"],
            "bound_by": dyn_row["bound_by"],
            "library_ms": dyn_row["library_ms"],
            "shape": "calibrated arxiv twin, P=1, H=1, F=256 (the dynamics' layers, 16 of the "
                     "18 of a forward), fwd+bwd",
            "other_shapes": {f"H={h},F={f}": {k: weighted_buckets[h, f][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "dpv_plain_ms")}
                for h, f in GAT_SHAPES},
        },
        att_entry("csr_spmm_weighted", spmm_src, "graph_odenet_tpu/ops/pallas_spmm.py:479",
                  mask_row, weighted),
        att_entry("gat_fwd", gat_src, "graph_odenet_tpu/ops/pallas_gat.py:206",
                  cite_row, gat_launches["gat_fwd"]),
        att_entry("gat_bwd", gat_src, "graph_odenet_tpu/ops/pallas_gat.py:890",
                  cite_row, gat_launches["gat_bwd"]),
        att_entry("gat_dwh", gat_src, "graph_odenet_tpu/ops/pallas_spmm.py:736",
                  cite_row, gat_launches["gat_dwh"]),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
