#!/usr/bin/env python3
"""The kernels' rows (B1, B2, B2-w, B3–B5) of several package trees, in turns.

    python3 chip_ab.py TREE ... [--out FILE]

Each TREE is the root of a checkout whose ``graph_odenet_tpu_torch`` is built
from its own sources and measured in a process of its own.  The trees run
one after another in the order given, so that two versions alternate on one
card (parent, change, change, parent).  A turn runs this checkout's
``chip_smoke.py`` phases ``kernel`` (B1), ``bucket`` (B2),
``bucket_weighted`` (B2-w; both with the footprint probe and, at the cells'
F = 256 shapes, the SHA-256 of each call's output, compared across the
turns), ``softmax_passes`` (``gather_rows`` and
``segment_max`` beside ``index_select`` and ``scatter_reduce``, in a tree
that has them) and ``attention`` (B3 ``gat_dwh``, B4 ``gat_fwd``, B5
``gat_bwd`` and B1-w: ms, plain ms, bound, and host µs, device µs, device
launches and share of bound (bound / device time) per call at each shape)
with the tree's package, then, end
to end, ``pubmed-gcnode``'s s/epoch, config 2's s/epoch (GAT-ODE on the
Citeseer twin) and config 4's ``step_ms`` on one card through
``run_config``, each with its test accuracy.  Each turn prints its phases' lines and one JSON line of its
rows; ``--out`` also writes those to FILE.  Then one line per row compares
the turns.  Needs one CUDA card.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def turn(tree):
    """Every row, measured with the package of ``tree``."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from graph_odenet_tpu_torch.configs import get_config, run_config
    from graph_odenet_tpu_torch.data import synthetic_ogbn_arxiv, synthetic_planetoid
    from graph_odenet_tpu_torch.graph import from_edges
    from graph_odenet_tpu_torch.ops import csr_spmm

    if not csr_spmm.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {csr_spmm.__file__}, not the package of {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smoke.phase_build()
    _, cfg = get_config("pubmed-gcnode")
    pubmed = synthetic_planetoid("pubmed", seed=cfg.seed, calibrated=True).graph
    rows = {f"B1 {r['graph']} F={r['F']}": r
            for r in smoke.phase_kernel(dev, pubmed, smoke.bench_graph(from_edges))}
    for p, r in smoke.phase_bucket(dev, synthetic_ogbn_arxiv(seed=0).graph).items():
        rows[f"B2 arxiv P={p}"] = r
    arxiv_cal = synthetic_ogbn_arxiv(seed=0, calibrated=True).graph
    weighted = smoke.phase_bucket_weighted(dev, arxiv_cal)
    for (h, f), r in ((k, r) for k, r in weighted.items() if k != "P8"):
        rows[f"B2-w calibrated arxiv P=1 H={h} F={f}"] = r
    if hasattr(csr_spmm, "gather_rows"):  # a tree without the softmax's kernels has no such rows
        rows.update(smoke.phase_softmax_passes(dev, arxiv_cal))
    names = {"gat_fwd": "B4", "gat_bwd": "B5", "gat_dwh": "B3", "csr_spmm_weighted": "B1-w"}
    for r in smoke.phase_attention(dev, smoke.bench_graph(from_edges, normalize=None)):
        for k, ms in r["kernel_ms"].items():
            c = r["call_costs"][k]
            rows[f"{names[k]} {k} {r['graph']} H={r['H']} F={r['F']} {r['mode']}"] = dict(
                ms=ms, plain_ms=r["kernel_plain_ms"][k], bound_ms=r["bound_ms"][k],
                host_us=c["host_us"], wall_us=c["wall_us"], device_us=c["device_us"],
                launches_per_call=c["launches_per_call"], kernels=c["kernels"],
                share_of_bound=(r["bound_ms"][k] * 1e3 / c["device_us"] if c["device_us"]
                                else float("nan")))
    res = run_config("pubmed-gcnode", calibrated=True, device=dev)
    e2e = {"pubmed-gcnode s/epoch": res["seconds"] / res["epochs_run"],
           "pubmed-gcnode test_acc": res["best"]["test_acc"]}
    res = run_config(2, calibrated=True, device=dev)
    e2e.update({"config2 s/epoch": res["seconds"] / res["epochs_run"],
                "config2 test_acc": res["best"]["test_acc"]})
    res = run_config(4, device=dev)
    e2e.update({"config4 step_ms": res["step_ms"], "config4 test_acc": res["test_acc"]})
    return dict(tree=tree, card=torch.cuda.get_device_name(0), rows=rows, end_to_end=e2e)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="checkout roots, measured in this order")
    ap.add_argument("--out", help="also write every turn's JSON line to this file")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(turn(args.trees[0])), flush=True)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                           "--id=0"], capture_output=True, text=True, check=True, timeout=60)
    lines = [json.dumps({"card": card.stdout.strip()})]
    print(lines[0], flush=True)
    turns = []
    for tree in args.trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                              capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"turn {tree} exited with {proc.returncode}")
        print(proc.stdout, end="", flush=True)
        lines.append(proc.stdout.strip().splitlines()[-1])
        turns.append(json.loads(lines[-1]))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.writelines(line + "\n" for line in lines)
    keys = dict.fromkeys(k for t in turns for k in t["rows"])
    for key in keys:
        for what in ("ms", "library_ms", "host_us", "device_us", "library_device_us",
                     "launches_per_call", "share_of_bound"):
            have = [t for t in turns
                    if isinstance(t["rows"].get(key, {}).get(what), (int, float))]
            if have:
                print(key, what, " | ".join(f"{t['tree']} {t['rows'][key][what]:.4f}"
                                             for t in have))
    for key in keys:  # the outputs' digests (bucket rows at the cells' shapes): equal bits
        digests = {t["tree"]: t["rows"][key]["sha256"] for t in turns
                   if "sha256" in t["rows"].get(key, {})}
        if digests:
            same = len({json.dumps(d, sort_keys=True) for d in digests.values()}) == 1
            print(key, "sha256", "equal in every turn" if same else "DIFFER",
                  " | ".join(f"{tree} {json.dumps(d, sort_keys=True)}" for tree, d in digests.items()))
    for key in turns[0]["end_to_end"]:
        print(key, " | ".join(f"{t['tree']} {t['end_to_end'][key]:.4f}" for t in turns))


if __name__ == "__main__":
    main()
