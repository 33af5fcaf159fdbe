#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, on the card at a
cell's own size.

    python3 perfbench/calibrate.py --config <name> --seeds 3 [--parts 4] [--program-seeds 0]

For each seed the reference's first steps in float32 are the yardstick, and
in the program's place:

  tf32         the reference computed in TF32 (the control: the precision
               next below the configuration's float32 with TF32 off)
  half_batch   the reference with every other training node left out of the loss
  no_exchange  (``--parts`` > 1) the reference with each block's remote
               edges left out
  program      (``--program-seeds`` > 0) the program's first steps through
               the trainer over ``--parts`` parts, one process per card, as
               a run's set-up takes them
  program_<fault>
               (``--program-faults``, on the first ``--seeds`` seeds) the
               same with ``harness.faults``'s fault planted in the program

A fault that leaves the state unchanged reads 1 by ``harness.compare``'s
measure and needs no run.  One JSON line per reading, from rank 0; the
benchmark's own runs never call this.
"""

import argparse
import json
import multiprocessing
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))


def _rank(args, rank: int, world: int, init_method: str, ckpt_root: str) -> None:
    import torch
    import torch.distributed as dist

    from graph_odenet_tpu_torch.parallel import (
        ShardedTrainConfig, bootstrap_distributed, fit_sharded_node_classifier,
    )
    from perfbench.drivers import sharded
    from perfbench.harness import compare, faults
    from perfbench.harness.twin import load_twin
    from perfbench.reference.train import run_steps

    if world > 1:
        bootstrap_distributed(init_method, world, rank, device="cuda")
    with open(HERE / "configs" / f"{args.config}.json") as f:
        config = json.load(f)
    trainer, model = config["trainer"], config["trainer"]["model"]
    arrays = load_twin(config["twin"])
    data = sharded.program_data(arrays) if args.program_seeds else None
    dev = torch.device("cuda", rank)
    f_in, n_class = arrays["features"].shape[1], int(arrays["n_class"])

    def reading(kind, seed, prog, ref, params0, seconds):
        line = dict(config=args.config, parts=args.parts, kind=kind, seed=seed, seconds=seconds,
                    **compare.gaps(prog, ref, params0))
        print(json.dumps(line), flush=True)

    def program(seed, params0, kind, fault):
        ckpt = os.path.join(ckpt_root, f"{seed}-{kind}")
        cfg = ShardedTrainConfig(**trainer, epochs=args.steps, patience=10 ** 9, seed=seed,
                                 ckpt_dir=ckpt, ckpt_every=args.steps - 1, n_parts=world)
        t = time.time()
        with faults.planted(fault):
            res = fit_sharded_node_classifier(cfg, data, device="cuda", init_state=params0)
        if world > 1:
            dist.barrier()
        prog = sharded._program_steps(ckpt, args.steps, res["losses"]) if rank == 0 else None
        return prog, time.time() - t

    for i in range(max(args.seeds, args.program_seeds)):
        seed = args.first_seed + 7919 * i
        params0 = sharded.init_params(model, trainer, f_in, n_class, seed, dev)
        progs = []
        if i < args.program_seeds:
            progs.append(("program",) + program(seed, params0, "program", None))
            for fault in (args.program_faults if i < args.seeds else []):
                progs.append((f"program_{fault}",) + program(seed, params0, fault, fault))
        if rank == 0:
            host0 = {k: v.cpu() for k, v in params0.items()}
            t = time.time()
            ref = run_steps(model, arrays, trainer, params0, seed=seed, steps=args.steps,
                            device=dev)
            t_ref = time.time() - t
            for kind, prog, seconds in progs:
                reading(kind, seed, prog, ref, host0, seconds)
            if i < args.seeds:
                others = [("tf32", dict(precision="tf32")), ("half_batch", dict(fault="half_batch"))]
                if args.parts > 1:
                    others.append(("no_exchange", dict(fault="no_exchange", parts=args.parts)))
                for kind, kw in others:
                    t = time.time()
                    other = run_steps(model, arrays, trainer, params0, seed=seed,
                                      steps=args.steps, device=dev, **kw)
                    reading(kind, seed, other, ref, host0, time.time() - t)
            print(json.dumps(dict(config=args.config, kind="reference_seconds", seed=seed,
                                  seconds=t_ref)), flush=True)
        if world > 1:
            dist.barrier()
    if world > 1:
        dist.destroy_process_group()


def main(argv=None):
    from perfbench.harness.faults import FAULTS

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2_000_000_011)
    ap.add_argument("--parts", type=int, default=1)
    ap.add_argument("--program-seeds", type=int, default=0)
    ap.add_argument("--program-faults", nargs="*", default=[],
                    choices=[f for f in FAULTS if f != "state_unchanged"])
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    ckpt_root = tempfile.mkdtemp(prefix="perfbench-cal-")
    try:
        if args.parts == 1 or not args.program_seeds:
            _rank(args, 0, 1, "", ckpt_root)
            return 0
        store = os.path.join(ckpt_root, "store")
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank,
                             args=(args, r, args.parts, f"file://{store}", ckpt_root))
                 for r in range(args.parts)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        return next((p.exitcode for p in procs if p.exitcode), 0)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
