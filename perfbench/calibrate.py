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
               the trainer on one chip, as a run's set-up takes them

A fault that leaves the state unchanged reads 1 by ``harness.compare``'s
measure and needs no run.  One JSON line per reading; the benchmark's own
runs never call this.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))


def main(argv=None):
    import torch

    from perfbench.drivers import sharded
    from perfbench.harness import compare
    from perfbench.harness.twin import load_twin
    from perfbench.reference.train import run_steps

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2_000_000_011)
    ap.add_argument("--parts", type=int, default=1)
    ap.add_argument("--program-seeds", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    with open(HERE / "configs" / f"{args.config}.json") as f:
        config = json.load(f)
    trainer, model = config["trainer"], config["trainer"]["model"]
    arrays = load_twin(config["twin"])
    dev = torch.device("cuda")
    f_in, n_class = arrays["features"].shape[1], int(arrays["n_class"])
    readings = []

    def reading(kind, seed, prog, ref, params0, seconds):
        numbers = compare.gaps(prog, ref, params0)
        line = dict(config=args.config, kind=kind, seed=seed, seconds=seconds, **numbers)
        print(json.dumps(line), flush=True)
        readings.append(line)

    for i in range(max(args.seeds, args.program_seeds)):
        seed = args.first_seed + 7919 * i
        params0 = sharded.init_params(model, trainer, f_in, n_class, seed, dev)
        host0 = {k: v.cpu() for k, v in params0.items()}
        t = time.time()
        ref = run_steps(model, arrays, trainer, params0, seed=seed, steps=args.steps, device=dev)
        t_ref = time.time() - t
        if i < args.program_seeds:
            from graph_odenet_tpu_torch.parallel import ShardedTrainConfig, fit_sharded_node_classifier

            with tempfile.TemporaryDirectory(prefix="perfbench-cal-") as ckpt:
                cfg = ShardedTrainConfig(**trainer, epochs=args.steps, patience=10 ** 9, seed=seed,
                                         ckpt_dir=ckpt, ckpt_every=args.steps - 1, n_parts=1)
                t = time.time()
                res = fit_sharded_node_classifier(cfg, sharded.program_data(arrays), device="cuda",
                                                  init_state=params0)
                prog = sharded._program_steps(ckpt, args.steps, res["losses"])
                reading("program", seed, prog, ref, host0, time.time() - t)
        if i >= args.seeds:
            continue
        faults = [("tf32", dict(precision="tf32")), ("half_batch", dict(fault="half_batch"))]
        if args.parts > 1:
            faults.append(("no_exchange", dict(fault="no_exchange", parts=args.parts)))
        for kind, kw in faults:
            t = time.time()
            other = run_steps(model, arrays, trainer, params0, seed=seed, steps=args.steps,
                              device=dev, **kw)
            reading(kind, seed, other, ref, host0, time.time() - t)
        print(json.dumps(dict(config=args.config, kind="reference_seconds", seed=seed,
                              seconds=t_ref)), flush=True)
    return readings


if __name__ == "__main__":
    main()
