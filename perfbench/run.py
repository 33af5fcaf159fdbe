#!/usr/bin/env python3
"""The benchmark of ``graph_odenet_tpu_torch``: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up by name in ``BENCHMARK.json``; its configuration
(``configs/<config>.json``), traffic (``traffic/<traffic>.json``) and own
limits (``workloads/<cell>.json``) are data files, and the configuration's
``driver`` names ``drivers/<driver>.py``.  A cell on several chips runs one
process per chip (``harness/launch.py``).  The last line on standard output
is the result (``drivers/``); the lines before it on standard error give
each number compared beside its limit.

Exit codes: 0 a result was printed; 3 no CUDA card, or fewer than the cell
asks for; 4 a process held a module of JAX or of the JAX package; anything
else a failure.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# Every build and kernel cache at a fixed path inside the checkout, Python's
# bytecode too.  Where the installed packages carry no bytecode and the
# environment forbids writing it (PYTHONDONTWRITEBYTECODE), every run would
# compile the sources of torch and of the thousand modules its optimizer and
# checkpoint code import at first use (some 10 s of set-up on the card);
# here the first run of a checkout writes them and the later ones read them.
CACHE = HERE / "_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix = str(CACHE / "pycache")
os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
sys.dont_write_bytecode = False


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _for_cell(metrics: list, cell: str) -> list:
    return [(m["name"], m["unit"]) for m in metrics if cell in m.get("workloads", [cell])]


def main(argv=None, *, require_cuda: bool = True, device: str = "cuda", fault=None,
         config_overrides=None, bench=None, own=None) -> int:
    """One run; the keywords after ``argv`` are for the tests alone (``bench``
    and ``own`` stand in for ``BENCHMARK.json`` and the cell's own file)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = bench or _load(REPO / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}; one of {sorted(cells)}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = _load(REPO / entry["file"])
    if config_overrides:
        config = {**config, **config_overrides}
    traffic = _load(HERE / "traffic" / f"{cell['traffic']}.json")
    own = own or _load(HERE / "workloads" / f"{cell['name']}.json")
    chips = int(cell["chips"])
    if int(traffic["parts"]) != chips:
        print(f"traffic {cell['traffic']!r} runs {traffic['parts']} parts on {chips} chips", file=sys.stderr)
        return 2

    if require_cuda:
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{args.workload} needs {chips} CUDA card(s); this machine has {have}",
                  file=sys.stderr)
            return 3

    from perfbench.harness.launch import run_ranks

    driver = __import__(f"perfbench.drivers.{config['driver']}", fromlist=["Spec"])
    spec = driver.Spec(
        config=config, traffic=traffic, limits=own["limits"],
        end_to_end=_for_cell(bench["end_to_end"], cell["name"]),
        per_layer=_for_cell(bench["per_layer"], cell["name"]), seed=args.seed,
        seconds=args.seconds, rate=float(own["epochs_per_second"]), trace=bool(args.trace), t_start=T_START,
        device=device, fault=fault,
    )
    try:
        driver.prepare(spec)
        return run_ranks(config["driver"], spec, chips)
    finally:
        if spec.ckpt_dir:
            shutil.rmtree(spec.ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
