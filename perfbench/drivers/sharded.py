"""Driver of the port's edge-partitioned trainer,
``graph_odenet_tpu_torch.parallel.fit_sharded_node_classifier``.

Set-up, on every rank: the twin (``harness.twin``, cached), the program's
data objects built from its arrays, the initial parameters drawn from the
seed on the device (``init_state``), then the first ``check_steps`` epochs
through the trainer itself, which saves the parameters and Adam's state
after the first and the last of them into a checkpoint directory.  Those
epochs warm up every shape (a training step and an evaluation).  The
window trains ``E`` epochs: ``--seconds`` at the cell's measured epochs a
second, a multiple of 5 (an evaluation falls every 5 epochs).

Window: one trainer call of ``E`` epochs from the same initial parameters
and seed, with no checkpoint directory, evaluations included, with
patience beyond ``E``; on the host clock, ending in a synchronise.  The
trainer builds its model, optimizer and dropout generators inside each
call and partitions the graph there, as every training run does, so the
window's first ``check_steps`` epochs are the set-up's again.

Then, on rank 0, with the program's state freed: the reference repeats the
first ``check_steps`` steps from the same parameters and dropout seeds, and
``harness.compare`` holds the window's own first losses, and the first
gradient and change that the set-up's checkpoints hold, against them
(``correct``).  Last, the process is looked over for modules of JAX or of
the JAX package once more, since the check imports the reference.

With ``--trace 1`` the window runs under ``torch.profiler``: a stretch of
whole epochs, starting at an epoch that evaluates, is recorded (the
profiler's steps are advanced by an optimizer post-step hook).  Each rank
reduces it twice, by kernel (``harness.trace``) and by the program's spans
(``harness.spans``, under ``spans`` in its summary), and the per-layer
readers (``metrics/``) take their numbers from every rank's summary.  Rank 0
prints each rank's table by span and the attribution's checks on standard
error; they decide neither ``correct`` nor the exit code.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from perfbench.harness import compare, spans as sp, trace as tr
from perfbench.harness.result import emit, forbidden_modules
from perfbench.harness.twin import load_twin
from perfbench.reference.train import run_steps

__all__ = ["Spec", "prepare", "run_rank"]

ROOT = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Spec:
    """Everything a rank needs, picklable."""

    config: dict
    traffic: dict
    limits: dict
    end_to_end: list       # this cell's end-to-end metrics: (name, unit)
    per_layer: list        # this cell's per-layer metrics: (name, unit)
    seed: int
    seconds: float
    rate: float            # the cell's epochs a second (its own file)
    trace: bool
    t_start: float         # wall clock at the first process's start
    device: str = "cuda"
    fault: Optional[str] = None
    ckpt_dir: str = ""
    init_method: str = ""


def prepare(spec: Spec) -> None:
    """Build the twin's cache and the kernels once, before any rank starts."""
    load_twin(spec.config["twin"])
    if spec.device == "cuda":
        from graph_odenet_tpu_torch.ops import _build

        _build.build()
    spec.ckpt_dir = tempfile.mkdtemp(prefix="perfbench-ckpt-")


def program_data(arrays: dict):
    """The program's ``NodeClassificationData`` holding the twin's arrays."""
    from graph_odenet_tpu_torch.data.planetoid import NodeClassificationData
    from graph_odenet_tpu_torch.graph import Graph

    tr_end, va_end, n = (int(v) for v in arrays["split"])
    graph = Graph(
        senders=torch.from_numpy(arrays["senders"]), receivers=torch.from_numpy(arrays["receivers"]),
        weight=torch.from_numpy(arrays["weight"]), n_node=int(arrays["n_node"]),
        n_edge=int(arrays["n_edge"]), n_node_pad=int(arrays["n_node_pad"]),
    )
    return NodeClassificationData(
        graph=graph, features=torch.from_numpy(arrays["features"]),
        labels=torch.from_numpy(arrays["labels"]), idx_train=torch.arange(0, tr_end),
        idx_val=torch.arange(tr_end, va_end), idx_test=torch.arange(va_end, n),
        n_class=int(arrays["n_class"]), name="ogbn-arxiv-synthetic",
    )


def init_params(model: str, cfg: dict, f_in: int, n_class: int, seed: int, device) -> dict:
    """Glorot-uniform weights and zero biases, in the model's order, from one
    uniform draw of a generator on ``device`` seeded with ``seed``."""
    shapes = importlib.import_module(f"perfbench.reference.{model}").param_shapes(cfg, f_in, n_class)
    sizes = [math.prod(s) for s, glorot in shapes.values() if glorot]
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for name, (shape, glorot) in shapes.items():
        if glorot:
            n = math.prod(shape)
            limit = math.sqrt(6.0 / (shape[0] + shape[1]))
            out[name] = ((u[off:off + n] * 2.0 - 1.0) * limit).view(shape)
            off += n
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def shape_of(arrays: dict, parts: int) -> dict:
    """The sizes the work modules count from, with each receiver block's
    real edges from each sender block."""
    n_pad, e = int(arrays["n_node_pad"]), int(arrays["n_edge"])
    block = n_pad // parts
    s = arrays["senders"][:e].astype(np.int64) // block
    r = arrays["receivers"][:e].astype(np.int64) // block
    counts = np.zeros((parts, parts), dtype=np.int64)
    np.add.at(counts, (r, s), 1)
    return dict(n_pad=n_pad, n_edge=e, f_in=int(arrays["features"].shape[1]),
                n_class=int(arrays["n_class"]), bucket_edges=counts.tolist())


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _program_steps(ckpt_dir: str, steps: int, losses) -> dict:
    """The program's readings of its first ``steps`` epochs: their
    ``losses`` as the window's call gave them, and from the checkpoints the
    set-up's call wrote the first gradient as Adam took it (its first moment after one step over ``1 - beta1``; zeros
    where Adam holds no state) and the parameters after the last."""
    first = torch.load(os.path.join(ckpt_dir, "step_0.pt"), map_location="cpu", weights_only=True)
    last = torch.load(os.path.join(ckpt_dir, f"step_{steps - 1}.pt"), map_location="cpu",
                      weights_only=True)
    names = list(first["params"])
    opt = first["opt_state"]
    beta1 = opt["param_groups"][0]["betas"][0]
    grad = {}
    for i, k in enumerate(names):
        m = opt["state"].get(i, {}).get("exp_avg")
        grad[k] = m.float() / (1.0 - beta1) if m is not None else torch.zeros_like(first["params"][k])
    return dict(losses=np.asarray(losses, np.float64), first_grad=grad,
                params={k: v.float() for k, v in last["params"].items()})


def _window_epochs(rate: float, seconds: float) -> int:
    """The window's epochs: ``seconds`` at the cell's ``epochs_per_second``
    (measured once, on the card, for the benchmark), a multiple of 5 so
    that every window holds whole evaluation periods.  A fixed count, not
    one sized from this run's own warm-up: one epoch timed in set-up
    wanders by a fifth, and with it the share of the window's partition
    in ``epoch_ms``."""
    return 5 * max(1, round(seconds * rate / 5))


def _metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}",
                                                  ROOT / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _refused(found: list, where: str) -> int:
    print(f"forbidden modules loaded {where}: {', '.join(found)}", file=sys.stderr, flush=True)
    return 4


def run_rank(spec: Spec, rank: int, world: int) -> int:
    import torch.distributed as dist
    from graph_odenet_tpu_torch.parallel import (
        ShardedTrainConfig, bootstrap_distributed, fit_sharded_node_classifier,
    )

    if world > 1:
        if spec.device == "cpu":  # the CPU tests' gloo worlds: one thread a rank
            torch.set_num_threads(1)
        bootstrap_distributed(spec.init_method, world, rank, device=spec.device)
    if spec.fault:
        from perfbench.harness.faults import plant

        plant(spec.fault)
    device = torch.device(spec.device, rank) if spec.device == "cuda" else torch.device("cpu")
    cfg, traffic = spec.config, spec.traffic
    model = cfg["trainer"]["model"]
    steps = int(traffic["check_steps"])

    def gather(obj):
        if world == 1:
            return [obj]
        out = [None] * world
        dist.all_gather_object(out, obj)
        return out

    marks = [("to the rank", time.time())]
    arrays = load_twin(cfg["twin"])
    data = program_data(arrays)
    marks.append(("twin", time.time()))
    params0 = init_params(model, cfg["trainer"], data.features.shape[1], data.n_class, spec.seed,
                          device)

    def trainer_config(epochs, **ckpt):
        return ShardedTrainConfig(**cfg["trainer"], epochs=epochs, patience=10 ** 9,
                                  seed=spec.seed, n_parts=world, **ckpt)

    marks.append(("parameters", time.time()))
    hooks, t_call = [], time.perf_counter()
    handle = register_optimizer_step_post_hook(
        lambda *_: hooks.append(time.perf_counter()))
    # Saves after epochs 0 and steps - 1 (what the check reads), none between:
    # the hooks' epoch steps - 2 → steps - 1 is one training epoch alone.
    first = fit_sharded_node_classifier(
        trainer_config(steps, ckpt_dir=spec.ckpt_dir, ckpt_every=steps - 1), data,
        device=spec.device, init_state=params0)
    _sync(device)
    handle.remove()
    del first
    if world > 1:
        dist.barrier()
    epochs = _window_epochs(spec.rate, spec.seconds)
    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    marks.append(("first epochs", time.time()))
    if rank == 0:
        t, parts = spec.t_start, []
        for name, at in marks:
            parts.append(f"{name} {at - t:.3f}")
            t = at
        epoch_s = ", ".join(f"{b - a:.4f}" for a, b in zip([t_call] + hooks, hooks))
        print(f"set-up s: {', '.join(parts)} (its epochs {epoch_s}); window epochs {epochs}",
              file=sys.stderr, flush=True)

    prof, events, trace_from = None, {}, 0
    if spec.trace:
        from torch.profiler import ProfilerActivity, profile, schedule

        trace_from = 5 * math.ceil((steps + 7) / 5)  # the first traced epoch evaluates
        active = _window_epochs(spec.rate, traffic["trace_seconds"])
        epochs = max(epochs, 5 * math.ceil((trace_from + active + 2) / 5))
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts,
                       on_trace_ready=lambda p: events.update(t=tr.from_profiler(p),
                                                              s=sp.from_profiler(p)),
                       schedule=schedule(wait=trace_from, warmup=1, active=active, repeat=1))
        events["active"] = active

    if world > 1:
        dist.barrier()
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    handle = None
    if prof is not None:
        prof.start()
        handle = register_optimizer_step_post_hook(lambda *_: prof.step())
    t_window = time.time()
    t0 = time.perf_counter()
    res = fit_sharded_node_classifier(trainer_config(epochs), data, device=spec.device,
                                      init_state=params0)
    _sync(device)
    t1 = time.perf_counter()
    if prof is not None:
        handle.remove()
        prof.stop()
    window_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    losses = np.asarray(res["losses"], np.float64)
    del res
    found = forbidden_modules()
    summary = (dict(tr.summarise(events["t"]), spans=sp.summarise(events["s"]))
               if "t" in events else None)
    mine = dict(seconds=t1 - t0, window_peak=window_peak, peak=max(setup_peak, window_peak),
                done=int(np.isfinite(losses).sum()), forbidden=found, summary=summary)
    everyone = gather(mine)
    if world > 1:
        dist.destroy_process_group()
    if rank != 0:
        return 0
    found = sorted({m for r in everyone for m in r["forbidden"]})
    if found:
        return _refused(found, "by a rank")

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    result_device = dict(platform="gpu" if device.type == "cuda" else "cpu", kind=kind,
                         count=world, memory_peak_bytes=max(r["peak"] for r in everyone))
    metrics = {}
    breakdown = None
    if spec.trace:
        if any(r["summary"] is None for r in everyone):
            raise RuntimeError("the profiler recorded no stretch of the window")
        shape = shape_of(arrays, world)
        work = importlib.import_module(f"perfbench.work.{model}")
        ctx = dict(chips=world, steps=events["active"], evaluations=events["active"] // 5,
                   ranks=[r["summary"] for r in everyone], flops=work.flops(cfg["trainer"], shape),
                   bucket=[work.bucket_calls(cfg["trainer"], shape, world, r) for r in range(world)])
        for name, unit in spec.per_layer:
            value = _metric_reader(name)(ctx)
            if value is not None:
                metrics[name] = dict(value=value, unit=unit)
        ranks = ctx["ranks"]
        result_device.update(busy_s=float(np.mean([r["busy_ns"] for r in ranks])) * 1e-9,
                             window_s=ranks[0]["window_ns"] * 1e-9)
        breakdown = dict(
            device_ops=[[n, ns * 1e-9] for n, ns in ranks[0]["top_device_ops"]],
            idle_gaps=[[n, ns * 1e-9] for n, ns in ranks[0]["idle_by_host"]])
        for i, r in enumerate(ranks):
            print(f"rank {i}, {ctx['steps']} epochs, {ctx['evaluations']} evaluations:",
                  file=sys.stderr)
            for line in sp.table(r["spans"], ctx["steps"]):
                print("  " + line, file=sys.stderr)
        for name, (value, limit, ok) in sp.checks(ctx).items():
            print(f"span check {name}: {value!r} limit {limit!r} {'ok' if ok else 'FAILED'}",
                  file=sys.stderr)
        sys.stderr.flush()
    else:
        values = dict(epoch_ms=everyone[0]["seconds"] * 1e3 / epochs,
                      peak_mem_gb=max(r["window_peak"] for r in everyone) / 1e9,
                      setup_s=t_window - spec.t_start)
        for name, unit in spec.end_to_end:
            metrics[name] = dict(value=values[name], unit=unit)

    # The program's state is gone; the reference runs on this rank's device.
    del data, params0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    params0 = init_params(model, cfg["trainer"], arrays["features"].shape[1],
                          int(arrays["n_class"]), spec.seed, device)
    ref = run_steps(model, arrays, cfg["trainer"], params0, seed=spec.seed, steps=steps,
                    device=device)
    prog = _program_steps(spec.ckpt_dir, steps, losses[:steps])
    shutil.rmtree(spec.ckpt_dir, ignore_errors=True)
    numbers = compare.gaps(prog, ref, {k: v.cpu() for k, v in params0.items()})
    failed = epochs - min(epochs, everyone[0]["done"])
    numbers["window_failed_epochs"] = failed
    correct, checks = compare.judge(numbers, dict(spec.limits, window_failed_epochs=0))
    result = dict(correct=bool(correct), attempted=epochs, failed=failed, metrics=metrics,
                  device=result_device)
    if breakdown is not None:
        result["breakdown"] = breakdown
    found = forbidden_modules()
    if found:
        return _refused(found, "by the check")
    emit(result, checks)
    return 0
