#!/usr/bin/env python3
"""A traced run of a one-chip cell with the program's spans read.

    python3 perfbench/trace_spans.py --workload <cell> --seed <n> --seconds <s>

``run.py --trace 1`` as it stands, with two additions made inside this
process: each rank's summary of the traced stretch gains ``spans``
(``harness/spans.py``, from the same finished profiler as
``harness/trace.py``'s numbers), and the cell's per-layer metrics gain the
span readers (``SPAN_METRICS``, ``metrics/<name>.py``), which read it.  The
last line on standard output is ``run.py``'s result, with those metrics in
it.  On standard error, after ``run.py``'s own lines: the table of device ms
an epoch by span, and the attribution's checks:

* ``gode.bucket_reduce``'s device time equals the by-name device time of
  the bucket kernel (``trace.KERNEL_KINDS``) within 1 %;
* the stretch's ``gode.bucket_reduce`` instances equal the work module's
  count of bucket-kernel calls (``work/<model>.bucket_calls``) for the
  stretch's instances of ``gode.train.step`` and ``gode.train.evaluate``;
* at least 99 % of the stretch's device time lies under
  ``gode.train.step`` or ``gode.train.evaluate``.

Exit code: ``run.py``'s, or 5 when a check fails.  A cell on several chips
runs its ranks in processes of their own, which these additions do not
reach: the tool refuses it (exit 2).
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

import run  # noqa: E402

GAT1 = "ogbn-arxiv-gatode-sharded.train.1chip"
GCN1 = "ogbn-arxiv-gcnode-sharded.train.1chip"
_ATTENTION = "parallel.sharded_gat and parallel.halo per-edge passes"
_STEP = "model step: parallel.trainer over sharded_gcn or sharded_gat"
_BUCKET = "kernel: csrc/csr_spmm.cu bucket modes (B2, B2-w)"


def _metric(name, layer, cells):
    return dict(name=name, unit="ms", better="lower", source="device_trace", layer=layer,
                moves="epoch_ms", workloads=cells)


#: The span readers as ``per_layer`` entries of ``BENCHMARK.json``.
SPAN_METRICS = [
    _metric("gat_softmax_ms", _ATTENTION, [GAT1]),
    _metric("gat_dpv_ms", _ATTENTION, [GAT1]),
    _metric("gat_recompute_ms", _STEP, [GAT1]),
    _metric("bucket_reduce_ms", _BUCKET, [GAT1, GCN1]),
    _metric("sync_idle_ms", _STEP, [GAT1, GCN1]),
]


@contextlib.contextmanager
def wired(seen: dict):
    """The driver with the span reduction beside the trace's and the
    readers' context kept in ``seen["ctx"]``; undone on exit."""
    from perfbench.drivers import sharded
    from perfbench.harness import spans, trace

    saved = trace.from_profiler, trace.summarise, sharded._metric_reader

    def from_profiler(prof):
        t = saved[0](prof)
        t.spans = spans.from_profiler(prof)
        return t

    def summarise(t, *args, **kwargs):
        return dict(saved[1](t, *args, **kwargs), spans=spans.summarise(t.spans))

    def metric_reader(name):
        read = saved[2](name)

        def keep(ctx):
            seen["ctx"] = ctx
            return read(ctx)
        return keep

    trace.from_profiler, trace.summarise, sharded._metric_reader = (
        from_profiler, summarise, metric_reader)
    try:
        yield
    finally:
        trace.from_profiler, trace.summarise, sharded._metric_reader = saved


def checks(ctx) -> dict:
    """Each check of the attribution on each rank: ``(value, limit, ok)``."""
    out = {}
    for rank, (summary, calls) in enumerate(zip(ctx["ranks"], ctx["bucket"])):
        s = summary["spans"]
        ((train, evaluation),) = calls.values()
        n = s["instances"]
        want = (n.get("gode.train.step", 0) * len(train)
                + n.get("gode.train.evaluate", 0) * len(evaluation))
        got = n.get("gode.bucket_reduce", 0)
        out[f"rank{rank}.bucket_instances"] = (got, want, got == want)
        by_name = summary["kind_ns"].get("bucket_kernel", 0)
        if by_name:
            gap = abs(s["span_ns"].get("gode.bucket_reduce", 0) - by_name) / by_name
            out[f"rank{rank}.bucket_ns_vs_by_name"] = (gap, 0.01, gap <= 0.01)
        if s["device_ns"]:
            share = (s["span_ns"].get("gode.train.step", 0)
                     + s["span_ns"].get("gode.train.evaluate", 0)) / s["device_ns"]
            out[f"rank{rank}.under_step_or_evaluate"] = (share, 0.99, share >= 0.99)
    return out


def main(argv=None, **run_kwargs) -> int:
    """``run.main`` with the spans wired in; the keywords are ``run.main``'s
    (for the tests)."""
    bench = (run_kwargs.pop("bench", None)
             or json.loads((HERE.parent / "BENCHMARK.json").read_text()))
    argv = list(sys.argv[1:] if argv is None else argv)
    cell = argv[argv.index("--workload") + 1]
    if any(w["name"] == cell and w["chips"] > 1 for w in bench["workloads"]):
        print(f"{cell} runs on several chips; this tool runs one-chip cells", file=sys.stderr)
        return 2
    names = {m["name"] for m in bench["per_layer"]}
    bench = dict(bench, per_layer=bench["per_layer"] + [m for m in SPAN_METRICS
                                                        if m["name"] not in names])
    seen = {}
    with wired(seen):
        rc = run.main(argv + ["--trace", "1"], bench=bench, **run_kwargs)
    if rc != 0 or "ctx" not in seen:
        return rc
    ctx = seen["ctx"]
    from perfbench.harness.spans import table

    for rank, summary in enumerate(ctx["ranks"]):
        print(f"rank {rank}, {ctx['steps']} epochs, {ctx['evaluations']} evaluations:",
              file=sys.stderr)
        for line in table(summary["spans"], ctx["steps"]):
            print("  " + line, file=sys.stderr)
    results = checks(ctx)
    for name, (value, limit, ok) in results.items():
        print(f"span check {name}: {value!r} limit {limit!r} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    return 0 if all(ok for _, _, ok in results.values()) else 5


if __name__ == "__main__":
    sys.exit(main())
