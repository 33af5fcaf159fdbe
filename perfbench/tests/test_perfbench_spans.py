"""The span reduction (``harness/spans.py``) on a synthetic trace: a span on
the launching thread, a backward node tied to its forward op, remat's span
inside a backward node, ``gode.train.*`` holding another thread's launches
by time, idle gaps by their start; the attribution's checks; the span
readers; and traced runs of the driver on the CPU, on one part and on four."""

import json
import re

import pytest

from perfbench.harness import spans as sp
from perfbench.metrics import (
    bucket_reduce_ms, gat_dpv_ms, gat_recompute_ms, gat_softmax_ms, sync_idle_ms,
)
from perfbench.tests._cells import GAT1, GCN1, GCN4, run, run_small


def _launch(t, thread, corr, name="cudaLaunchKernel"):
    return (name, t, t + 1, thread, corr, -1, 0)


def _span(name, s, e, thread=1):
    return (name, s, e, thread, 0, -1, 0)


# Thread 1 runs the trainer and the forward; thread 2 is autograd's device
# thread.  Host events: (name, start, end, thread, correlation, sequence_nr,
# fwd_thread); device: (name, start, end, stream, correlation).
HOST = [
    _span("ProfilerStep#1", 100, 1000), _span("ProfilerStep#2", 1000, 2000),
    _launch(90, 1, 10),                                   # before the stretch
    _span("gode.train.step", 110, 900),
    _span("gode.gat.softmax", 120, 200),
    ("aten::exp", 130, 150, 1, 0, 7, 0),                  # forward op #7, inside the softmax
    _launch(140, 1, 1),
    ("aten::tanh", 160, 170, 1, 0, 9, 0),                 # forward op #9, inside the softmax
    _launch(210, 1, 2),                                   # the step alone
    ("autograd::engine::evaluate_function: ExpBackward0", 400, 500, 2, 0, 7, 1),
    ("ExpBackward0", 401, 499, 2, 0, 7, 1),
    _launch(410, 2, 3),                                   # exp's backward: its forward's spans
    ("TanhBackward0", 510, 700, 2, 0, 9, 1),
    _span("gode.gat.recompute", 520, 690, thread=2),       # opened inside the node
    _span("gode.gat.softmax", 530, 600, thread=2),
    _launch(540, 2, 4),                                   # recompute and softmax
    _launch(610, 2, 5),                                   # recompute alone
    _launch(695, 2, 6),                                   # the node outside its spans
    _span("gode.train.evaluate", 905, 980),
    _span("gode.train.eval_read", 950, 975),
    _launch(955, 1, 7, "cudaMemcpyAsync"),
    _span("gode.train.loss_read", 985, 995),
    _launch(986, 1, 9, "cudaMemcpyAsync"),
    _span("gode.train.step", 1000, 2000),                # closed at the stop
    _launch(1010, 1, 8),
]
DEVICE = [
    ("k0", 95, 105, 7, 10),
    ("k1", 300, 310, 7, 1), ("k2", 310, 330, 7, 2), ("k3", 420, 440, 7, 3),
    ("k4", 545, 560, 7, 4), ("k5", 615, 630, 7, 5), ("k6", 700, 705, 7, 6),
    ("Memcpy DtoH", 960, 962, 7, 7), ("Memcpy DtoH", 990, 992, 7, 9), ("k8", 1100, 1200, 7, 8),
    ("ncclDevKernel_AllReduce", 320, 350, 9, 99),         # no launch record
]


@pytest.fixture(scope="module")
def summary():
    return sp.summarise(sp.SpanTrace(DEVICE, HOST))


def test_kernels_by_span(summary):
    assert summary["span_ns"] == {
        "gode.gat.softmax": 10 + 20 + 15 + 5,   # k1, k3 (backward), k4, k6 (the node's forward)
        "gode.gat.recompute": 15 + 15,                      # k4, k5
        "gode.train.step": 10 + 20 + 20 + 15 + 15 + 5 + 100,
        "gode.train.evaluate": 2, "gode.train.eval_read": 2, "gode.train.loss_read": 2,
    }
    assert summary["span_launches"]["gode.gat.softmax"] == 4
    assert summary["span_launches"]["gode.train.step"] == 7
    assert summary["device_ns"] == 189 + 30 and summary["unlaunched_ns"] == 30


def test_idle_by_the_span_open_at_each_gap_start(summary):
    assert summary["idle_ns"] == {
        "gode.train.step": 70 + 105 + 55 + 70 + 255,
        "gode.train.eval_read": 28,                         # [962, 990)
        "gode.train.loss_read": 108,                        # [992, 1100)
    }


def test_instances_in_the_stretch(summary):
    assert summary["instances"] == {
        "gode.train.step": 2, "gode.gat.softmax": 2, "gode.gat.recompute": 1,
        "gode.train.evaluate": 1, "gode.train.eval_read": 1, "gode.train.loss_read": 1,
    }


def test_the_last_step_dropped_by_the_profiler_is_restored(summary):
    """The profiler stops inside the stretch's last step and may drop its
    open range: from the trainer's last ``gode.train.*`` span to the
    stretch's end counts as that step."""
    dropped = [h for h in HOST if h[:3] != ("gode.train.step", 1000, 2000)]
    assert sp.summarise(sp.SpanTrace(DEVICE, dropped)) == summary


def test_a_last_step_cut_short_but_kept_is_not_added_again(summary):
    """On some ranks the profiler keeps the last step's range, ended at its
    stop a little before the stretch's end: no second step is made up."""
    cut = [h if h[:3] != ("gode.train.step", 1000, 2000) else ("gode.train.step", 1000, 1990)
           + h[3:] for h in HOST]
    assert sp.summarise(sp.SpanTrace(DEVICE, cut))["instances"] == summary["instances"]


def test_a_span_inside_the_node_wins_over_the_forward_ops():
    """dpv: the node's forward op ran inside a softmax span, but the node
    opens its own span, which takes the launch alone."""
    host = [_span("ProfilerStep#1", 0, 100), _span("gode.gat.softmax", 1, 10),
            ("_BucketSpMMWeighted", 2, 3, 1, 0, 4, 0),
            ("_BucketSpMMWeightedBackward", 20, 60, 2, 0, 4, 1),
            _span("gode.b2w.dpv", 30, 50, thread=2), _launch(40, 2, 1), _launch(55, 2, 2)]
    s = sp.summarise(sp.SpanTrace([("dpv", 41, 45, 7, 1), ("dchunk", 56, 60, 7, 2)], host))
    assert s["span_ns"] == {"gode.b2w.dpv": 4, "gode.gat.softmax": 4}


def _ctx(summary, ranks=1, **kw):
    ctx = dict(chips=ranks, steps=2, evaluations=0,
               ranks=[dict(kind_ns={}, spans=summary)] * ranks)
    ctx.update(kw)
    return ctx


def test_readers(summary):
    ctx = _ctx(summary)
    assert gat_softmax_ms.read(ctx) == pytest.approx(50e-6 / 2)
    assert gat_recompute_ms.read(ctx) == pytest.approx(30e-6 / 2)
    assert sync_idle_ms.read(ctx) == pytest.approx((108 + 28) * 1e-6 / 2)
    assert gat_dpv_ms.read(ctx) is None and bucket_reduce_ms.read(ctx) is None


def test_readers_take_the_largest_rank():
    quiet = dict(span_ns={"gode.bucket_reduce": 10}, idle_ns={},
                 instances={"gode.bucket_reduce": 1})
    busy = dict(quiet, span_ns={"gode.bucket_reduce": 30})
    ctx = dict(chips=2, steps=1, evaluations=0, ranks=[dict(spans=quiet), dict(spans=busy)])
    assert bucket_reduce_ms.read(ctx) == pytest.approx(30e-6)


@pytest.mark.parametrize("reader", [gat_softmax_ms, gat_dpv_ms, gat_recompute_ms, bucket_reduce_ms,
                                    sync_idle_ms])
def test_no_spans_read_nothing(reader):
    plain = [h for h in HOST if not h[0].startswith("gode.")]
    assert reader.read(_ctx(sp.summarise(sp.SpanTrace(DEVICE, plain)))) is None
    assert reader.read(dict(chips=1, steps=2, evaluations=0, ranks=[dict(kind_ns={})])) is None


def test_table_lists_every_span(summary):
    lines = sp.table(summary, 2)
    for name in summary["instances"]:
        assert any(line.startswith(name) for line in lines)


def _checked(kind_ns, **spans):
    summary = dict(instances={"gode.train.step": 2, "gode.train.evaluate": 1,
                              "gode.bucket_reduce": 8},
                   span_ns={"gode.train.step": 90, "gode.train.evaluate": 10,
                            "gode.bucket_reduce": 50},
                   device_ns=100)
    summary.update(spans)
    ctx = dict(steps=2, evaluations=1, ranks=[dict(kind_ns=kind_ns, spans=summary)],
               bucket=[{"b2": ([(1, 1)] * 3, [(1, 1)] * 2)}])
    return sp.checks(ctx)


def test_checks_of_the_attribution():
    assert _checked({"bucket_kernel": 50}) == {
        "rank0.bucket_instances": (8, 2 * 3 + 2, True),
        "rank0.bucket_ns_vs_by_name": (0.0, 0.01, True),
        "rank0.under_step_or_evaluate": (1.0, 0.99, True),
    }
    bad = _checked({"bucket_kernel": 40}, instances={"gode.train.step": 2}, device_ns=125)
    assert bad["rank0.bucket_instances"] == (0, 6, False)
    assert bad["rank0.bucket_ns_vs_by_name"] == (pytest.approx(0.25), 0.01, False)
    assert bad["rank0.under_step_or_evaluate"] == (pytest.approx(0.8), 0.99, False)
    assert "rank0.bucket_ns_vs_by_name" not in _checked({})  # no bucket kernel by name


_SPAN_METRICS = ("gat_softmax_ms", "gat_dpv_ms", "gat_recompute_ms", "bucket_reduce_ms",
                 "sync_idle_ms")


def _instances_an_epoch(err, span):
    """The instances an epoch of ``span`` in every rank's table on stderr."""
    return [float(m) for m in re.findall(rf"^  {re.escape(span)} +\S+ +\S+ +(\S+) ", err, re.M)]


def test_traced_run_holds_the_spans(capfd):
    rc, result, err = run_small(GCN1, capfd, trace=1)
    assert rc == 0 and result["correct"]
    assert _instances_an_epoch(err, "gode.train.step") == [1.0]
    assert re.search(r"^span check rank0\.bucket_instances: \d+ limit \d+ ok$", err, re.M)
    assert "FAILED" not in err
    bench = json.loads((run.REPO / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["per_layer"]
            if m["name"] in _SPAN_METRICS and GCN1 in m["workloads"]}
    assert want == {"bucket_reduce_ms", "sync_idle_ms"}
    assert want <= set(result["metrics"])


def test_traced_run_prints_the_span_metrics(capfd):
    rc, result, err = run_small(GAT1, capfd, trace=1)
    assert rc == 0 and result["correct"], err[-2000:]
    for name in _SPAN_METRICS:
        assert isinstance(result["metrics"][name]["value"], float), name
        assert result["metrics"][name]["unit"] == "ms"
    assert "rank 0, " in err and "device, in all" in err
    assert "span check rank0.bucket_instances" in err and "FAILED" not in err
    # the table and the attribution's checks come before the checks of ``correct``
    assert err.rindex("span check") < err.index("check loss:")


def test_four_part_traced_run_gathers_every_ranks_spans(capfd):
    """Each rank reduces its own trace by span; rank 0 gathers the summaries
    and reads the span metrics over all of them."""
    rc, result, err = run_small(GCN4, capfd, trace=1)
    assert rc == 0 and result["correct"], err[-2000:]
    assert _instances_an_epoch(err, "gode.train.step") == [1.0] * 4
    for rank in range(4):
        assert f"rank {rank}, " in err
        assert re.search(rf"^span check rank{rank}\.bucket_instances: \d+ limit \d+ ok$", err,
                         re.M)
    assert "FAILED" not in err
    for name in ("bucket_reduce_ms", "sync_idle_ms"):
        assert isinstance(result["metrics"][name]["value"], float), name
