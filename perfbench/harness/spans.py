"""From a ``torch.profiler`` trace to device time by the program's spans.

The program opens a span where its work happens
(``graph_odenet_tpu_torch.utils.profiling.annotate``: a ``record_function``
range whose name begins with ``gode.``).  The profiler puts those host
ranges, the autograd nodes and CUPTI's device activities on one timeline,
and ties each kernel to its launch call by correlation id, so no second
clock is needed.  A trace is reduced to plain tuples: device activities
``(name, start_ns, end_ns, stream, correlation)``, as in ``trace.Trace``, and
host events ``(name, start_ns, end_ns, thread, correlation, sequence_nr,
fwd_thread)``, of which only the spans, the profiler's steps, the launch
calls (``cu...``) and the ops and nodes that autograd numbered are kept.

The stretch is ``trace.summarise``'s: the device activities launched inside
the profiler's ``ProfilerStep#`` annotations, and those without a launch
record where they fall between the first one's start and the last one's end.

The spans a kernel belongs to, from its launch call at time t on thread T:

* every ``gode.train.*`` span that holds t, on any thread: the trainer waits
  in them while autograd's device thread launches the backward;
* the other spans open on T at t; but where the launch lies inside an
  autograd node (an event with a ``sequence_nr`` and a forward thread: the
  backward of one forward op), the spans opened inside the innermost such
  node, or where none was, the spans that were open around the node's
  forward op (the last op with the node's ``(fwd_thread, sequence_nr)``)
  when it ran; spans opened on T before the node hold the kernel too.

So a softmax's backward counts under ``gode.gat.softmax``, and remat's
recomputation, opened inside a backward node, counts under
``gode.gat.recompute`` (its nested softmax under both).  A kernel counts
under every span that holds it.  Each idle gap of the device (the stretch
less the union of its activities) is put down to the innermost span open
on the trainer's thread (that of ``gode.train.step``) at the gap's start:
what the host was doing when the device ran dry.

The profiler stops inside the stretch's last step (the benchmark steps it
from Adam's post-step hook) and may drop that step's range, still open:
where the trainer's thread holds no ``gode.train.*`` span from the last
one's end to the stretch's end, that interval is taken as the missing
``gode.train.step``.
"""

from __future__ import annotations

import dataclasses

from perfbench.harness.trace import _gaps, union

__all__ = ["PREFIX", "SpanTrace", "from_profiler", "summarise", "table"]

PREFIX = "gode."
TRAIN = "gode.train."
NO_SPAN = "(no program span)"


@dataclasses.dataclass
class SpanTrace:
    device: list   # (name, start_ns, end_ns, stream, correlation)
    host: list     # (name, start_ns, end_ns, thread, correlation, sequence_nr, fwd_thread)


def _kept(name: str, seq: int) -> bool:
    return seq >= 0 or name.startswith((PREFIX, "cu", "ProfilerStep#"))


def from_profiler(prof) -> SpanTrace:
    """The events of a finished ``torch.profiler.profile``; the profiler's
    own annotations mirrored onto the device's timeline are left out."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.name(), start, end, e.device_resource_id(), e.correlation_id()))
        elif e.device_type() == DeviceType.CPU:
            name, seq = e.name(), e.sequence_nr()
            if _kept(name, seq):
                host.append((name, start, end, e.start_thread_id(), e.correlation_id(), seq,
                             e.fwd_thread_id()))
    return SpanTrace(device, host)


def _launch_spans(host, launches) -> dict:
    """``{correlation: span names}`` of each launch call in ``launches``
    (``{correlation: (time, thread)}``), one sweep over the host's events
    in time order with a stack of open spans and nodes per thread."""
    SPAN, NODE, FWD, TRAIN_SPAN, LAUNCH = range(5)
    items = []
    for name, s, e, thread, _, seq, fwd_thread in host:
        if name.startswith(TRAIN):
            items.append((s, 0, TRAIN_SPAN, thread, (name, e)))
        elif name.startswith(PREFIX):
            items.append((s, 0, SPAN, thread, (name, e)))
        elif seq >= 0 and fwd_thread > 0:
            items.append((s, 0, NODE, thread, ((fwd_thread, seq), e)))
        elif seq >= 0:
            items.append((s, 0, FWD, thread, seq))
    items += [(t, 1, LAUNCH, thread, corr) for corr, (t, thread) in launches.items()]
    items.sort(key=lambda it: (it[0], it[1]))

    stacks, train, fwd_spans, out = {}, [], {}, {}
    for t, _, kind, thread, x in items:
        stack = stacks.setdefault(thread, [])
        stack[:] = [o for o in stack if o[2] > t]  # (kind, span name or node key, end)
        if kind in (SPAN, NODE):
            stack.append((kind, *x))
        elif kind == TRAIN_SPAN:
            train.append(x)
        elif kind == FWD:
            fwd_spans[(thread, x)] = [o[1] for o in stack if o[0] == SPAN]
        else:
            train[:] = [o for o in train if o[1] > t]
            nodes = [i for i, o in enumerate(stack) if o[0] == NODE]
            cut = nodes[-1] if nodes else len(stack)
            names = [o[1] for o in stack[:cut] if o[0] == SPAN]
            if nodes:
                inside = [o[1] for o in stack[cut + 1:] if o[0] == SPAN]
                names += inside or fwd_spans.get(stack[cut][1], [])
            out[x] = set(names) | {name for name, _ in train}
    return out


def _trainer_thread(host):
    steps = [h[3] for h in host if h[0] == TRAIN + "step"]
    return max(set(steps), key=steps.count) if steps else None


def _with_last_step(host, host_hi) -> list:
    """``host`` with the stretch's last step added where the profiler
    dropped it."""
    trainer = _trainer_thread(host)
    ends = [h[2] for h in host if h[3] == trainer and h[0].startswith(TRAIN)]
    if not ends or max(ends) >= host_hi:
        return host
    return host + [(TRAIN + "step", max(ends), host_hi, trainer, 0, -1, 0)]


def _idle_by_span(host, gaps) -> dict:
    """Idle ns by the innermost span open on the trainer's thread at each
    gap's start."""
    trainer = _trainer_thread(host)
    spans = sorted((h for h in host if h[3] == trainer and h[0].startswith(PREFIX)),
                   key=lambda h: h[1])
    out, open_, i = {}, [], 0
    for gs, ge in sorted(gaps):
        while i < len(spans) and spans[i][1] <= gs:
            open_.append(spans[i])
            i += 1
        open_ = [h for h in open_ if h[2] > gs]
        name = max(open_, key=lambda h: h[1])[0] if open_ else NO_SPAN
        out[name] = out.get(name, 0) + (ge - gs)
    return out


def summarise(trace: SpanTrace) -> dict:
    """Per-rank numbers of the traced stretch by span: device ns and
    launches (a kernel under several spans counts under each), idle ns, and
    each span's instances (those that open inside the stretch on the host);
    with the stretch's device ns in all, and the part without a launch
    record."""
    steps = [(h[1], h[2]) for h in trace.host if h[0].startswith("ProfilerStep#")]
    host_lo, host_hi = min(s for s, _ in steps), max(e for _, e in steps)
    host = _with_last_step(trace.host, host_hi)
    launched = {h[4]: (h[1], h[3]) for h in host if h[4] and h[0].startswith("cu")}
    mine = [d for d in trace.device if host_lo <= launched.get(d[4], (-1,))[0] < host_hi]
    lo, hi = ((min(d[1] for d in mine), max(d[2] for d in mine)) if mine
              else (host_lo, host_hi))  # nothing ran on a device
    other = [(n, max(s, lo), min(e, hi), st, c) for n, s, e, st, c in trace.device
             if c not in launched and e > lo and s < hi]
    by_launch = _launch_spans(host, {d[4]: launched[d[4]] for d in mine})
    span_ns, span_launches = {}, {}
    for _, s, e, _, c in mine:
        for name in by_launch[c]:
            span_ns[name] = span_ns.get(name, 0) + (e - s)
            span_launches[name] = span_launches.get(name, 0) + 1
    instances = {}
    for h in host:
        if h[0].startswith(PREFIX) and host_lo <= h[1] < host_hi:
            instances[h[0]] = instances.get(h[0], 0) + 1
    busy = union((d[1], d[2]) for d in mine + other)
    unlaunched = sum(e - s for _, s, e, _, _ in other)
    return dict(
        span_ns=span_ns, span_launches=span_launches,
        idle_ns=_idle_by_span(host, _gaps(busy, lo, hi)), instances=instances,
        device_ns=sum(e - s for _, s, e, _, _ in mine) + unlaunched, unlaunched_ns=unlaunched,
    )


def table(summary: dict, epochs: int) -> list:
    """Lines of device ms, launches, instances and idle ms an epoch by span."""
    names = sorted(set(summary["span_ns"]) | set(summary["instances"]) | set(summary["idle_ns"]))
    lines = [f"{'span':24} {'device ms':>10} {'launches':>9} {'instances':>9} {'idle ms':>8}"
             "  (an epoch)"]
    for n in names:
        lines.append(f"{n:24} {summary['span_ns'].get(n, 0) * 1e-6 / epochs:10.3f} "
                     f"{summary['span_launches'].get(n, 0) / epochs:9.1f} "
                     f"{summary['instances'].get(n, 0) / epochs:9.1f} "
                     f"{summary['idle_ns'].get(n, 0) * 1e-6 / epochs:8.3f}")
    lines.append(f"{'device, in all':24} {summary['device_ns'] * 1e-6 / epochs:10.3f} "
                 f"(without a launch record {summary['unlaunched_ns'] * 1e-6 / epochs:.3f})")
    return lines
