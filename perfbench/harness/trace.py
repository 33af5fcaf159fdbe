"""From a ``torch.profiler`` trace to the numbers the per-layer readers take.

A trace is reduced to plain tuples: device activities ``(name, start_ns,
end_ns, stream, correlation)`` and host operations ``(name, start_ns,
end_ns, thread, correlation)``.  The traced stretch is, on the host, the
span of the profiler's ``ProfilerStep#`` annotations; on the device, the
activities that the host launched inside it (matched by the launch call's
correlation id), from the first one's start to the last one's end.  The
device runs behind the host, so cutting the device's timeline at the
host's bounds would take in the tail of the step before the stretch and
leave out the tail of its last one.  A device activity whose launch was not
recorded (NCCL's kernels may be launched through the driver) counts where it
falls inside the device's stretch.

Busy time is the length of the union of device intervals over all streams,
so a collective on its own stream overlapping a kernel counts once; idle is
the stretch less busy.  A transfer's exposed time is the part of its
intervals that no compute interval covers.

Kernels are classified by name (``KERNEL_KINDS``, matched in order; copied
from the port's ``chip_smoke.py``, with NCCL's kernels added first).
"""

from __future__ import annotations

import dataclasses

__all__ = ["KERNEL_KINDS", "kernel_kind", "Trace", "from_profiler", "union", "subtract_length", "summarise"]

KERNEL_KINDS = (
    ("nccl_p2p", ("SendRecv", "ncclDevKernel_Send", "ncclDevKernel_Recv", "ncclKernel_Send",
                  "ncclKernel_Recv")),
    ("nccl_collective", ("nccl",)),
    ("bucket_kernel", ("csr_reduce_kernel",)),
    ("matmul", ("gemm", "cutlass", "cublas")),
    ("gather", ("indexSelect", "index_select", "gather")),
    ("segment_ops", ("scatter", "indexFuncLargeIndex", "indexFuncSmallIndex", "index_add")),
    ("reduce", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized")),
    ("memory", ("Memcpy", "Memset")),
)
COMMS = ("nccl_p2p", "nccl_collective")


def kernel_kind(name: str) -> str:
    return next((kind for kind, keys in KERNEL_KINDS if any(k in name for k in keys)), "other")


@dataclasses.dataclass
class Trace:
    device: list   # (name, start_ns, end_ns, stream, correlation)
    host: list     # (name, start_ns, end_ns, thread, correlation)


def from_profiler(prof) -> Trace:
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
            host.append((e.name(), start, end, e.start_thread_id(), e.correlation_id()))
    return Trace(device, host)


def union(intervals) -> list:
    """Sorted, disjoint ``(start, end)`` covering the given intervals."""
    out = []
    for s, e in sorted((s, e) for s, e in intervals if e > s):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def subtract_length(a, b) -> int:
    """Length of ``union(a)`` not covered by ``union(b)``."""
    b = union(b)
    total, j = 0, 0
    for s, e in union(a):
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while cur < e:
            if k < len(b) and b[k][0] < e:
                bs, be = b[k]
                if bs > cur:
                    total += bs - cur
                cur = max(cur, be)
                k += 1
            else:
                total += e - cur
                cur = e
    return total


def _gaps(busy, lo, hi):
    gaps, cur = [], lo
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    return gaps


def _idle_by_host(host, gaps) -> dict:
    """Idle ns by the innermost host operation running at each gap's middle
    (the profiler's own step annotations aside), one sweep over both sorted."""
    events = sorted((h for h in host if not h[0].startswith("ProfilerStep#")),
                    key=lambda h: h[1])
    stacks, out, i = {}, {}, 0
    for gs, ge in sorted(gaps, key=lambda g: g[0] + g[1]):
        t = (gs + ge) // 2
        while i < len(events) and events[i][1] <= t:
            ev = events[i]
            stack = stacks.setdefault(ev[3], [])
            while stack and stack[-1][2] <= ev[1]:
                stack.pop()
            stack.append(ev)
            i += 1
        best = None
        for stack in stacks.values():
            while stack and stack[-1][2] <= t:
                stack.pop()
            if stack and (best is None or stack[-1][1] > best[1]):
                best = stack[-1]
        name = best[0] if best else "(no host operation)"
        out[name] = out.get(name, 0) + (ge - gs)
    return out


def summarise(trace: Trace, top: int = 10) -> dict:
    """Per-rank numbers of the traced stretch: its length on the device, busy
    and idle ns, device ns and launches by kind, the exposed ns of the
    point-to-point transfers, the device operations that took most time
    and the idle time by what the host was doing."""
    steps = [(h[1], h[2]) for h in trace.host if h[0].startswith("ProfilerStep#")]
    host_lo, host_hi = min(s for s, _ in steps), max(e for _, e in steps)
    launched = {h[4]: h[1] for h in trace.host if h[4] and h[0].startswith("cu")}
    mine = [d for d in trace.device if host_lo <= launched.get(d[4], -1) < host_hi]
    lo, hi = ((min(d[1] for d in mine), max(d[2] for d in mine)) if mine
              else (host_lo, host_hi))  # nothing ran on a device
    dev = mine + [(n, max(s, lo), min(e, hi), st, c) for n, s, e, st, c in trace.device
                  if c not in launched and e > lo and s < hi]
    busy = union((d[1], d[2]) for d in dev)
    by_kind, launches, by_name = {}, {}, {}
    for n, s, e, _, _ in dev:
        k = kernel_kind(n)
        by_kind[k] = by_kind.get(k, 0) + (e - s)
        launches[k] = launches.get(k, 0) + 1
        by_name[n] = by_name.get(n, 0) + (e - s)
    p2p = [(d[1], d[2]) for d in dev if kernel_kind(d[0]) == "nccl_p2p"]
    compute = [(d[1], d[2]) for d in dev if kernel_kind(d[0]) not in COMMS]
    idle_by_host = _idle_by_host(trace.host, _gaps(busy, lo, hi))
    return dict(
        window_ns=hi - lo, busy_ns=sum(e - s for s, e in busy), kind_ns=by_kind,
        kind_launches=launches, p2p_exposed_ns=subtract_length(p2p, compute),
        top_device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        idle_by_host=sorted(idle_by_host.items(), key=lambda kv: -kv[1])[:top],
    )
