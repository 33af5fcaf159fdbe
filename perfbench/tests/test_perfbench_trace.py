"""The trace reduction on a synthetic trace: the stretch by launch, the idle
union over streams, the exposed part of the transfers, and the readers, the
span readers of the attention's layer with the program's spans added."""

import pytest

from perfbench.harness import spans as sp, trace as tr
from perfbench.metrics import (
    b2_roofline_pct, device_idle_pct, gat_dpv_ms, gat_softmax_ms, halo_exposed_ms, step_mfu,
)

SEND = "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)"
HOST = [
    ("ProfilerStep#1", 100, 200, 1, 0), ("ProfilerStep#2", 200, 300, 1, 0),
    ("cudaLaunchKernel", 90, 91, 1, 4), ("cudaLaunchKernel", 110, 111, 1, 1),
    ("cudaLaunchKernel", 150, 151, 1, 2), ("cudaLaunchKernel", 250, 251, 1, 3),
    ("cudaLaunchKernel", 310, 311, 1, 5), ("aten::foo", 220, 240, 1, 0),
    ("autograd::engine", 205, 295, 2, 0),
]
DEVICE = [
    ("csr_reduce_kernel<32>", 95, 140, 7, 4),       # launched before the stretch: out
    ("csr_reduce_kernel<32>", 140, 170, 7, 1),
    ("indexSelectLargeIndex", 180, 200, 7, 2),
    ("vectorized_elementwise_kernel", 260, 320, 7, 3),  # runs after the host's stretch: in
    (SEND, 150, 190, 9, 99),                         # no launch recorded: counts where it falls
    ("csr_reduce_kernel<32>", 330, 340, 7, 5),      # launched after the stretch: out
]


def test_union_and_subtract():
    assert tr.union([(0, 5), (3, 8), (10, 12), (12, 13)]) == [(0, 8), (10, 13)]
    assert tr.subtract_length([(0, 10), (20, 30)], [(2, 4), (3, 6), (25, 40)]) == (2 + 4) + 5
    assert tr.subtract_length([(0, 10)], []) == 10


def test_summarise():
    s = tr.summarise(tr.Trace(DEVICE, HOST))
    assert s["window_ns"] == 320 - 140
    assert s["busy_ns"] == (200 - 140) + (320 - 260)
    assert s["kind_launches"] == {"bucket_kernel": 1, "gather": 1, "elementwise": 1, "nccl_p2p": 1}
    assert s["kind_ns"]["nccl_p2p"] == 40
    assert s["p2p_exposed_ns"] == 10          # [170, 180]: no compute kernel under it
    assert s["idle_by_host"] == [("aten::foo", 60)]  # the gap [200, 260], host in aten::foo at 230


# The same host with the attention's spans: the softmax around the gather's
# launch, ``dpv`` around the elementwise kernel's (host events as in
# ``harness/spans.py``: sequence number and forward thread added).
SPANS = [("gode.gat.softmax", 140, 160, 1, 0), ("gode.b2w.dpv", 245, 255, 1, 0)]
SPAN_HOST = [h + (-1, 0) for h in HOST + SPANS]


def _ctx(summary, **kw):
    ctx = dict(chips=1, steps=2, evaluations=0, ranks=[summary], flops=(1e9, 0.0),
               bucket=[{"b2": ([(1000, 10)], [])}])
    ctx.update(kw)
    return ctx


def test_readers():
    s = tr.summarise(tr.Trace(DEVICE, HOST))
    assert device_idle_pct.read(_ctx(s)) == pytest.approx(100 * 60 / 180)
    assert halo_exposed_ms.read(_ctx(s)) == pytest.approx(10e-6 / 2)
    s["spans"] = sp.summarise(sp.SpanTrace(DEVICE, SPAN_HOST))
    assert gat_softmax_ms.read(_ctx(s)) == pytest.approx(20e-6 / 2)   # indexSelectLargeIndex
    assert gat_dpv_ms.read(_ctx(s)) == pytest.approx(60e-6 / 2)       # the elementwise kernel
    assert step_mfu.read(_ctx(s)) == pytest.approx(100 * 2e9 / (180e-9 * 67e12))
    # one B2 launch seen, two expected: the roofline reader reads nothing
    assert b2_roofline_pct.read(_ctx(s)) is None
    one = _ctx(s, steps=1)
    assert b2_roofline_pct.read(one) == pytest.approx(100 * (1000 / 3.35e12) / 30e-9)
    assert b2_roofline_pct.read(_ctx(s, bucket=[{"b2w": ([(1, 1)], [])}])) is None


def test_nothing_on_a_device_reads_nothing():
    s = tr.summarise(tr.Trace([], HOST))
    assert device_idle_pct.read(_ctx(s)) is None
    assert step_mfu.read(_ctx(s)) is None
    assert halo_exposed_ms.read(_ctx(s)) is None
