"""Port parity: the utilities (checkpoints, sanitizers, profiling hooks), the
segment reductions ``segment_mean``/``segment_max`` and the dopri5 aliases,
against the JAX package where it has the same function.

``Checkpointer`` is held to ``tests/test_utils.py``'s round trip, keeps the
newest ``max_to_keep`` steps, round-trips an Adam state exactly, raises
``FileNotFoundError`` on an empty directory like JAX's, and a process killed
during a save leaves the previous step whole.  ``validate_tiling`` passes on
every view ``prepare`` and ``csr_view`` build (both run it) and raises
``ValueError`` on each broken invariant.  ``odeint_checked`` follows
``tests/test_sanitize.py``.  The segment reductions equal JAX's exactly,
empty segments included.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_odenet_tpu_torch.graph import from_edges
from graph_odenet_tpu_torch.ops import csr_spmm, prepare, segment_max, segment_mean
from graph_odenet_tpu_torch.ops.csr_spmm import SEG_EDGES, csr_view
from graph_odenet_tpu_torch.utils import (
    Checkpointer, annotate, debug_nans, odeint_checked, trace, validate_tiling,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several processes at once, whose thread pools would otherwise wait on
    each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- Checkpointer -----------------------------------------------------------


def _state():
    return dict(params=dict(w=torch.arange(6.0).reshape(2, 3), b=torch.zeros(3)), step=7)


def test_checkpoint_save_restore_roundtrip(tmp_path):
    """tests/test_utils.py:16: the latest step, and an earlier one by number."""
    state = _state()
    ck = Checkpointer(str(tmp_path / "ckpt"))
    ck.save(7, state, wait=True)
    ck.save(9, dict(params={k: v + 1 for k, v in state["params"].items()}, step=9), wait=True)
    assert ck.latest_step() == 9
    like = dict(params={k: torch.zeros_like(v) for k, v in state["params"].items()}, step=0)
    restored = ck.restore(like)
    torch.testing.assert_close(restored["params"]["w"], torch.arange(6.0).reshape(2, 3) + 1)
    assert restored["step"] == 9
    restored7 = ck.restore(like, step=7)
    torch.testing.assert_close(restored7["params"]["w"], torch.arange(6.0).reshape(2, 3))
    assert restored7["step"] == 7
    ck.close()


def test_checkpoint_keeps_the_newest_steps(tmp_path):
    ck = Checkpointer(str(tmp_path), max_to_keep=2)
    for step in (1, 5, 3, 8):
        ck.save(step, _state())
    assert ck.steps() == [5, 8] and ck.latest_step() == 8
    assert sorted(os.listdir(tmp_path)) == ["step_5.pt", "step_8.pt"]


def test_checkpoint_roundtrips_adam_state_exactly(tmp_path):
    """An Adam state_dict (with the step counters) and a generator state come
    back bit for bit, and training on from them is training on without a stop."""
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.Adam(model.parameters(), lr=0.01, weight_decay=5e-4)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(16, 4)

    def step():
        opt.zero_grad()
        model(x * (torch.rand(16, 4, generator=gen) > 0.5)).square().mean().backward()
        opt.step()

    for _ in range(3):
        step()
    ck = Checkpointer(str(tmp_path))
    ck.save(3, dict(params=model.state_dict(), opt_state=opt.state_dict(), rng=gen.get_state()))
    for _ in range(2):
        step()
    want = {k: v.clone() for k, v in model.state_dict().items()}

    model2 = torch.nn.Linear(4, 3)
    opt2 = torch.optim.Adam(model2.parameters(), lr=0.01, weight_decay=5e-4)
    state = ck.restore(dict(params=model2.state_dict(), opt_state=opt2.state_dict(),
                            rng=gen.get_state()))
    model2.load_state_dict(state["params"])
    opt2.load_state_dict(state["opt_state"])
    gen.set_state(state["rng"])
    model, opt = model2, opt2
    for _ in range(2):
        step()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)


def test_checkpoint_empty_directory_raises_like_jax(tmp_path):
    ck = Checkpointer(str(tmp_path / "empty"))
    assert ck.latest_step() is None and ck.steps() == []
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ck.restore(_state())


_KILLED_SAVE = """
import os, signal, sys, torch
sys.path.insert(0, {repo!r})
from graph_odenet_tpu_torch.utils.checkpoint import Checkpointer
ck = Checkpointer({path!r})
ck.save(1, dict(w=torch.ones(1000), step=1))
def dying_save(obj, f):
    f.write(b"half a checkpoint")
    f.flush()
    os.kill(os.getpid(), signal.SIGKILL)
torch.save = dying_save
ck.save(2, dict(w=torch.full((1000,), 2.0), step=2))
"""


def test_a_kill_during_a_save_leaves_the_previous_step(tmp_path):
    path = str(tmp_path / "ckpt")
    proc = subprocess.run([sys.executable, "-c", _KILLED_SAVE.format(repo=REPO, path=path)],
                          capture_output=True, timeout=120)
    assert proc.returncode == -9, proc.stderr.decode()
    assert any(n.endswith(".tmp") for n in os.listdir(path))  # the torn write
    ck = Checkpointer(path)
    assert ck.latest_step() == 1
    got = ck.restore(dict(w=torch.zeros(1000), step=0))
    assert got["step"] == 1 and bool((got["w"] == 1.0).all())
    ck.save(2, dict(w=torch.full((1000,), 2.0), step=2))
    assert ck.latest_step() == 2 and ck.restore(None)["step"] == 2


# --- validate_tiling ----------------------------------------------------------


@pytest.fixture(scope="module")
def hub_csr():
    """A graph with hub rows both ways (split rows in both views)."""
    rng = np.random.default_rng(0)
    s = np.concatenate([rng.integers(0, 900, 1200), np.full(700, 7)])
    r = np.concatenate([np.full(1200, 3), rng.integers(0, 900, 700)])
    s = np.concatenate([s, rng.integers(0, 900, 2000)])
    r = np.concatenate([r, rng.integers(0, 900, 2000)])
    csr = prepare(from_edges(s, r, n_node=900, normalize="row"))
    assert csr.part.n_slots > 0 and csr.t_part.n_slots > 0
    return csr


@pytest.fixture(scope="module")
def view():
    rng = np.random.default_rng(1)
    rows = np.sort(np.concatenate([rng.integers(0, 40, 300), np.full(600, 11)]))
    cols = rng.integers(0, 70, rows.shape[0])
    v = csr_view(rows, cols, rng.random(rows.shape[0]), 40, 70)
    assert v.part.n_slots > 0
    return v


def test_validate_tiling_passes_on_prepare_and_csr_view(hub_csr, view):
    validate_tiling(hub_csr)
    validate_tiling(view)
    validate_tiling(csr_view([], [], [], 5, 6))


def test_prepare_and_csr_view_run_validate_tiling(monkeypatch):
    seen = []
    monkeypatch.setattr(csr_spmm, "validate_tiling", lambda v: seen.append(type(v).__name__))
    prepare(from_edges(np.array([0, 1, 2]), np.array([1, 2, 0]), n_node=3))
    csr_view([0, 1], [1, 0], [1.0, 1.0], 2, 2)
    assert seen == ["CSRGraph", "CSRView"]


def _set(t, idx, value):
    t = t.clone()
    t[idx] = value
    return t


def _first_split_boundary(part):
    """Index into seg_ptr of a boundary between two segments of one split row."""
    seg_slot = part.seg_slot.numpy()
    return int(np.nonzero(seg_slot >= 0)[0][0]) + 1


def _corrupt_part(csr, transpose, **fields):
    name = "t_part" if transpose else "part"
    return dataclasses.replace(csr, **{name: dataclasses.replace(getattr(csr, name), **fields)})


CORRUPTIONS = {
    # name: (function of the CSRGraph, message)
    "row_ptr_end": (lambda c: dataclasses.replace(c, row_ptr=_set(c.row_ptr, -1, 10**9)),
                    "row_ptr"),
    "row_ptr_not_monotone": (lambda c: dataclasses.replace(c, row_ptr=_set(c.row_ptr, 5, -1)),
                             "row_ptr"),
    "t_row_ptr_start": (lambda c: dataclasses.replace(c, t_row_ptr=_set(c.t_row_ptr, 0, 1)),
                        "row_ptr"),
    "senders_out_of_range": (lambda c: dataclasses.replace(
        c, senders=_set(c.senders, 0, c.n_node_pad)), "senders"),
    "t_receivers_negative": (lambda c: dataclasses.replace(
        c, t_receivers=_set(c.t_receivers, 3, -1)), "t_receivers"),
    "receivers_out_of_range": (lambda c: dataclasses.replace(
        c, receivers=_set(c.receivers, 2, c.n_node_pad + 5)), "receivers"),
    "t_perm_repeats": (lambda c: dataclasses.replace(c, t_perm=_set(c.t_perm, 0, c.t_perm[1])),
                       "t_perm"),
    "weight_short": (lambda c: dataclasses.replace(c, weight=c.weight[:-1]), "weight"),
    "seg_ptr_end": (lambda c: _corrupt_part(c, False, seg_ptr=_set(c.part.seg_ptr, -1, 0)),
                    "seg_ptr"),
    "segment_too_long": (lambda c: _corrupt_part(c, True, seg_ptr=_set(
        c.t_part.seg_ptr, _first_split_boundary(c.t_part),
        c.t_part.seg_ptr[_first_split_boundary(c.t_part)] + 10)), "SEG_EDGES"),
    "segment_outside_its_row": (lambda c: _corrupt_part(c, False, seg_row=_set(
        c.part.seg_row, 10, c.part.seg_row[10] + 1)), "span"),
    "seg_row_out_of_range": (lambda c: _corrupt_part(c, False, seg_row=_set(
        c.part.seg_row, -1, c.n_node_pad)), "seg_row"),
    "slot_shared": (lambda c: _corrupt_part(c, False, seg_slot=_set(
        c.part.seg_slot, _first_split_boundary(c.part),
        c.part.seg_slot[_first_split_boundary(c.part) - 1])), "seg_slot"),
    "split_ptr_end": (lambda c: _corrupt_part(c, True, split_ptr=_set(
        c.t_part.split_ptr, -1, c.t_part.n_slots + 1)), "split_ptr"),
    "slot_split_wrong": (lambda c: _corrupt_part(c, False, slot_split=_set(
        c.part.slot_split, 0, 5)), "slot_split"),
    "n_slots_wrong": (lambda c: _corrupt_part(c, False, n_slots=c.part.n_slots + 1),
                      "split_ptr"),
    "split_row_out_of_range": (lambda c: _corrupt_part(c, True, split_row=_set(
        c.t_part.split_row, 0, -2)), "split_row"),
    "whole_row_twice": (lambda c: _corrupt_part(c, False, seg_slot=_set(
        c.part.seg_slot, _first_split_boundary(c.part), -1)), "seg_slot"),
}


@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_validate_tiling_catches_corruption(hub_csr, name):
    corrupt, message = CORRUPTIONS[name]
    with pytest.raises(ValueError, match=message):
        validate_tiling(corrupt(hub_csr))


VIEW_CORRUPTIONS = {
    "col_out_of_range": (lambda v: dataclasses.replace(v, col=_set(v.col, 4, v.n_cols)), "col"),
    "row_ptr_end": (lambda v: dataclasses.replace(v, row_ptr=_set(v.row_ptr, -1, 3)), "row_ptr"),
    "segment_too_long": (lambda v: dataclasses.replace(v, part=dataclasses.replace(
        v.part, seg_ptr=_set(v.part.seg_ptr, _first_split_boundary(v.part),
                             v.part.seg_ptr[_first_split_boundary(v.part)] + 1))), "SEG_EDGES"),
}


@pytest.mark.parametrize("name", sorted(VIEW_CORRUPTIONS))
def test_validate_tiling_catches_view_corruption(view, name):
    corrupt, message = VIEW_CORRUPTIONS[name]
    with pytest.raises(ValueError, match=message):
        validate_tiling(corrupt(view))


def test_segments_of_a_split_row_hold_seg_edges(hub_csr):
    """The fixture's hub rows are cut into full segments (the cases above
    lengthen one past ``SEG_EDGES``)."""
    seg = np.diff(hub_csr.t_part.seg_ptr.numpy())
    assert seg.max() == SEG_EDGES


# --- odeint_checked (tests/test_sanitize.py:27-59) -------------------------


def _nan_after(t0):
    def dyn(t, y):
        return -y + torch.where(t > t0, torch.nan, 0.0)

    return dyn


def test_nan_injection_reported():
    with pytest.raises(RuntimeError, match="non-finite"):
        odeint_checked(_nan_after(0.5), torch.tensor([1.0, 2.0]), torch.linspace(0.0, 1.0, 5),
                       method="rk4")


def test_nan_injection_returned_without_throw():
    err, (ys, stats) = odeint_checked(_nan_after(0.5), torch.tensor([1.0]),
                                      torch.linspace(0.0, 1.0, 3), method="rk4", throw=False)
    assert isinstance(err, RuntimeError) and "non-finite" in str(err)
    assert ys.shape == (3, 1) and stats["nfe"] == 8
    err, _ = odeint_checked(lambda t, y: -y, torch.tensor([1.0]), torch.linspace(0.0, 1.0, 3),
                            method="rk4", throw=False)
    assert err is None


@pytest.mark.parametrize("method", ["dopri5", "adams"])
def test_clean_solve_passes(method):
    y0 = torch.tensor([1.0, 2.0], dtype=torch.float64)
    ys, stats = odeint_checked(lambda t, y: -y, y0, torch.linspace(0.0, 1.0, 5), method=method)
    np.testing.assert_allclose(ys[-1].numpy(), y0.numpy() * np.exp(-1.0), rtol=1e-5)
    assert stats["success"]


@pytest.mark.parametrize("method", ["dopri5", "adams"])
def test_step_budget_exhaustion_reported(method):
    with pytest.raises(RuntimeError, match="step budget"):
        odeint_checked(lambda t, y: torch.stack([y[1], -y[0]]),
                       torch.tensor([1.0, 0.0], dtype=torch.float64), [0.0, 2 * np.pi],
                       method=method, rtol=1e-9, atol=1e-12, max_steps=3)


def test_odeint_checked_messages_are_jax_messages():
    from jax.experimental import checkify

    from graph_odenet_tpu.utils.sanitize import odeint_checked as jchecked

    for dyn, tdyn, kw in (
        (lambda t, y: -y + jnp.where(t > 0.5, jnp.nan, 0.0), _nan_after(0.5), dict(method="rk4")),
        (lambda t, y: jnp.stack([y[1], -y[0]]), lambda t, y: torch.stack([y[1], -y[0]]),
         dict(method="dopri5", rtol=1e-9, atol=1e-12, max_steps=3)),
    ):
        with pytest.raises(checkify.JaxRuntimeError) as want:
            jchecked(dyn, jnp.array([1.0, 0.0]), jnp.array([0.0, 1.0, 2 * np.pi]), **kw)
        with pytest.raises(RuntimeError) as got:
            odeint_checked(tdyn, torch.tensor([1.0, 0.0], dtype=torch.float64),
                           [0.0, 1.0, 2 * np.pi], **kw)
        assert str(got.value) in str(want.value)


# --- segment_mean / segment_max ---------------------------------------------


@pytest.mark.parametrize("fn,dtype", [
    ("segment_mean", np.float32), ("segment_mean", np.float64), ("segment_max", np.float32),
    ("segment_max", np.float64), ("segment_max", np.int32),
])
def test_segment_reductions_match_jax(fn, dtype):
    """Segments 2 and 5 are empty: mean 0, max the dtype's lowest (-inf)."""
    from graph_odenet_tpu.ops import segment as jsegment

    rng = np.random.default_rng(0)
    ids = np.array([0, 0, 1, 3, 3, 3, 4, 6], np.int64)
    data = (rng.standard_normal((8, 3)) * 10).astype(dtype)
    want = np.asarray(getattr(jsegment, fn)(jnp.asarray(data), jnp.asarray(ids), 7))
    got = {"segment_mean": segment_mean, "segment_max": segment_max}[fn](
        torch.from_numpy(data), torch.from_numpy(ids), 7)
    assert got.dtype == torch.from_numpy(data).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_segment_max_gradient_matches_jax():
    from graph_odenet_tpu.ops import segment as jsegment

    rng = np.random.default_rng(1)
    ids = np.array([0, 0, 1, 3, 3, 3], np.int64)
    data = rng.standard_normal((6, 2))
    w = rng.standard_normal((5, 2))
    jg = jax.grad(lambda d: jnp.sum(jnp.where(jnp.isfinite(m := jsegment.segment_max(
        d, jnp.asarray(ids), 5)), m, 0.0) * w))(jnp.asarray(data))
    d = torch.from_numpy(data).requires_grad_()
    m = segment_max(d, torch.from_numpy(ids), 5)
    (torch.where(torch.isfinite(m), m, 0.0) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(d.grad.numpy(), np.asarray(jg))


# --- the dopri5 aliases -----------------------------------------------------


@pytest.mark.parametrize("alias", ["odeint_dopri5", "odeint_dopri5_scan"])
def test_dopri5_aliases_match_jax(alias):
    from graph_odenet_tpu.ode import adaptive as jadaptive
    from graph_odenet_tpu_torch.ode import adaptive

    ts = np.linspace(0.0, 2.0, 5)
    y0 = np.array([1.0, 0.0])
    jys, js = getattr(jadaptive, alias)(lambda t, y: jnp.stack([y[1], -y[0]]), jnp.asarray(y0),
                                        jnp.asarray(ts), rtol=1e-6, atol=1e-8)
    tys, tst = getattr(adaptive, alias)(lambda t, y: torch.stack([y[1], -y[0]]),
                                        torch.from_numpy(y0), torch.from_numpy(ts), rtol=1e-6,
                                        atol=1e-8)
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys), rtol=1e-10, atol=1e-10)
    assert (tst["nfe"], tst["n_accept"]) == (int(js["nfe"]), int(js["n_accept"]))
    from graph_odenet_tpu_torch import ode

    assert getattr(ode, alias) is getattr(adaptive, alias)


# --- profiling ----------------------------------------------------------------


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    with trace(str(tmp_path / "trace")) as prof:
        with annotate("odeblock_solve"):
            torch.ones(8).cumsum(0)
    names = {e.name for e in prof.events()}
    assert "odeblock_solve" in names
    (path,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "odeblock_solve" for e in events)


def test_debug_nans_raises_in_the_backward():
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    debug_nans(True)
    try:
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        debug_nans(False)
    assert not torch.is_anomaly_enabled()
