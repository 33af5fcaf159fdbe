"""The program's spans (``utils.profiling.annotate``): a shared no-op with no
profiler running, and under ``utils.profiling.trace`` one instance for each
piece of work it names, counted here per training step and per evaluation
of the sharded trainer on the CPU."""

import pytest
import torch

from graph_odenet_tpu_torch.data.ogbn import synthetic_ogbn_arxiv
from graph_odenet_tpu_torch.parallel import ShardedTrainConfig, fit_sharded_node_classifier
from graph_odenet_tpu_torch.utils import profiling
from perfbench.work import gatode as gatode_work
from perfbench.work import gcnode as gcnode_work

WORK = {"gcnode": gcnode_work, "gatode": gatode_work}
STEPS = 4  # rk4 substeps, as the benchmark's configurations run them
LAYERS = 1 + 4 * STEPS + 1  # encoder, dynamics evaluations, readout
DYNAMICS = 4 * STEPS


@pytest.fixture(scope="module")
def data():
    return synthetic_ogbn_arxiv(seed=0, scale=0.004)


def _config(model, mode, remat, **kw):
    width = dict(hidden=8, heads=2) if model == "gatode" else dict(hidden=16)
    return ShardedTrainConfig(**{**dict(model=model, mode=mode, remat=remat, steps=STEPS,
                                        dropout=0.5, epochs=1, eval_every=1, seed=5),
                                 **width, **kw})


def test_annotate_enters_no_range_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.annotate("gode.train.step"):
        with profiling.annotate("gode.gat.softmax"):
            pass
    assert profiling.annotate("gode.a") is profiling.annotate("gode.b")


@pytest.mark.parametrize("name", profiling.SPANS)
def test_span_names_begin_with_gode_and_are_documented(name):
    assert name.startswith("gode.")
    assert f"``{name}``" in profiling.__doc__


def _counts(prof):
    """Each span's instances inside the one training step, inside the one
    evaluation, and in all."""
    events = [e for e in prof.events() if e.name.startswith("gode.")]

    def inside(outer):
        (o,) = [e for e in events if e.name == outer]
        out = {}
        for e in events:
            if e is not o and o.time_range.start <= e.time_range.start < o.time_range.end:
                out[e.name] = out.get(e.name, 0) + 1
        return out

    total = {}
    for e in events:
        total[e.name] = total.get(e.name, 0) + 1
    return inside("gode.train.step"), inside("gode.train.evaluate"), total


def _bucket_calls(model, cfg, data):
    g = data.graph
    shape = dict(n_pad=g.n_node_pad, n_edge=g.n_edge, f_in=data.features.shape[1],
                 n_class=data.n_class, bucket_edges=[[g.n_edge]])
    trainer = dict(hidden=cfg.hidden, heads=cfg.heads, steps=cfg.steps, remat=cfg.remat)
    ((train, evaluation),) = WORK[model].bucket_calls(trainer, shape, 1, 0).values()
    return len(train), len(evaluation)


@pytest.mark.parametrize("model,mode,remat", [
    ("gcnode", "ring", False),
    ("gatode", "ring_pallas", True),
    ("gatode", "ring_pallas", False),
    ("gatode", "ring", True),
    ("gatode", "ring", False),
])
def test_span_instances_per_step_and_evaluation(model, mode, remat, data, tmp_path):
    cfg = _config(model, mode, remat)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        fit_sharded_node_classifier(cfg, data, device="cpu")
    step, evaluation, total = _counts(prof)

    if model == "gcnode":
        softmax = (0, 0)
    elif mode == "ring_pallas":  # one softmax a layer; remat recomputes the dynamics'
        softmax = (LAYERS + (DYNAMICS if remat else 0), LAYERS)
    else:  # one hop with one part, two spans a hop
        softmax = (2 * (LAYERS + (DYNAMICS if remat else 0)), 2 * LAYERS)
    b2w = model == "gatode" and mode == "ring_pallas"
    bucket = _bucket_calls(model, cfg, data) if model == "gcnode" or b2w else (0, 0)
    want_step = {"gode.gat.softmax": softmax[0], "gode.bucket_reduce": bucket[0],
                 "gode.b2w.dpv": LAYERS if b2w else 0,
                 "gode.gat.recompute": DYNAMICS if remat else 0}
    want_eval = {"gode.gat.softmax": softmax[1], "gode.bucket_reduce": bucket[1],
                 "gode.b2w.dpv": 0, "gode.gat.recompute": 0, "gode.train.eval_read": 1}
    assert {k: step.get(k, 0) for k in want_step} == want_step
    assert {k: evaluation.get(k, 0) for k in want_eval} == want_eval
    assert "gode.train.loss_read" not in step and "gode.train.loss_read" not in evaluation
    for name in ("gode.train.step", "gode.train.evaluate", "gode.train.loss_read",
                 "gode.train.eval_read"):
        assert total[name] == 1, name
    assert set(total) <= set(profiling.SPANS)


def test_a_traced_run_trains_as_an_untraced_one(data, tmp_path):
    cfg = _config("gatode", "ring_pallas", True, epochs=3)
    plain = fit_sharded_node_classifier(cfg, data, device="cpu")
    with profiling.trace(str(tmp_path / "trace")):
        traced = fit_sharded_node_classifier(cfg, data, device="cpu")
    assert traced["losses"] == plain["losses"]
    for k, v in plain["params"].items():
        assert torch.equal(traced["params"][k], v), k
