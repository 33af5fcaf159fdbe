"""The port's command line (``graph_odenet_tpu_torch.cli``) on the CPU, after
``tests/test_cli.py``: ``node``, ``physics --rollout``, ``config``'s
plumbing and the save → ``predict`` round trip with ``--device cpu``, and
the ``NodeClassConfig`` both CLIs build from the same flags."""

import contextlib
import dataclasses
import io
import json

import pytest
import torch

import graph_odenet_tpu.train as jtrain
from graph_odenet_tpu.cli import main as jmain
from graph_odenet_tpu_torch import configs
from graph_odenet_tpu_torch.cli import main, node_config, parser


def capture_json(argv):
    """Run the port's CLI, return its last stdout line parsed as JSON."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_node():
    out = capture_json([
        "node", "--model", "gcn", "--dataset", "cora", "--scale", "0.08",
        "--epochs", "40", "--patience", "40", "--quiet", "--device", "cpu",
    ])
    # Plumbing: well above 7-class chance (~0.14) on the tiny twin.
    assert out["best"]["test_acc"] > 0.35
    assert out["epochs_run"] == 40


def test_cli_physics_rollout():
    out = capture_json([
        "physics", "--n-sims", "12", "--n-steps", "20", "--epochs", "1",
        "--n-bodies", "4", "--rollout", "5", "--device", "cpu",
    ])
    assert "one_step_mse" in out and "rollout_mse" in out
    with pytest.raises(SystemExit):  # the IN-ODE's rollout is config 3's
        main(["physics", "--ode", "--rollout", "5", "--device", "cpu"])


def test_cli_config_plumbing(monkeypatch):
    out = capture_json(["config", "0", "--scale", "0.08", "--seed", "3", "--device", "cpu"])
    assert (out["config"], out["dataset"]) == ("cora-gcn-discrete", "cora-synthetic")
    assert "params" not in out and 0.0 <= out["best"]["test_acc"] <= 1.0
    seen = {}
    monkeypatch.setattr(configs, "run_config", lambda i, **kw: seen.update(i=i, **kw) or {})
    capture_json(["config", "nbody-inode-rollout", "--scale", "0.5", "--calibrated",
                  "--rollout", "7", "--device", "cpu"])
    assert seen == dict(i="nbody-inode-rollout", scale=0.5, calibrated=True, seed=None,
                        rollout=7, device="cpu")


@pytest.mark.parametrize("model", ["gcn", "gatode"])
def test_cli_train_save_predict_roundtrip(tmp_path, model):
    """Training with --ckpt-dir, then ``predict`` restores the same params."""
    ck = str(tmp_path / "ck")
    common = ["--scale", "0.2", "--model", model, "--heads", "2", "--device", "cpu"]
    out = capture_json(["node", "--epochs", "12", "--ckpt-dir", ck, "--quiet", *common])
    pred = capture_json(["predict", "--ckpt-dir", ck, *common])
    assert pred["test_acc"] == out["best"]["test_acc"]
    assert pred["n_node"] > 0


def test_cli_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["node", "--scale", "0.08", "--epochs", "1"])


@pytest.mark.parametrize("argv", [
    ["node"],
    ["node", "--model", "gatode", "--hidden", "8", "--heads", "4", "--dropout", "0.3",
     "--t1", "2", "--method", "dopri5_scan", "--steps", "7", "--rtol", "1e-4", "--atol", "1e-5",
     "--adjoint", "checkpoint", "--lr", "0.005", "--weight-decay", "1e-3", "--epochs", "3",
     "--patience", "2", "--seed", "5", "--representation", "dense", "--log-path", "m.jsonl",
     "--quiet"],
    ["node", "--adjoint"],
    ["node", "--adjoint", "false", "--representation", "segment"],
])
def test_both_clis_build_the_same_node_config(monkeypatch, argv):
    seen = []

    def fake_fit(cfg, data):
        seen.append(cfg)
        return dict(best=dict(epoch=0), epochs_run=0, seconds=0.0, params={})

    monkeypatch.setattr(jtrain, "fit_node_classifier", fake_fit)
    with contextlib.redirect_stdout(io.StringIO()):
        jmain(argv + ["--scale", "0.05"])
    want = dataclasses.asdict(seen[0])
    got = dataclasses.asdict(node_config(parser().parse_args(argv)))
    assert got == want


def test_entry_matches_graft_entry():
    """``entry()``'s forward with the JAX entry's parameters (``convert``)
    against ``__graft_entry__.entry()``'s logits."""
    import importlib.util
    import os

    import jax
    import numpy as np

    from graph_odenet_tpu_torch.convert import params_from_flax
    from graph_odenet_tpu_torch.entry import entry

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("graft_entry", os.path.join(root,
                                                                             "__graft_entry__.py"))
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)
    jfn, (jparams, jadj, jx) = graft.entry()
    want = np.asarray(jax.jit(jfn)(jparams, jadj, jx))

    fn, (params, adj, x) = entry(device="cpu")
    assert set(params) == set(params_from_flax(jax.tree.map(np.asarray, jparams)))
    np.testing.assert_allclose(adj.numpy(), np.asarray(jadj))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx))
    with torch.no_grad():
        got = fn(params_from_flax(jax.tree.map(np.asarray, jparams)), adj, x)
        assert torch.isfinite(fn(params, adj, x)).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
