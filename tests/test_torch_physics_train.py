"""Port parity: the physics trainers against the JAX package's, and config 3
on the CPU.

Three Adam steps of each trainer, from the JAX trainer's initial parameters
and trajectories with a batch that holds every sample (the permutation then
only reorders a mean), land on the JAX trainer's loss and parameters to
1e-4 (float32).  Gradients stay finite at config 3's solver settings.
``physics_rollout_curves`` and ``run_config(3, rollout=...)`` run on the CPU
at a tiny size.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_odenet_tpu.data.nbody import SpringSystem as JSpringSystem
from graph_odenet_tpu.data.nbody import generate_trajectories as jgenerate
from graph_odenet_tpu.data.nbody import one_step_dataset as jone_step
from graph_odenet_tpu.models import InteractionNetwork as JIN
from graph_odenet_tpu.train.physics import PhysicsConfig as JPhysicsConfig
from graph_odenet_tpu.train.physics import fit_inode as jfit_inode
from graph_odenet_tpu.train.physics import fit_interaction_network as jfit_in
from graph_odenet_tpu_torch.configs import run_config
from graph_odenet_tpu_torch.convert import params_from_interaction
from graph_odenet_tpu_torch.data import SpringSystem
from graph_odenet_tpu_torch.train import PhysicsConfig, fit_inode, fit_interaction_network
from graph_odenet_tpu_torch.train.physics import physics_rollout_curves, trajectory_windows

TOL = dict(rtol=1e-4, atol=1e-4)
WIDTHS = dict(effect_dim=8, relation_hidden=(16, 16), object_hidden=(16,))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_data(cfg):
    jsys = JSpringSystem(n_bodies=cfg.n_bodies)
    trajs = np.asarray(jgenerate(jsys, jax.random.PRNGKey(7), cfg.n_sims, cfg.n_steps), np.float32)
    return jsys, trajs


def _jax_init_key(seed):
    """The key the JAX trainers initialise from (after the data key)."""
    key, _ = jax.random.split(jax.random.PRNGKey(seed))
    return jax.random.split(key)[1]


TRAIN = dict(n_bodies=3, n_sims=4, n_steps=8, epochs=3, batch_size=64, seed=2, **WIDTHS)


def _check_params(got, jparams):
    want = params_from_interaction(_numpy_tree(jparams))
    for k in want:
        torch.testing.assert_close(got[k], want[k], **TOL, msg=lambda m, k=k: f"{k}: {m}")


def test_fit_interaction_network_three_adam_steps_match_optax():
    jcfg = JPhysicsConfig(**TRAIN)
    jsys, trajs = _jax_data(jcfg)
    jres = jfit_in(jcfg, trajs=jnp.asarray(trajs), system=jsys)
    # The JAX trainer's initialisation, on its own standardised first sample.
    inputs, _ = jone_step(jnp.asarray(trajs))
    mean, std = inputs.mean(axis=(0, 1)), jnp.maximum(inputs.std(axis=(0, 1)), 1e-6)
    jmodel = JIN(out_dim=2, **WIDTHS)
    s, r = jsys.edges()
    jinit = jmodel.init(_jax_init_key(jcfg.seed), (inputs[0] - mean) / std, s, r)["params"]

    res = fit_interaction_network(
        PhysicsConfig(**TRAIN), torch.from_numpy(trajs), SpringSystem(n_bodies=3),
        device="cpu", init_state=params_from_interaction(_numpy_tree(jinit)),
    )
    assert len(res["history"]) == 3
    np.testing.assert_allclose(res["one_step_mse"], jres["one_step_mse"], **TOL)
    _check_params(res["params"], jres["params"])


@pytest.mark.parametrize("method", ["dopri5_scan", "rk4", "adams_scan"])
def test_fit_inode_three_adam_steps_match_optax(method):
    cfg = dict(TRAIN, ode_method=method, ode_steps=4, ode_window=4)
    jcfg = JPhysicsConfig(**cfg)
    jsys, trajs = _jax_data(jcfg)
    jres = jfit_inode(jcfg, trajs=jnp.asarray(trajs), system=jsys)
    wins = trajectory_windows(torch.from_numpy(trajs), 4).numpy()
    assert wins.shape == (8, 5, 3, 5)
    s, r = jsys.edges()
    jinit = jres["model"].init(
        _jax_init_key(jcfg.seed), jnp.asarray(wins[0, 0, :, 1:]),
        jnp.arange(5, dtype=jnp.float32) * jsys.dt, jnp.asarray(wins[0, 0, :, :1]), s, r,
    )["params"]

    res = fit_inode(
        PhysicsConfig(**cfg), torch.from_numpy(trajs), SpringSystem(n_bodies=3), device="cpu",
        init_state=params_from_interaction(_numpy_tree(jinit)),
    )
    np.testing.assert_allclose(res["window_mse"], jres["window_mse"], **TOL)
    _check_params(res["params"], jres["params"])
    if method == "dopri5_scan":
        assert res["solver"]["success"] and res["solver"]["host_reads"] >= 4
    if method == "adams_scan":
        assert res["solver"]["final_order"]["max"] >= 1


def test_gradients_finite_at_the_configs_solver_settings():
    """dopri5_scan, 16 attempts, remat: done samples still compute an attempt,
    whose zero cotangent must not turn into NaN."""
    cfg = PhysicsConfig(n_bodies=3, n_sims=2, n_steps=20, **WIDTHS)
    res = fit_inode(dataclasses.replace(cfg, epochs=1), device="cpu")
    model = res["model"]
    batch = trajectory_windows(res["trajs"], cfg.ode_window)
    loss = torch.mean((res["forward"](batch) - batch[..., 1:]) ** 2)
    loss.backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    assert model.stats["success"].all()


CURVES = dict(n_bodies=3, n_sims=8, n_steps=20, epochs=1, batch_size=64, ode_steps=2,
              ode_window=5, relation_hidden=(32,), object_hidden=(32,), seed=1)


def _check_curves(out, horizon):
    for key in ("rollout_mse_discrete", "rollout_mse_inode"):
        curve = np.asarray(out[key])
        assert curve.shape == (horizon + 1,) and np.all(np.isfinite(curve)), key
        assert curve[0] < 1e-9, key
    assert np.isfinite(out["one_step_mse"]) and np.isfinite(out["window_mse"])
    assert out["device"] == "cpu" and out["horizon"] == horizon


@pytest.mark.parametrize("method", ["rk4", "dopri5_scan", "adams_scan"])
def test_physics_rollout_curves(method):
    out = physics_rollout_curves(PhysicsConfig(**CURVES, ode_method=method), horizon=6,
                                 n_test=4, device="cpu")
    _check_curves(out, 6)
    assert len(out["one_step_mse_history"]) == len(out["window_mse_history"]) == 1
    if method != "rk4":
        assert out["rollout_solver"]["success"]
        assert out["rollout_solver"]["attempts_per_interval"]["max"] <= 64
    if method == "adams_scan":
        assert out["rollout_solver"]["final_order"]["max"] >= 1


def test_run_config_3_with_rollout_on_cpu():
    out = run_config(3, scale=0.01, rollout=6, device="cpu")
    _check_curves(out, 6)
    assert out["config"] == "nbody-inode-rollout" and out["n_test"] == 4
    assert (out["cfg"]["n_sims"], out["cfg"]["n_steps"]) == (8, 20)
    assert out["cfg"]["relation_hidden"] == (150, 150, 150, 150)
    assert out["window_mse_history"][-1] < out["window_mse_history"][0]


def test_plots(tmp_path):
    pytest.importorskip("matplotlib")
    from graph_odenet_tpu_torch.utils.plots import (
        plot_rollout_mse,
        plot_training_curve,
        plot_trajectories,
    )

    rng = np.random.default_rng(0)
    traj = torch.from_numpy(rng.standard_normal((20, 4, 5)).cumsum(axis=0))
    paths = [tmp_path / f"{k}.png" for k in ("traj", "mse", "curve")]
    plot_trajectories(traj, traj + 0.05, dim=2, path=str(paths[0]))
    plot_rollout_mse(np.abs(rng.standard_normal((2, 30))), labels=["a", "b"], path=str(paths[1]))
    plot_training_curve([{"loss": 1 / (i + 1)} for i in range(10)], path=str(paths[2]))
    assert all(p.stat().st_size > 1000 for p in paths)
