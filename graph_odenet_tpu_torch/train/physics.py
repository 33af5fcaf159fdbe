"""Physics trainers: the discrete IN on one-step targets with autoregressive
rollout, and the IN-ODE fitted on trajectory windows (config 3).

Counterpart of ``graph_odenet_tpu/train/physics.py``: MSE and Adam (torch's
``Adam(lr, eps=1e-8)`` is optax's ``adam``), z-scored inputs for the
discrete IN (population std, as ``jnp.std``), windows of ``ode_window``
steps for the IN-ODE, each window solved as its own problem (the batched
solver: ``odeint(batch_dims=1)``, what ``jax.vmap`` gives the JAX package),
and rollout-MSE curves of both models on held-out trajectories.

Random draws come from CPU ``torch.Generator``s derived from ``cfg.seed``:
one for the data, one for the initialisation, one for the minibatch
permutations (the JAX package splits its key the same three ways), so the
initialisation does not depend on whether the data was passed in.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from graph_odenet_tpu_torch.data.nbody import SpringSystem, generate_trajectories, one_step_dataset
from graph_odenet_tpu_torch.models.interaction import INODE, InteractionNetwork
from graph_odenet_tpu_torch.utils.device import resolve_device
from graph_odenet_tpu_torch.utils.logging import MetricsLogger

__all__ = [
    "PhysicsConfig", "fit_interaction_network", "rollout_discrete", "rollout_mse",
    "fit_inode", "physics_rollout_curves", "trajectory_windows", "solver_summary",
]


@dataclasses.dataclass
class PhysicsConfig:
    # Data.
    n_bodies: int = 6
    dim: int = 2
    n_sims: int = 256
    n_steps: int = 200
    # Model.
    effect_dim: int = 50
    relation_hidden: tuple = (150, 150, 150, 150)
    object_hidden: tuple = (100,)
    # Optimisation.
    lr: float = 1e-3
    batch_size: int = 512
    epochs: int = 20
    seed: int = 0
    # IN-ODE.
    ode_method: str = "dopri5_scan"
    ode_steps: int = 16
    ode_window: int = 10        # trajectory timesteps fitted per sample
    ode_remat: bool = True      # recompute the dynamics in the backward
    rtol: float = 1e-4
    atol: float = 1e-6
    log_path: Optional[str] = None
    echo: bool = False


def _generators(seed: int):
    """The data, initialisation and permutation generators of ``seed``."""
    root = torch.Generator().manual_seed(seed)
    draws = torch.randint(0, 2**62, (3,), generator=root)
    return tuple(torch.Generator().manual_seed(int(s)) for s in draws)


def _make_data(cfg: PhysicsConfig, generator, device):
    system = SpringSystem(n_bodies=cfg.n_bodies, dim=cfg.dim)
    trajs = generate_trajectories(
        system, cfg.n_sims, cfg.n_steps, generator=generator, device=device
    )
    return system, trajs


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def fit_interaction_network(
    cfg: PhysicsConfig, trajs=None, system: Optional[SpringSystem] = None, *,
    device="cuda", init_state: Optional[dict] = None,
):
    """Train the discrete IN on one-step velocity targets.

    Runs on the card unless ``device="cpu"``; without a card the default
    raises.  ``trajs``/``system`` replace the generated data and
    ``init_state`` the seeded initialisation (``convert.params_from_interaction``
    carries the JAX package's over).  Returns the trained ``model`` and its
    ``params``, ``forward(states [B, N, 1+2D]) -> vel [B, N, D]`` (the
    standardisation included), the data, the last step's ``one_step_mse``,
    its value after every epoch (``history``) and the training ``seconds``.
    """
    device = resolve_device(device)
    data_gen, init_gen, perm_gen = _generators(cfg.seed)
    if trajs is None:
        system, trajs = _make_data(cfg, data_gen, device)
    trajs = trajs.to(device)
    senders, receivers = system.edges(device)
    inputs, targets = one_step_dataset(trajs, dim=cfg.dim)

    # Standardise (velocity targets can be tiny); jnp.std is the population std.
    in_mean = inputs.mean(dim=(0, 1))
    in_std = torch.clamp(inputs.std(dim=(0, 1), correction=0), min=1e-6)

    model = InteractionNetwork(
        1 + 2 * cfg.dim, cfg.dim, cfg.effect_dim, cfg.relation_hidden, cfg.object_hidden,
        generator=init_gen,
    )
    if init_state is not None:
        model.load_state_dict(init_state)
    model.to(device)

    def forward(states):
        return model((states - in_mean) / in_std, senders, receivers)

    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, eps=1e-8)
    n = inputs.shape[0]
    steps_per_epoch = max(n // cfg.batch_size, 1)
    log = MetricsLogger(cfg.log_path, echo=cfg.echo)
    history = []
    loss = torch.tensor(float("inf"))
    t0 = time.perf_counter()
    for epoch in range(cfg.epochs):
        perm = torch.randperm(n, generator=perm_gen).to(device)
        for s in range(steps_per_epoch):
            idx = perm[s * cfg.batch_size: (s + 1) * cfg.batch_size]
            opt.zero_grad(set_to_none=True)
            loss = torch.mean((forward(inputs[idx]) - targets[idx]) ** 2)
            loss.backward()
            opt.step()
        history.append(log.write(epoch=epoch, one_step_mse=loss.detach())["one_step_mse"])
    seconds = time.perf_counter() - t0
    log.close()
    return dict(
        params=model.state_dict(), model=model, forward=forward, system=system, trajs=trajs,
        one_step_mse=float(loss.detach()), history=history, seconds=seconds,
    )


def rollout_discrete(forward, system: SpringSystem, init_states, horizon: int):
    """Autoregressive rollout: v̂ = IN(state); pos ← pos + dt·v̂.

    ``init_states [B, N, 1+2D]`` → predicted trajectories
    ``[B, horizon+1, N, 1+2D]``.
    """
    dim, dt = system.dim, system.dt
    states, out = init_states, [init_states]
    for _ in range(horizon):
        vel = forward(states)
        pos = states[..., 1:1 + dim] + dt * vel
        states = torch.cat([states[..., :1], pos, vel], dim=-1)
        out.append(states)
    return torch.stack(out, dim=1)


def rollout_mse(pred_traj, true_traj, dim: int = 2):
    """Position MSE per horizon step: the rollout curve ``[T]``."""
    p = pred_traj[..., 1:1 + dim]
    t = true_traj[..., 1:1 + dim]
    return torch.mean((p - t) ** 2, dim=(0, 2, 3))


def trajectory_windows(trajs, window: int):
    """``[S, T+1, N, F]`` → ``[S · (T // window), window+1, N, F]``: each
    simulation's consecutive windows (sharing their end states), sim-major."""
    s, t1, n, f = trajs.shape
    n_win = (t1 - 1) // window
    wins = torch.stack([trajs[:, i * window: i * window + window + 1] for i in range(n_win)], 1)
    return wins.reshape(s * n_win, window + 1, n, f)


def solver_summary(stats: dict, n_intervals: int) -> dict:
    """JSON-able digest of one forward's solver stats: the attempts each
    sample made per output interval (min, median, max over the samples), the
    NFE per sample, the host reads, whether every sample reached every output
    time and the share that did, and for VCABM the spread of the final order.
    Fixed-grid methods report their NFE only."""
    if "n_accept" not in stats:
        return dict(nfe=stats["nfe"])

    def spread(x):
        x = x.double().cpu()
        return dict(min=float(x.min()), median=float(x.quantile(0.5)), max=float(x.max()))

    attempts = (stats["n_accept"] + stats["n_reject"]).double()
    out = dict(
        attempts_per_interval=spread(attempts / n_intervals),
        nfe=spread(stats["nfe"]), host_reads=stats["host_reads"],
        success=bool(stats["success"].all()),
        success_share=float(stats["success"].double().mean()),
    )
    if "final_order" in stats:
        out["final_order"] = spread(stats["final_order"])
    return out


def fit_inode(
    cfg: PhysicsConfig, trajs=None, system: Optional[SpringSystem] = None, *,
    device="cuda", init_state: Optional[dict] = None,
):
    """Train the IN-ODE by fitting trajectory windows with the solver in the loop.

    ``cfg.ode_method`` is any method with a backward: the fixed-grid ones,
    the adaptive RK ones and VCABM (``adams``, ``adams_scan``), each window
    its own problem; ``scipy_solver``, forward only, raises in the first
    backward, as JAX's does.  Arguments as ``fit_interaction_network``.
    Returns the trained ``model`` and its ``params``, ``forward(windows [B,
    W+1, N, 1+2D]) -> [B, W+1, N, 2D]``, the data, the last step's
    ``window_mse``, its value after every epoch (``history``), the training
    ``seconds`` and ``solver``, the ``solver_summary`` of the last training
    forward.
    """
    device = resolve_device(device)
    data_gen, init_gen, perm_gen = _generators(cfg.seed)
    if trajs is None:
        system, trajs = _make_data(cfg, data_gen, device)
    trajs = trajs.to(device)
    senders, receivers = system.edges(device)
    window = cfg.ode_window
    wins = trajectory_windows(trajs, window)

    model = INODE(
        dim=cfg.dim, effect_dim=cfg.effect_dim, relation_hidden=cfg.relation_hidden,
        object_hidden=cfg.object_hidden, method=cfg.ode_method, steps=cfg.ode_steps,
        remat=cfg.ode_remat, rtol=cfg.rtol, atol=cfg.atol, generator=init_gen,
    )
    if init_state is not None:
        model.load_state_dict(init_state)
    model.to(device)
    # On the CPU: the solver reads its direction from it without a device sync.
    ts = torch.arange(window + 1, dtype=torch.float32) * system.dt

    def forward(batch):
        w0 = batch[:, 0]
        return model(w0[..., 1:], ts, w0[..., :1], senders, receivers)

    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, eps=1e-8)
    nb = wins.shape[0]
    bs = min(cfg.batch_size, nb)
    steps_per_epoch = max(nb // bs, 1)
    log = MetricsLogger(cfg.log_path, echo=cfg.echo)
    history = []
    loss = torch.tensor(float("inf"))
    t0 = time.perf_counter()
    for epoch in range(cfg.epochs):
        perm = torch.randperm(nb, generator=perm_gen).to(device)
        for st in range(steps_per_epoch):
            batch = wins[perm[st * bs: (st + 1) * bs]]
            opt.zero_grad(set_to_none=True)
            loss = torch.mean((forward(batch) - batch[..., 1:]) ** 2)
            loss.backward()
            opt.step()
        history.append(log.write(epoch=epoch, window_mse=loss.detach())["window_mse"])
    seconds = time.perf_counter() - t0
    log.close()
    return dict(
        params=model.state_dict(), model=model, forward=forward, system=system, trajs=trajs,
        window_mse=float(loss.detach()), history=history, seconds=seconds,
        solver=solver_summary(model.stats, window) if model.stats else None,
    )


def physics_rollout_curves(cfg: PhysicsConfig, horizon: int = 50, n_test: int = 64, *,
                           device="cuda"):
    """Config 3's deliverable: train the discrete IN and the IN-ODE on shared
    trajectories, then roll both out over ``horizon`` steps from held-out
    initial states and report the position MSE at every step.

    Runs on the card unless ``device="cpu"``.  Returns a JSON-able dict with
    the curves ``rollout_mse_discrete`` and ``rollout_mse_inode`` (index =
    horizon step), the training summaries and histories, the solver digests
    of the last training forward and of the rollout, and ``device``, the
    card's name (``"cpu"`` on the CPU).
    """
    t0 = time.perf_counter()
    device = resolve_device(device)
    data_gen = _generators(cfg.seed)[0]
    system, trajs = _make_data(cfg, data_gen, device)
    test_trajs = generate_trajectories(
        system, n_test, horizon + 1, generator=data_gen, device=device
    )

    res_in = fit_interaction_network(cfg, trajs, system, device=device)
    res_ode = fit_inode(cfg, trajs, system, device=device)

    truth = test_trajs[:, : horizon + 1]
    init = test_trajs[:, 0]  # [B, N, 1+2D]
    model = res_ode["model"]
    # One long integration over the horizon, with the attempt budget scaled
    # so the solver can resolve the longer span.
    long_model = INODE(
        dim=cfg.dim, effect_dim=cfg.effect_dim, relation_hidden=cfg.relation_hidden,
        object_hidden=cfg.object_hidden, method=model.method, rtol=model.rtol,
        atol=model.atol, remat=model.remat,
        steps=max(model.steps * (horizon // cfg.ode_window + 1), 64),
    )
    long_model.load_state_dict(model.state_dict())
    long_model.to(device)
    ts = torch.arange(horizon + 1, dtype=torch.float32) * system.dt
    senders, receivers = system.edges(device)
    with torch.no_grad():
        pred_disc = rollout_discrete(res_in["forward"], system, init, horizon)
        mse_disc = rollout_mse(pred_disc, truth, cfg.dim)
        y = long_model(init[..., 1:], ts, init[..., :1], senders, receivers)  # [B, T, N, 2D]
        mass = init[:, None, :, :1].expand(y.shape[:-1] + (1,))
        mse_ode = rollout_mse(torch.cat([mass, y], dim=-1), truth, cfg.dim)
    return dict(
        config="physics-in-ode",
        device=_device_name(device),
        horizon=horizon,
        n_test=n_test,
        dt=float(system.dt),
        one_step_mse=res_in["one_step_mse"],
        window_mse=res_ode["window_mse"],
        one_step_mse_history=res_in["history"],
        window_mse_history=res_ode["history"],
        train_seconds_in=res_in["seconds"],
        train_seconds_inode=res_ode["seconds"],
        train_solver=res_ode["solver"],
        rollout_solver=solver_summary(long_model.stats, horizon),
        rollout_mse_discrete=mse_disc.tolist(),
        rollout_mse_inode=mse_ode.tolist(),
        cfg=dataclasses.asdict(cfg),
        total_seconds=time.perf_counter() - t0,
    )
