"""Trajectory and training plots of the physics runs.

Counterpart of ``graph_odenet_tpu/utils/plots.py``.  Headless (Agg) and
optional: matplotlib is imported when a plot is drawn, and nothing else in
the package imports this module.
"""

from __future__ import annotations

import numpy as np

__all__ = ["plot_trajectories", "plot_rollout_mse", "plot_training_curve"]


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _numpy(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def plot_trajectories(true_traj, pred_traj=None, *, dim: int = 2, path=None):
    """XY traces of every body: ground truth solid, prediction dashed.

    Args:
      true_traj: ``[T, N, 1+2·dim]`` state trajectory (mass, pos, vel), a
        tensor or an array.
      pred_traj: optional same-shape model rollout to overlay.
      path: write a PNG there if given; returns the figure either way.
    """
    plt = _plt()
    true_traj = _numpy(true_traj)
    n = true_traj.shape[1]
    fig, ax = plt.subplots(figsize=(6, 6))
    colors = plt.cm.tab10(np.linspace(0, 1, min(n, 10)))
    for i in range(n):
        c = colors[i % len(colors)]
        pos = true_traj[:, i, 1:1 + dim]
        ax.plot(pos[:, 0], pos[:, 1], "-", color=c, lw=1.5,
                label=f"body {i}" if i < 10 else None)
        ax.plot(pos[0, 0], pos[0, 1], "o", color=c, ms=5)
        if pred_traj is not None:
            ppos = _numpy(pred_traj)[:, i, 1:1 + dim]
            ax.plot(ppos[:, 0], ppos[:, 1], "--", color=c, lw=1.2)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_title("n-body trajectories (solid=true, dashed=model)")
    ax.set_aspect("equal")
    if n <= 10:
        ax.legend(fontsize=7)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


def plot_rollout_mse(mse_per_step, *, labels=None, path=None):
    """Rollout-horizon MSE curves (one line per model variant)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    arrs = np.atleast_2d(_numpy(mse_per_step))
    for i, row in enumerate(arrs):
        ax.semilogy(row, label=(labels[i] if labels else None))
    ax.set_xlabel("rollout step")
    ax.set_ylabel("MSE")
    ax.set_title("rollout error growth")
    if labels:
        ax.legend()
    ax.grid(True, alpha=0.3)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


def plot_training_curve(history, *, keys=("loss",), path=None):
    """Per-epoch metric curves from a list of metric dicts (JSONL rows)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for k in keys:
        ys = [float(h[k]) for h in history if k in h]
        ax.plot(ys, label=k)
    ax.set_xlabel("epoch")
    ax.legend()
    ax.grid(True, alpha=0.3)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig
