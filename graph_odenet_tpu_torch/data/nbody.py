"""Spring n-body simulator, vectorised over simulations on the device.

Counterpart of ``graph_odenet_tpu/data/nbody.py``: the state of a body is
``(mass, pos[D], vel[D])``, the force on body i is
``Σ_j −k·(|d|−L)·d̂ − γ·vel`` with ``d = x_i − x_j``, and the stepper is
semi-implicit Euler.  The JAX package scans each simulation and vmaps over
them; here one Python loop steps every simulation at once.

Initial states are drawn from an explicit CPU ``torch.Generator`` and then
moved to the device, so a seed gives the same data on the CPU and on the
card.  The draws are torch's, not ``jax.random``'s: the tests feed the JAX
package's initial states to ``simulate`` instead.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["SpringSystem", "simulate", "generate_trajectories", "one_step_dataset"]


@dataclasses.dataclass(frozen=True)
class SpringSystem:
    n_bodies: int = 6
    dim: int = 2
    stiffness: float = 0.5
    rest_length: float = 1.0
    damping: float = 0.02
    dt: float = 0.01
    # Initial-condition scales.
    mass_range: tuple = (0.5, 2.0)
    pos_scale: float = 2.0
    vel_scale: float = 0.5

    def edges(self, device=None):
        """Fully connected directed edges without self loops, sender-major:
        ``(senders [E], receivers [E])`` as int64."""
        n = self.n_bodies
        s, r = torch.meshgrid(
            torch.arange(n, device=device), torch.arange(n, device=device), indexing="ij"
        )
        mask = s != r
        return s[mask], r[mask]

    def acceleration(self, mass, pos, vel):
        """``[..., N, 1]``, ``[..., N, D]``, ``[..., N, D]`` → ``[..., N, D]``:
        spring and damping acceleration."""
        d = pos[..., :, None, :] - pos[..., None, :, :]  # [..., N, N, D] x_i − x_j
        dist = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True) + 1e-12)
        eye = torch.eye(self.n_bodies, dtype=pos.dtype, device=pos.device)[..., None]
        force_pair = -self.stiffness * (dist - self.rest_length) * (d / dist)
        force_pair = force_pair * (1.0 - eye)  # no self force
        force = torch.sum(force_pair, dim=-2) - self.damping * vel
        return force / mass

    def step(self, mass, pos, vel):
        """Semi-implicit Euler: the velocity first, then the position with it."""
        vel = vel + self.dt * self.acceleration(mass, pos, vel)
        pos = pos + self.dt * vel
        return pos, vel

    def init_state(self, generator: torch.Generator, n_sims: Optional[int] = None):
        """Masses, positions and velocities drawn on the CPU from ``generator``:
        ``[N, 1]``, ``[N, D]``, ``[N, D]``, or with a leading ``n_sims`` axis."""
        lead = () if n_sims is None else (n_sims,)
        lo, hi = self.mass_range
        mass = lo + (hi - lo) * torch.rand(lead + (self.n_bodies, 1), generator=generator)
        pos = self.pos_scale * torch.randn(lead + (self.n_bodies, self.dim), generator=generator)
        vel = self.vel_scale * torch.randn(lead + (self.n_bodies, self.dim), generator=generator)
        return mass, pos, vel


def simulate(system: SpringSystem, mass, pos, vel, n_steps: int, record_every: int = 1):
    """Step the initial states ``mass [..., N, 1]``, ``pos``, ``vel [..., N, D]``.

    Returns ``[..., n_steps + 1, N, 1 + 2D]``: (mass ‖ pos ‖ vel) at the start
    and after every ``record_every`` steps.
    """
    frames = [torch.cat([pos, vel], dim=-1)]
    for _ in range(n_steps):
        for _ in range(record_every):
            pos, vel = system.step(mass, pos, vel)
        frames.append(torch.cat([pos, vel], dim=-1))
    traj = torch.stack(frames, dim=-3)
    mass_t = mass.unsqueeze(-3).expand(traj.shape[:-1] + (1,))
    return torch.cat([mass_t, traj], dim=-1)


def generate_trajectories(
    system: SpringSystem, n_sims: int, n_steps: int, record_every: int = 1, *,
    generator: torch.Generator, device="cpu",
):
    """→ f32 ``[n_sims, n_steps + 1, N, 1 + 2D]`` (mass ‖ pos ‖ vel) trajectories,
    simulated on ``device`` from initial states drawn from ``generator``."""
    mass, pos, vel = (x.to(device) for x in system.init_state(generator, n_sims))
    return simulate(system, mass, pos, vel, n_steps, record_every)


def one_step_dataset(trajs, dim: int = 2):
    """(state_t → vel_{t+1}) pairs for discrete-IN training.

    Returns ``(states [B, N, 1+2D], target_vel [B, N, D])`` with
    ``B = n_sims · n_steps``.
    """
    s, t1, n, f = trajs.shape
    inputs = trajs[:, :-1].reshape(s * (t1 - 1), n, f)
    targets = trajs[:, 1:, :, 1 + dim:].reshape(s * (t1 - 1), n, dim)
    return inputs, targets
