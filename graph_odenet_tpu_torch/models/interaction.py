"""Interaction networks (Battaglia et al. 2016), discrete and ODE form.

Counterpart of ``graph_odenet_tpu/models/interaction.py``.  Object states
are gathered onto the relations by index, the relation MLP's effects are
summed onto their receivers with ``index_add`` (the JAX package's
``segment_sum``; out of place, so that ``torch.func.vmap`` can run it one
sample at a time), and the object MLP maps ``[o ‖ Σ effects ‖ ext]`` to the
output.  Every module takes any leading batch axes (the JAX package vmaps).
On a card ``index_add`` adds with atomics in the order the card schedules
them; under ``torch.use_deterministic_algorithms(True)`` it sums in a fixed
order.

Defaults are the published IN sizes: relation MLP 4 × 150 → 50-dim effects,
object MLP 100 hidden.  Initialisation is flax's ``Dense`` default
(LeCun-normal kernels, truncated at two standard deviations, zero biases),
drawn from an explicit CPU ``torch.Generator``.

``dtype``/``param_dtype`` are flax's (``models/gcn.py``): each dense layer
computes in ``dtype``, input, kernel and bias.  The concatenations promote
as JAX's do, so the IN-ODE's state keeps ``y0``'s dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from graph_odenet_tpu_torch.models.gcn import Typed, dense
from graph_odenet_tpu_torch.ode import odeint, odeint_adjoint

__all__ = ["MLP", "InteractionNetwork", "INODE"]

# Standard deviation of a unit normal truncated to [-2, 2]: flax's
# ``truncated_normal`` initialisers divide by it to keep the variance.
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(weight: torch.Tensor, generator) -> None:
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


class MLP(Typed):
    """Dense layers with an activation between them, none after the last."""

    def __init__(
        self, in_features: int, hidden: Sequence[int], out: int, activation: str = "relu",
        *, dtype: torch.dtype = torch.float32, param_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        widths = [in_features, *hidden, out]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        for layer in self.layers:
            _lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)
        self.activation = getattr(torch.nn.functional, activation)
        self.to(param_dtype)
        self.dtype = dtype

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = self.activation(dense(x, layer, self.dtype))
        return dense(x, self.layers[-1], self.dtype)


class InteractionNetwork(nn.Module):
    """effects = φ_R([o_src ‖ o_dst ‖ r_attr]);  out = φ_O([o ‖ Σ effects ‖ ext]).

    ``forward(objs [..., N, Do], senders [E], receivers [E], rel_attr
    [..., E, Dr]?, ext [..., N, De]?) -> [..., N, out_dim]``.
    """

    def __init__(
        self, obj_dim: int, out_dim: int, effect_dim: int = 50,
        relation_hidden: Sequence[int] = (150, 150, 150, 150),
        object_hidden: Sequence[int] = (100,), rel_dim: int = 0, ext_dim: int = 0,
        *, dtype: torch.dtype = torch.float32, param_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        self.relation_mlp = MLP(2 * obj_dim + rel_dim, relation_hidden, effect_dim, **kw)
        self.object_mlp = MLP(obj_dim + effect_dim + ext_dim, object_hidden, out_dim, **kw)

    def forward(self, objs, senders, receivers, rel_attr=None, ext=None):
        node_axis = objs.dim() - 2
        rel_in = [objs.index_select(node_axis, senders), objs.index_select(node_axis, receivers)]
        if rel_attr is not None:
            rel_in.append(rel_attr)
        effects = self.relation_mlp(torch.cat(rel_in, dim=-1))
        agg = effects.new_zeros(objs.shape[:-1] + effects.shape[-1:])
        agg = agg.index_add(node_axis, receivers, effects)
        obj_in = [objs, agg]
        if ext is not None:
            obj_in.append(ext)
        return self.object_mlp(torch.cat(obj_in, dim=-1))


class INODE(nn.Module):
    """Interaction network as continuous dynamics.

    The state ``y [..., N, 2D]`` is position ‖ velocity; the IN predicts the
    acceleration from ``[static_attr ‖ pos ‖ vel]``, so the vector field is
    ``d pos/dt = vel, d vel/dt = IN(...)``.

    ``forward(y0, ts, static_attr, senders, receivers, rel_attr=None)``
    integrates over ``ts`` and returns the trajectory ``[T, N, 2D]`` for
    ``y0 [N, 2D]``, or ``[B, T, N, 2D]`` for a batch ``y0 [B, N, 2D]`` (with
    ``static_attr [B, N, Ds]``), each window solved as its own problem
    (``odeint(batch_dims=1)``: its own steps, and on ``adams``/``adams_scan``
    its own order, as under ``jax.vmap``; on ``scipy_solver`` one host solve
    a window, forward only, each of whose evaluations runs the whole batch:
    B windows cost B times the evaluations of B solves alone, and a copy to
    the host and back each).  The solver stats of the last forward are kept
    in ``stats``.

    ``remat=True`` recomputes each dynamics call in the backward
    (``torch.utils.checkpoint``) instead of storing its activations.
    ``adjoint=True`` trains with the continuous adjoint, ``"checkpoint"``
    with the checkpointed-forward adjoint (``ode.odeint_adjoint``), each
    window of a batch its own problem there too.  The continuous adjoint
    takes every method, the checkpointed one the fixed-grid and explicit
    adaptive ones, as JAX's do.
    """

    def __init__(
        self, dim: int = 2, static_dim: int = 1, effect_dim: int = 50,
        relation_hidden: Sequence[int] = (150, 150, 150, 150),
        object_hidden: Sequence[int] = (100,), method: str = "dopri5_scan",
        rtol: float = 1e-4, atol: float = 1e-6, steps: int = 16,
        adjoint: Union[bool, str] = False, remat: bool = False, rel_dim: int = 0,
        *, dtype: torch.dtype = torch.float32, param_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.core = InteractionNetwork(
            static_dim + 2 * dim, dim, effect_dim, relation_hidden, object_hidden,
            rel_dim=rel_dim, dtype=dtype, param_dtype=param_dtype, generator=generator,
        )
        self.dim = dim
        self.method, self.rtol, self.atol, self.steps = method, rtol, atol, steps
        self.adjoint = adjoint
        self.remat = remat
        self.stats = None

    def _accel(self, objs, senders, receivers, rel_attr, params):
        """The core's output.  ``params`` with a leading batch axis, one copy of
        each core parameter per sample (what the batched continuous adjoint
        passes), runs each sample with its own copy."""
        if not params or params[0].shape == next(self.core.parameters()).shape:
            return self.core(objs, senders, receivers, rel_attr)
        named = dict(zip((k for k, _ in self.core.named_parameters()), params))

        def one(p, o, *r):
            return torch.func.functional_call(self.core, p, (o, senders, receivers, *r))

        return torch.func.vmap(one)(named, objs, *(() if rel_attr is None else (rel_attr,)))

    def _dynamics(self, t, y, static_attr, senders, receivers, rel_attr, *params):
        del t  # autonomous
        vel = y[..., self.dim:]
        objs = torch.cat([static_attr, y], dim=-1)  # [static ‖ pos ‖ vel]
        return torch.cat([vel, self._accel(objs, senders, receivers, rel_attr, params)], dim=-1)

    def field(self, static_attr, senders, receivers, rel_attr=None):
        """The vector field ``f(t, y, *params)`` that ``forward`` integrates;
        without ``params`` it reads the core's own parameters."""

        def f(t, y, *params):
            args = (t, y, static_attr, senders, receivers, rel_attr, *params)
            if self.remat:
                # The dynamics draws no random numbers: no RNG state to restore.
                return checkpoint(self._dynamics, *args, use_reentrant=False,
                                  preserve_rng_state=False)
            return self._dynamics(*args)

        return f

    def forward(self, y0, ts, static_attr, senders, receivers, rel_attr=None):
        if y0.dim() not in (2, 3):
            raise ValueError(f"y0 must be [N, 2D] or [B, N, 2D], got {tuple(y0.shape)}")
        batch_dims = y0.dim() - 2
        f = self.field(static_attr, senders, receivers, rel_attr)
        kw = dict(method=self.method, rtol=self.rtol, atol=self.atol,
                  steps_per_interval=self.steps, max_steps_per_interval=self.steps,
                  return_stats=True, batch_dims=batch_dims)
        if self.adjoint:
            ys, self.stats = odeint_adjoint(f, y0, ts, *self.core.parameters(),
                                            checkpoint=self.adjoint == "checkpoint", **kw)
        else:
            ys, self.stats = odeint(f, y0, ts, **kw)
        return ys.movedim(0, 1) if batch_dims else ys
