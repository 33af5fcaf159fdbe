"""ODE-wrapped GNNs: continuous-depth models.

Counterpart of ``graph_odenet_tpu/models/odeblock.py``.  ``ODEBlock``
integrates ``dh/dt = f(t, h)`` over ``[0, t1]`` with any method of
``ode.odeint`` (fixed-grid, adaptive, or an adaptive ``_scan`` form bounded
at ``steps`` attempts) and trains by backpropagating through the solver
steps, or by the continuous or the checkpointed adjoint
(``ode.odeint_adjoint``).  The solver stats of the last forward are kept in
``ODEBlock.stats`` (``{"nfe"}`` for fixed-grid methods; ``{"nfe",
"n_accept", "n_reject", "success", "t_reached"}`` for adaptive ones).

``dtype``/``param_dtype`` are flax's (``models/gcn.py``).  The ODE state
is whatever the encoder returns and the times are in its dtype, as JAX's
``ODEBlock`` builds ``ts`` in ``h.dtype``: with ``dtype=torch.bfloat16``
the GCN-ODE integrates a bf16 state (the CSR kernel returns bf16), and the
GAT-ODE a float32 state on the GAT kernels (a ``CSRGraph``) but a bf16 one
on the segment path (a ``Graph``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from graph_odenet_tpu_torch.models.gat import GATLayer
from graph_odenet_tpu_torch.models.gcn import GCNLayer, dropout
from graph_odenet_tpu_torch.ode import odeint, odeint_adjoint
from graph_odenet_tpu_torch.ops.csr_spmm import widen

__all__ = ["GCNDynamics", "GATDynamics", "ODEBlock", "GCNODE", "GATODE"]


class GCNDynamics(nn.Module):
    """dh/dt = σ(Â h W + b), a width-preserving graph-conv vector field."""

    def __init__(
        self, hidden: int, activation: str = "tanh",
        *, dtype: torch.dtype = torch.float32, param_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.layer = GCNLayer(hidden, hidden, dtype=dtype, param_dtype=param_dtype,
                              generator=generator)
        self.activation = getattr(torch.nn.functional, activation)

    def forward(self, t, adj, h: torch.Tensor) -> torch.Tensor:
        del t  # autonomous
        return self.activation(self.layer(adj, h))


class GATDynamics(nn.Module):
    """dh/dt = σ(att(h)), a width-preserving single-head attention field."""

    def __init__(
        self, hidden: int, activation: str = "tanh",
        *, dtype: torch.dtype = torch.float32, param_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.layer = GATLayer(hidden, hidden, heads=1, concat=False, dtype=dtype,
                              param_dtype=param_dtype, generator=generator)
        self.activation = getattr(torch.nn.functional, activation)

    def forward(self, t, adj, h: torch.Tensor) -> torch.Tensor:
        del t  # autonomous
        return self.activation(self.layer(adj, h))


class ODEBlock(nn.Module):
    """h(t1) = h(0) + ∫ f(t, h) dt, a continuous residual block.

    ``dynamics`` is a module called as ``(t, adj, h) -> dh``.
    ``adjoint=True`` trains with the continuous adjoint, ``adjoint=
    "checkpoint"`` with the checkpointed-forward adjoint (it stores the
    accepted states and takes fixed rk4 steps back over them); otherwise
    autograd differentiates through the steps of a reverse-differentiable
    ``method`` (fixed-grid or ``_scan``).  ``remat=True`` recomputes each
    dynamics call in the backward (``torch.utils.checkpoint``) instead of
    storing its activations.
    """

    def __init__(
        self, dynamics: nn.Module, t1: float = 1.0, method: str = "rk4", steps: int = 4,
        rtol: float = 1e-3, atol: float = 1e-4,
        adjoint: Union[bool, str] = False, remat: bool = False,
    ):
        super().__init__()
        self.dynamics = dynamics
        self.t1 = t1
        self.method = method
        self.steps = steps
        self.rtol, self.atol = rtol, atol
        self.adjoint = adjoint
        self.remat = remat
        self.stats = None

    def forward(self, adj, h: torch.Tensor) -> torch.Tensor:
        def f(t, y, *params):
            del params  # the dynamics' own parameters, passed on to the adjoint
            if self.remat:
                return checkpoint(self.dynamics, t, adj, y, use_reentrant=False)
            return self.dynamics(t, adj, y)

        kw = dict(method=self.method, rtol=self.rtol, atol=self.atol,
                  steps_per_interval=self.steps, max_steps_per_interval=self.steps,
                  return_stats=True)
        if self.adjoint:
            ys, self.stats = odeint_adjoint(
                f, h, [0.0, self.t1], *self.dynamics.parameters(),
                checkpoint=self.adjoint == "checkpoint", **kw,
            )
        else:
            ys, self.stats = odeint(f, h, [0.0, self.t1], **kw)
        return ys[-1]


class GCNODE(nn.Module):
    """Continuous-depth GCN classifier: encoder conv -> ODEBlock -> readout conv."""

    def __init__(
        self, in_features: int, hidden: int = 16, n_class: int = 7, dropout: float = 0.5,
        t1: float = 1.0, method: str = "rk4", steps: int = 4, rtol: float = 1e-3,
        atol: float = 1e-4, adjoint: Union[bool, str] = False, remat: bool = False,
        activation: str = "tanh", *, dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dropout = dropout
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        encoder = GCNLayer(in_features, hidden, **kw)
        self.odeblock = ODEBlock(
            GCNDynamics(hidden, activation, **kw),
            t1=t1, method=method, steps=steps, rtol=rtol, atol=atol,
            adjoint=adjoint, remat=remat,
        )
        readout = GCNLayer(hidden, n_class, **kw)
        self.layers = nn.ModuleList([encoder, readout])

    def forward(self, adj, x, *, deterministic: bool = True, generator=None):
        kw = dict(deterministic=deterministic, generator=generator)
        h = torch.relu(self.layers[0](adj, x))
        h = dropout(h, self.dropout, **kw)
        h = self.odeblock(adj, h)
        h = dropout(h, self.dropout, **kw)
        h = self.layers[1](adj, h)
        return torch.log_softmax(widen(h), dim=-1)


class GATODE(nn.Module):
    """Continuous-depth GAT classifier (config 2: dopri5_scan, 32 attempts)."""

    def __init__(
        self, in_features: int, hidden: int = 8, heads: int = 8, n_class: int = 7,
        dropout: float = 0.6, t1: float = 1.0, method: str = "dopri5_scan", steps: int = 32,
        rtol: float = 1e-3, atol: float = 1e-4, adjoint: Union[bool, str] = False,
        remat: bool = False, activation: str = "tanh", *, dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dropout = dropout
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator)
        encoder = GATLayer(in_features, hidden, heads=heads, attn_dropout=dropout, **kw)
        self.odeblock = ODEBlock(
            GATDynamics(hidden * heads, activation, **kw),
            t1=t1, method=method, steps=steps, rtol=rtol, atol=atol,
            adjoint=adjoint, remat=remat,
        )
        readout = GATLayer(hidden * heads, n_class, heads=1, concat=False, **kw)
        self.layers = nn.ModuleList([encoder, readout])

    def forward(self, adj, x, *, deterministic: bool = True, generator=None, seed_generator=None):
        kw = dict(deterministic=deterministic, generator=generator)
        x = dropout(x, self.dropout, **kw)
        h = torch.nn.functional.elu(
            self.layers[0](adj, x, deterministic=deterministic, seed_generator=seed_generator)
        )
        h = self.odeblock(adj, h)
        h = dropout(h, self.dropout, **kw)
        h = self.layers[1](adj, h, deterministic=deterministic)
        return torch.log_softmax(widen(h), dim=-1)
