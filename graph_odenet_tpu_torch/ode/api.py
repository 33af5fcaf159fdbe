"""``odeint``: the torchdiffeq-compatible entry point.

Counterpart of ``graph_odenet_tpu/ode/api.py``.  ``odeint(func, y0, ts,
*args, method=...)`` integrates ``dy/dt = func(t, y, *args)`` and returns
the solution at every requested time (``ys[0] == y0``).  ``y0`` is one
tensor; the solvers work on it elementwise and take the error norm over all
of it, as JAX does over the ravelled state.

Methods (``SOLVERS``, JAX's names): the fixed-grid tableaus; the fixed-grid
Adams methods ``explicit_adams`` (AB4), ``implicit_adams`` and its alias
``fixed_adams`` (ABM4, ``ode/adams.py``); the adaptive tableaus
(``dopri5``, ``dopri8``, ``bosh3``, ``adaptive_heun``, ``fehlberg2``) and
their ``_scan`` forms; the variable-order Adams ``adams`` and ``adams_scan``
(``ode/vcabm.py``).  All are differentiable by autograd through the steps.
``scipy_solver`` is ``scipy.integrate.solve_ivp`` on the host in float64,
forward only, as JAX's ``pure_callback`` is: a backward through it raises.
Every method takes ``batch_dims=1``, as every JAX method composes with
``jax.vmap``.

``odeint_adjoint`` takes its gradient with the continuous adjoint or the
checkpointed-forward adjoint instead (``ode/adjoint.py``).
"""

from __future__ import annotations

from typing import Callable

import torch

from graph_odenet_tpu_torch.ode import adams, adaptive, fixed, tableaus, vcabm

__all__ = ["odeint", "odeint_adjoint", "SOLVERS"]

_FIXED = {
    "euler": tableaus.EULER,
    "midpoint": tableaus.MIDPOINT,
    "heun2": tableaus.HEUN2,
    "heun3": tableaus.HEUN3,
    # torchdiffeq's "rk4" is Kutta's 3/8 rule; match it.
    "rk4": tableaus.RK4_38,
    "rk4_classic": tableaus.RK4,
}

_ADAPTIVE = {
    "dopri5": tableaus.DOPRI5,
    "dopri8": tableaus.DOPRI8,
    "bosh3": tableaus.BOSH3,
    "adaptive_heun": tableaus.HEUN12,
    "fehlberg2": tableaus.FEHLBERG2,
}
# Fixed-grid multistep: torchdiffeq's explicit_adams / implicit_adams, and
# "fixed_adams", its alias for the ABM predictor-corrector.
_ADAMS = {"explicit_adams": False, "implicit_adams": True, "fixed_adams": True}

SOLVERS = tuple(_FIXED) + tuple(_ADAMS) + tuple(_ADAPTIVE) + tuple(
    f"{m}_scan" for m in _ADAPTIVE
) + ("adams", "adams_scan", "scipy_solver")


class _ScipySolve(torch.autograd.Function):
    """``solve_ivp`` on the host: forward only, as JAX's ``pure_callback``,
    which has no JVP.  ``y0`` and ``args`` are inputs so that a backward that
    reaches the solve raises instead of silently returning nothing.

    ``batched``: one ``solve_ivp`` per sample of ``y0``, in order (JAX's
    ``vmap_method="sequential"``).  ``func`` takes the batch, and may hold
    per-sample data of its own, so each evaluation passes it the whole batch,
    the sample's state in its row and every other row at its own ``y0``, with
    ``t`` of shape ``[B]``, and reads that row: a batch of B costs B whole-batch
    evaluations per evaluation of one sample."""

    @staticmethod
    def forward(ctx, func, ts, opts, batched, y0, *args):
        import numpy as np
        from scipy.integrate import solve_ivp

        def host(v):
            return v.detach().reshape(-1).cpu().numpy().astype(np.float64)

        ts64 = ts.detach().cpu().numpy().astype(np.float64)

        def solve(rhs, start, shape):
            sol = solve_ivp(rhs, (ts64[0], ts64[-1]), host(start), t_eval=ts64, **opts)
            if not sol.success:
                raise RuntimeError(f"scipy solve_ivp failed: {sol.message}")
            ys = torch.from_numpy(np.ascontiguousarray(sol.y.T))
            return ys.to(dtype=y0.dtype, device=y0.device).view((ts64.shape[0],) + shape)

        if not batched:
            def rhs(t, y):
                y_dev = torch.as_tensor(y, dtype=y0.dtype, device=y0.device).view(y0.shape)
                t_dev = torch.as_tensor(t, dtype=y0.dtype, device=y0.device)
                return host(func(t_dev, y_dev, *args))

            return solve(rhs, y0, y0.shape)

        def rhs_of(b):
            def rhs(t, y):
                batch = y0.detach().clone()
                batch[b] = torch.as_tensor(y, dtype=y0.dtype, device=y0.device).view(y0.shape[1:])
                t_dev = torch.full(y0.shape[:1], t, dtype=y0.dtype, device=y0.device)
                return host(func(t_dev, batch, *args)[b])

            return rhs

        return torch.stack([solve(rhs_of(b), y0[b], y0.shape[1:]) for b in range(y0.shape[0])],
                           dim=1)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError(
            "scipy_solver is forward only (a host solve, like JAX's pure_callback, which has "
            "no JVP): take gradients with another method or with odeint_adjoint")


def odeint(
    func: Callable,
    y0: torch.Tensor,
    ts,
    *args,
    method: str = "dopri5",
    rtol: float = 1e-7,
    atol: float = 1e-9,
    steps_per_interval: int = 1,
    max_steps: int = 10_000,
    max_steps_per_interval: int = 64,
    first_step: float | None = None,
    return_stats: bool = False,
    scipy_method: str = "RK45",
    max_order: int = 12,
    batch_dims: int = 0,
):
    """Integrate ``dy/dt = func(t, y, *args)`` over the monotonic times ``ts``.

    ``ts`` may be a list or a tensor.  Returns ``ys [T, *y0.shape]`` (and a
    stats dict when ``return_stats=True``: ``{nfe}`` for the fixed-grid
    methods, fixed Adams included, ``{nfe, n_accept, n_reject, success,
    t_reached}`` for the adaptive ones, ``final_order`` too for ``adams``
    and ``adams_scan``, and ``{nfe: -1}`` for ``scipy_solver``).
    ``max_order`` bounds ``adams``' order (at most 12); ``scipy_method`` is
    ``solve_ivp``'s ``method``.

    ``batch_dims=1`` integrates each ``y0[b]`` as its own problem, as
    ``jax.vmap`` over ``odeint`` does: the adaptive methods, RK and VCABM,
    keep a step size, error ratio, accept mask (and for VCABM an order and a
    history) and stats per sample (stats are ``[B]`` tensors, plus
    ``host_reads``) and call ``func`` with ``t`` of shape ``[B]``; the
    fixed-grid methods, fixed Adams included, are elementwise and take
    ``y0`` as it is; ``scipy_solver`` runs one host solve per sample, in
    order, its ``nfe`` a ``[B]`` tensor of -1.  Other ``batch_dims`` raise
    ``ValueError``.
    """
    if method not in SOLVERS:
        raise ValueError(f"unknown method {method!r}; choose from {SOLVERS}")
    if batch_dims not in (0, 1):
        raise ValueError(f"batch_dims must be 0 or 1, got {batch_dims!r}")
    ts = torch.as_tensor(ts, dtype=y0.dtype)
    if method == "scipy_solver":  # solve_ivp integrates decreasing times itself
        ys = _ScipySolve.apply(func, ts, dict(method=scipy_method, rtol=rtol, atol=atol),
                               bool(batch_dims), y0, *args)
        nfe = (torch.full(y0.shape[:1], -1, dtype=torch.int64, device=y0.device) if batch_dims
               else -1)
        return (ys, dict(nfe=nfe)) if return_stats else ys

    def f(t, y):
        return func(t, y, *args)

    # Reverse time: substitute s = -t, so dy/ds = -f(-s, y) over the
    # increasing grid -ts.
    if ts.shape[0] >= 2 and bool(ts[1] < ts[0]):
        inner = f

        def f(s, y):
            return -inner(-s, y)

        ts = -ts

    if method in _FIXED:
        ys, nfe = fixed.odeint_fixed(
            f, _FIXED[method], y0, ts, steps_per_interval=steps_per_interval
        )
        stats = dict(nfe=nfe)
    elif method in _ADAMS:
        ys, nfe = adams.odeint_adams(
            f, y0, ts, steps_per_interval=steps_per_interval, corrector=_ADAMS[method]
        )
        stats = dict(nfe=nfe)
    elif method == "adams":
        ys, stats = vcabm.odeint_vcabm(
            f, y0, ts, rtol=rtol, atol=atol, max_order=max_order, max_steps=max_steps,
            first_step=first_step, batch_dims=batch_dims,
        )
    elif method == "adams_scan":
        ys, stats = vcabm.odeint_vcabm_scan(
            f, y0, ts, rtol=rtol, atol=atol, max_order=max_order,
            max_steps_per_interval=max_steps_per_interval, first_step=first_step,
            batch_dims=batch_dims,
        )
    elif method in _ADAPTIVE:
        ys, stats = adaptive.odeint_adaptive(
            f, y0, ts, tab=_ADAPTIVE[method], rtol=rtol, atol=atol,
            max_steps=max_steps, first_step=first_step, batch_dims=batch_dims,
        )
    else:
        ys, stats = adaptive.odeint_adaptive_scan(
            f, y0, ts, tab=_ADAPTIVE[method[: -len("_scan")]], rtol=rtol, atol=atol,
            max_steps_per_interval=max_steps_per_interval, first_step=first_step,
            batch_dims=batch_dims,
        )
    return (ys, stats) if return_stats else ys


def _odeint_ckpt_forward(
    func: Callable, y0: torch.Tensor, ts, *args, method: str = "dopri5",
    rtol: float = 1e-7, atol: float = 1e-9, steps_per_interval: int = 1,
    max_steps_per_interval: int = 64, first_step: float | None = None, batch_dims: int = 0,
    **_ignored,
):
    """Forward solve that also returns the accepted-step trace: the forward of
    the checkpointed adjoint (JAX's ``_odeint_ckpt_forward``).

    Fixed-grid methods emit their substep grid as the trace; the explicit
    adaptive methods run ``adaptive.odeint_adaptive_ckpt``.  ``_scan``
    suffixes are stripped: the checkpointed adjoint never differentiates
    through the forward.  Returns ``(ys, stats, trace)`` with the trace on
    ``y0``'s device (see ``odeint_adaptive_ckpt``; a fixed grid's ``t`` is
    ``[K+1]`` for every sample of a batch).
    """
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)

    def f(t, y):
        return func(t, y, *args)

    base = method[: -len("_scan")] if method.endswith("_scan") else method
    if base in _FIXED:
        n_sub = max(int(steps_per_interval), 1)
        frac = torch.arange(n_sub, dtype=ts.dtype, device=ts.device) / n_sub
        seg = ts[:-1, None] + (ts[1:] - ts[:-1])[:, None] * frac
        ts_fine = torch.cat([seg.reshape(-1), ts[-1:]])
        ys_fine, nfe = fixed.odeint_fixed(f, _FIXED[base], y0, ts_fine, steps_per_interval=1)
        acc_at_target = torch.arange(ts.shape[0], device=ts.device) * n_sub
        trace = dict(t=ts_fine, y=ys_fine, acc_at_target=acc_at_target,
                     n_steps=(ts.shape[0] - 1) * n_sub, ok=True)
        return ys_fine[acc_at_target], dict(nfe=nfe), trace
    if base in _ADAPTIVE:
        return adaptive.odeint_adaptive_ckpt(
            f, y0, ts, tab=_ADAPTIVE[base], rtol=rtol, atol=atol,
            trace_per_interval=max_steps_per_interval, first_step=first_step,
            batch_dims=batch_dims,
        )
    raise ValueError(
        f"checkpoint adjoint supports fixed-grid and explicit adaptive methods, not "
        f"{method!r} (adams/scipy have no step trace)"
    )


def odeint_adjoint(
    func: Callable,
    y0: torch.Tensor,
    ts,
    *params,
    method: str = "dopri5",
    rtol: float = 1e-7,
    atol: float = 1e-9,
    return_stats: bool = False,
    checkpoint: bool = False,
    bwd_method: str = "rk4",
    bwd_substeps: int = 1,
    **options,
):
    """``odeint`` whose gradient is taken by an adjoint solve, not by autograd
    through the steps (JAX's ``odeint_adjoint``; torchdiffeq's
    ``odeint_adjoint``).

    ``params`` are the tensors that ``func(t, y, *params)`` reads and that the
    gradient must reach (torchdiffeq's ``adjoint_params``): a module's
    ``tuple(module.parameters())``, which ``func`` may read through the module
    itself.  Each gets a gradient; one that ``func`` does not read gets zeros.

    The continuous adjoint (``checkpoint=False``) keeps ``ys`` only and solves
    the augmented system ``[y, a, t̄, θ̄]`` backwards over each output
    interval with the forward's method and options.  ``checkpoint=True``
    keeps every accepted state of a forward whose steps land on the output
    times, and takes one fixed ``bwd_method`` step (``bwd_substeps``
    substeps) per stored step, ``y`` read from the store.  The forward's
    solver stats are returned with ``return_stats=True``, as ``odeint``
    returns them.

    ``batch_dims=1`` solves each ``y0[b]`` as its own problem, as ``jax.vmap``
    of the JAX function does.  The continuous adjoint then needs each
    sample's parameter cotangent (each sample's controller measures its own
    augmented state), so in the backward ``func`` is called with every
    parameter expanded to one copy per sample (``[B, *p.shape]``) and must
    compute each sample with its own copy.
    """
    from graph_odenet_tpu_torch.ode import adjoint

    opts = dict(method=method, rtol=rtol, atol=atol, **options)
    if not torch.is_tensor(ts):
        ts = torch.tensor(ts, dtype=y0.dtype)
    stats = {}  # the Function's forward fills it
    if checkpoint:
        if bwd_method not in adjoint.BWD_TABLEAUS:
            raise ValueError(f"unknown bwd_method {bwd_method!r}; choose from "
                             f"{tuple(adjoint.BWD_TABLEAUS)}")
        bwd = (adjoint.BWD_TABLEAUS[bwd_method], int(bwd_substeps))
        ys = adjoint._OdeintCkptAdjoint.apply(func, opts, bwd, stats, y0, ts, *params)
    else:
        ys = adjoint._OdeintAdjoint.apply(func, opts, stats, y0, ts, *params)
    return (ys, stats) if return_stats else ys
