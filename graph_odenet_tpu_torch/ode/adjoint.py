"""Gradients through ``odeint`` by adjoint solves.

Counterpart of ``graph_odenet_tpu/ode/adjoint.py``, whose ``jax.custom_vjp``s
are ``torch.autograd.Function``s here.  The forward solves without a graph;
the backward integrates the augmented system

    d/dt [y, a, t̄, θ̄] = [f, −aᵀ∂f/∂y, −aᵀ∂f/∂t, −aᵀ∂f/∂θ]

in reversed time ``s = −t`` (the solvers integrate increasing grids), where
every component flips sign: ``[−f, aᵀ∂f/∂y, aᵀ∂f/∂t, aᵀ∂f/∂θ]`` at ``−s``.
``a`` starts at the cotangent of the last output and takes the cotangent of
each earlier output as the solve passes its time.  The vector-Jacobian
products come from ``torch.autograd.grad`` under ``enable_grad`` (a
``Function``'s backward runs with grad mode off), on fresh leaves for ``y``
and ``t`` and on the parameters themselves, which ``func`` may read through
its module.  A parameter that ``func`` does not read gets zeros.

Two adjoints, as in JAX:

  * ``_OdeintAdjoint`` (continuous, torchdiffeq's ``odeint_adjoint``): keeps
    ``ys`` only and re-integrates ``y`` backwards beside the cotangents with
    the forward's method and options, the whole flat state ``[y | a | t̄ | θ̄]``
    under one error control.
  * ``_OdeintCkptAdjoint`` (checkpointed forward): the forward stores every
    accepted state, with steps clipped to land on the output times; the
    reverse sweep takes one fixed ``bwd_method`` step (``bwd_substeps``
    substeps) per stored step, ``y`` re-anchored at the stored state.

With ``batch_dims=1`` each sample of ``y0`` is its own problem, as under
``jax.vmap``.  The continuous adjoint then carries one ``θ̄`` per sample
(``[B, P]``, summed at the end): each sample's controller takes its RMS over
its own augmented state, so a ``θ̄`` shared by the batch would give other
step sizes.  Its reverse solve runs on the forward's method, VCABM (its own
order per sample) and ``scipy_solver`` (one host solve per sample) included.
The checkpointed adjoint's steps are fixed, and its update of ``θ̄`` is
linear and feeds back into nothing, so one shared ``θ̄`` is exact
(in exact arithmetic): each sample's cotangent enters the parameter vjp
scaled by its own step.

Dtypes, as JAX's ravelled states give them: the continuous adjoint solves
``[y | a | t̄ | θ̄]`` in the promoted dtype of the state and the parameters
(float32 for a bf16 state with float32 parameters) and hands the dynamics
``y`` and ``a`` in the state's dtype; ``a`` and ``t̄`` are rounded to their
own dtypes at each output time, and each parameter's cotangent to its
parameter's.  The checkpointed adjoint refuses a state narrower than its
parameters with ``ValueError``, as JAX's does: its one flat array promotes
the cotangent above the dynamics' output dtype, which ``jax.vjp`` rejects.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from graph_odenet_tpu_torch.ode import tableaus as _tabs
from graph_odenet_tpu_torch.ode.api import _odeint_ckpt_forward, odeint
from graph_odenet_tpu_torch.ode.tableaus import _combine, rk_step

__all__ = ["BWD_TABLEAUS"]

BWD_TABLEAUS = {
    "euler": _tabs.EULER,
    "midpoint": _tabs.MIDPOINT,
    "heun2": _tabs.HEUN2,
    "heun3": _tabs.HEUN3,
    "rk4": _tabs.RK4_38,       # torchdiffeq's rk4 = Kutta 3/8
    "rk4_classic": _tabs.RK4,
    "adaptive_heun": _tabs.HEUN12,
    "fehlberg2": _tabs.FEHLBERG2,
    "bosh3": _tabs.BOSH3,
    "dopri5": _tabs.DOPRI5,
    "dopri8": _tabs.DOPRI8,
}


def _promoted(ys, params):
    """The dtype of JAX's ravelled ``[y, params]``: the state's dtype promoted
    with every parameter's."""
    dtype = ys.dtype
    for p in params:
        dtype = torch.promote_types(dtype, p.dtype)
    return dtype


def _vjp(func, t, y, a, params, per_sample=False):
    """``f = func(t, y, *params)`` and ``⟨a, ∂f/∂(y, t, params)⟩``, zeros where
    ``f`` does not depend on an input.  ``per_sample``: ``y`` has a leading
    batch axis, ``func`` is given one copy of each parameter per sample and
    the parameter cotangents keep that axis."""
    with torch.enable_grad():
        y_ = y.detach().requires_grad_()
        t_ = t.detach().requires_grad_()
        if per_sample:
            params = [p.detach().expand((y.shape[0],) + p.shape).requires_grad_()
                      for p in params]
        wrt = [p for p in params if p.requires_grad]
        f = func(t_, y_, *params)
        grads = (torch.autograd.grad(f, (y_, t_, *wrt), a, allow_unused=True)
                 if f.requires_grad else (None,) * (2 + len(wrt)))
    vy, vt, *vw = (torch.zeros_like(x) if g is None else g
                   for g, x in zip(grads, (y_, t_, *wrt)))
    vw = iter(vw)
    vp = [next(vw) if p.requires_grad else torch.zeros_like(p) for p in params]
    return f.detach(), vy, vt, vp


class _OdeintAdjoint(torch.autograd.Function):
    """The continuous adjoint (JAX's ``_odeint_adjoint_impl`` and its ``_bwd``)."""

    @staticmethod
    def forward(ctx, func, opts, stats, y0, ts, *params):
        ys, forward_stats = odeint(func, y0, ts, *params, return_stats=True, **opts)
        stats.update(forward_stats)
        ctx.func, ctx.opts = func, opts
        ctx.save_for_backward(ys, ts, *params)
        return ys

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        ys, ts, *params = ctx.saved_tensors
        func, opts = ctx.func, ctx.opts
        batched = opts.get("batch_dims", 0) == 1
        lead = ys.shape[1:2] if batched else ()
        shape = ys.shape[1:]
        dim = ys[0].numel() // (ys.shape[1] if batched else 1)

        def per(x):
            return x.reshape(lead + (-1,))

        def aug(s, w):
            y, a = (w[..., k * dim:(k + 1) * dim].reshape(shape).to(ys.dtype) for k in (0, 1))
            f, vy, vt, vp = _vjp(func, -s, y, a, params, per_sample=batched)
            return torch.cat([per(-f), per(vy), vt.reshape(lead + (1,)).to(w)]
                             + [per(v) for v in vp], dim=-1)

        n_params = sum(p.numel() for p in params)
        y_bar = g[-1]
        t0_bar = ys.new_zeros(lead)
        p_bar = ys.new_zeros(lead + (n_params,), dtype=_promoted(ys, params))
        ts_bar = [None] * ts.shape[0]
        for i in range(ts.shape[0] - 1, 0, -1):
            # Moving output time i moves the loss by ⟨f(t_i, y_i), g_i⟩.
            ts_bar[i] = (per(func(ts[i], ys[i], *params)) * per(g[i])).sum(-1)
            t0_bar = t0_bar - ts_bar[i]
            w = torch.cat([per(ys[i]), per(y_bar), t0_bar[..., None], p_bar], dim=-1)
            w = odeint(aug, w, torch.stack([-ts[i], -ts[i - 1]]), **opts)[1]
            y_bar = w[..., dim:2 * dim].reshape(shape).to(ys.dtype) + g[i - 1]
            t0_bar, p_bar = w[..., 2 * dim].to(ys.dtype), w[..., 2 * dim + 1:]
        ts_bar[0] = t0_bar
        ts_bar = torch.stack(ts_bar)
        if batched:
            ts_bar, p_bar = ts_bar.sum(-1), p_bar.sum(0)
        p_grads = [v.view_as(p).to(p.dtype) for v, p in
                   zip(p_bar.split([p.numel() for p in params]), params)]
        ts_grad = ts_bar.to(ts) if ctx.needs_input_grad[4] else None
        return (None, None, None, y_bar, ts_grad, *p_grads)


class _OdeintCkptAdjoint(torch.autograd.Function):
    """The checkpointed-forward adjoint (JAX's ``_odeint_ckpt_adjoint_impl``,
    ``_ckpt_fwd`` and ``_ckpt_bwd``)."""

    @staticmethod
    def forward(ctx, func, opts, bwd, stats, y0, ts, *params):
        ys, forward_stats, trace = _odeint_ckpt_forward(func, y0, ts, *params, **opts)
        stats.update(forward_stats)
        ctx.func, ctx.bwd, ctx.batched = func, bwd, opts.get("batch_dims", 0) == 1
        acc = torch.as_tensor(trace["acc_at_target"], device=y0.device)
        n_steps = torch.as_tensor(trace["n_steps"], device=y0.device)
        ctx.save_for_backward(ys, ts, trace["t"], trace["y"], acc, n_steps, *params)
        return ys

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        ys, ts, trace_t, trace_y, acc, n_steps, *params = ctx.saved_tensors
        wide = _promoted(ys, params)
        if wide != ys.dtype:
            raise ValueError(
                f"the checkpointed adjoint of a {ys.dtype} state with {wide} parameters: its "
                f"reverse sweep would carry the state's cotangent in {wide} into dynamics that "
                f"return {ys.dtype}, which JAX's checkpointed adjoint refuses (ValueError) too; "
                "use param_dtype equal to the state's dtype, or the continuous adjoint")
        (tab, n_sub), func = ctx.bwd, ctx.func
        if not ctx.batched:  # one problem: a batch of one
            func1 = func

            def func(t, y, *p):
                return func1(t.reshape(()), y[0], *p)[None]

            ys, g, trace_y = ys[:, None], g[:, None], trace_y[:, None]
            trace_t, acc, n_steps = trace_t[:, None], acc[:, None], n_steps.reshape(1)
        n = ys.shape[1]
        if trace_t.dim() == 1:  # a fixed grid: the same for every sample
            trace_t, acc, n_steps = (trace_t[:, None].expand(-1, n), acc[:, None].expand(-1, n),
                                     n_steps.expand(n))
        shape, dim = ys.shape[1:], ys[0, 0].numel()
        samples = torch.arange(n, device=ys.device)
        t_out = ts.to(ys)

        def flat(x):
            return x.reshape(n, -1)

        def col(v):
            return v.view((n,) + (1,) * (len(shape) - 1))

        # Moving output time i moves the loss by ⟨f(t_i, y_i), g_i⟩.
        t_bar = torch.stack([(flat(func(t_out[i].expand(n), ys[i], *params)) * flat(g[i])).sum(-1)
                             for i in range(ts.shape[0])])

        def step(s0, h, w, p_bar):
            """One ``tab`` step of the augmented system over ``[s0, s0 + h]``, in
            τ = (s − s0)/h on [0, 1], so that each sample's step scales its own
            derivatives and its cotangent in the shared parameter vjp."""
            stages = []

            def aug(tau, w):
                y, a = w[:, :dim].reshape(shape), w[:, dim:2 * dim].reshape(shape)
                f, vy, vt, vp = _vjp(func, -(s0 + tau * h), y, a * col(h), params)
                stages.append(vp)
                return torch.cat([flat(-f * col(h)), flat(vy), vt.reshape(n, 1).to(w)], dim=1)

            w, _, _, _ = rk_step(aug, tab, 0.0, w, aug(0.0, w), 1.0, compute_f1=False)
            p_bar = [_combine(pb, 1.0, tab.b, [vp[k] for vp in stages])
                     for k, pb in enumerate(p_bar)]
            return w, p_bar

        y_bar, t0_bar = torch.zeros_like(ys[0]), ys.new_zeros(n)
        p_bar = [torch.zeros_like(p) for p in params]
        g_tail, t_bar_tail, last = g[1:], t_bar[1:], trace_t.shape[0] - 1
        for kk in range(int(n_steps.max())):
            live = kk < n_steps
            j = (n_steps - kk).clamp(min=1)  # each sample's stored step, high -> low
            # Output time i is the end of stored step acc[i] (the forward lands
            # its steps on the output times): its cotangent enters there.
            m = ((acc[1:] == j) & live).to(ys.dtype)
            y_bar = y_bar + (m.view(m.shape + (1,) * (len(shape) - 1)) * g_tail).sum(0)
            t0_bar = t0_bar - (m * t_bar_tail).sum(0)
            # Reads past the trace's last slot (an overflowed forward, ``ok``
            # False) take that slot, as JAX's gather clamps them.
            at, before = j.clamp(max=last), (j - 1).clamp(max=last)
            t1 = trace_t[at, samples]
            h = (t1 - trace_t[before, samples]) / n_sub * live  # 0: a finished sample stays
            w = torch.cat([flat(trace_y[at, samples]), flat(y_bar), t0_bar[:, None]], dim=1)
            for i in range(n_sub):
                w, p_bar = step(-t1 + i * h, h, w, p_bar)
            y_bar, t0_bar = w[:, dim:2 * dim].reshape(shape), w[:, 2 * dim]

        y0_bar = y_bar + g[0]
        ts_bar = torch.cat([t0_bar[None], t_bar[1:]]).sum(-1).to(ts)
        if not ctx.batched:
            y0_bar = y0_bar[0]
        p_grads = [v.to(p.dtype) for v, p in zip(p_bar, params)]
        return (None, None, None, None, y0_bar, ts_bar if ctx.needs_input_grad[5] else None,
                *p_grads)
