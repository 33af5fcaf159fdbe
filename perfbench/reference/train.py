"""The reference's first training steps: full-batch NLL over the training
nodes, its gradients, and Adam with L2 weight decay, from the benchmark's
inputs and initial parameters.

Faults are planted here for the control runs (``fault``):

  half_batch   the loss over every other training node, its mean over them
  no_exchange  each of ``parts`` receiver blocks aggregates only the edges
               whose sender lies in its own block (the ring left out)
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from perfbench.reference.common import Precision, RefGraph, adam_step, ref_graph

__all__ = ["run_steps", "local_edges"]


def local_edges(g: RefGraph, parts: int) -> RefGraph:
    """The edges of ``g`` whose sender and receiver share a block of ``parts``."""
    block = g.n_pad // parts
    keep = (g.senders // block) == (g.receivers // block)
    return RefGraph(g.senders[keep], g.receivers[keep], g.weight[keep], g.n_pad)


def run_steps(model: str, arrays: dict, cfg: dict, params0: dict, *, seed: int, steps: int,
              device, precision: str = "float32", fault: str | None = None,
              parts: int = 1) -> dict:
    """``steps`` training steps of the reference from ``params0``.

    Returns ``losses`` (the loss each step computed, before its update),
    ``first_grad`` (the first step's gradients as Adam took them, weight
    decay included) and ``params`` (after the last step), tensors on the host.
    """
    mod = importlib.import_module(f"perfbench.reference.{model}")
    prec = Precision(precision)
    g = ref_graph(arrays, device)
    if fault == "no_exchange":
        g = local_edges(g, parts)
    x = torch.from_numpy(arrays["features"]).to(device)
    labels = torch.from_numpy(arrays["labels"]).to(device)
    train = torch.arange(int(arrays["split"][0]), device=device)
    if fault == "half_batch":
        train = train[::2]
    y = labels.index_select(0, train)
    params = {k: v.detach().to(device, torch.float32).clone().requires_grad_(True)
              for k, v in params0.items()}
    drop_gen = torch.Generator(device=device).manual_seed(seed + 1)
    seed_gen = torch.Generator().manual_seed(seed + 1)
    state, losses, first = {}, [], None
    for _ in range(steps):
        lp = mod.forward(params, g, x, cfg, prec, drop_gen=drop_gen, seed_gen=seed_gen)
        loss = -lp.index_select(0, train).gather(1, y[:, None]).sum() / train.numel()
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        with torch.no_grad():
            taken = adam_step(params, grads, state, lr=cfg["lr"], weight_decay=cfg["weight_decay"])
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: v.detach().cpu() for k, v in taken.items()}
        del lp, loss, grads
    return dict(losses=np.array(losses), first_grad=first,
                params={k: v.detach().cpu() for k, v in params.items()})
