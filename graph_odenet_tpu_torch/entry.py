"""The port's compile-and-run entry: one forward of the flagship model.

Counterpart of ``entry()`` in the repository's ``__graft_entry__.py``:
GCN-ODE (hidden 64, rk4 × 4) full-batch node classification on the Cora
twin, aggregating through dense Â.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from graph_odenet_tpu_torch.data.planetoid import synthetic_planetoid
from graph_odenet_tpu_torch.models import GCNODE
from graph_odenet_tpu_torch.utils.device import resolve_device

__all__ = ["entry"]


def entry(device="cuda"):
    """``(fn, args)``: ``fn(params, adj, x)`` is the model's forward in
    evaluation (log-probs ``[N_pad, C]``), ``args`` are its seeded
    parameters (a ``state_dict``), dense Â and the features, on ``device``.
    Runs on the card unless ``device="cpu"``; without a card the default
    raises."""
    dev = resolve_device(device)
    data = synthetic_planetoid("cora", seed=0).to(dev)
    model = GCNODE(data.features.shape[1], hidden=64, n_class=data.n_class, method="rk4",
                   steps=4, generator=torch.Generator().manual_seed(0)).to(dev)
    params = {k: v.detach() for k, v in model.state_dict().items()}

    def fwd(params, adj, x):
        return functional_call(model, params, (adj, x), dict(deterministic=True))

    return fwd, (params, data.dense_adj(), data.features)
