"""Edge-parallel end-to-end training: config 4's recipe over the process group.

Counterpart of ``graph_odenet_tpu/parallel/trainer.py``: Adam with weight
decay as L2 in the gradient, full-batch NLL on the training nodes, early
stopping on validation loss, test accuracy at the best epoch, over the
edge-partitioned GCN-ODE (``parallel.sharded_gcn``) or GAT-ODE
(``parallel.sharded_gat``).  Every rank runs this
function (SPMD): it partitions the graph on the host, keeps its node
block's rows on its device, and holds a replica of the parameters.  Per
step it all-reduces the parameter gradients once (SUM, before Adam) and
the loss once; the evaluation sums once, so every rank reports the same
numbers and stops at the same epoch.  With one part there is no
collective.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from graph_odenet_tpu_torch.data.planetoid import NodeClassificationData
from graph_odenet_tpu_torch.parallel import sharded_gat, sharded_gcn
from graph_odenet_tpu_torch.parallel.mesh import device_for, world
from graph_odenet_tpu_torch.parallel.partition import partition_by_receiver

__all__ = ["ShardedTrainConfig", "fit_sharded_node_classifier"]


@dataclasses.dataclass
class ShardedTrainConfig:
    model: str = "gcnode"        # gcnode | gatode
    hidden: int = 256            # gatode: per-head width (heads * hidden in all)
    heads: int = 4               # gatode only
    steps: int = 4               # rk4 substeps
    t1: float = 1.0
    mode: str = "ring"           # ring | ring_pallas | allgather (gcnode only)
    lr: float = 0.01
    weight_decay: float = 5e-4
    # Feature (and, gatode, attention) dropout; evaluation never drops.
    dropout: float = 0.0
    epochs: int = 30
    patience: int = 100
    # None: evaluate every epoch below 200,000 edges, every 5 above.
    eval_every: Optional[int] = None
    seed: int = 0
    # gatode: recompute each dynamics evaluation in the backward instead of
    # keeping its per-edge activations.
    remat: bool = False
    n_parts: Optional[int] = None  # default: the process group's size
    ckpt_dir: Optional[str] = None  # ROADMAP A17


def _rows_mask(idx: torch.Tensor, n_pad: int, rows: slice) -> torch.Tensor:
    m = torch.zeros(n_pad, dtype=torch.float32)
    m[idx] = 1.0
    return m[rows]


def fit_sharded_node_classifier(
    cfg: ShardedTrainConfig, data: NodeClassificationData, *, device="cuda",
    init_state: Optional[dict] = None,
):
    """Train the edge-partitioned model; returns the JAX package's summary
    keys (``test_acc``, ``val_acc``, ``val_loss``, ``best_epoch``,
    ``epochs_run``, ``step_ms``, ``loss_first``, ``loss_final``,
    ``seconds``, ``n_parts``, ``params``).

    Runs on the rank's card (``cuda:rank``) unless ``device="cpu"``;
    without a card the default raises.  ``cfg.n_parts`` must equal the
    process group's size (1 without a process group).  ``init_state``
    replaces the seeded initialisation, e.g. with the JAX package's
    (``convert.params_from_sharded`` or ``params_from_sharded_gat``).
    """
    if cfg.model not in ("gcnode", "gatode"):
        raise ValueError(f"unknown sharded model {cfg.model!r}")
    gat = cfg.model == "gatode"
    if gat and cfg.mode not in sharded_gat.MODES:
        raise ValueError(f"unknown mode {cfg.mode!r} for gatode; one of {sharded_gat.MODES}")
    if cfg.ckpt_dir:
        raise NotImplementedError("sharded checkpoints are not ported yet (ROADMAP A17)")
    n_world, rank = world()
    n_parts = cfg.n_parts or n_world
    if n_parts != n_world:
        raise ValueError(f"n_parts={n_parts} but the process group has {n_world} ranks")
    dev = device_for(device, rank)

    g = data.graph
    pg = partition_by_receiver(g, n_parts).to(dev)
    n_pad, c = g.n_node_pad, data.n_class
    rows = slice(rank * pg.block_size, (rank + 1) * pg.block_size)
    x = data.features[rows].to(dev).contiguous()
    labels = data.labels[rows].to(dev)
    y1h = torch.nn.functional.one_hot(labels.clamp(min=0), c).to(torch.float32)
    y1h *= (labels >= 0)[:, None]  # padding rows (label -1) are all zeros
    w_tr, w_va, w_te = (
        _rows_mask(idx.cpu(), n_pad, rows).to(dev)
        for idx in (data.idx_train, data.idx_val, data.idx_test)
    )
    counts = sharded_gcn.all_reduce_sum(torch.stack([w_tr.sum(), w_va.sum(), w_te.sum()]))
    n_tr, n_va, n_te = torch.clamp(counts, min=1.0)

    init_gen = torch.Generator().manual_seed(cfg.seed)
    if gat:
        model = sharded_gat.init_gatode_params(x.shape[1], cfg.hidden, cfg.heads, c,
                                               generator=init_gen)
    else:
        model = sharded_gcn.init_params(x.shape[1], cfg.hidden, c, generator=init_gen)
    if init_state is not None:
        model.load_state_dict(init_state)
    model.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, weight_decay=cfg.weight_decay)
    drop_gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    seed_gen = torch.Generator().manual_seed(cfg.seed + 1)  # attention-dropout seeds (CPU)
    common = dict(steps=cfg.steps, t1=cfg.t1, mode=cfg.mode)

    def forward(train: bool):
        kw = dict(common, dropout=cfg.dropout, generator=drop_gen) if train else common
        if gat:
            return sharded_gat.gatode_forward(model, pg, x, seed_generator=seed_gen,
                                              remat=cfg.remat, **kw)
        return sharded_gcn.forward(model, pg, x, **kw)

    def nll_sum(lp, w):
        return -(lp * y1h).sum(-1).mul(w).sum()

    def train_step():
        model.train()
        opt.zero_grad(set_to_none=True)
        loss = nll_sum(forward(True), w_tr) / n_tr  # the rank's share of the global loss
        loss.backward()
        sharded_gcn.all_reduce_grads(model)
        opt.step()
        return sharded_gcn.all_reduce_sum(loss.detach())

    @torch.no_grad()
    def evaluate():
        model.eval()
        lp = forward(False)
        hit = (lp.argmax(-1) == labels).to(torch.float32)
        sums = sharded_gcn.all_reduce_sum(torch.stack([
            nll_sum(lp, w_va), (hit * w_va).sum(), (hit * w_te).sum(),
        ]))
        return dict(
            val_loss=float(sums[0] / n_va), val_acc=float(sums[1] / n_va),
            test_acc=float(sums[2] / n_te),
        )

    def snapshot():
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    eval_every = cfg.eval_every or (1 if g.n_edge < 200_000 else 5)
    best = dict(val_loss=float("inf"), val_acc=0.0, test_acc=0.0, epoch=-1)
    best_params = snapshot()
    bad = 0
    losses = []
    step_ms = None
    t0 = time.perf_counter()
    for epoch in range(cfg.epochs):
        t_step = time.perf_counter()
        loss = float(train_step())  # waits for the step
        if epoch > 0:  # steady state
            dt = (time.perf_counter() - t_step) * 1e3
            step_ms = dt if step_ms is None else min(step_ms, dt)
        losses.append(loss)
        if epoch % eval_every == 0 or epoch == cfg.epochs - 1:
            m = evaluate()
            if m["val_loss"] < best["val_loss"]:
                best = dict(m, epoch=epoch)
                best_params = snapshot()
                bad = 0
            else:
                bad += 1
                if bad > cfg.patience:
                    break
    return dict(
        test_acc=best["test_acc"],
        val_acc=best["val_acc"],
        val_loss=best["val_loss"],
        best_epoch=best["epoch"],
        epochs_run=epoch + 1,
        step_ms=step_ms,
        loss_first=losses[0] if losses else None,
        loss_final=losses[-1] if losses else None,
        seconds=time.perf_counter() - t0,
        n_parts=n_parts,
        params=best_params,
    )
