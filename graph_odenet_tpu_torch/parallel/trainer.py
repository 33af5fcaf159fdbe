"""Edge-parallel end-to-end training: config 4's recipe over the process group.

Counterpart of ``graph_odenet_tpu/parallel/trainer.py``: Adam with weight
decay as L2 in the gradient, full-batch NLL on the training nodes, early
stopping on validation loss, test accuracy at the best epoch, over the
edge-partitioned GCN-ODE (``parallel.sharded_gcn``), GAT-ODE
(``parallel.sharded_gat``) or GRAND-nl (``parallel.sharded_grand``).  Every
rank runs this
function (SPMD): it partitions the graph on the host, keeps its node
block's rows on its device, and holds a replica of the parameters.  Per
step it all-reduces the parameter gradients once (SUM, before Adam) and
the loss once; the evaluation sums once, so every rank reports the same
numbers and stops at the same epoch.  With one part there is no
collective.

Fault tolerance, as in JAX: with ``ckpt_dir`` set, the parameters, the Adam
state and the epoch are saved every ``ckpt_every`` epochs and at the last
(``utils.checkpoint.Checkpointer``), and a new call with the same directory
resumes at the epoch after the latest save.  Rank 0 writes; every rank
restores, after a barrier.  JAX derives each epoch's dropout key from the
epoch; the port draws dropout from two stateful generators (the feature
masks' on the device, the attention-dropout seeds' on the host), so their
states are saved too, and a resumed run is the same run.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
import torch.distributed as dist

from graph_odenet_tpu_torch.data.planetoid import NodeClassificationData
from graph_odenet_tpu_torch.parallel import halo, sharded_gat, sharded_gcn, sharded_grand
from graph_odenet_tpu_torch.parallel.mesh import all_reduce_grads, all_reduce_sum, device_for, world
from graph_odenet_tpu_torch.parallel.partition import partition_by_receiver
from graph_odenet_tpu_torch.utils.profiling import annotate

__all__ = ["ShardedTrainConfig", "fit_sharded_node_classifier", "MODELS"]


# Each model: ``init(f_in, hidden, heads, n_class, generator=)``; ``forward(model,
# pg, x, mode=, remat=, seed_generator=, steps=, t1=)``, the rank's log-probs
# (with ``dropout=`` and ``generator=`` on a training step); the ``mode`` and
# ``remat`` values it takes; the refusal of any other.
_TABLE = {
    "gcnode": (
        lambda f_in, hidden, heads, c, **kw: sharded_gcn.init_params(f_in, hidden, c, **kw),
        lambda m, pg, x, remat, seed_generator, **kw: sharded_gcn.forward(m, pg, x, **kw),
        halo.MODES, (False, True), "unknown mode {mode!r}; one of {modes}"),
    "gatode": (
        sharded_gat.init_gatode_params, sharded_gat.gatode_forward,
        sharded_gat.MODES, (False, True), "unknown mode {mode!r} for gatode; one of {modes}"),
    "grandnl": (
        sharded_grand.init_grandnl_params,
        lambda m, pg, x, mode, remat, seed_generator, **kw: sharded_grand.grandnl_forward(
            m, pg, x, **kw),
        ("ring_pallas",), (False,),
        "grandnl runs mode='ring_pallas' without remat, got mode={mode!r}, remat={remat}"),
}
MODELS = tuple(_TABLE)


@dataclasses.dataclass
class ShardedTrainConfig:
    model: str = "gcnode"        # one of MODELS
    hidden: int = 256            # gatode, grandnl: per head (grandnl's d_k), heads * hidden in all
    heads: int = 4               # gatode, grandnl
    steps: int = 4               # rk4 substeps
    t1: float = 1.0
    mode: str = "ring"           # ring | ring_pallas | allgather; _TABLE lists each model's
    lr: float = 0.01
    weight_decay: float = 5e-4
    dropout: float = 0.0         # feature (gatode: and attention) dropout, never in evaluation
    epochs: int = 30
    patience: int = 100
    eval_every: Optional[int] = None  # None: every epoch below 200,000 edges, every 5 above
    seed: int = 0
    # gatode: recompute each dynamics evaluation in the backward instead of
    # keeping its per-edge activations.
    remat: bool = False
    n_parts: Optional[int] = None  # default: the process group's size
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 10


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
    ``seconds``, ``n_parts``, ``params``) and ``losses``, the training loss
    of each epoch this call ran (after a resume, from the epoch after the
    checkpoint's).

    Runs on the rank's card (``cuda:rank``) unless ``device="cpu"``;
    without a card the default raises.  ``cfg.n_parts`` must equal the
    process group's size (1 without a process group).  ``init_state``
    replaces the seeded initialisation, e.g. with the JAX package's
    (``convert.params_from_sharded`` or ``params_from_sharded_gat``).
    """
    if cfg.model not in MODELS:
        raise ValueError(f"unknown sharded model {cfg.model!r}; one of {MODELS}")
    init, model_forward, modes, remats, refusal = _TABLE[cfg.model]
    if cfg.mode not in modes or cfg.remat not in remats:
        raise ValueError(refusal.format(mode=cfg.mode, remat=cfg.remat, modes=modes))
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
    counts = all_reduce_sum(torch.stack([w_tr.sum(), w_va.sum(), w_te.sum()]))
    n_tr, n_va, n_te = torch.clamp(counts, min=1.0)

    model = init(x.shape[1], cfg.hidden, cfg.heads, c,
                 generator=torch.Generator().manual_seed(cfg.seed))
    if init_state is not None:
        model.load_state_dict(init_state)
    model.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, weight_decay=cfg.weight_decay)
    drop_gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    seed_gen = torch.Generator().manual_seed(cfg.seed + 1)  # attention-dropout seeds (CPU)
    common = dict(steps=cfg.steps, t1=cfg.t1, mode=cfg.mode, remat=cfg.remat,
                  seed_generator=seed_gen)

    def forward(train: bool):
        kw = dict(common, dropout=cfg.dropout, generator=drop_gen) if train else common
        return model_forward(model, pg, x, **kw)

    def nll_sum(lp, w):
        return -(lp * y1h).sum(-1).mul(w).sum()

    def train_step():
        with annotate("gode.train.step"):
            model.train()
            opt.zero_grad(set_to_none=True)
            loss = nll_sum(forward(True), w_tr) / n_tr  # the rank's share of the global loss
            loss.backward()
            all_reduce_grads(model)
            opt.step()
            return all_reduce_sum(loss.detach())

    @torch.no_grad()
    def evaluate():
        with annotate("gode.train.evaluate"):
            model.eval()
            lp = forward(False)
            hit = (lp.argmax(-1) == labels).to(torch.float32)
            sums = all_reduce_sum(torch.stack([
                nll_sum(lp, w_va), (hit * w_va).sum(), (hit * w_te).sum(),
            ]))
            with annotate("gode.train.eval_read"):
                return dict(
                    val_loss=float(sums[0] / n_va), val_acc=float(sums[1] / n_va),
                    test_acc=float(sums[2] / n_te),
                )

    def snapshot():
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    def run_state(epoch):
        return dict(params=model.state_dict(), opt_state=opt.state_dict(), epoch=epoch,
                    drop_rng=drop_gen.get_state(), seed_rng=seed_gen.get_state())

    ckpt, start_epoch = None, 0
    if cfg.ckpt_dir:
        from graph_odenet_tpu_torch.utils.checkpoint import Checkpointer

        if n_world > 1:  # rank 0's last save is on disk before anyone reads
            dist.barrier()
        ckpt = Checkpointer(cfg.ckpt_dir)
        if ckpt.latest_step() is not None:
            state = ckpt.restore(run_state(0))
            model.load_state_dict(state["params"])
            opt.load_state_dict(state["opt_state"])
            drop_gen.set_state(state["drop_rng"])
            seed_gen.set_state(state["seed_rng"])
            start_epoch = int(state["epoch"]) + 1

    eval_every = cfg.eval_every or (1 if g.n_edge < 200_000 else 5)
    best = dict(val_loss=float("inf"), val_acc=0.0, test_acc=0.0, epoch=-1)
    best_params = snapshot()
    bad = 0
    losses = []
    step_ms = None
    t0 = time.perf_counter()
    epoch = start_epoch - 1
    for epoch in range(start_epoch, cfg.epochs):
        t_step = time.perf_counter()
        loss = train_step()
        with annotate("gode.train.loss_read"):
            loss = float(loss)  # waits for the step
        if epoch > start_epoch:  # steady state
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
        if ckpt and rank == 0 and (epoch % cfg.ckpt_every == 0 or epoch == cfg.epochs - 1):
            ckpt.save(epoch, run_state(epoch), wait=True)
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
        losses=losses,
    )
