"""Full-batch node-classification trainer.

Counterpart of ``graph_odenet_tpu/train/node_classification.py``: Adam with
weight decay as L2 in the gradient, full-graph forward, NLL on the training
nodes, early stopping on validation loss, test accuracy at the best epoch.
GCN-family models aggregate through dense Â on small graphs and through the
CSR kernel (``representation="kernel"``) on large graphs on the card; GAT-
family models take the attention kernels on the card at every scale.
Attention-dropout seeds come from a CPU generator seeded from ``cfg.seed``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import torch

from graph_odenet_tpu_torch.data.planetoid import NodeClassificationData
from graph_odenet_tpu_torch.models import GAT, GATODE, GCN, GCNODE, ResGAT, ResGCN
from graph_odenet_tpu_torch.ops.csr_spmm import prepare
from graph_odenet_tpu_torch.utils.device import resolve_device
from graph_odenet_tpu_torch.utils.logging import MetricsLogger
from graph_odenet_tpu_torch.utils.metrics import masked_accuracy, masked_nll

__all__ = [
    "NodeClassConfig", "GAT_FAMILY", "build_model", "choose_representation", "fit_node_classifier",
]

#: Largest padded graph that aggregates through dense Â by default.
DENSE_MAX_NODES = 16_384
GAT_FAMILY = ("gat", "resgat", "gatode")


@dataclasses.dataclass
class NodeClassConfig:
    model: str = "gcn"           # gcn|resgcn|gcnode|gat|resgat|gatode
    hidden: int = 16
    heads: int = 8               # GAT family
    n_blocks: int = 2            # residual variants
    dropout: float = 0.5
    # ODE-variant knobs.
    t1: float = 1.0
    method: str = "rk4"
    steps: int = 4               # fixed-grid substeps / attempts of a _scan method
    rtol: float = 1e-3
    atol: float = 1e-4
    adjoint: Union[bool, str] = False  # only False is ported (A13)
    activation: str = "tanh"
    # Optimisation (reference defaults).
    lr: float = 0.01
    weight_decay: float = 5e-4
    epochs: int = 200
    patience: int = 100
    seed: int = 42
    # Aggregation path: dense Â for small graphs (GCN family only).
    dense_adj: bool = True
    # Explicit override: "dense" | "segment" | "kernel" (the CSR kernel; on
    # a CPU tensor its plain version).  None -> choose_representation.
    representation: Optional[str] = None
    log_path: Optional[str] = None
    echo: bool = False


def build_model(cfg: NodeClassConfig, n_class: int, in_features: int, *, generator=None):
    """The config's model, initialised from ``generator`` on the CPU."""
    common = dict(n_class=n_class, dropout=cfg.dropout, generator=generator)
    ode = dict(
        t1=cfg.t1, method=cfg.method, steps=cfg.steps, rtol=cfg.rtol, atol=cfg.atol,
        adjoint=cfg.adjoint, activation=cfg.activation,
    )
    if cfg.model == "gcn":
        return GCN(in_features, hidden=cfg.hidden, **common)
    if cfg.model == "resgcn":
        return ResGCN(in_features, hidden=cfg.hidden, n_blocks=cfg.n_blocks, **common)
    if cfg.model == "gcnode":
        return GCNODE(in_features, hidden=cfg.hidden, **common, **ode)
    if cfg.model == "gat":
        return GAT(in_features, hidden=cfg.hidden, heads=cfg.heads, **common)
    if cfg.model == "resgat":
        return ResGAT(
            in_features, hidden=cfg.hidden, heads=cfg.heads, n_blocks=cfg.n_blocks, **common
        )
    if cfg.model == "gatode":
        return GATODE(in_features, hidden=cfg.hidden, heads=cfg.heads, **common, **ode)
    raise ValueError(f"unknown model {cfg.model!r}")


def choose_representation(graph, model: str) -> str:
    """Adjacency representation by scale and device.

    GCN-family models on graphs of at most ``DENSE_MAX_NODES`` padded nodes
    take dense Â (one matmul).  Larger graphs, and the other models, take
    the CSR kernel when the graph lies on a CUDA device and the segment ops
    on the CPU.  The threshold is inherited from the JAX package; PERF.md
    records what the H100 measures at Pubmed size.
    """
    on_cuda = graph.device.type == "cuda"
    if model in ("gcn", "resgcn", "gcnode") and graph.n_node_pad <= DENSE_MAX_NODES:
        return "dense"
    return "kernel" if on_cuda else "segment"


def fit_node_classifier(
    cfg: NodeClassConfig,
    data: NodeClassificationData,
    *,
    device="cuda",
    init_state: Optional[dict] = None,
):
    """Train, early-stop on validation loss, and test.  Returns a results dict.

    Runs on the card unless ``device="cpu"``; without a card the default
    raises.  ``init_state`` replaces the seeded initialisation, to continue
    from weights trained by the JAX package (``convert.params_from_flax``).
    """
    device = resolve_device(device)
    data = data.to(device)
    model = build_model(
        cfg, data.n_class, data.features.shape[1],
        generator=torch.Generator().manual_seed(cfg.seed),
    )
    if init_state is not None:
        model.load_state_dict(init_state)
    model.to(device)

    representation = cfg.representation
    if representation is None:
        representation = (
            choose_representation(data.graph, cfg.model) if cfg.dense_adj else "segment"
        )
    if representation == "dense":
        adj = data.dense_adj()
    elif representation == "segment":
        adj = data.graph
    elif representation == "kernel":
        adj = prepare(data.graph)
    else:
        raise ValueError(f"unknown representation {representation!r}")

    # Adam(weight_decay) adds L2 to the gradient, as the reference does.
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, weight_decay=cfg.weight_decay)
    drop_gen = torch.Generator(device=device).manual_seed(cfg.seed)
    gens = dict(generator=drop_gen)
    if cfg.model in GAT_FAMILY:
        gens["seed_generator"] = torch.Generator().manual_seed(cfg.seed)

    def train_step():
        model.train()
        opt.zero_grad(set_to_none=True)
        out = model(adj, data.features, deterministic=False, **gens)
        loss = masked_nll(out, data.labels, data.idx_train)
        loss.backward()
        opt.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step():
        model.eval()
        out = model(adj, data.features, deterministic=True)
        return dict(
            train_acc=masked_accuracy(out, data.labels, data.idx_train),
            val_loss=masked_nll(out, data.labels, data.idx_val),
            val_acc=masked_accuracy(out, data.labels, data.idx_val),
            test_acc=masked_accuracy(out, data.labels, data.idx_test),
        )

    def snapshot():
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    log = MetricsLogger(cfg.log_path, echo=cfg.echo)
    best = dict(val_loss=float("inf"), test_acc=0.0, val_acc=0.0, epoch=-1)
    best_params = snapshot()
    bad_epochs = 0
    t_start = time.perf_counter()
    for epoch in range(cfg.epochs):
        loss = train_step()
        m = eval_step()
        rec = log.write(epoch=epoch, loss=loss, **m)
        if rec["val_loss"] < best["val_loss"]:
            best = dict(
                val_loss=rec["val_loss"], val_acc=rec["val_acc"],
                test_acc=rec["test_acc"], epoch=epoch,
            )
            best_params = snapshot()
            bad_epochs = 0
        else:
            bad_epochs += 1
            if bad_epochs > cfg.patience:
                break
    log.close()
    return dict(
        best=best,
        params=best_params,
        epochs_run=epoch + 1,
        seconds=time.perf_counter() - t_start,
        final_test_acc=best["test_acc"],
        representation=representation,
        # Solver stats of the last forward (the last evaluation), ODE models only.
        ode_stats=model.odeblock.stats if hasattr(model, "odeblock") else None,
    )
