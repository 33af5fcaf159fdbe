"""Canonical experiment configs, node-classification kind.

Counterpart of ``graph_odenet_tpu/configs/__init__.py``:

  0  2-layer GCN on Cora (discrete baseline)
  1  GCN-ODE on Cora, fixed-step RK4 (4 steps)
  2  GAT-ODE on Citeseer with dopri5_scan (32 attempts)
  3  Interaction-network ODE on n-body        (ROADMAP A15)
  4  Edge-partitioned GCN-ODE on OGBN-arxiv

plus the named extras of the GCN and GAT families (``pubmed-gcnode`` and
``cora-gatode`` among them).  ``get_config`` returns ``(kind, config)``:
``node`` selects ``train.fit_node_classifier``, ``sharded``
``parallel.fit_sharded_node_classifier``.  Config 3 raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses

from graph_odenet_tpu_torch.train.node_classification import NodeClassConfig

__all__ = ["get_config", "run_config", "CONFIG_NAMES", "EXTRA_CONFIGS", "ShardedConfig"]

CONFIG_NAMES = {
    0: "cora-gcn-discrete",
    1: "cora-gcnode-rk4",
    2: "citeseer-gatode-dopri5",
    3: "nbody-inode-rollout",
    4: "ogbn-arxiv-gcnode-sharded",
}

_GCN_RECIPE = dict(
    model="gcn", hidden=16, dropout=0.5, lr=0.01,
    weight_decay=5e-4, epochs=200, patience=100,
)
_RESGCN_RECIPE = dict(_GCN_RECIPE, model="resgcn", n_blocks=2)
_GCNODE_RECIPE = dict(
    model="gcnode", hidden=16, method="rk4", steps=4, dropout=0.5,
    lr=0.01, weight_decay=5e-4, epochs=200, patience=100,
)
# The Veličković GAT recipe: 8 heads × 8 hidden, dropout 0.6, lr 0.005.
_GAT_RECIPE = dict(
    model="gat", hidden=8, heads=8, dropout=0.6,
    lr=0.005, weight_decay=5e-4, epochs=300, patience=100,
)
_RESGAT_RECIPE = dict(_GAT_RECIPE, model="resgat", n_blocks=2)
_GATODE_RECIPE = dict(
    model="gatode", hidden=8, heads=8, method="dopri5_scan",
    steps=32, rtol=1e-3, atol=1e-4, dropout=0.6,
    lr=0.005, weight_decay=5e-4, epochs=300, patience=100,
)
EXTRA_CONFIGS = {
    "citeseer-gcn": ("citeseer", _GCN_RECIPE),
    "pubmed-gcn": ("pubmed", _GCN_RECIPE),
    "cora-gat": ("cora", _GAT_RECIPE),
    "citeseer-gat": ("citeseer", _GAT_RECIPE),
    "pubmed-gat": ("pubmed", _GAT_RECIPE),
    "cora-resgcn": ("cora", _RESGCN_RECIPE),
    "citeseer-resgcn": ("citeseer", _RESGCN_RECIPE),
    "pubmed-resgcn": ("pubmed", _RESGCN_RECIPE),
    "cora-resgat": ("cora", _RESGAT_RECIPE),
    "citeseer-resgat": ("citeseer", _RESGAT_RECIPE),
    "pubmed-resgat": ("pubmed", _RESGAT_RECIPE),
    "citeseer-gcnode": ("citeseer", _GCNODE_RECIPE),
    "pubmed-gcnode": ("pubmed", _GCNODE_RECIPE),
    "cora-gatode": ("cora", _GATODE_RECIPE),
    "pubmed-gatode": ("pubmed", _GATODE_RECIPE),
}

# Configs of the JAX package that wait for a later slice.
_NOT_PORTED = {3: "A15"}


@dataclasses.dataclass
class ShardedConfig:
    """Config 4: the edge-partitioned GCN-ODE on (the twin of) OGBN-arxiv."""

    dataset: str = "ogbn-arxiv"
    model: str = "gcnode"
    hidden: int = 256
    steps: int = 4
    t1: float = 1.0
    lr: float = 0.01
    weight_decay: float = 5e-4
    epochs: int = 30
    patience: int = 100
    mode: str = "ring"    # halo exchange flavour
    dropout: float = 0.5  # feature dropout
    n_parts: int = 8      # at most; the process group's size bounds it
    ckpt_dir: str | None = None  # ROADMAP A17


def get_config(i):
    """(kind, config) of config ``i``, by index or by name."""
    if isinstance(i, str):
        if i in EXTRA_CONFIGS:
            return "node", NodeClassConfig(**EXTRA_CONFIGS[i][1])
        inv = {v: k for k, v in CONFIG_NAMES.items()}
        if i in inv:
            return get_config(inv[i])
    if i in _NOT_PORTED:
        raise NotImplementedError(f"config {i!r} is not ported yet (ROADMAP {_NOT_PORTED[i]})")
    if i == 0:
        return "node", NodeClassConfig(**_GCN_RECIPE)
    if i == 1:
        return "node", NodeClassConfig(
            model="gcnode", hidden=16, method="rk4", steps=4,
            dropout=0.5, lr=0.01, weight_decay=5e-4, epochs=200,
        )
    if i == 2:
        return "node", NodeClassConfig(**_GATODE_RECIPE)
    if i == 4:
        return "sharded", ShardedConfig()
    raise KeyError(i)


_CONFIG_DATASET = {0: "cora", 1: "cora", 2: "citeseer"}


def run_config(
    i,
    *,
    scale: float = 1.0,
    data_path: str | None = None,
    calibrated: bool = False,
    seed: int | None = None,
    device="cuda",
):
    """Run config ``i`` (index or name) end to end on ``device``.

    Runs on the card unless ``device="cpu"``; without a card the default
    raises.  ``scale`` shrinks the synthetic dataset for smoke runs;
    ``data_path`` points at real files (pygcn format; the OGB CSVs for
    config 4); ``calibrated`` takes the difficulty-calibrated twin; ``seed``
    overrides the config seed (config 4 has none, as in the JAX package).
    Config 4 runs over ``min(8, ranks)`` parts: one process, one part,
    without a process group.
    """
    kind, cfg = get_config(i)
    cfg_name = CONFIG_NAMES[i] if isinstance(i, int) else i
    if seed is not None and hasattr(cfg, "seed"):
        cfg = dataclasses.replace(cfg, seed=seed)
    if kind == "sharded":
        return _run_sharded(cfg_name, cfg, scale, data_path, calibrated, device)
    from graph_odenet_tpu_torch.data.planetoid import load_planetoid, synthetic_planetoid
    from graph_odenet_tpu_torch.train import fit_node_classifier

    name = _CONFIG_DATASET[i] if isinstance(i, int) else EXTRA_CONFIGS[i][0]
    data = (
        load_planetoid(name, data_path)
        if data_path
        else synthetic_planetoid(name, seed=cfg.seed, scale=scale, calibrated=calibrated)
    )
    res = fit_node_classifier(cfg, data, device=device)
    return dict(
        config=cfg_name, dataset=data.name, best=res["best"], seconds=res["seconds"],
        epochs_run=res["epochs_run"], representation=res["representation"],
        params=res["params"], ode_stats=res["ode_stats"],
    )


def _run_sharded(cfg_name, cfg: ShardedConfig, scale, data_path, calibrated, device):
    from graph_odenet_tpu_torch.data.ogbn import load_ogbn_arxiv, synthetic_ogbn_arxiv
    from graph_odenet_tpu_torch.parallel import (
        ShardedTrainConfig, fit_sharded_node_classifier, world,
    )

    data = (
        load_ogbn_arxiv(data_path) if data_path
        else synthetic_ogbn_arxiv(seed=0, scale=scale, calibrated=calibrated)
    )
    tcfg = ShardedTrainConfig(
        model=cfg.model, hidden=cfg.hidden, steps=cfg.steps, t1=cfg.t1, lr=cfg.lr,
        weight_decay=cfg.weight_decay, epochs=cfg.epochs, patience=cfg.patience,
        mode=cfg.mode, dropout=cfg.dropout, n_parts=min(cfg.n_parts, world()[0]),
        ckpt_dir=cfg.ckpt_dir,
    )
    res = fit_sharded_node_classifier(tcfg, data, device=device)
    res.pop("params")
    return dict(config=cfg_name, dataset=data.name, **res)
