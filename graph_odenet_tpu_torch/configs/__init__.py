"""Canonical experiment configs, node-classification kind.

Counterpart of ``graph_odenet_tpu/configs/__init__.py``:

  0  2-layer GCN on Cora (discrete baseline)
  1  GCN-ODE on Cora, fixed-step RK4 (4 steps)
  2  GAT-ODE on Citeseer with dopri5         (ROADMAP A12)
  3  Interaction-network ODE on n-body        (ROADMAP A15)
  4  Edge-partitioned GCN-ODE on OGBN-arxiv   (ROADMAP A16)

plus the GCN-family named extras (``pubmed-gcnode`` among them).  The
configs that are not ported yet raise ``NotImplementedError`` naming their
ROADMAP item.
"""

from __future__ import annotations

import dataclasses

from graph_odenet_tpu_torch.train.node_classification import NodeClassConfig

__all__ = ["get_config", "run_config", "CONFIG_NAMES", "EXTRA_CONFIGS"]

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
EXTRA_CONFIGS = {
    "citeseer-gcn": ("citeseer", _GCN_RECIPE),
    "pubmed-gcn": ("pubmed", _GCN_RECIPE),
    "cora-resgcn": ("cora", _RESGCN_RECIPE),
    "citeseer-resgcn": ("citeseer", _RESGCN_RECIPE),
    "pubmed-resgcn": ("pubmed", _RESGCN_RECIPE),
    "citeseer-gcnode": ("citeseer", _GCNODE_RECIPE),
    "pubmed-gcnode": ("pubmed", _GCNODE_RECIPE),
}

# Configs of the JAX package that wait for a later slice.
_NOT_PORTED = {
    2: "A12", 3: "A15", 4: "A16",
    "cora-gat": "A11", "citeseer-gat": "A11", "pubmed-gat": "A11",
    "cora-resgat": "A11", "citeseer-resgat": "A11", "pubmed-resgat": "A11",
    "cora-gatode": "A12", "pubmed-gatode": "A12",
}


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
    raise KeyError(i)


_CONFIG_DATASET = {0: "cora", 1: "cora"}


def run_config(
    i,
    *,
    scale: float = 1.0,
    data_path: str | None = None,
    calibrated: bool = False,
    seed: int | None = None,
    device="cpu",
):
    """Run config ``i`` (index or name) end to end on ``device``.

    ``scale`` shrinks the synthetic dataset for smoke runs; ``data_path``
    points at real pygcn-format files; ``calibrated`` takes the
    difficulty-calibrated twin; ``seed`` overrides the config seed.
    """
    kind, cfg = get_config(i)
    cfg_name = CONFIG_NAMES[i] if isinstance(i, int) else i
    if seed is not None:
        cfg = dataclasses.replace(cfg, seed=seed)
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
        params=res["params"],
    )
