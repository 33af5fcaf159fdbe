"""Datasets: Planetoid citation networks, OGBN-arxiv, and their synthetic twins."""

from graph_odenet_tpu_torch.data.ogbn import (  # noqa: F401
    ARXIV_CALIBRATED,
    load_ogbn_arxiv,
    synthetic_ogbn_arxiv,
)
from graph_odenet_tpu_torch.data.planetoid import (  # noqa: F401
    CALIBRATED,
    NodeClassificationData,
    load_planetoid,
    synthetic_planetoid,
)
