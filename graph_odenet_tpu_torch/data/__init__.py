"""Datasets: Planetoid citation networks and their synthetic twin."""

from graph_odenet_tpu_torch.data.planetoid import (  # noqa: F401
    CALIBRATED,
    NodeClassificationData,
    load_planetoid,
    synthetic_planetoid,
)
