"""Trainers: full-batch node classification."""

from graph_odenet_tpu_torch.train.node_classification import (  # noqa: F401
    NodeClassConfig,
    build_model,
    choose_representation,
    fit_node_classifier,
)
