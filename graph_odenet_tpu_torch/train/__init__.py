"""Trainers: full-batch node classification and the physics trainers."""

from graph_odenet_tpu_torch.train.node_classification import (  # noqa: F401
    NodeClassConfig,
    adjacency,
    build_model,
    choose_representation,
    fit_node_classifier,
)
from graph_odenet_tpu_torch.train.physics import (  # noqa: F401
    PhysicsConfig,
    fit_inode,
    fit_interaction_network,
    physics_rollout_curves,
    rollout_discrete,
    rollout_mse,
)
