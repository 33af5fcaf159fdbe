"""Models: GCN and GAT families with their residual and continuous-depth variants."""

from graph_odenet_tpu_torch.models.gat import GAT, GATLayer, ResGAT  # noqa: F401
from graph_odenet_tpu_torch.models.gcn import GCN, GCNLayer, ResGCN  # noqa: F401
from graph_odenet_tpu_torch.models.odeblock import (  # noqa: F401
    GATODE,
    GCNODE,
    GATDynamics,
    GCNDynamics,
    ODEBlock,
)
