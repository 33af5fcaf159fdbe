"""Models: GCN, ResGCN and the continuous-depth GCN-ODE."""

from graph_odenet_tpu_torch.models.gcn import GCN, GCNLayer, ResGCN  # noqa: F401
from graph_odenet_tpu_torch.models.odeblock import GCNODE, GCNDynamics, ODEBlock  # noqa: F401
