"""graph_odenet_tpu_torch — the graph-ODE framework on PyTorch and CUDA.

The PyTorch counterpart of ``graph_odenet_tpu``: the same module layout, the
same semantics, checked against the JAX package by ``tests/test_torch_*.py``.
Plain tensor code is PyTorch; every aggregation the JAX package runs through
a Pallas kernel runs here through a CUDA C++ kernel written for Hopper
(``csrc/``), built with ``nvcc`` at first use and bound with ``ctypes``.

This package imports neither JAX nor the JAX package.

  graph            Graph container: COO edges, normalisation, padding.
  ops              gather/segment_sum, SpMM (segment, CSR kernel, dense).
  ode              odeint with the fixed-grid Runge-Kutta solvers.
  models           GCN, ResGCN, ODEBlock and GCN-ODE.
  data             Planetoid loader and its synthetic twin.
  train            Full-batch node-classification trainer.
  configs          Named node-classification configs and ``run_config``.
  convert          Flax parameter trees to torch ``state_dict``s.
"""

__version__ = "0.1.0"

from graph_odenet_tpu_torch.graph import Graph  # noqa: F401
