"""graph_odenet_tpu_torch — the graph-ODE framework on PyTorch and CUDA.

The PyTorch counterpart of ``graph_odenet_tpu``: the same module layout, the
same semantics, checked against the JAX package by ``tests/test_torch_*.py``.
Plain tensor code is PyTorch; every aggregation the JAX package runs through
a Pallas kernel runs here through a CUDA C++ kernel written for Hopper
(``csrc/``), built with ``nvcc`` at first use and bound with ``ctypes``.

This package imports neither JAX nor the JAX package.

  graph            Graph container: COO edges, normalisation, padding.
  ops              gather/segment_sum/segment_softmax, SpMM (segment, CSR
                   kernel, dense), GAT attention (segment path and the
                   fused kernels), the counter-hash attention dropout.
  ode              odeint with the fixed-grid and adaptive Runge-Kutta
                   solvers (dopri5 and kin, each with a ``_scan`` form),
                   batched over independent problems with ``batch_dims=1``,
                   the fixed-grid and variable-order Adams methods and
                   ``scipy_solver``; odeint_adjoint, the continuous and
                   checkpointed adjoints.
  models           GCN, ResGCN, GAT, ResGAT, ODEBlock, GCN-ODE, GAT-ODE,
                   the interaction network and IN-ODE.
  data             Planetoid and OGBN-arxiv loaders and twins, spring n-body.
  train            Full-batch node-classification and physics trainers.
  parallel         The edge-partitioned tier (config 4).
  configs          Named configs 0–4 and extras, and ``run_config``.
  convert          Flax parameter trees to torch ``state_dict``s.
  utils            Device choice, metrics, logging, plots (matplotlib, lazily),
                   checkpoints, sanitizers (validate_tiling, odeint_checked),
                   profiling.
"""

__version__ = "0.1.0"

from graph_odenet_tpu_torch.graph import Graph  # noqa: F401
from graph_odenet_tpu_torch.ode.api import SOLVERS, odeint, odeint_adjoint  # noqa: F401
