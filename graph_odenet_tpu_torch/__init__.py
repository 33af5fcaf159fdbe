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
  parallel         The edge-partitioned tier (config 4), on meshes of
                   process groups (feature-axis tensor parallelism too):
                   the sharded GCN-ODE, GAT-ODE and GRAND-nl
                   (``parallel.sharded_grand``, which has no counterpart in
                   the JAX package).
  configs          Named configs 0–4 and extras, and ``run_config``.
  convert          Flax parameter trees to torch ``state_dict``s.
  utils            Device choice, metrics, logging, plots (matplotlib, lazily),
                   checkpoints, sanitizers (validate_tiling, odeint_checked),
                   profiling.
  bench            The benchmark functions (SpMM, GAT attention, ODE solves,
                   the ODE models, sharded scaling), one record each.
  cli              ``python -m graph_odenet_tpu_torch.cli``: node, predict,
                   physics, config, bench.
  entry            ``entry()``: one GCN-ODE forward on the Cora twin.
"""

__version__ = "0.1.0"

from graph_odenet_tpu_torch.graph import Graph  # noqa: F401
from graph_odenet_tpu_torch.ode.api import SOLVERS, odeint, odeint_adjoint  # noqa: F401
