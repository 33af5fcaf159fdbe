"""ODE solvers: ``odeint`` over the fixed-grid and adaptive Runge-Kutta tableaus."""

from graph_odenet_tpu_torch.ode.api import SOLVERS, odeint  # noqa: F401
