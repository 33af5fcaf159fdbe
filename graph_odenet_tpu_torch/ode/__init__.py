"""ODE solvers: ``odeint`` over the fixed-grid and adaptive Runge-Kutta tableaus,
and ``odeint_adjoint``, its gradient by the continuous or checkpointed adjoint."""

from graph_odenet_tpu_torch.ode.api import SOLVERS, odeint, odeint_adjoint  # noqa: F401
