"""ODE solvers: ``odeint`` over the fixed-grid and adaptive Runge-Kutta tableaus,
the fixed-grid and variable-order Adams methods and ``scipy_solver``, and
``odeint_adjoint``, its gradient by the continuous or checkpointed adjoint."""

from graph_odenet_tpu_torch.ode.adams import odeint_adams  # noqa: F401
from graph_odenet_tpu_torch.ode.adaptive import odeint_dopri5, odeint_dopri5_scan  # noqa: F401
from graph_odenet_tpu_torch.ode.api import SOLVERS, odeint, odeint_adjoint  # noqa: F401
from graph_odenet_tpu_torch.ode.vcabm import gamma_star, odeint_vcabm, odeint_vcabm_scan  # noqa: F401
