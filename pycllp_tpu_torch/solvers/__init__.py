"""Solver layer: registry + the ported backends."""

from pycllp_tpu_torch.solvers.options import Solution, SolverOptions, Status
from pycllp_tpu_torch.solvers.base import (
    BaseSolver,
    available_solvers,
    get_solver,
    register_solver,
    solver_registry,
)

# importing backend modules registers them
from pycllp_tpu_torch.solvers import torch_hsd as _torch_hsd  # noqa: F401
from pycllp_tpu_torch.solvers import scipy_solver as _scipy_solver  # noqa: F401
from pycllp_tpu_torch.solvers import cpp as _cpp  # noqa: F401
from pycllp_tpu_torch.solvers import dense_path as _dense_path  # noqa: F401
from pycllp_tpu_torch.solvers import schur_solver as _schur_solver  # noqa: F401

__all__ = [
    "BaseSolver",
    "Solution",
    "SolverOptions",
    "Status",
    "available_solvers",
    "get_solver",
    "register_solver",
    "solver_registry",
]
