"""Sampling-based MPC solvers (MPPI, CoVO online / speculative / offline)
and the PID and Random baselines."""

from covo_mpc_tpu_torch.solvers.base import BaseSolver, RandomSolver, resolve_engine
from covo_mpc_tpu_torch.solvers.covo import CoVOParams, CoVOSolver, covo_params_from_numpy
from covo_mpc_tpu_torch.solvers.factory import (
    FAST_PATH,
    get_solver,
    hover_sequence,
    parse_sample_params,
)
from covo_mpc_tpu_torch.solvers.mppi import MPPIParams, MPPISolver, mppi_params_from_numpy
from covo_mpc_tpu_torch.solvers.pid import PIDParams, PIDSolver

# the reference's controller names (JAX: solvers/__init__.py)
BaseController = BaseSolver
RandomController = RandomSolver
PIDController = PIDSolver
MPPIController = MPPISolver
CoVOController = CoVOSolver

__all__ = [
    "BaseController",
    "BaseSolver",
    "CoVOController",
    "FAST_PATH",
    "CoVOParams",
    "CoVOSolver",
    "covo_params_from_numpy",
    "get_solver",
    "hover_sequence",
    "MPPIController",
    "MPPIParams",
    "MPPISolver",
    "mppi_params_from_numpy",
    "parse_sample_params",
    "PIDController",
    "PIDParams",
    "PIDSolver",
    "RandomController",
    "RandomSolver",
    "resolve_engine",
]
