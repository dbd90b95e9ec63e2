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

__all__ = [
    "BaseSolver",
    "FAST_PATH",
    "CoVOParams",
    "CoVOSolver",
    "covo_params_from_numpy",
    "get_solver",
    "hover_sequence",
    "MPPIParams",
    "MPPISolver",
    "mppi_params_from_numpy",
    "parse_sample_params",
    "PIDParams",
    "PIDSolver",
    "RandomSolver",
    "resolve_engine",
]
