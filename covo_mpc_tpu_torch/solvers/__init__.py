"""Sampling-based MPC solvers (CoVO online)."""

from covo_mpc_tpu_torch.solvers.base import BaseSolver
from covo_mpc_tpu_torch.solvers.covo import CoVOParams, CoVOSolver, covo_params_from_numpy
from covo_mpc_tpu_torch.solvers.factory import get_solver, hover_sequence, parse_sample_params

__all__ = [
    "BaseSolver",
    "CoVOParams",
    "CoVOSolver",
    "covo_params_from_numpy",
    "get_solver",
    "hover_sequence",
    "parse_sample_params",
]
