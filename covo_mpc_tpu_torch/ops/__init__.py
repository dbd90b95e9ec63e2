"""Compute ops: rollout engines, kernel wrappers, Hessian, Sigma design,
sampling and reductions. Importing builds no kernel."""

from covo_mpc_tpu_torch.ops import covariance, reductions, sampling
from covo_mpc_tpu_torch.ops.rollout import make_hessian_cost, make_rollout

__all__ = ["covariance", "make_hessian_cost", "make_rollout", "reductions", "sampling"]
