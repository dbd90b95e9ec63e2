"""Harness: episode runner and the evaluation protocol."""

from covo_mpc_tpu_torch.runtime.episode import make_episode_runner
from covo_mpc_tpu_torch.runtime.eval import EvalResult, evaluate

__all__ = ["EvalResult", "evaluate", "make_episode_runner"]
