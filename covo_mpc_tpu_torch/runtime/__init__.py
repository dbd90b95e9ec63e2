"""Harness: the captured solves and control step (CUDA graphs), the episode
runner, the evaluation protocol and the latency helpers."""

from covo_mpc_tpu_torch.runtime.episode import make_episode_runner
from covo_mpc_tpu_torch.runtime.eval import EvalResult, evaluate
from covo_mpc_tpu_torch.runtime.graphs import capture, capture_solver

__all__ = ["EvalResult", "capture", "capture_solver", "evaluate", "make_episode_runner"]
