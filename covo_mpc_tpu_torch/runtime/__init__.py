"""Harness: the captured solves and control step (CUDA graphs), the episode
runner, the evaluation and render protocols, the supervised eval, the run
config, solve metrics, checkpoints, debug mode and the latency helpers."""

from covo_mpc_tpu_torch.runtime.config import RunConfig
from covo_mpc_tpu_torch.runtime.episode import make_episode_runner
from covo_mpc_tpu_torch.runtime.eval import EvalResult, evaluate
from covo_mpc_tpu_torch.runtime.graphs import capture, capture_solver
from covo_mpc_tpu_torch.runtime.metrics import MetricsLogger, sigma_metrics, solve_metrics
from covo_mpc_tpu_torch.runtime.render import load_trace, render_episode, save_trace
from covo_mpc_tpu_torch.runtime.supervisor import SupervisedResult, run_supervised

__all__ = [
    "EvalResult",
    "MetricsLogger",
    "RunConfig",
    "SupervisedResult",
    "capture",
    "capture_solver",
    "evaluate",
    "load_trace",
    "make_episode_runner",
    "render_episode",
    "run_supervised",
    "save_trace",
    "sigma_metrics",
    "solve_metrics",
]
