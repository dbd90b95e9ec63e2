"""Harness: the captured solves and control step (CUDA graphs), the episode
runners, the evaluation protocols (sequential and batched) and render, the
supervised evals and the sweep store, the run config, solve metrics,
checkpoints, debug mode and the latency helpers."""

from covo_mpc_tpu_torch.runtime.config import RunConfig
from covo_mpc_tpu_torch.runtime.episode import make_batched_episode_runner, make_episode_runner
from covo_mpc_tpu_torch.runtime.eval import EvalResult, evaluate, evaluate_batched
from covo_mpc_tpu_torch.runtime.graphs import capture, capture_solver
from covo_mpc_tpu_torch.runtime.metrics import MetricsLogger, sigma_metrics, solve_metrics
from covo_mpc_tpu_torch.runtime.render import load_trace, render_episode, save_trace
from covo_mpc_tpu_torch.runtime.supervisor import (
    CellStore,
    SupervisedResult,
    run_supervised,
    run_supervised_batched,
)

__all__ = [
    "CellStore",
    "EvalResult",
    "MetricsLogger",
    "RunConfig",
    "SupervisedResult",
    "capture",
    "capture_solver",
    "evaluate",
    "evaluate_batched",
    "load_trace",
    "make_batched_episode_runner",
    "make_episode_runner",
    "render_episode",
    "run_supervised",
    "run_supervised_batched",
    "save_trace",
    "sigma_metrics",
    "solve_metrics",
]
