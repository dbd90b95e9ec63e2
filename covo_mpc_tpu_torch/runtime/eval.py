"""Evaluation protocol: fixed reset trajectories x repetitions.

Counterpart of :func:`covo_mpc_tpu.runtime.eval.evaluate`: ``num_trajs``
reset trajectories, each run ``reps`` times in a row, with one random
stream threaded through all episodes. For a solver that draws from JAX keys
("parity", "invariant") that stream is JAX's own (:func:`key_protocol`:
``PRNGKey(seed)``, its split, the reset keys, the key chain through every
episode), so the episodes are JAX's, step for step. For any other solver
the draws come from torch generators seeded from ``seed``: the protocol is
the same, the trajectories are not the JAX package's. The episodes go
through :func:`make_episode_runner`: on the card each control step is one
replayed CUDA graph, as JAX scans its jitted step; on the CPU (and for a
solver that reads the host) the eager loop.

:func:`evaluate_batched` is JAX's throughput protocol: ``num_eps``
independent episodes stepped at once by the controller's batched twin
(``runtime/episode.py::BatchedEpisodes``), each with its own generators
seeded from ``seed`` and its index.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from covo_mpc_tpu_torch.runtime.episode import (
    make_batched_episode_runner,
    make_episode_runner,
)
from covo_mpc_tpu_torch.runtime.metrics import MetricsLogger
from covo_mpc_tpu_torch.utils import prng


@dataclasses.dataclass
class EvalResult:
    err_pos_ep: torch.Tensor  # (num_eps,) per-episode mean tracking error [m]
    mean: float
    std: float
    # per-solve health metrics, dict of (num_eps, T) tensors, when the
    # controller was built with collect_metrics=True
    metrics: Optional[dict] = None

    def summary(self) -> str:
        return f"err_pos: {self.mean*100:.2f} +/- {self.std*100:.2f} cm"


def _episodes(env, total_steps: int, num_trajs: int):
    """(num_trajs, reps) of the protocol: ``total_steps // max_steps``
    episodes over at most ``num_trajs`` reset trajectories."""
    max_steps = env.default_params.max_steps_in_episode
    num_eps = int(total_steps // max_steps)
    if num_eps < 1:
        raise ValueError(
            f"total_steps={total_steps} is less than one episode "
            f"({max_steps} steps)"
        )
    # fewer episodes than reset trajectories: the first num_eps once each
    num_trajs = min(num_trajs, num_eps)
    return num_trajs, num_eps // num_trajs


def key_protocol(env, total_steps: int, num_trajs: int, seed: int):
    """JAX's plan from ``seed`` (runtime/eval.py:92-96): ``(num_eps, reps,
    reset_keys (num_trajs, 2), rng)``: ``rng, meta = split(PRNGKey(seed))``,
    ``reset_keys = split(meta, num_trajs)``; episode i resets from
    ``reset_keys[i // reps]`` and ``rng`` runs through all episodes."""
    num_trajs, reps = _episodes(env, total_steps, num_trajs)
    rng, meta = prng.split(prng.PRNGKey(seed, env.device))
    return num_trajs * reps, reps, prng.split(meta, num_trajs), rng.clone()


def protocol(env, total_steps: int, num_trajs: int, seed: int):
    """The protocol's plan from ``seed`` for a solver that draws from
    generators: ``(num_eps, reps, reset_seeds, step_seed)``. Episode i
    resets from ``reset_seeds[i // reps]``; one step generator seeded with
    ``step_seed`` runs through all episodes."""
    num_trajs, reps = _episodes(env, total_steps, num_trajs)
    meta = torch.Generator().manual_seed(seed)
    reset_seeds = torch.randint(0, 2**62, (num_trajs,), generator=meta).tolist()
    step_seed = int(torch.randint(0, 2**62, (), generator=meta))
    return num_trajs * reps, reps, reset_seeds, step_seed


def run_episode(env, run_one_ep, reset_seed: int, gen: torch.Generator):
    """One protocol episode: ``(mean err_pos (device scalar), metrics)``."""
    reset_gen = torch.Generator(device=env.device).manual_seed(reset_seed)
    err_pos, _, metrics = run_one_ep(reset_gen, gen)
    return err_pos.mean(), metrics


def write_metrics_jsonl(metrics: dict, err_pos, path: str) -> MetricsLogger:
    """Dump per-solve metrics (dict of (num_eps, T) arrays) as JSONL, one
    record per (episode, step) with the episode's tracking error."""
    arrs = {k: np.asarray(torch.as_tensor(v).cpu()) for k, v in metrics.items()}
    err = np.asarray(torch.as_tensor(err_pos).cpu())
    logger = MetricsLogger(path)
    num_eps, T = next(iter(arrs.values())).shape
    for ep in range(num_eps):
        for t in range(T):
            logger.log(
                step=ep * T + t, episode=ep,
                err_pos=err[ep] if err.ndim == 1 else err[ep, t],
                **{k: v[ep, t] for k, v in arrs.items()},
            )
    logger.close()
    return logger


def evaluate(env, controller, total_steps: int = 12000, num_trajs: int = 4,
             seed: int = 1, metrics_path: Optional[str] = None) -> EvalResult:
    """Run ``total_steps // max_steps`` episodes: episode i resets onto
    trajectory ``i // reps``. Reads the device once, at the end (and once
    an episode for the Sigma metrics of a solver that collects them).
    ``metrics_path``: when the controller collects solve metrics, also
    write them as JSONL, one record per (episode, step). A solver that
    draws from JAX keys runs JAX's key schedule (:func:`key_protocol`)."""
    run_one_ep = make_episode_runner(env, controller)
    controller.seed(seed)
    errs, per_ep = [], []
    if getattr(controller, "draws_from_keys", False):
        num_eps, reps, reset_keys, rng = key_protocol(env, total_steps, num_trajs,
                                                      seed)
        for i in range(num_eps):
            err_pos, _, metrics = run_one_ep(reset_keys[i // reps], rng)
            errs.append(err_pos.mean())
            per_ep.append(metrics)
    else:
        num_eps, reps, reset_seeds, step_seed = protocol(env, total_steps, num_trajs,
                                                         seed)
        gen = torch.Generator(device=env.device).manual_seed(step_seed)
        for i in range(num_eps):
            err, metrics = run_episode(env, run_one_ep, reset_seeds[i // reps], gen)
            errs.append(err)
            per_ep.append(metrics)
    err_pos_ep = torch.stack(errs).cpu()
    metrics = ({k: torch.stack([m[k] for m in per_ep]).cpu() for k in per_ep[0]}
               if per_ep[0] else None)
    result = EvalResult(
        err_pos_ep=err_pos_ep,
        mean=float(err_pos_ep.mean()),
        std=float(err_pos_ep.std(correction=0)),
        metrics=metrics,
    )
    if metrics_path and metrics:
        write_metrics_jsonl(metrics, err_pos_ep, metrics_path)
    return result


def evaluate_batched(env, controller, num_eps: int = 40, seed: int = 1,
                     env_params=None) -> EvalResult:
    """Throughput-oriented: all ``num_eps`` episodes at once, each with its
    own generators (JAX: ``vmap`` of the episode over independent keys).
    The controller runs as its batched twin (``parallel.batched_controller``;
    one that has none raises). Reads the device once, at the end."""
    run = make_batched_episode_runner(env, controller)
    err_pos, _ = run(seed, 0, num_eps, env_params)
    err_pos_ep = err_pos.mean(dim=1).cpu()
    return EvalResult(
        err_pos_ep=err_pos_ep,
        mean=float(err_pos_ep.mean()),
        std=float(err_pos_ep.std(correction=0)),
    )
