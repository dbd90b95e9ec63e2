"""Evaluation protocol: fixed reset trajectories x repetitions.

Counterpart of :func:`covo_mpc_tpu.runtime.eval.evaluate`: ``num_trajs``
reset trajectories, each run ``reps`` times in a row, with one step
generator threaded through all episodes. The draws come from torch
generators seeded from ``seed``, so the trajectories are not the JAX
package's (its threefry keys are not ported); the protocol is the same. The
episodes go through :func:`make_episode_runner`: on the card each control
step is one replayed CUDA graph, as JAX scans its jitted step; on the CPU
the eager loop.
"""

from __future__ import annotations

import dataclasses

import torch

from covo_mpc_tpu_torch.runtime.episode import make_episode_runner


@dataclasses.dataclass
class EvalResult:
    err_pos_ep: torch.Tensor  # (num_eps,) per-episode mean tracking error [m]
    mean: float
    std: float

    def summary(self) -> str:
        return f"err_pos: {self.mean*100:.2f} +/- {self.std*100:.2f} cm"


def evaluate(env, controller, total_steps: int = 12000, num_trajs: int = 4,
             seed: int = 1) -> EvalResult:
    """Run ``total_steps // max_steps`` episodes: episode i resets onto
    trajectory ``i // reps``. Reads the device once, at the end."""
    max_steps = env.default_params.max_steps_in_episode
    num_eps = int(total_steps // max_steps)
    if num_eps < 1:
        raise ValueError(
            f"total_steps={total_steps} is less than one episode "
            f"({max_steps} steps)"
        )
    num_trajs = min(num_trajs, num_eps)
    reps = num_eps // num_trajs
    run_one_ep = make_episode_runner(env, controller)

    meta = torch.Generator().manual_seed(seed)
    reset_seeds = torch.randint(0, 2**62, (num_trajs,), generator=meta).tolist()
    gen = torch.Generator(device=env.device).manual_seed(
        int(torch.randint(0, 2**62, (), generator=meta))
    )
    controller.seed(seed)

    errs = []
    for i in range(num_trajs * reps):
        reset_gen = torch.Generator(device=env.device).manual_seed(
            reset_seeds[i // reps]
        )
        err_pos, _ = run_one_ep(reset_gen, gen)
        errs.append(err_pos.mean())
    err_pos_ep = torch.stack(errs).cpu()
    return EvalResult(
        err_pos_ep=err_pos_ep,
        mean=float(err_pos_ep.mean()),
        std=float(err_pos_ep.std(correction=0)),
    )
