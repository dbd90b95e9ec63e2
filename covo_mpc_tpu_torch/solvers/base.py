"""Solver (controller) protocol.

``action, control_params, info = solver(obs, state, env_params,
control_params, env_info)`` — the JAX call signature without the
``rng_act`` key: a solver owns its random streams (seeded by :meth:`seed`,
listed by :meth:`random_streams`: device generators and seed streams,
which a captured solve advances at each replay).
"""

from __future__ import annotations

import torch

from covo_mpc_tpu_torch.ops import sampling
from covo_mpc_tpu_torch.ops.rollout import make_rollout
from covo_mpc_tpu_torch.ops.rollout_cuda import make_rollout_costs


def make_cost_rollout(env, engine: str, rng_mode: str):
    """The costs-only rollout a solver's fast sampler feeds: K4 on
    ``engine="cuda"`` (which runs rng modes "fast" and "kernel"), the plain
    rollout on ``engine="torch"`` (rng mode "fast" only)."""
    if rng_mode not in (sampling.FAST, sampling.KERNEL):
        raise NotImplementedError(f"rng_mode {rng_mode!r} is not ported yet")
    if engine == "cuda":
        return make_rollout_costs(env)
    if engine == "torch":
        if rng_mode != sampling.FAST:
            raise ValueError("rng_mode='kernel' requires engine='cuda'")
        return make_rollout(env)
    raise ValueError(f"unknown engine {engine!r}")


class BaseSolver:
    def __init__(self, env, control_params) -> None:
        self.env = env
        self.init_control_params = control_params

    def seed(self, seed: int) -> None:
        """Seed the solver's generators (none here)."""

    def random_streams(self) -> list:
        """The device generators and seed streams a solve draws from (none
        here)."""
        return []

    def reset(self, env_state=None, env_params=None, control_params=None):
        """Return fresh solver params."""
        return self.init_control_params

    def __call__(self, obs, state, env_params, control_params, env_info=None):
        raise NotImplementedError


def resolve_engine(env, engine: str) -> str:
    """Resolve ``engine="auto"`` (JAX: factory.resolve_engine, with "cuda"
    in the place of "pallas"): the CUDA kernels when the env lies on a CUDA
    device, the plain PyTorch path when it lies on the CPU."""
    if engine != "auto":
        return engine
    return "cuda" if torch.device(env.device).type == "cuda" else "torch"


class RandomSolver(BaseSolver):
    """N(0, 0.3^2) actions, drawn from the solver's own generator on the
    env's device (JAX: solvers/base.RandomSolver)."""

    def __init__(self, env, control_params=None, seed: int = 0) -> None:
        super().__init__(env, control_params)
        self.generator = torch.Generator(device=env.device)
        self.seed(seed)

    def seed(self, seed: int) -> None:
        self.generator.manual_seed(seed)

    def random_streams(self) -> list:
        return [self.generator]

    def __call__(self, obs, state, env_params, control_params, env_info=None):
        action = torch.randn(self.env.action_dim, generator=self.generator,
                             device=self.env.device) * 0.3
        return action, control_params, {}
