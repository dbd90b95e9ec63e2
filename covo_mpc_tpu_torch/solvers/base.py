"""Solver (controller) protocol.

``action, control_params, info = solver(obs, state, env_params,
control_params, env_info)`` — the JAX call signature without the
``rng_act`` key: a solver owns its random streams (seeded by :meth:`seed`,
listed by :meth:`random_streams`: device generators and seed streams,
which a captured solve advances at each replay).

A solver whose rng mode draws from JAX keys (``draws_from_keys``: "parity"
and "invariant", ``ops/sampling.KEY_MODES``) takes JAX's ``rng_act`` as
``key=`` (a (2,) key of ``utils/prng.py``) and draws what JAX's solver
draws from it; called without one it raises. The episode runner then
follows JAX's key schedule (``runtime/episode.py``).
"""

from __future__ import annotations

import torch

from covo_mpc_tpu_torch.ops import sampling
from covo_mpc_tpu_torch.ops.rollout import make_rollout
from covo_mpc_tpu_torch.ops.rollout_cuda import make_rollout_costs
from covo_mpc_tpu_torch.runtime import metrics
from covo_mpc_tpu_torch.utils import prng


RNG_MODES = (sampling.PARITY, sampling.FAST, sampling.INVARIANT, sampling.KERNEL)


def make_cost_rollout(env, engine: str, rng_mode: str):
    """The costs-only rollout a solver's sampler feeds: K4 on
    ``engine="cuda"`` (every rng mode; "kernel" also runs its fused
    kernel), the plain rollout on ``engine="torch"`` (every mode but
    "kernel")."""
    if rng_mode not in RNG_MODES:
        raise ValueError(f"unknown rng_mode {rng_mode!r}")
    if engine == "cuda":
        return make_rollout_costs(env)
    if engine == "torch":
        if rng_mode == sampling.KERNEL:
            raise ValueError("rng_mode='kernel' requires engine='cuda'")
        return make_rollout(env)
    raise ValueError(f"unknown engine {engine!r}")


class BaseSolver:
    # True for a solver that draws from JAX keys (``key=`` in each call)
    draws_from_keys = False
    # False for a solve that reads the host (eigh), which no CUDA graph holds
    capturable = True

    def __init__(self, env, control_params) -> None:
        self.env = env
        self.init_control_params = control_params

    def _key(self, key):
        """``key`` for a solver that draws from keys, which raises without
        one (nothing falls back to its generators)."""
        if key is None:
            raise ValueError(f"{type(self).__name__}: rng_mode "
                             f"{getattr(self, 'rng_mode', 'parity')!r} draws from "
                             "JAX keys; pass key= (JAX's rng_act)")
        return key

    def seed(self, seed: int) -> None:
        """Seed the solver's generators (none here)."""

    def random_streams(self) -> list:
        """The device generators and seed streams a solve draws from (none
        here)."""
        return []

    def reset(self, env_state=None, env_params=None, control_params=None, key=None):
        """Return fresh solver params (``key``: JAX's ``rng_control``, for a
        solver whose reset draws)."""
        return self.init_control_params

    def __call__(self, obs, state, env_params, control_params, env_info=None):
        raise NotImplementedError


def resolve_engine(env, engine: str, collect_debug: bool = False) -> str:
    """Resolve ``engine="auto"`` (JAX: factory.resolve_engine, with "cuda"
    in the place of "pallas" and "torch" in that of "jnp"): the plain
    PyTorch path under ``collect_debug`` (the kernels compute costs only)
    or for an env on the CPU, else the CUDA kernels."""
    if engine != "auto":
        return engine
    if collect_debug:
        return "torch"
    return "cuda" if torch.device(env.device).type == "cuda" else "torch"


class RandomSolver(BaseSolver):
    """N(0, 0.3^2) actions (JAX: solvers/base.RandomSolver), drawn from the
    solver's own generator on the env's device, or, under a key-drawing
    ``rng_mode`` ("parity", "invariant"), as JAX draws them:
    ``normal(key, (4,)) * 0.3``."""

    def __init__(self, env, control_params=None, seed: int = 0,
                 rng_mode: str = sampling.FAST) -> None:
        super().__init__(env, control_params)
        if rng_mode not in RNG_MODES:
            raise ValueError(f"unknown rng_mode {rng_mode!r}")
        self.rng_mode = rng_mode
        self.draws_from_keys = rng_mode in sampling.KEY_MODES
        self.generator = torch.Generator(device=env.device)
        self.seed(seed)

    def seed(self, seed: int) -> None:
        self.generator.manual_seed(seed)

    def random_streams(self) -> list:
        return [self.generator]

    def __call__(self, obs, state, env_params, control_params, env_info=None,
                 key=None):
        if self.draws_from_keys:
            z = prng.normal(self._key(key), (self.env.action_dim,))
        else:
            z = torch.randn(self.env.action_dim, generator=self.generator,
                            device=self.env.device)
        return z * 0.3, control_params, {}


def solve_info(collect_metrics: bool, costs, weight, poses=None, sigma=None) -> dict:
    """A sampling solve's info (JAX: the solvers' ``_solve_info``): the
    sampled rollouts' mean and std position a step, ``pos_mean`` and
    ``pos_std`` (H, 3), when ``poses`` (H, N, 3) were collected; the solve's
    health (``runtime/metrics.py``; with Sigma's conditioning when ``sigma``
    is given) under ``collect_metrics``."""
    info = {}
    if poses is not None:
        info["pos_mean"] = poses.mean(dim=1)
        info["pos_std"] = poses.std(dim=1, correction=0)
    if collect_metrics:
        info["metrics"] = metrics.solve_metrics(costs, weight)
        if sigma is not None:
            info["metrics"].update(metrics.sigma_metrics(sigma))
    return info
