"""MPPI: Model Predictive Path Integral control.

Counterpart of :class:`covo_mpc_tpu.solvers.mppi.MPPISolver` (its
sample-last fast path). One solve, in order:

1. act on ``info["noisy_state"]``;
2. shift the mean AND the covariance, and the carried Cholesky factor
   (CoVO shifts the mean only);
3. sample and roll out, stochastically (the one shared disturbance draw:
   gaussian normals, or the uniforms of "periodic" / "mixed"): K5
   (``rng_mode="kernel"``: per-step draw, rollout and costs in one launch;
   the gaussian draw in-kernel too, the uniforms from the device
   generator), or z and the draw from the solver's device generator
   (``"fast"``) or from JAX's key (``"parity"``: a key a sample and a step,
   sample-first, the draw through the reference's key chain;
   ``"invariant"``: a ``fold_in`` a sample, sample-last, the draw from the
   step key itself), then K4 (``engine="cuda"``) or the plain rollout
   (``engine="torch"``); ``engine="auto"`` picks by the env's device, and
   the plain path under ``collect_debug``, which also returns the sampled
   rollouts' ``pos_mean`` and ``pos_std`` (H, 3);
4. softmax weights, the mean update, and the covariance update (which
   leaves covariance and factor untouched at ``gamma_sigma == 0``);
   ``collect_metrics`` puts the cost statistics and the ESS in
   ``info["metrics"]`` (``runtime/metrics.py``).

A solve reads no value on the host and only device tensors, so it can be
captured as a CUDA graph and replayed (``runtime/graphs.py``), as JAX jits
it: K5's two Philox keys (the actions', the krng draw's) are device words
of the solver's seed stream (:class:`~covo_mpc_tpu_torch.ops.sampling.
SeedStream`), advanced on the device each solve, and the fast sampler's
normals and the draws come from the solver's device generator, which a
graph advances at each replay.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch

from covo_mpc_tpu_torch.models.structs import pack_state
from covo_mpc_tpu_torch.ops import reductions, sampling
from covo_mpc_tpu_torch.ops.rollout_cuda import make_rollout_sampling
from covo_mpc_tpu_torch.solvers.base import (
    BaseSolver,
    make_cost_rollout,
    resolve_engine,
    solve_info,
)
from covo_mpc_tpu_torch.utils import prng


@dataclasses.dataclass
class MPPIParams:
    gamma_mean: float
    gamma_sigma: float
    discount: float
    sample_sigma: float
    a_mean: torch.Tensor  # (H, dA)
    a_cov: torch.Tensor  # (H, dA, dA) per-step covariance
    a_cov_chol: torch.Tensor  # (H, dA, dA) its carried Cholesky factor

    def replace(self, **changes) -> "MPPIParams":
        return dataclasses.replace(self, **changes)


def mppi_params_from_numpy(leaves: Mapping[str, Any], device="cuda") -> MPPIParams:
    """Build :class:`MPPIParams` from the JAX struct's leaves as numpy
    arrays: scalars as Python floats, arrays as float32 tensors on
    ``device`` (the factor made row-major)."""
    kw = {}
    for f in dataclasses.fields(MPPIParams):
        v = np.asarray(leaves[f.name])
        kw[f.name] = (float(v) if v.ndim == 0 else
                      torch.from_numpy(np.array(v, np.float32, order="C")).to(device))
    return MPPIParams(**kw)


def _shift(x: torch.Tensor) -> torch.Tensor:
    """Receding-horizon shift along the step axis, repeating the last."""
    return torch.cat([x[1:], x[-1:]])


class MPPISolver(BaseSolver):
    def __init__(
        self,
        env,
        control_params: MPPIParams,
        N: int,
        H: int,
        lam: float,
        rng_mode: str = sampling.FAST,
        collect_debug: bool = False,
        engine: str = "auto",
        seed: int = 0,
        collect_metrics: bool = False,
    ) -> None:
        super().__init__(env, control_params)
        self.engine = resolve_engine(env, engine, collect_debug)
        if collect_debug and self.engine == "cuda":
            # the kernels compute costs only (JAX: the pallas engine refuses it)
            raise ValueError("engine='cuda' requires collect_debug=False")
        self.rollout = make_cost_rollout(env, self.engine, rng_mode)
        self.N, self.H, self.lam = N, H, lam
        self.collect_metrics = collect_metrics
        self.collect_debug = collect_debug
        self.rng_mode = rng_mode
        self.draws_from_keys = rng_mode in sampling.KEY_MODES
        self.action_dim = env.action_dim
        self.rollout_sampling = (make_rollout_sampling(env)
                                 if rng_mode == sampling.KERNEL else None)
        # K5's Philox keys, device words; the device generator for the fast
        # sampler's normals and the draw
        self.seeds = sampling.SeedStream(env.device)
        self.device_generator = torch.Generator(device=env.device)
        self.seed(seed)

    def seed(self, seed: int) -> None:
        self.seeds.seed(seed)
        self.device_generator.manual_seed(seed)

    def random_streams(self) -> list:
        return [self.seeds, self.device_generator]

    def __call__(self, obs, env_state, env_params, control_params: MPPIParams,
                 info: Optional[dict] = None, z: Optional[torch.Tensor] = None,
                 draw: Optional[torch.Tensor] = None, key=None):
        """One solve. ``key`` is JAX's ``rng_act`` (key-drawing rng modes;
        JAX's chain: ``key, act_key = split(key)``, ``key, step_key =
        split(key)``). ``z`` (N, H, dA) feeds given standard normals to the
        generator modes' sampler and ``draw`` (3,) the shared disturbance
        draw (tests hand in the ones JAX drew; K5 then runs its input-z
        mode); by default they come from the solver's generators or key."""
        if info is not None and info.get("noisy_state") is not None:
            env_state = info["noisy_state"]

        a_mean = _shift(control_params.a_mean)
        a_cov = _shift(control_params.a_cov)
        a_chol = _shift(control_params.a_cov_chol)

        x0 = pack_state(env_state)
        args = (x0, env_state.time, env_state.pos_traj, env_state.vel_traj)
        kw = dict(deterministic=False, discount=control_params.discount)
        if self.collect_debug:
            kw["collect_poses"] = True
        if self.draws_from_keys:
            rest, act_key = prng.split(self._key(key))
            step_key = prng.split(rest)[1]
            if draw is None:
                draw = self.env.disturb_from_key(
                    step_key, fast=self.rng_mode != sampling.PARITY)
        if self.rng_mode == sampling.PARITY:
            a = torch.clamp(sampling.sample_per_step(act_key, a_mean, a_chol, self.N),
                            -1.0, 1.0)
            out = self.rollout(*args, a, env_params, draw, layout="nhd", **kw)
            a_t = a.permute(1, 2, 0)
        elif self.rollout_sampling is not None:
            seed, disturb_seed = self.seeds.next(2)
            if draw is None and self.env.config.disturb_type != "gaussian":
                # K5 draws the gaussian force itself, no other model's
                draw = self.env.draw_disturb(self.device_generator)
            out, a_flat = self.rollout_sampling(
                *args, a_mean, a_chol, env_params, seed, self.N,
                draw=draw, z=None if z is None else z.permute(1, 2, 0).contiguous(),
                disturb_seed=disturb_seed, **kw,
            )
            a_t = a_flat.reshape(self.H, self.action_dim, self.N)
        else:
            src = act_key if self.draws_from_keys else self.device_generator
            a_t = torch.clamp(sampling.sample_per_step_t(src, a_mean, a_chol, self.N, z=z,
                                                         mode=self.rng_mode), -1.0, 1.0)
            if draw is None and not self.draws_from_keys:
                draw = self.env.draw_disturb(self.device_generator)
            out = self.rollout(*args, a_t, env_params, draw, layout="hdn", **kw)
        costs, poses = out if self.collect_debug else (out, None)

        weight = reductions.mppi_weights(costs, self.lam)
        new_mean = reductions.mean_update_t(weight, a_t, a_mean,
                                            control_params.gamma_mean)
        a_cov, a_chol = reductions.cov_factor_update_t(
            weight, a_t, new_mean, a_cov, a_chol, control_params.gamma_sigma,
        )
        control_params = control_params.replace(a_mean=new_mean, a_cov=a_cov,
                                                a_cov_chol=a_chol)
        return (new_mean[0], control_params,
                solve_info(self.collect_metrics, costs, weight, poses))
