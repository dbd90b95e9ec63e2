"""Scenario-batched CoVO-online and MPPI solves on one device.

Counterpart of :func:`covo_mpc_tpu.parallel.scenarios.make_batched_covo_solve`
and :func:`~covo_mpc_tpu.parallel.scenarios.make_batched_mppi_solve`: one
call solves B independent scenarios (B domain-randomized plants, each with
its own state, trajectory and parameters), so one launch does B scenarios'
work and the host's launch cost is paid once per batch, not once per
scenario. Every op is batched over the leading scenario axis; nothing loops
over B in Python:

- the Hessian is the plain primal and chain under ``torch.func.vmap``
  (``ops/hessian.make_hessian_batched``; JAX vmaps its scan primal);
- the Newton–Schulz designer runs on the (B, D, D) stack;
- the rollout is K6 (``engine="cuda"``, given actions) or K7 (``rng=
  "kernel"``: per-step draw for MPPI, joint draw for CoVO, one launch over
  a (lane-tiles, B) grid), or the plain batched rollout (``engine="torch"``);
- the weights and the updates reduce over each scenario's samples.

The per-solve Philox seed comes from a CPU generator the solve owns, the
fast sampler's normals and the per-scenario disturbance draws (MPPI's
stochastic ones; under "periodic" / "mixed" CoVO's rollout and Hessian
uniforms too) from a device generator, so a solve never syncs with the
host. ``collect_metrics`` appends each scenario's solve metrics (and, for
CoVO, its Sigma's; ``runtime/metrics.py``) to the outputs, as JAX does. The
multichip steps (``make_multichip_control_step``,
``make_multichip_covo_step``) are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from covo_mpc_tpu_torch.ops import covariance, reductions, sampling
from covo_mpc_tpu_torch.ops.hessian import make_hessian_batched
from covo_mpc_tpu_torch.ops.rollout import make_rollout_batched
from covo_mpc_tpu_torch.ops.rollout_cuda import (
    make_rollout_batched_costs,
    make_rollout_batched_sampling,
)
from covo_mpc_tpu_torch.runtime import metrics
from covo_mpc_tpu_torch.solvers.base import resolve_engine

_RNGS = (sampling.FAST, sampling.KERNEL)


def _shift(x: torch.Tensor) -> torch.Tensor:
    """Receding-horizon shift along the step axis (axis 1), repeating the
    last step."""
    return torch.cat([x[:, 1:], x[:, -1:]], dim=1)


def _check(rng: str, engine: str) -> None:
    if rng not in _RNGS:
        raise ValueError(f"batched solve supports rng='fast'/'kernel', got {rng!r}")
    if engine not in ("torch", "cuda"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "torch" and rng == sampling.KERNEL:
        raise ValueError("rng='kernel' requires engine='cuda'")


class _BatchedSolve:
    """What both batched solves share: the rollout of given actions and the
    generators."""

    def __init__(self, env, N: int, H: int, lam: float, rng: str, engine: str,
                 seed: int, collect_metrics: bool = False):
        self.env = env
        self.collect_metrics = collect_metrics
        self.N, self.H, self.lam = N, H, lam
        self.dA = env.action_dim
        self.rng, self.engine = rng, engine
        self._rollout = (make_rollout_batched_costs(env) if engine == "cuda"
                         else make_rollout_batched(env))
        # CPU generator for the kernels' Philox seeds (no device read per
        # solve), device generator for the fast sampler and the draws
        self.generator = torch.Generator()
        self.device_generator = torch.Generator(device=env.device)
        self.seed(seed)

    def seed(self, seed: int) -> None:
        self.generator.manual_seed(seed)
        self.device_generator.manual_seed(seed)

    def _philox_seed(self) -> int:
        return int(torch.randint(0, 2**63 - 1, (), generator=self.generator))

    def _draw(self, *batch: int, deterministic: bool):
        return self.env.draw_disturb(self.device_generator, *batch,
                                     deterministic=deterministic)


class BatchedCoVOSolve(_BatchedSolve):
    """``solve(x0s (B, 16), t0s (B,), pos_trajs (B, T, 3), vel_trajs,
    a_means (B, H, dA), params_b, gamma_mean=1.0, discount=1.0, z=None,
    draws=None, hess_draws=None) -> (a_means_new (B, H, dA), min_costs
    (B,)[, metrics])``: per scenario, the mean shift, the Hessian, the NS designer, the
    joint sample + deterministic rollout, the weights and the γ-blended mean
    update (CoVO re-designs Σ every solve, so no covariance is carried).
    ``z`` (B, N, D) feeds given standard normals (tests hand in JAX's); K7
    then runs its input-z mode. ``draws`` (B, 3) and ``hess_draws`` (B, H,
    3) are the rollouts' and the Hessians' disturbance uniforms ("periodic"
    / "mixed"; drawn here when not given). Under ``collect_metrics`` a
    third output holds (B,) each of the cost min / mean / max, the ESS and
    Sigma's conditioning and log-determinant (from the factors, as JAX).
    """

    def __init__(self, env, N: int, H: int, lam: float, sample_sigma: float,
                 rng: str, hessian_mode: str, engine: str, seed: int,
                 collect_metrics: bool = False):
        if hessian_mode not in ("adjoint", "gn"):
            raise ValueError(f"batched covo supports 'adjoint'/'gn', got "
                             f"{hessian_mode!r}")
        # TF32 would truncate the designer's fp32 matmuls (see solvers/covo.py)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__(env, N, H, lam, rng, engine, seed, collect_metrics)
        self.sample_sigma = sample_sigma
        self.D = H * self.dA
        self._hessian = make_hessian_batched(
            env, H, second_order=hessian_mode == "adjoint")
        self._sampler = (make_rollout_batched_sampling(env, joint=True)
                         if rng == sampling.KERNEL else None)

    def __call__(self, x0s, t0s, pos_trajs, vel_trajs, a_means, params_b,
                 gamma_mean=1.0, discount=1.0,
                 z: Optional[torch.Tensor] = None,
                 draws: Optional[torch.Tensor] = None,
                 hess_draws: Optional[torch.Tensor] = None):
        B, N, D = a_means.shape[0], self.N, self.D
        a_means = _shift(a_means)
        if hess_draws is None:
            hess_draws = self._draw(B, self.H, deterministic=True)
        if draws is None:
            draws = self._draw(B, deterministic=True)
        R = self._hessian(a_means.reshape(B, D), x0s, t0s, pos_trajs,
                          vel_trajs, params_b, hess_draws)
        _, factors = covariance.optimize_sigma_ns(R, self.sample_sigma, D)
        if self._sampler is not None:
            costs, a_t = self._sampler(
                x0s, t0s, pos_trajs, vel_trajs, a_means, factors, params_b,
                self._philox_seed(), N, deterministic=True, discount=discount,
                draws=draws,
                z=None if z is None else z.transpose(1, 2).contiguous(),
            )
        else:
            a_t = torch.clamp(
                sampling.sample_joint_t(self.device_generator,
                                        a_means.reshape(B, D), factors, N, z=z),
                -1.0, 1.0,
            )
            costs = self._rollout(x0s, t0s, pos_trajs, vel_trajs, a_t, params_b,
                                  draws, deterministic=True, discount=discount,
                                  layout="hdn")
        weights = reductions.mppi_weights(costs, self.lam)
        a_means_new = reductions.mean_update_t(
            weights, a_t.reshape(B, self.H, self.dA, N), a_means, gamma_mean)
        if self.collect_metrics:
            return a_means_new, torch.amin(costs, dim=-1), {
                **metrics.solve_metrics_sharded(costs, weights, None, N),
                **metrics.sigma_metrics(factors @ factors.transpose(-1, -2)),
            }
        return a_means_new, torch.amin(costs, dim=-1)


class BatchedMPPISolve(_BatchedSolve):
    """``solve(x0s, t0s, pos_trajs, vel_trajs, a_means (B, H, dA), a_covs
    (B, H, dA, dA), params_b, gamma_mean=1.0, gamma_sigma=0.0, discount=1.0,
    z=None, draws=None) -> (a_means_new, a_covs_new, min_costs (B,)[,
    metrics])``: per
    scenario, the shift of mean AND covariance, the per-step sample (factors
    by ``cholesky_ex`` of the shifted covariances, as JAX factors them every
    solve) + stochastic rollout under one shared disturbance draw, the
    weights, and the γ-blended mean and covariance updates (the covariance
    untouched at γ_σ = 0). ``z`` (B, N, H, dA) and ``draws`` (B, 3) feed
    given standard normals to the sampler and to each scenario's shared
    disturbance; by default they come from the solve's generators. Under
    ``collect_metrics`` a fourth output holds (B,) each of the cost min /
    mean / max and the ESS.
    """

    def __init__(self, env, N: int, H: int, lam: float, rng: str,
                 engine: str, seed: int, collect_metrics: bool = False):
        super().__init__(env, N, H, lam, rng, engine, seed, collect_metrics)
        self._sampler = (make_rollout_batched_sampling(env, joint=False)
                         if rng == sampling.KERNEL else None)

    def __call__(self, x0s, t0s, pos_trajs, vel_trajs, a_means, a_covs,
                 params_b, gamma_mean=1.0, gamma_sigma=0.0, discount=1.0,
                 z: Optional[torch.Tensor] = None,
                 draws: Optional[torch.Tensor] = None):
        B, N, H, dA = a_means.shape[0], self.N, self.H, self.dA
        a_means, a_covs = _shift(a_means), _shift(a_covs)
        chols = torch.linalg.cholesky_ex(a_covs).L.contiguous()
        if draws is None:
            draws = self._draw(B, deterministic=False)
        if self._sampler is not None:
            costs, a_flat = self._sampler(
                x0s, t0s, pos_trajs, vel_trajs, a_means, chols, params_b,
                self._philox_seed(), N, deterministic=False, discount=discount,
                draws=draws,
                z=None if z is None else z.permute(0, 2, 3, 1).contiguous(),
            )
            a_t = a_flat.reshape(B, H, dA, N)
        else:
            a_t = torch.clamp(
                sampling.sample_per_step_t(self.device_generator, a_means, chols,
                                           N, z=z),
                -1.0, 1.0,
            )
            costs = self._rollout(x0s, t0s, pos_trajs, vel_trajs, a_t, params_b,
                                  draws, deterministic=False, discount=discount,
                                  layout="hdn")
        weights = reductions.mppi_weights(costs, self.lam)
        a_means_new = reductions.mean_update_t(weights, a_t, a_means, gamma_mean)
        a_covs_new = reductions.cov_update_t(weights, a_t, a_means_new, a_covs,
                                             gamma_sigma)
        if self.collect_metrics:
            return (a_means_new, a_covs_new, torch.amin(costs, dim=-1),
                    metrics.solve_metrics_sharded(costs, weights, None, N))
        return a_means_new, a_covs_new, torch.amin(costs, dim=-1)


def make_batched_covo_solve(env, N: int, H: int, lam: float,
                            sample_sigma: float = 0.5, rng: str = "fast",
                            collect_metrics: bool = False,
                            hessian_mode: str = "adjoint",
                            engine: str = "auto",
                            seed: int = 0) -> BatchedCoVOSolve:
    """Scenario-batched CoVO-online solve on one device (JAX:
    make_batched_covo_solve; ``interpret`` has no counterpart, ``engine``
    picks the CUDA kernels or the plain path, "auto" by the env's device).
    ``rng="kernel"`` runs K7 (joint), ``"fast"`` draws with torch and runs
    K6 (``engine="cuda"``) or the plain rollout (``engine="torch"``, which
    takes ``rng="fast"`` only)."""
    engine = resolve_engine(env, engine)
    _check(rng, engine)
    return BatchedCoVOSolve(env, N, H, lam, sample_sigma, rng, hessian_mode,
                            engine, seed, collect_metrics)


def make_batched_mppi_solve(env, N: int, H: int, lam: float,
                            rng: str = "fast", collect_metrics: bool = False,
                            engine: str = "auto",
                            seed: int = 0) -> BatchedMPPISolve:
    """Scenario-batched MPPI solve on one device (JAX:
    make_batched_mppi_solve). ``rng="kernel"`` runs K7 (per-step), ``"fast"``
    draws with torch and runs K6 or the plain rollout, as for CoVO."""
    engine = resolve_engine(env, engine)
    _check(rng, engine)
    return BatchedMPPISolve(env, N, H, lam, rng, engine, seed, collect_metrics)
