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

K7's per-solve Philox key is a device word of the solve's seed stream
(:class:`~covo_mpc_tpu_torch.ops.sampling.SeedStream`, advanced on the
device each solve), and the fast sampler's normals and the per-scenario
disturbance draws (MPPI's stochastic ones; under "periodic" / "mixed"
CoVO's rollout and Hessian uniforms too) come from the solve's device
generator, unless the caller hands them in (``z``, ``draws``,
``hess_draws``). So a solve reads no value on the host and can be captured
as a CUDA graph (``runtime/graphs.capture_solver``), as JAX jits it; its
``random_streams()`` are registered with the graph. ``offset`` (an int or a
0-d int32 device word) shifts K7's scenario slots: scenario b then draws as
episode ``offset + b`` of the batched protocol. ``collect_metrics`` appends
each scenario's solve metrics (and, for CoVO, its Sigma's;
``runtime/metrics.py``) to the outputs, as JAX does.

:func:`batched_controller` maps a controller to its batched twin, the form
``runtime/eval.evaluate_batched`` steps B episodes with (JAX vmaps the
controller itself). The multichip steps (``make_multichip_control_step``,
``make_multichip_covo_step``) are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from covo_mpc_tpu_torch.models.structs import (
    EnvParams3D,
    float_leaves,
    pack_state,
    stack,
    vmap_trees,
)
from covo_mpc_tpu_torch.ops import covariance, reductions, sampling
from covo_mpc_tpu_torch.ops.hessian import make_hessian_batched
from covo_mpc_tpu_torch.ops.rollout import make_rollout_batched
from covo_mpc_tpu_torch.ops.rollout_cuda import (
    Offset,
    make_rollout_batched_costs,
    make_rollout_batched_sampling,
)
from covo_mpc_tpu_torch.runtime import metrics
from covo_mpc_tpu_torch.solvers.base import RandomSolver, resolve_engine
from covo_mpc_tpu_torch.solvers.covo import CoVOSolver
from covo_mpc_tpu_torch.solvers.mppi import MPPISolver
from covo_mpc_tpu_torch.solvers.pid import PIDSolver

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
        # K7's Philox keys, device words; the device generator for the fast
        # sampler's normals and the draws
        self.seeds = sampling.SeedStream(env.device)
        self.device_generator = torch.Generator(device=env.device)
        self.seed(seed)

    def seed(self, seed: int) -> None:
        self.seeds.seed(seed)
        self.device_generator.manual_seed(seed)

    def random_streams(self) -> list:
        """The seed stream and the device generator a solve draws from."""
        return [self.seeds, self.device_generator]

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
    / "mixed"; drawn here when not given). ``offset`` is K7's episode
    offset (the module docstring). Under ``collect_metrics`` a
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
                 hess_draws: Optional[torch.Tensor] = None,
                 offset: Offset = None):
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
                self.seeds.next()[0], N, deterministic=True, discount=discount,
                draws=draws,
                z=None if z is None else z.transpose(1, 2).contiguous(),
                offset=offset,
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
    disturbance; by default they come from the solve's generators.
    ``offset`` is K7's episode offset (the module docstring). Under
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
                 draws: Optional[torch.Tensor] = None,
                 offset: Offset = None):
        B, N, H, dA = a_means.shape[0], self.N, self.H, self.dA
        a_means, a_covs = _shift(a_means), _shift(a_covs)
        chols = torch.linalg.cholesky_ex(a_covs).L.contiguous()
        if draws is None:
            draws = self._draw(B, deterministic=False)
        if self._sampler is not None:
            costs, a_flat = self._sampler(
                x0s, t0s, pos_trajs, vel_trajs, a_means, chols, params_b,
                self.seeds.next()[0], N, deterministic=False, discount=discount,
                draws=draws,
                z=None if z is None else z.permute(0, 2, 3, 1).contiguous(),
                offset=offset,
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


# --- the batched twins of the controllers ------------------------------------


def _per_episode(gens, draw) -> Optional[torch.Tensor]:
    """``draw(g)`` from each episode's generator, stacked on a leading axis
    (None where the draw is None: a model that draws nothing)."""
    out = [draw(g) for g in gens]
    return None if out[0] is None else torch.stack(out)


def _solve_inputs(state, info):
    """(x0s, t0s, pos_trajs, vel_trajs) of the batched states the sampling
    solvers act on: ``info["noisy_state"]`` where the env generates one."""
    if info is not None and info.get("noisy_state") is not None:
        state = info["noisy_state"]
    return pack_state(state), state.time, state.pos_traj, state.vel_traj


def _expand_params(params: EnvParams3D, B: int) -> EnvParams3D:
    """One ``env_params`` for B episodes, as the batched solves take them:
    each tensor leaf expanded (a view, no copy) to a leading B axis."""
    return params.replace(**{k: v.expand(B, *v.shape)
                             for k, v in float_leaves(params).items()})


class BatchedTwin:
    """A controller's batched form (:func:`batched_controller`): ``reset(B)``
    gives the carry of B fresh episodes, and ``twin(state, info, env_params,
    carry, gens, offset) -> (actions (B, dA), carry)`` acts on B batched
    states (``models/batched.py``) under one shared ``env_params``. ``gens``
    are the episodes' own generators, one each, for the draws a solve takes
    per episode (the fast sampler's normals, the disturbance draws), so an
    episode's draws do not depend on its batch; ``offset`` is the first
    episode's index, K7's episode offset. ``seed`` and ``random_streams``
    are the solve's (a capture registers them)."""

    def __init__(self, controller):
        self.controller = controller
        self.env = controller.env
        self.params = controller.init_control_params

    def seed(self, seed: int) -> None:
        """Seed the solve's own streams (none here)."""

    def random_streams(self) -> list:
        return []


class _SolveTwin(BatchedTwin):
    def __init__(self, controller, solve):
        super().__init__(controller)
        self.solve = solve

    def seed(self, seed: int) -> None:
        self.solve.seed(seed)

    def random_streams(self) -> list:
        return self.solve.random_streams()


class BatchedCoVOTwin(_SolveTwin):
    """CoVO online: :class:`BatchedCoVOSolve`; the carry is the means (B, H,
    dA). Per episode, its generator draws the fast sampler's normals (N, D)
    and, under "periodic" / "mixed", the rollout's draw and the Hessian's."""

    def reset(self, B: int):
        return self.params.a_mean.expand(B, *self.params.a_mean.shape).clone()

    def __call__(self, state, info, env_params, a_means, gens, offset=None):
        env, solve, dev = self.env, self.solve, self.env.device
        z = (_per_episode(gens, lambda g: torch.randn(solve.N, solve.D, generator=g,
                                                      device=dev))
             if solve.rng == sampling.FAST else None)
        draws = _per_episode(gens, lambda g: env.draw_disturb(g, deterministic=True))
        hess_draws = _per_episode(
            gens, lambda g: env.draw_disturb(g, solve.H, deterministic=True))
        a_means, _ = solve(*_solve_inputs(state, info), a_means,
                           _expand_params(env_params, len(gens)),
                           self.params.gamma_mean, self.params.discount, z=z,
                           draws=draws, hess_draws=hess_draws, offset=offset)
        return a_means[:, 0], a_means


class BatchedMPPITwin(_SolveTwin):
    """MPPI: :class:`BatchedMPPISolve`; the carry is (means (B, H, dA),
    covariances (B, H, dA, dA)). Per episode, its generator draws the fast
    sampler's normals (N, H, dA) and the rollout's shared disturbance."""

    def reset(self, B: int):
        return (self.params.a_mean.expand(B, *self.params.a_mean.shape).clone(),
                self.params.a_cov.expand(B, *self.params.a_cov.shape).clone())

    def __call__(self, state, info, env_params, carry, gens, offset=None):
        env, solve, dev = self.env, self.solve, self.env.device
        z = (_per_episode(gens, lambda g: torch.randn(solve.N, solve.H, solve.dA,
                                                      generator=g, device=dev))
             if solve.rng == sampling.FAST else None)
        draws = _per_episode(gens, env.draw_disturb)
        p = self.params
        a_means, a_covs, _ = solve(*_solve_inputs(state, info), *carry,
                                   _expand_params(env_params, len(gens)),
                                   p.gamma_mean, p.gamma_sigma, p.discount, z=z,
                                   draws=draws, offset=offset)
        return a_means[:, 0], (a_means, a_covs)


class BatchedPIDTwin(BatchedTwin):
    """PID: its solve under ``torch.func.vmap`` over the episodes (no
    kernel, as in JAX); the carry is the stacked :class:`PIDParams`."""

    def reset(self, B: int):
        return stack([self.params] * B)

    def __call__(self, state, info, env_params, carry, gens, offset=None):
        pid = self.controller
        action, carry, _ = vmap_trees(lambda s, c, p: pid(None, s, p, c),
                                      (state, carry), (env_params,))
        return action, carry


class BatchedRandomTwin(BatchedTwin):
    """Random: N(0, 0.3^2) actions, each episode's from its generator."""

    def reset(self, B: int):
        return None

    def __call__(self, state, info, env_params, carry, gens, offset=None):
        dA, dev = self.env.action_dim, self.env.device
        return _per_episode(gens, lambda g: torch.randn(dA, generator=g, device=dev)
                            * 0.3), carry


def batched_controller(controller) -> BatchedTwin:
    """The batched twin of ``controller`` (JAX vmaps the controller; the
    port maps each of its controllers to a batched form): CoVO online ->
    :class:`BatchedCoVOSolve` (its N, H, λ, σ, rng mode, Hessian mode and
    engine), MPPI -> :class:`BatchedMPPISolve`, PID -> a vmap of its solve,
    Random -> per-episode draws. Anything else raises: CoVO speculative and
    offline (their K2 / K3 / K8 have no batched kernel) and the
    ``ns_pallas`` / ``eigh`` designers wait for a later slice (ROADMAP.md
    queue 1); nothing falls back to a loop over episodes."""
    env = controller.env
    if getattr(controller, "draws_from_keys", False):
        raise NotImplementedError(
            f"no batched twin of a controller that draws from JAX keys (rng_mode "
            f"{controller.rng_mode!r}): {sampling.KEY_ITEM}")
    if isinstance(controller, CoVOSolver):
        if controller.mode != "online":
            raise NotImplementedError(
                f"no batched CoVO {controller.mode} solve yet: its K2 / K3 / K8 have "
                "no batched kernel (a later slice, ROADMAP.md queue 1)")
        if controller.sigma_mode != "ns":
            raise NotImplementedError(
                f"the batched CoVO solve runs sigma_mode='ns', not "
                f"{controller.sigma_mode!r} (a later slice, ROADMAP.md queue 1)")
        p = controller.init_control_params
        return BatchedCoVOTwin(controller, make_batched_covo_solve(
            env, controller.N, controller.H, controller.lam, p.sample_sigma,
            rng=controller.rng_mode, hessian_mode=controller.hessian_mode,
            engine=controller.engine))
    if isinstance(controller, MPPISolver):
        return BatchedMPPITwin(controller, make_batched_mppi_solve(
            env, controller.N, controller.H, controller.lam,
            rng=controller.rng_mode, engine=controller.engine))
    if isinstance(controller, PIDSolver):
        return BatchedPIDTwin(controller)
    if isinstance(controller, RandomSolver):
        return BatchedRandomTwin(controller)
    raise NotImplementedError(f"no batched form of {type(controller).__name__}")
