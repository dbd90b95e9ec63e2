"""Scenario-batched CoVO and MPPI solves on one device, and each controller's
batched twin.

Counterpart of :func:`covo_mpc_tpu.parallel.scenarios.make_batched_covo_solve`
and :func:`~covo_mpc_tpu.parallel.scenarios.make_batched_mppi_solve`: one
call solves B independent scenarios (B domain-randomized plants, each with
its own state, trajectory and parameters), so one launch does B scenarios'
work and the host's launch cost is paid once per batch, not once per
scenario. Every op is batched over the leading scenario axis; nothing loops
over B in Python:

- the Hessian is the plain primal and chain under ``torch.func.vmap``
  (``ops/hessian.make_hessian_batched``; JAX vmaps its scan primal), or a
  reference estimator (``fwd_fwd``, ``fwd_rev``, ``sensitivity``) under
  vmap (``ops/hessian.vmap_hessian``), as JAX vmaps them;
- the Newton–Schulz designer, or ``eigh``, runs on the (B, D, D) stack;
- the rollout is K6 (``engine="cuda"``, given actions: the fast and the
  key-drawn samples, laid out ``nhd`` under parity as the single solver
  lays them out) or K7 (``rng="kernel"``: per-step draw for MPPI, joint
  draw for CoVO, one launch over a (lane-tiles, B) grid), or the plain
  batched rollout (``engine="torch"``);
- the weights and the updates reduce over each scenario's samples.

K7's per-solve Philox key is a device word of the solve's seed stream
(:class:`~covo_mpc_tpu_torch.ops.sampling.SeedStream`, advanced on the
device each solve), and the fast sampler's normals and the per-scenario
disturbance draws (MPPI's stochastic ones; under "periodic" / "mixed"
CoVO's rollout and Hessian uniforms too) come from the solve's device
generator, unless the caller hands them in (``z``, ``draws``,
``hess_draws``). Under ``rng="parity"`` / ``"invariant"`` each scenario
draws from its own JAX key (``key`` (B, 2), JAX's ``rng_act``) what the
single solver draws from its key: the Hessian's draws from the key, the
samples from ``split(key)[1]``, the rollout's draw from the chain after it
(``utils/prng.py`` maps over the leading axis). Under fast / kernel rng a
``key`` given keys the disturbance draws alone. So a solve reads no value
on the host and can be captured as a CUDA graph
(``runtime/graphs.capture_solver``), as JAX jits it; its
``random_streams()`` are registered with the graph. The exception is
``sigma_mode="eigh"``, which reads its status on the host: such a solve is
not ``capturable`` and runs eagerly, its batched Hessian one replayed
graph per B (``runtime/graphs.Graphed``), as the single eigh solve runs
(a failed capture of eigh leaves cuSOLVER unusable, PERF.md §6); a
reference estimator's batched Hessian is such a graph in every solve, as
the single solver's.
``offset`` (an int or a 0-d int32 device word) shifts K7's scenario slots:
scenario b then draws as episode ``offset + b`` of the batched protocol.
``collect_metrics`` appends each scenario's solve metrics (and, for CoVO,
its Sigma's; ``runtime/metrics.py``) to the outputs, as JAX does.
``axis`` (a bound mesh axis; None by default) splits each scenario's N
samples over the axis's ranks: each rank draws ``n = N / k`` of them (the
invariant sampler at their global ids, K7 on word s of the solve's k
seed-stream words at rank s) and the weights and updates are all-reduced
over the axis (``ops/reductions.py``), as ``parallel/sharded.py`` splits a
single solve's. None is the identity: every sample on this device.

:func:`batched_controller` maps a controller to its batched twin, the form
``runtime/eval.evaluate_batched`` steps B episodes with (JAX vmaps the
controller itself): CoVO online, speculative (``act`` then ``prepare``
over B) and offline (the B episodes' Sigma schedules at reset), MPPI, PID
and Random, in every rng mode.

The multichip steps (:func:`make_multichip_control_step`,
:func:`make_multichip_covo_step`, JAX's config #5) run one full control
step of B scenarios over a (scenarios, samples) rank mesh
(``parallel/mesh.py``): the scenario axis is data parallel, each rank
stepping its block of B with no per-solve communication, and each
scenario's samples are sharded over the sample axis by the batched solve
with that ``axis`` (three collectives a step, each of B values). A step
is JAX's key split (4 a scenario for MPPI, 5 for CoVO), the batched solve
on the split keys' draws (the plain Hessian under vmap, JAX's scan
primal; the plain Newton–Schulz designer), then the env step.
"""

from __future__ import annotations

from typing import Optional

import torch

from covo_mpc_tpu_torch.models.batched import BatchedEnv
from covo_mpc_tpu_torch.models.structs import (
    expand_params,
    pack_state,
    stack,
    tree_flatten,
    tree_select,
    tree_unflatten,
    vmap_trees,
)
from covo_mpc_tpu_torch.ops import covariance, reductions, sampling
from covo_mpc_tpu_torch.ops.hessian import (
    make_hessian_batched,
    make_hessian_sensitivity,
    vmap_hessian,
)
from covo_mpc_tpu_torch.ops.rollout import (
    hessian_draws_from_key,
    make_hessian_cost,
    make_rollout_batched,
)
from covo_mpc_tpu_torch.ops.rollout_cuda import (
    Offset,
    make_rollout_batched_costs,
    make_rollout_batched_sampling,
)
from covo_mpc_tpu_torch.parallel.mesh import SAMPLE_AXIS, SCENARIO_AXIS
from covo_mpc_tpu_torch.parallel.sharded import (
    MeshSolve,
    act_step_keys as _act_keys,
    check_divisible,
    check_engine,
    check_rng,
    local_ids,
)
from covo_mpc_tpu_torch.runtime import graphs, metrics
from covo_mpc_tpu_torch.solvers.base import RandomSolver, resolve_engine
from covo_mpc_tpu_torch.solvers.covo import SPECULATIVE_FOLD, CoVOSolver
from covo_mpc_tpu_torch.solvers.mppi import MPPISolver
from covo_mpc_tpu_torch.solvers.pid import PIDSolver
from covo_mpc_tpu_torch.utils import prng

_RNGS = (sampling.FAST, sampling.KERNEL, sampling.PARITY, sampling.INVARIANT)
# the offline twin designs its B episodes' schedules (B x max_steps states)
# in slices of this many states, which bounds the Hessians' intermediates
# (a reference estimator holds (states, D, D, 16) tangents)
OFFLINE_SLICE = 1200
NS_PALLAS_ITEM = ("a batched K8 (one cluster a scenario) is ROADMAP.md queue 2 part B, "
                  "taken only with a measured case")


def _shift(x: torch.Tensor) -> torch.Tensor:
    """Receding-horizon shift along the step axis (axis 1), repeating the
    last step."""
    return torch.cat([x[:, 1:], x[:, -1:]], dim=1)


def _check(rng: str, engine: str) -> None:
    if rng not in _RNGS:
        raise ValueError(f"batched solve supports rng in {_RNGS}, got {rng!r}")
    if engine not in ("torch", "cuda"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "torch" and rng == sampling.KERNEL:
        raise ValueError("rng='kernel' requires engine='cuda'")


class _BatchedSolve:
    """What both batched solves share: the rollout of given actions, the
    generators, the key check and the sample axis."""

    def __init__(self, env, N: int, H: int, lam: float, rng: str, engine: str,
                 seed: int, collect_metrics: bool = False, axis=None):
        self.env = env
        self.collect_metrics = collect_metrics
        self.N, self.H, self.lam = N, H, lam
        self.axis = axis
        # this rank's samples of each scenario
        self.n = N if axis is None else check_divisible(N, axis.size)
        self.dA = env.action_dim
        self.rng, self.engine = rng, engine
        self.draws_from_keys = rng in sampling.KEY_MODES
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

    def _keys(self, key):
        if key is None:
            raise ValueError(f"batched solve: rng={self.rng!r} draws from JAX keys; "
                             "pass key= (B, 2), each scenario's rng_act")
        return key

    def _keyed(self, key) -> bool:
        """Whether a solve's draws come from ``key``: always under parity /
        invariant (a key required); under fast / kernel rng when one is
        given (its disturbance draws only)."""
        return self.draws_from_keys or key is not None

    def _act_keys(self, key):
        """(act_key, step_key) (B, 2) each: JAX's solve chain from ``key``,
        or the pair as given (the multichip steps split their own keys)."""
        key = self._keys(key)
        return key if isinstance(key, tuple) else _act_keys(key)

    def _word(self) -> torch.Tensor:
        """K7's Philox key: word s of the solve's k seed-stream words at
        rank s of the sample axis (one word without an axis)."""
        if self.axis is None:
            return self.seeds.next()[0]
        return self.seeds.next(self.axis.size)[self.axis.index]

    def _normals(self, act_key, shape: tuple) -> torch.Tensor:
        """This rank's invariant normals: its samples' global ids."""
        ids = (None if self.axis is None
               else local_ids(self.axis, self.n, act_key.device))
        return sampling.std_normal_invariant(act_key, self.n, shape, ids)


class BatchedCoVOSolve(_BatchedSolve):
    """``solve(x0s (B, 16), t0s (B,), pos_trajs (B, T, 3), vel_trajs,
    a_means (B, H, dA), params_b, gamma_mean=1.0, discount=1.0, z=None,
    draws=None, hess_draws=None, offset=None, key=None) -> (a_means_new (B,
    H, dA), min_costs (B,)[, metrics])``: per scenario, the mean shift, then
    :meth:`design` (the Hessian, the designer) and :meth:`sample_update`
    (the joint sample + deterministic rollout, the weights and the
    γ-blended mean update). CoVO re-designs Sigma every solve, so no
    covariance is carried. The speculative and offline twins call the two
    halves apart. ``z`` (B, N, D) feeds given standard normals (tests hand
    in JAX's; K7 then runs its input-z mode). ``draws`` (B, 3) and
    ``hess_draws`` (B, H, 3) are the rollouts' and the Hessians' disturbance
    uniforms ("periodic" / "mixed"; drawn here when not given). ``offset``
    is K7's episode offset, ``key`` the scenarios' JAX keys under parity /
    invariant (the module docstring; ``sample_update`` also takes the
    (act_key, step_key) pair already split). Under ``collect_metrics`` a third
    output holds (B,) each of the cost min / mean / max, the ESS and
    Sigma's conditioning and log-determinant (from the factors, as JAX).
    """

    def __init__(self, env, N: int, H: int, lam: float, sample_sigma: float,
                 rng: str, hessian_mode: str, engine: str, seed: int,
                 collect_metrics: bool = False, sigma_mode: str = "ns", axis=None):
        # TF32 would truncate the designer's fp32 matmuls (see solvers/covo.py)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__(env, N, H, lam, rng, engine, seed, collect_metrics, axis)
        self.sample_sigma = sample_sigma
        self.D = H * self.dA
        self.hessian_mode, self.sigma_mode = hessian_mode, sigma_mode
        if sigma_mode == "ns":
            self._optimize_sigma = covariance.optimize_sigma_ns
        elif sigma_mode == "eigh":
            self._optimize_sigma = covariance.optimize_sigma
        elif sigma_mode == "ns_pallas":
            raise NotImplementedError(
                "no batched sigma_mode='ns_pallas': JAX cannot vmap K8's pallas_call on "
                f"hardware either (covo_mpc_tpu/solvers/covo.py:83-90); {NS_PALLAS_ITEM}")
        else:
            raise ValueError(f"unknown sigma_mode {sigma_mode!r}")
        # eigh reads its status on the host: the solve runs eagerly, its
        # Hessian (a pure function of its inputs) one graph per B on the card;
        # so do the reference estimators always, as the single solver's
        # (torch.func's transforms cost the host seconds a call eagerly)
        self.capturable = sigma_mode != "eigh"
        hessian = _batched_hessian(env, H, hessian_mode)
        self._hessian = (hessian if self.capturable and hessian_mode in ("gn", "adjoint")
                         else graphs.Graphed(hessian))
        self._sampler = (make_rollout_batched_sampling(env, joint=True)
                         if rng == sampling.KERNEL else None)

    def design(self, x0s, t0s, pos_trajs, vel_trajs, nominals, params_b,
               hess_draws: Optional[torch.Tensor] = None, key=None):
        """(a_covs, factors) (B, D, D) each around the nominals (B, H, dA) at
        the states: the batched Hessian, then the designer on the stack.
        Under parity / invariant the Hessian's draws come from ``key`` (B,
        2), as the single solver's from its key."""
        B = nominals.shape[0]
        if hess_draws is None:
            hess_draws = (hessian_draws_from_key(self.env, self._keys(key), self.H)
                          if self._keyed(key) else self._draw(B, self.H, deterministic=True))
        R = self._hessian(nominals.reshape(B, self.D), x0s, t0s, pos_trajs, vel_trajs,
                          params_b, hess_draws)
        return self._optimize_sigma(R, self.sample_sigma, self.D)

    def sample_update(self, x0s, t0s, pos_trajs, vel_trajs, a_means, a_covs, factors,
                      params_b, gamma_mean=1.0, discount=1.0,
                      z: Optional[torch.Tensor] = None,
                      draws: Optional[torch.Tensor] = None, key=None,
                      offset: Offset = None):
        """The joint sample around the (shifted) means with each scenario's
        factor, the deterministic rollout, the weights and the mean update:
        returns (a_means_new (B, H, dA), costs (B, N), weights (B, N)).
        Parity samples through ``cholesky(a_covs)`` sample-first, as the
        single parity solver; the other modes through ``factors``."""
        B, N, D, H, dA = a_means.shape[0], self.n, self.D, self.H, self.dA
        kw = dict(deterministic=True, discount=discount)
        act_key = None
        if self._keyed(key):
            act_key, step_key = self._act_keys(key)
            if draws is None:
                draws = self.env.disturb_from_key(step_key, deterministic=True,
                                                  fast=self.rng != sampling.PARITY)
        elif draws is None:
            draws = self._draw(B, deterministic=True)
        if self.rng == sampling.PARITY:
            chol = torch.linalg.cholesky_ex(a_covs).L
            if z is None:
                z = prng.normal(prng.split(act_key, N), (D,))
            a = torch.clamp(a_means.reshape(B, 1, D) + z @ chol.mT, -1.0, 1.0)
            a = a.reshape(B, N, H, dA)
            costs = self._rollout(x0s, t0s, pos_trajs, vel_trajs, a, params_b, draws,
                                  layout="nhd", **kw)
            a_t = a.permute(0, 2, 3, 1)
        elif self._sampler is not None:
            costs, a_t = self._sampler(
                x0s, t0s, pos_trajs, vel_trajs, a_means, factors, params_b,
                self._word(), N, draws=draws,
                z=None if z is None else z.transpose(1, 2).contiguous(),
                offset=offset, **kw)
        else:
            if z is None and self.rng == sampling.INVARIANT:
                z = self._normals(act_key, (D,))
            a_t = torch.clamp(
                sampling.sample_joint_t(self.device_generator, a_means.reshape(B, D),
                                        factors, N, z=z),
                -1.0, 1.0,
            )
            costs = self._rollout(x0s, t0s, pos_trajs, vel_trajs, a_t, params_b, draws,
                                  layout="hdn", **kw)
        weights = reductions.mppi_weights(costs, self.lam, self.axis)
        a_means_new = reductions.mean_update_t(
            weights, a_t.reshape(B, H, dA, N), a_means, gamma_mean, self.axis)
        return a_means_new, costs, weights

    def __call__(self, x0s, t0s, pos_trajs, vel_trajs, a_means, params_b,
                 gamma_mean=1.0, discount=1.0,
                 z: Optional[torch.Tensor] = None,
                 draws: Optional[torch.Tensor] = None,
                 hess_draws: Optional[torch.Tensor] = None,
                 offset: Offset = None, key=None):
        a_means = _shift(a_means)
        a_covs, factors = self.design(x0s, t0s, pos_trajs, vel_trajs, a_means, params_b,
                                      hess_draws, key)
        a_means_new, costs, weights = self.sample_update(
            x0s, t0s, pos_trajs, vel_trajs, a_means, a_covs, factors, params_b,
            gamma_mean, discount, z, draws, key, offset)
        if self.collect_metrics:
            return a_means_new, torch.amin(costs, dim=-1), {
                **metrics.solve_metrics_sharded(costs, weights, self.axis, self.N),
                **metrics.sigma_metrics(factors @ factors.transpose(-1, -2)),
            }
        return a_means_new, torch.amin(costs, dim=-1)


def _batched_hessian(env, H: int, hessian_mode: str):
    """The Hessian at B points at once by the named estimator: the plain
    adjoint / Gauss–Newton chassis (:func:`make_hessian_batched`), or a
    reference estimator under vmap."""
    if hessian_mode in ("adjoint", "gn"):
        return make_hessian_batched(env, H, second_order=hessian_mode == "adjoint")
    if hessian_mode == "sensitivity":
        return vmap_hessian(make_hessian_sensitivity(env, H))
    if hessian_mode in (covariance.FWD_FWD, covariance.FWD_REV):
        return vmap_hessian(covariance.make_hessian(make_hessian_cost(env, H),
                                                    hessian_mode))
    raise ValueError(f"unknown hessian_mode {hessian_mode!r}")


class BatchedMPPISolve(_BatchedSolve):
    """``solve(x0s, t0s, pos_trajs, vel_trajs, a_means (B, H, dA), a_covs
    (B, H, dA, dA), params_b, gamma_mean=1.0, gamma_sigma=0.0, discount=1.0,
    z=None, draws=None, offset=None, key=None) -> (a_means_new, a_covs_new,
    min_costs (B,)[, metrics])``: per scenario, the shift of mean AND
    covariance, the per-step sample (factors by ``cholesky_ex`` of the
    shifted covariances, as JAX factors them every solve) + stochastic
    rollout under one shared disturbance draw, the weights, and the
    γ-blended mean and covariance updates (the covariance untouched at γ_σ
    = 0). ``z`` (B, N, H, dA) and ``draws`` (B, 3) feed given standard
    normals to the sampler and to each scenario's shared disturbance; by
    default they come from the solve's generators, or from ``key`` (B, 2)
    under parity (a key a sample and a step, sample-first) and invariant (a
    ``fold_in`` a sample). ``offset`` is K7's episode offset (the module
    docstring; ``key`` may be the (act_key, step_key) pair already split).
    Under ``collect_metrics`` a fourth output holds (B,) each of the cost
    min / mean / max and the ESS.
    """

    def __init__(self, env, N: int, H: int, lam: float, rng: str,
                 engine: str, seed: int, collect_metrics: bool = False, axis=None):
        super().__init__(env, N, H, lam, rng, engine, seed, collect_metrics, axis)
        self._sampler = (make_rollout_batched_sampling(env, joint=False)
                         if rng == sampling.KERNEL else None)

    def __call__(self, x0s, t0s, pos_trajs, vel_trajs, a_means, a_covs,
                 params_b, gamma_mean=1.0, gamma_sigma=0.0, discount=1.0,
                 z: Optional[torch.Tensor] = None,
                 draws: Optional[torch.Tensor] = None,
                 offset: Offset = None, key=None):
        B, N, H, dA = a_means.shape[0], self.n, self.H, self.dA
        a_means, a_covs = _shift(a_means), _shift(a_covs)
        chols = torch.linalg.cholesky_ex(a_covs).L.contiguous()
        kw = dict(deterministic=False, discount=discount)
        act_key = None
        if self._keyed(key):
            act_key, step_key = self._act_keys(key)
            if draws is None:
                draws = self.env.disturb_from_key(step_key,
                                                  fast=self.rng != sampling.PARITY)
        elif draws is None:
            draws = self._draw(B, deterministic=False)
        if self.rng == sampling.PARITY:
            if z is None:
                # per sample a key, per step a key under it (reference mppi.py:53-65)
                z = prng.normal(prng.split(prng.split(act_key, N), H), (dA,))
            a = torch.clamp(a_means[:, None] + torch.einsum("bhij,bnhj->bnhi", chols, z),
                            -1.0, 1.0)
            costs = self._rollout(x0s, t0s, pos_trajs, vel_trajs, a, params_b, draws,
                                  layout="nhd", **kw)
            a_t = a.permute(0, 2, 3, 1)
        elif self._sampler is not None:
            costs, a_flat = self._sampler(
                x0s, t0s, pos_trajs, vel_trajs, a_means, chols, params_b,
                self._word(), N, draws=draws,
                z=None if z is None else z.permute(0, 2, 3, 1).contiguous(),
                offset=offset, **kw)
            a_t = a_flat.reshape(B, H, dA, N)
        else:
            if z is None and self.rng == sampling.INVARIANT:
                z = self._normals(act_key, (H, dA))
            a_t = torch.clamp(
                sampling.sample_per_step_t(self.device_generator, a_means, chols,
                                           N, z=z),
                -1.0, 1.0,
            )
            costs = self._rollout(x0s, t0s, pos_trajs, vel_trajs, a_t, params_b, draws,
                                  layout="hdn", **kw)
        weights = reductions.mppi_weights(costs, self.lam, self.axis)
        a_means_new = reductions.mean_update_t(weights, a_t, a_means, gamma_mean, self.axis)
        a_covs_new = reductions.cov_update_t(weights, a_t, a_means_new, a_covs,
                                             gamma_sigma, self.axis)
        if self.collect_metrics:
            return (a_means_new, a_covs_new, torch.amin(costs, dim=-1),
                    metrics.solve_metrics_sharded(costs, weights, self.axis, self.N))
        return a_means_new, a_covs_new, torch.amin(costs, dim=-1)


def make_batched_covo_solve(env, N: int, H: int, lam: float,
                            sample_sigma: float = 0.5, rng: str = "fast",
                            collect_metrics: bool = False,
                            hessian_mode: str = "adjoint",
                            engine: str = "auto",
                            seed: int = 0, sigma_mode: str = "ns") -> BatchedCoVOSolve:
    """Scenario-batched CoVO-online solve on one device (JAX:
    make_batched_covo_solve; ``interpret`` has no counterpart, ``engine``
    picks the CUDA kernels or the plain path, "auto" by the env's device).
    ``rng="kernel"`` runs K7 (joint), ``"fast"`` draws with torch and runs
    K6 (``engine="cuda"``) or the plain rollout (``engine="torch"``, which
    takes every rng but ``"kernel"``); ``"parity"`` / ``"invariant"`` draw
    from each scenario's key. ``hessian_mode`` is any of the single
    solver's estimators, ``sigma_mode`` "ns" or "eigh" (``"ns_pallas"``
    raises: no batched K8)."""
    engine = resolve_engine(env, engine)
    _check(rng, engine)
    return BatchedCoVOSolve(env, N, H, lam, sample_sigma, rng, hessian_mode,
                            engine, seed, collect_metrics, sigma_mode)


def make_batched_mppi_solve(env, N: int, H: int, lam: float,
                            rng: str = "fast", collect_metrics: bool = False,
                            engine: str = "auto",
                            seed: int = 0) -> BatchedMPPISolve:
    """Scenario-batched MPPI solve on one device (JAX:
    make_batched_mppi_solve). ``rng="kernel"`` runs K7 (per-step), ``"fast"``
    draws with torch and runs K6 or the plain rollout, as for CoVO;
    ``"parity"`` / ``"invariant"`` draw from each scenario's key."""
    engine = resolve_engine(env, engine)
    _check(rng, engine)
    return BatchedMPPISolve(env, N, H, lam, rng, engine, seed, collect_metrics)


# --- the batched twins of the controllers ------------------------------------


def _per_episode(gens, draw) -> Optional[torch.Tensor]:
    """``draw(g)`` from each episode's generator, stacked on a leading axis
    (None where the draw is None: a model that draws nothing)."""
    out = [draw(g) for g in gens]
    return None if out[0] is None else torch.stack(out)


def _inputs(state) -> tuple:
    """(x0s, t0s, pos_trajs, vel_trajs) of batched states."""
    return pack_state(state), state.time, state.pos_traj, state.vel_traj


def _solve_inputs(state, info):
    """:func:`_inputs` of the states the sampling solvers act on:
    ``info["noisy_state"]`` where the env generates one."""
    if info is not None and info.get("noisy_state") is not None:
        state = info["noisy_state"]
    return _inputs(state)


class BatchedTwin:
    """A controller's batched form (:func:`batched_controller`):
    ``reset(B, state, env_params, src)`` gives the carry of B fresh episodes
    at their reset states (None: the cold start), and ``twin(state, info,
    env_params, carry, src, offset) -> (actions (B, dA), carry)`` acts on B
    batched states (``models/batched.py``) under one shared ``env_params``.

    ``src`` is what each episode draws from: for a controller that draws
    from JAX keys (``draws_from_keys``), the episodes' keys (B, 2), JAX's
    ``rng_control`` at reset and ``rng_act`` at a step, each drawn from as
    the single controller draws from its key; otherwise the episodes' own
    generators, one each, for the draws a solve takes per episode (the fast
    sampler's normals, the disturbance draws), so an episode's draws do not
    depend on its batch. ``offset`` is the first episode's index, K7's
    episode offset. ``seed`` and ``random_streams`` are the solve's (a
    capture registers them); a twin that is not ``capturable`` (the eigh
    designer) runs eagerly on the card too."""

    capturable = True

    def __init__(self, controller):
        self.controller = controller
        self.env = controller.env
        self.params = controller.init_control_params
        self.draws_from_keys = getattr(controller, "draws_from_keys", False)

    def seed(self, seed: int) -> None:
        """Seed the solve's own streams (none here)."""

    def random_streams(self) -> list:
        return []

    def _means(self, B: int) -> torch.Tensor:
        return self.params.a_mean.expand(B, *self.params.a_mean.shape).clone()


class _SolveTwin(BatchedTwin):
    def __init__(self, controller, solve):
        super().__init__(controller)
        self.solve = solve
        self.capturable = getattr(solve, "capturable", True)

    def seed(self, seed: int) -> None:
        self.solve.seed(seed)

    def random_streams(self) -> list:
        return self.solve.random_streams()


class _CoVOTwin(_SolveTwin):
    """What the CoVO twins share: each episode's draws for a solve's halves
    (from its key, or its generator)."""

    def _act_draws(self, src) -> dict:
        """The inputs of one :meth:`BatchedCoVOSolve.sample_update`: the
        keys, or per episode the fast sampler's normals (N, D) and, under
        "periodic" / "mixed", the rollout's draw."""
        if self.draws_from_keys:
            return {"key": src}
        env, solve, dev = self.env, self.solve, self.env.device
        return {
            "z": (_per_episode(src, lambda g: torch.randn(solve.N, solve.D, generator=g,
                                                          device=dev))
                  if solve.rng == sampling.FAST else None),
            "draws": _per_episode(src, lambda g: env.draw_disturb(g, deterministic=True)),
        }

    def _design_draws(self, src) -> dict:
        """The inputs of one :meth:`BatchedCoVOSolve.design`: the keys, or
        per episode the Hessian's uniforms (H, 3) ("periodic" / "mixed")."""
        if self.draws_from_keys:
            return {"key": src}
        H = self.solve.H
        return {"hess_draws": _per_episode(
            src, lambda g: self.env.draw_disturb(g, H, deterministic=True))}


class BatchedCoVOTwin(_CoVOTwin):
    """CoVO online: :class:`BatchedCoVOSolve`; the carry is the means (B, H,
    dA). Per episode, its generator draws the fast sampler's normals (N, D)
    and, under "periodic" / "mixed", the rollout's draw and the Hessian's;
    or its key, what the single solve draws from it."""

    def reset(self, B: int, state=None, env_params=None, src=None):
        return self._means(B)

    def __call__(self, state, info, env_params, a_means, src, offset=None):
        B = a_means.shape[0]
        a_means, _ = self.solve(*_solve_inputs(state, info), a_means,
                                expand_params(env_params, B), self.params.gamma_mean,
                                self.params.discount, offset=offset,
                                **{**self._act_draws(src), **self._design_draws(src)})
        return a_means[:, 0], a_means


class BatchedSpeculativeTwin(_CoVOTwin):
    """CoVO speculative (JAX: ``act`` then ``prepare`` on the folded key,
    vmapped; solvers/covo.py:222-277, 378-422): the carry is (means (B, H,
    dA), a_covs, factors (B, D, D)), the Sigma designed last step for this
    one. A step runs ``act`` over B (:meth:`BatchedCoVOSolve.sample_update`
    with the carried factors: K7 joint under kernel rng, the sampler and K6
    under fast), then ``prepare`` over B: one deterministic model step of
    every episode with its action about to be applied (the env's
    ``model_step`` under vmap), the batched Hessian there around the shifted
    new means, and the designer on the stack. Under parity / invariant
    ``prepare`` draws from ``fold_in(rng_act, 7919)``: ``key, k_step =
    split(key)``, the model step's draw from ``k_step``, the Hessian's from
    ``key``. ``reset`` designs step 0's Sigma of every episode at its reset
    state around the shifted initial nominal."""

    def reset(self, B: int, state=None, env_params=None, src=None):
        means = self._means(B)
        if state is None:  # the isotropic cold start
            p = self.params
            return (means, p.a_cov.expand(B, *p.a_cov.shape).clone(),
                    p.a_factor.expand(B, *p.a_factor.shape).clone())
        a_covs, factors = self.solve.design(*_inputs(state), _shift(means),
                                            expand_params(env_params, B),
                                            **self._design_draws(src))
        return means, a_covs, factors

    def __call__(self, state, info, env_params, carry, src, offset=None):
        means, a_covs, factors = carry
        B, env, p = means.shape[0], self.env, self.params
        params_b = expand_params(env_params, B)
        new, _, _ = self.solve.sample_update(
            *_solve_inputs(state, info), _shift(means), a_covs, factors, params_b,
            p.gamma_mean, p.discount, offset=offset, **self._act_draws(src))
        if self.draws_from_keys:
            key, k_step = prng.split(prng.fold_in(src, SPECULATIVE_FOLD)).unbind(-2)
            draw = env.disturb_from_key(k_step, deterministic=True)
            design_src = key
        else:
            draw = _per_episode(src, lambda g: env.draw_disturb(g, deterministic=True))
            design_src = src
        if draw is None:  # the deterministic gaussian step's zero draw
            draw = new.new_zeros(B, 3)
        observed = info["noisy_state"] if info.get("noisy_state") is not None else state
        x_next = vmap_trees(lambda s, a, d, prm: env.model_step(s, a, prm, d),
                            (observed, new[:, 0], draw), (env_params,))
        a_covs, factors = self.solve.design(*_inputs(x_next), _shift(new), params_b,
                                            **self._design_draws(design_src))
        return new[:, 0], (new, a_covs, factors)


class BatchedOfflineTwin(_CoVOTwin):
    """CoVO offline (JAX: solvers/covo.py:280-374, vmapped): the carry is
    (means (B, H, dA), a_cov_offline, a_factor_offline (B, max_steps, D,
    D)). ``reset`` builds every episode's Sigma schedule: the PID expansion
    episodes of the B reset states, one loop over time with the B episodes
    stepped at once, then :meth:`CoVOSolver.offline_sigma_at` on the stack
    of their B x max_steps states (nominal PID rollouts, the Hessians, the
    controller's designer), in slices of :data:`OFFLINE_SLICE` states.
    Under parity / invariant each episode's chain comes from its reset key
    (``CoVOSolver.offline_schedule_keys`` over the leading axis); otherwise
    its generator draws the expansion steps' disturbances (and, under
    "periodic" / "mixed", the nominal rollouts' and Hessians' uniforms). A
    step gathers each episode's ``a_cov_offline[time]`` and factor and
    samples: K7 joint under kernel rng, the sampler and K6 under fast,
    ``cholesky(a_cov)`` under parity. Its steps read the host nowhere, so
    it is captured whatever the designer (eigh runs at reset only)."""

    def __init__(self, controller, solve):
        super().__init__(controller, solve)
        self.capturable = True

    def reset(self, B: int, state=None, env_params=None, src=None):
        if state is None:
            raise ValueError("the offline twin's reset builds each episode's Sigma "
                             "schedule from its reset state: pass the B states")
        solver, env, p = self.controller, self.env, self.params
        T = env.default_params.max_steps_in_episode
        if env_params is None:
            env_params = env.default_params
        keys = step_draws = hess_draws = None
        if self.draws_from_keys:
            keys, disturb = solver.offline_schedule_keys(src)  # (T, B, 2), (T, B, 3)
        else:
            disturb = _per_episode(src, lambda g: env.draw_disturb(g, T))
            disturb = None if disturb is None else disturb.transpose(0, 1)
        st, states = state, []
        for t in range(T):
            states.append(st)
            action, _, _ = solver.expansion(None, st, env_params, solver.expansion_params)
            st = vmap_trees(lambda s, a, d, prm: env.model_step(s, a, prm, d),
                            (st, action, None if disturb is None else disturb[t]),
                            (env_params,))
        # (T, B, ...) -> the B episodes' schedules, episode-major (B T, ...)
        leaves, spec = tree_flatten(stack(states))
        flat = tree_unflatten(spec, [x.transpose(0, 1).reshape(B * T, *x.shape[2:])
                                     for x in leaves])
        if keys is not None:
            keys = keys.transpose(0, 1).reshape(B * T, 2)
        else:
            H = solver.H
            step_draws = _per_episode(src, lambda g: env.draw_disturb(
                g, H, T, deterministic=True))
            if step_draws is not None:  # (B, H, T, 3) -> (H, B T, 3)
                step_draws = step_draws.transpose(0, 1).reshape(H, B * T, 3)
                hess_draws = torch.stack([env.draw_disturb(g, T, H, deterministic=True)
                                          for g in src]).reshape(B * T, H, 3)
        covs, facs = [], []
        for lo in range(0, B * T, OFFLINE_SLICE):
            sl = slice(lo, lo + OFFLINE_SLICE)
            c, f = solver.offline_sigma_at(
                _slice_tree(flat, sl), env_params, p.sample_sigma,
                None if keys is None else keys[sl],
                None if step_draws is None else step_draws[:, sl],
                None if hess_draws is None else hess_draws[sl])
            covs.append(c)
            facs.append(f)
        D = solver.D
        return (self._means(B), torch.cat(covs).reshape(B, T, D, D),
                torch.cat(facs).reshape(B, T, D, D))

    def __call__(self, state, info, env_params, carry, src, offset=None):
        means, covs, facs = carry
        B, p = means.shape[0], self.params
        x0s, t0s, pos_trajs, vel_trajs = _solve_inputs(state, info)
        idx = torch.clamp(t0s, 0, covs.shape[1] - 1).long()
        b = torch.arange(B, device=idx.device)
        new, _, _ = self.solve.sample_update(
            x0s, t0s, pos_trajs, vel_trajs, _shift(means), covs[b, idx], facs[b, idx],
            expand_params(env_params, B), p.gamma_mean, p.discount, offset=offset,
            **self._act_draws(src))
        return new[:, 0], (new, covs, facs)


def _slice_tree(tree, sl: slice):
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [x[sl] for x in leaves])


class BatchedMPPITwin(_SolveTwin):
    """MPPI: :class:`BatchedMPPISolve`; the carry is (means (B, H, dA),
    covariances (B, H, dA, dA)). Per episode, its generator draws the fast
    sampler's normals (N, H, dA) and the rollout's shared disturbance; or
    its key, what the single solve draws from it."""

    def reset(self, B: int, state=None, env_params=None, src=None):
        return (self._means(B),
                self.params.a_cov.expand(B, *self.params.a_cov.shape).clone())

    def __call__(self, state, info, env_params, carry, src, offset=None):
        env, solve, dev = self.env, self.solve, self.env.device
        B = carry[0].shape[0]
        if self.draws_from_keys:
            kw = {"key": src}
        else:
            kw = {"z": (_per_episode(src, lambda g: torch.randn(
                solve.N, solve.H, solve.dA, generator=g, device=dev))
                if solve.rng == sampling.FAST else None),
                "draws": _per_episode(src, env.draw_disturb)}
        p = self.params
        a_means, a_covs, _ = solve(*_solve_inputs(state, info), *carry,
                                   expand_params(env_params, B), p.gamma_mean,
                                   p.gamma_sigma, p.discount, offset=offset, **kw)
        return a_means[:, 0], (a_means, a_covs)


class BatchedPIDTwin(BatchedTwin):
    """PID: its solve under ``torch.func.vmap`` over the episodes (no
    kernel, as in JAX); the carry is the stacked :class:`PIDParams`."""

    def reset(self, B: int, state=None, env_params=None, src=None):
        return stack([self.params] * B)

    def __call__(self, state, info, env_params, carry, src, offset=None):
        pid = self.controller
        action, carry, _ = vmap_trees(lambda s, c, p: pid(None, s, p, c),
                                      (state, carry), (env_params,))
        return action, carry


class BatchedRandomTwin(BatchedTwin):
    """Random: N(0, 0.3^2) actions, each episode's from its generator, or
    from its key (``normal(key, (4,)) * 0.3``, as JAX draws them)."""

    def reset(self, B: int, state=None, env_params=None, src=None):
        return None

    def __call__(self, state, info, env_params, carry, src, offset=None):
        dA, dev = self.env.action_dim, self.env.device
        if self.draws_from_keys:
            return prng.normal(src, (dA,)) * 0.3, carry
        return _per_episode(src, lambda g: torch.randn(dA, generator=g, device=dev)
                            * 0.3), carry


def batched_controller(controller) -> BatchedTwin:
    """The batched twin of ``controller`` (JAX vmaps the controller; the
    port maps each of its controllers to a batched form): CoVO online,
    speculative and offline -> :class:`BatchedCoVOSolve` (its N, H, λ, σ,
    rng mode, Hessian estimator, designer and engine) in
    :class:`BatchedCoVOTwin`, :class:`BatchedSpeculativeTwin`,
    :class:`BatchedOfflineTwin`; MPPI -> :class:`BatchedMPPISolve`; PID ->
    a vmap of its solve; Random -> per-episode draws. Every rng mode runs.
    Online and speculative CoVO with ``sigma_mode="ns_pallas"`` raise (K8
    does not batch; offline designs with the plain designer, as the single
    offline solver); nothing falls back to a loop over episodes."""
    env = controller.env
    if isinstance(controller, CoVOSolver):
        twin = {"online": BatchedCoVOTwin, "speculative": BatchedSpeculativeTwin,
                "offline": BatchedOfflineTwin}[controller.mode]
        sigma_mode = controller.sigma_mode
        if sigma_mode == "ns_pallas":
            if controller.mode != "offline":
                raise NotImplementedError(
                    f"no batched CoVO {controller.mode} solve with sigma_mode="
                    "'ns_pallas': JAX cannot vmap K8's pallas_call on hardware either "
                    f"(covo_mpc_tpu/solvers/covo.py:83-90); {NS_PALLAS_ITEM}")
            sigma_mode = "ns"  # offline's schedule runs the plain designer
        p = controller.init_control_params
        return twin(controller, make_batched_covo_solve(
            env, controller.N, controller.H, controller.lam, p.sample_sigma,
            rng=controller.rng_mode, hessian_mode=controller.hessian_mode,
            engine=controller.engine, sigma_mode=sigma_mode))
    if isinstance(controller, MPPISolver):
        return BatchedMPPITwin(controller, make_batched_mppi_solve(
            env, controller.N, controller.H, controller.lam,
            rng=controller.rng_mode, engine=controller.engine))
    if isinstance(controller, PIDSolver):
        return BatchedPIDTwin(controller)
    if isinstance(controller, RandomSolver):
        return BatchedRandomTwin(controller)
    raise NotImplementedError(f"no batched form of {type(controller).__name__}")


# --- the multichip steps: scenarios data parallel, samples sharded ------------


def _env_step_b(env, keys: torch.Tensor, states, actions: torch.Tensor, params_b):
    """Each scenario's auto-resetting env step on its key under its own
    parameters (JAX: ``jax.vmap(env.step)(keys, states, actions,
    params_b)``): the key split as :meth:`QuadEnv.step` splits it, the
    draws made as :class:`~covo_mpc_tpu_torch.models.batched.BatchedEnv`
    makes them, then step, reset and select under ``torch.func.vmap``.
    Returns (states', rewards, dones)."""
    step_keys, reset_keys = prng.split(keys).unbind(-2)
    batched = BatchedEnv(env)
    step_draws, reset_draws = batched.draw_step(step_keys), batched.draw_reset(reset_keys)

    def one(sd, rd, st, a, p):
        _, st_st, reward, done, _ = env.step_from_draws(sd, st, a, p)
        _, _, st_re = env.reset_from_draws(rd, p)
        return tree_select(done, st_re, st_st), reward, done

    return vmap_trees(one, (step_draws, reset_draws, states, actions, params_b))


class _MultichipStep(MeshSolve):
    """What both multichip steps share: the batched solve over the mesh's
    sample axis, whose seed stream the step's capture registers, and K7's
    slot offset (see :func:`make_multichip_control_step`)."""

    def __init__(self, env, mesh, engine, rng, seed, capture, make_solve):
        super().__init__(env, mesh, seed, capture)
        engine = check_engine(env, engine)
        check_rng(rng, engine)
        self.batched = make_solve(engine, mesh.axis(SAMPLE_AXIS))
        self.seeds = self.batched.seeds
        self.scenario = mesh.index(SCENARIO_AXIS)

    def _offset(self, B: int) -> int:
        """This rank's first global scenario, K7's first slot."""
        return self.scenario * B


class MultichipControlStep(_MultichipStep):
    """``step(states, params_b, a_means (B, H, dA), a_covs (B, H, dA, dA),
    keys (B, 2), gamma_mean=1.0, gamma_sigma=0.0, discount=1.0) ->
    (states', a_means', a_covs', rewards (B,), dones (B,))`` on this rank's
    B scenarios (its block of the global batch: ``mesh.shard``; outputs
    assemble with ``mesh.gather``): JAX's key split (4 a scenario: act,
    step, env keys at 1, 2, 3), the batched MPPI solve over the sample axis
    on the act keys and the step keys' draw (:class:`BatchedMPPISolve`:
    the shift, the per-step sample, the stochastic rollout, the reduced
    updates; the covariance a fourth collective at γ_σ > 0, ``gamma_sigma``
    a Python float), and the auto-resetting env step with the new mean's
    first action."""

    def __init__(self, env, mesh, N, H, lam, engine, rng, seed, capture):
        super().__init__(env, mesh, engine, rng, seed, capture, lambda engine, axis:
                         BatchedMPPISolve(env, N, H, lam, rng, engine, seed, axis=axis))

    def solve(self, states, params_b, a_means, a_covs, keys, gamma_mean=1.0,
              gamma_sigma=0.0, discount=1.0):
        _, act_keys, step_keys, env_keys = prng.split(keys, 4).unbind(-2)
        a_means, a_covs, _ = self.batched(
            *_inputs(states), a_means, a_covs, params_b, gamma_mean, gamma_sigma, discount,
            offset=self._offset(a_means.shape[0]), key=(act_keys, step_keys))
        states_new, rewards, dones = _env_step_b(self.env, env_keys, states,
                                                 a_means[:, 0], params_b)
        return states_new, a_means, a_covs, rewards, dones


def make_multichip_control_step(env, mesh, N: int, H: int, lam: float,
                                engine: str = "auto", rng: str = "invariant",
                                seed: int = 0, capture: bool = False) -> MultichipControlStep:
    """The distributed MPPI control step over a (scenarios, samples) mesh
    (:class:`MultichipControlStep`; JAX: make_multichip_control_step, whose
    ``interpret`` has no counterpart). ``rng="kernel"`` runs K7 per-step
    (``engine="cuda"``), ``"invariant"`` K6 or the plain rollout on the
    keys' draws; kernel streams and capture as in ``parallel/sharded.py``:
    rank s of the sample axis takes word s of the step's words, and K7's
    slot of scenario b is this rank's first global scenario index plus b,
    so no two ranks, scenarios or sample blocks share a stream."""
    return MultichipControlStep(env, mesh, N, H, lam, engine, rng, seed, capture)


class MultichipCoVOStep(_MultichipStep):
    """``step(states, params_b, a_means (B, H, dA), keys (B, 2),
    gamma_mean=1.0, discount=1.0) -> (states', a_means', rewards, dones)``
    on this rank's B scenarios (see :class:`MultichipControlStep`): the
    shift of the mean, JAX's key split (5 a scenario: Hessian, act, step,
    env keys at 1-4), :meth:`BatchedCoVOSolve.design` with the Hessian's
    draws from the Hessian keys (replicated over the sample axis),
    :meth:`BatchedCoVOSolve.sample_update` over the sample axis on the act
    keys and the step keys' draw, and the env step."""

    def __init__(self, env, mesh, N, H, lam, sample_sigma, engine, rng, hessian_mode,
                 seed, capture):
        if hessian_mode not in ("adjoint", "gn"):
            raise ValueError(f"multichip covo supports 'adjoint'/'gn', got {hessian_mode!r}")
        super().__init__(env, mesh, engine, rng, seed, capture, lambda engine, axis:
                         BatchedCoVOSolve(env, N, H, lam, sample_sigma, rng, hessian_mode,
                                          engine, seed, axis=axis))

    def solve(self, states, params_b, a_means, keys, gamma_mean=1.0, discount=1.0):
        _, hess_keys, act_keys, step_keys, env_keys = prng.split(keys, 5).unbind(-2)
        x, solve = _inputs(states), self.batched
        a_means = _shift(a_means)
        a_covs, factors = solve.design(*x, a_means, params_b, key=hess_keys)
        a_means, _, _ = solve.sample_update(
            *x, a_means, a_covs, factors, params_b, gamma_mean, discount,
            key=(act_keys, step_keys), offset=self._offset(a_means.shape[0]))
        states_new, rewards, dones = _env_step_b(self.env, env_keys, states,
                                                 a_means[:, 0], params_b)
        return states_new, a_means, rewards, dones


def make_multichip_covo_step(env, mesh, N: int, H: int, lam: float,
                             sample_sigma: float = 0.5, engine: str = "auto",
                             rng: str = "invariant", hessian_mode: str = "adjoint",
                             seed: int = 0, capture: bool = False) -> MultichipCoVOStep:
    """The distributed CoVO-online control step (:class:`MultichipCoVOStep`;
    JAX: make_multichip_covo_step): scenarios data parallel, samples
    sharded. ``rng="kernel"`` runs K7 joint (``engine="cuda"``),
    ``"invariant"`` K6 or the plain rollout on the keys' draws (streams and
    capture as :func:`make_multichip_control_step`)."""
    return MultichipCoVOStep(env, mesh, N, H, lam, sample_sigma, engine, rng,
                             hessian_mode, seed, capture)
