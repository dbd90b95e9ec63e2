"""Sample-axis sharding of the MPPI and CoVO solves over a rank mesh.

Counterpart of :mod:`covo_mpc_tpu.parallel.sharded`. The N samples of a
solve, the only axis with cross-sample reductions, are split over the
mesh's sample axis. Each rank

1. draws its ``n_local = N / k`` samples: under ``rng="invariant"`` with
   the global ids ``rank * n_local + arange(n_local)`` (JAX's invariant
   sampler, ``fold_in(act_key, id)`` a sample: ``ops/sampling.py``), so
   the result is the one-rank result at every mesh shape; under
   ``rng="kernel"`` inside its sampling kernel (K5 per step, K1 joint),
   which gives up that invariance, as in JAX;
2. rolls out its samples locally (K4 on ``engine="cuda"``, the plain
   rollout on ``engine="torch"``);
3. takes part in three collectives: a MIN of the cost minima, a SUM of the
   softmax normalizers and a SUM of the weighted action sums (H * dA
   floats), ``Axis.pmin`` / ``Axis.psum`` (``parallel/mesh.py``).

Every input and output is replicated: each rank passes the same values and
gets the same result. Σ's design (the Hessian and the designer, O(D^2) and
independent of N) runs replicated on every rank, cheaper than sending it.

Kernel rng streams. JAX folds the shard index into the solve's key
(``fold_in(act_key, shard)``). Here a kernel's Philox key is a device word
of the solve's seed stream (``ops/sampling.SeedStream``): each solve draws
``k`` words at once (``next(k)``: splitmix64 of the counter times k plus
j, j = 0 .. k-1, a bijection, so no word repeats across ranks or solves),
and rank s takes word s (MPPI draws 2k and takes word 2s, as the single
MPPI solve takes the first of two). Rank 0 of a one-rank mesh so draws
what the single-device solver seeded alike draws. Inside a kernel the
Philox counter holds the sample, so no two samples share a stream either.
The shared disturbance of a rollout comes from ``step_key`` on every rank
(JAX's fast key chain), so all the shards of one solve roll out under one
draw.

Engines map as elsewhere in the port: JAX's ``jnp`` is ``"torch"``,
``pallas`` is ``"cuda"`` (the kernels for CUDA tensors; their plain
versions for CPU ones), ``"auto"`` picks by the env's device.

Capture. A solve reads no value on the host, so on a mesh whose
collectives are NCCL's (or on one rank without a group) it can be captured
as a CUDA graph (``runtime/graphs.py``): ``capture=True`` captures the
first call (its arguments become the graph's buffers) and replays the
graph at every call after; each replay equals the eager call bit for bit.
Gloo's collectives run eagerly through the host, so ``capture=True`` on a
gloo mesh raises; so does anything else that keeps a capture from
happening. ``capture=False`` (the default) runs eagerly.
"""

from __future__ import annotations

from typing import Optional

import torch

from covo_mpc_tpu_torch.models import dynamics
from covo_mpc_tpu_torch.ops import covariance, sampling
from covo_mpc_tpu_torch.ops.hessian import make_hessian_adjoint
from covo_mpc_tpu_torch.ops.rollout import hessian_draws_from_key, make_rollout
from covo_mpc_tpu_torch.ops.rollout_cuda import (
    make_rollout_costs,
    make_rollout_joint_sampling,
    make_rollout_sampling,
)
from covo_mpc_tpu_torch.parallel.mesh import SAMPLE_AXIS, Mesh
from covo_mpc_tpu_torch.runtime import graphs, metrics
from covo_mpc_tpu_torch.solvers.base import resolve_engine
from covo_mpc_tpu_torch.utils import prng

RNGS = (sampling.INVARIANT, sampling.KERNEL)
# JAX's engine names and the port's
_ENGINES = {"jnp": "torch", "pallas": "cuda"}


def check_engine(env, engine: str) -> str:
    """``engine`` resolved ("auto" by the env's device); an unknown one
    raises, JAX's names naming their counterparts."""
    engine = resolve_engine(env, engine)
    if engine in _ENGINES:
        raise ValueError(f"unknown engine {engine!r}: the port's counterpart of JAX's "
                         f"{engine!r} is {_ENGINES[engine]!r}")
    if engine not in ("torch", "cuda"):
        raise ValueError(f"unknown engine {engine!r}")
    return engine


def check_rng(rng: str, engine: str) -> None:
    if rng not in RNGS:
        raise ValueError(f"the sharded solves take rng in {RNGS}, got {rng!r}")
    if rng == sampling.KERNEL and engine != "cuda":
        raise ValueError("rng='kernel' requires engine='cuda'")


def check_divisible(N: int, k: int) -> int:
    if N % k:
        raise ValueError(f"N={N} not divisible by {k} shards")
    return N // k


def make_cost_engine(env, engine: str = "auto"):
    """The costs-only rollout of given actions the sharded solves run per
    rank: K4 (``engine="cuda"``) or the plain rollout (``"torch"``), both
    ``costs_fn(x0, t0, pos_traj, vel_traj, actions, params, draw,
    deterministic, discount, layout)``. K4 takes any sample count (JAX
    pads its tiles; the port's kernels take ragged N)."""
    engine = check_engine(env, engine)
    return make_rollout_costs(env) if engine == "cuda" else make_rollout(env)


def local_ids(axis, n_local: int, device) -> torch.Tensor:
    """This rank's global sample ids along ``axis`` (None: the whole axis
    on this rank)."""
    start = axis.index * n_local if axis is not None else 0
    return start + torch.arange(n_local, device=device)


class MeshSolve:
    """What the sharded solves and multichip steps share: the mesh, the
    seed stream of the kernels' Philox words, and capture (the module
    docstring). ``__call__`` runs :meth:`solve` eagerly, or, under
    ``capture=True``, the graph captured at the first call."""

    def __init__(self, env, mesh: Mesh, seed: int, capture: bool):
        self.env, self.mesh = env, mesh
        self.seeds = sampling.SeedStream(env.device)
        self.seeds.seed(seed)
        if capture and not mesh.capturable:
            raise ValueError("capture=True: gloo's collectives run through the host and "
                             "cannot be captured in a CUDA graph; run eagerly "
                             "(capture=False), or one rank a card under nccl")
        self.capture = capture
        self.graph = None  # the captured call (runtime.graphs.CapturedCall)

    def seed(self, seed: int) -> None:
        self.seeds.seed(seed)

    def random_streams(self) -> list:
        return [self.seeds]

    def words(self, n: int, index: int) -> torch.Tensor:
        """Word ``index`` of the solve's ``n`` words (advances the stream)."""
        return self.seeds.next(n)[index]

    def solve(self, *args):
        raise NotImplementedError

    def __call__(self, *args):
        if not self.capture:
            return self.solve(*args)
        if self.graph is None:
            self.graph = graphs.capture(self.solve, *args, streams=self.random_streams())
        return self.graph(*args)


class ShardedMPPISolve(MeshSolve):
    """``solve(x0, t0, pos_traj, vel_traj, a_mean (H, dA), a_cov (H, dA,
    dA), gamma_mean, gamma_sigma, discount, params, act_key, step_key) ->
    (a_mean_new, a_cov_new, min_cost[, metrics])``, every argument and
    result replicated over the axis (JAX's signature). No shift: the caller
    shifts, as in JAX. ``gamma_sigma`` is a Python float: at 0 the
    covariance passes through, else the weighted covariance around the new
    mean (a fourth collective) is blended in. The rollout is stochastic
    under one shared draw from ``step_key``."""

    def __init__(self, env, mesh, N, H, lam, axis, engine, rng, collect_metrics, seed,
                 capture):
        super().__init__(env, mesh, seed, capture)
        self.engine = check_engine(env, engine)
        check_rng(rng, self.engine)
        self.axis = mesh.axis(axis)
        self.n_local = check_divisible(N, self.axis.size)
        self.N, self.H, self.lam, self.rng = N, H, lam, rng
        self.collect_metrics = collect_metrics
        self.dA = env.action_dim
        self.rollout = make_cost_engine(env, self.engine)
        self.fused = make_rollout_sampling(env) if rng == sampling.KERNEL else None

    def solve(self, x0, t0, pos_traj, vel_traj, a_mean, a_cov, gamma_mean,
              gamma_sigma, discount, params, act_key, step_key):
        ax, n = self.axis, self.n_local
        chol = torch.linalg.cholesky_ex(a_cov).L.contiguous()
        draw = self.env.disturb_from_key(step_key, deterministic=False, fast=True)
        kw = dict(deterministic=False, discount=discount)
        if self.fused is not None:
            costs, a_flat = self.fused(x0, t0, pos_traj, vel_traj, a_mean, chol, params,
                                       self.words(2 * ax.size, 2 * ax.index), n,
                                       draw=draw, **kw)
            a_t = a_flat.reshape(self.H, self.dA, n)
        else:
            z = sampling.std_normal_invariant(act_key, n, (self.H, self.dA),
                                              local_ids(ax, n, x0.device))
            a_t = torch.clamp(sampling.sample_per_step_t(None, a_mean, chol, n, z=z),
                              -1.0, 1.0)
            costs = self.rollout(x0, t0, pos_traj, vel_traj, a_t, params, draw,
                                 layout="hdn", **kw)
        min_cost = ax.pmin(torch.amin(costs))
        unnorm = torch.exp(-(costs - min_cost) / self.lam)
        weight = unnorm / ax.psum(torch.sum(unnorm))
        mean = ax.psum(torch.einsum("n,hdn->hd", weight, a_t))
        a_mean_new = mean * gamma_mean + a_mean * (1.0 - gamma_mean)
        if gamma_sigma == 0.0:
            a_cov_new = a_cov
        else:
            dev = a_t - a_mean_new[..., None]
            cov = ax.psum(torch.einsum("n,hin,hjn->hij", weight, dev, dev))
            a_cov_new = cov * gamma_sigma + a_cov * (1.0 - gamma_sigma)
        if self.collect_metrics:
            return (a_mean_new, a_cov_new, min_cost,
                    metrics.solve_metrics_sharded(costs, weight, ax, self.N))
        return a_mean_new, a_cov_new, min_cost


def make_sharded_mppi_solve(env, mesh: Mesh, N: int, H: int, lam: float,
                            axis: str = SAMPLE_AXIS, engine: str = "auto",
                            rng: str = "invariant", collect_metrics: bool = False,
                            seed: int = 0, capture: bool = False) -> ShardedMPPISolve:
    """The sharded MPPI sample -> rollout -> reduce -> update core
    (:class:`ShardedMPPISolve`; JAX: make_sharded_mppi_solve, its
    ``interpret`` has no counterpart). ``rng="kernel"`` runs K5 per rank
    (``engine="cuda"``), ``"invariant"`` draws from the keys and runs K4 or
    the plain rollout. ``collect_metrics`` appends the cost min / mean /
    max and the ESS from all-reduced partials."""
    return ShardedMPPISolve(env, mesh, N, H, lam, axis, engine, rng, collect_metrics,
                            seed, capture)


def make_covo_local_core(env, H: int, lam: float, engine: str = "auto",
                         rng: str = "invariant", collect_metrics: bool = False):
    """One rank's CoVO sample -> rollout -> reduce -> update body, shared
    by :func:`make_sharded_covo_sample_rollout` (collectives over a sample
    axis) and the pipeline's act stage (``parallel/pipeline.py``).

    Returns ``local(x0, t0, pos_traj, vel_traj, mean_flat, factor,
    gamma_mean, discount, params, act_key, step_key, *, n_local, ids,
    seed_word, axis=None) -> (a_mean_new (H, dA), min_cost[, metrics])``:
    ``ids`` are this rank's global sample ids (the invariant sampler),
    ``seed_word`` K1's Philox key (``rng="kernel"``), ``axis`` the bound
    axis to reduce over (None: every sample lies on this rank). The
    rollout is deterministic; its draw comes from ``step_key`` (None: a
    model that draws nothing then, gaussian or none)."""
    engine = check_engine(env, engine)
    check_rng(rng, engine)
    rollout = make_cost_engine(env, engine)
    fused = make_rollout_joint_sampling(env) if rng == sampling.KERNEL else None
    dA = env.action_dim

    def local(x0, t0, pos_traj, vel_traj, mean_flat, factor, gamma_mean, discount,
              params, act_key, step_key, *, n_local, ids, seed_word=None, axis=None):
        H_ = mean_flat.shape[0] // dA
        draw = (None if step_key is None
                else env.disturb_from_key(step_key, deterministic=True, fast=True))
        kw = dict(deterministic=True, discount=discount)
        if fused is not None:
            costs, a_t = fused(x0, t0, pos_traj, vel_traj, mean_flat.reshape(H_, dA),
                               factor, params, seed_word, n_local, draw=draw, **kw)
        else:
            z = sampling.std_normal_invariant(act_key, n_local, (H_ * dA,), ids)
            a_t = torch.clamp(sampling.sample_joint_t(None, mean_flat, factor, n_local,
                                                      z=z), -1.0, 1.0)
            costs = rollout(x0, t0, pos_traj, vel_traj, a_t, params, draw,
                            layout="hdn", **kw)
        local_min = torch.amin(costs)
        min_cost = axis.pmin(local_min) if axis is not None else local_min
        unnorm = torch.exp(-(costs - min_cost) / lam)
        norm = torch.sum(unnorm)
        weight = unnorm / (axis.psum(norm) if axis is not None else norm)
        mean = torch.einsum("n,hdn->hd", weight, a_t.reshape(H_, dA, n_local))
        if axis is not None:
            mean = axis.psum(mean)
        a_mean_new = mean * gamma_mean + mean_flat.reshape(H_, dA) * (1.0 - gamma_mean)
        if collect_metrics:
            n_total = n_local * (axis.size if axis is not None else 1)
            return a_mean_new, min_cost, metrics.solve_metrics_sharded(
                costs, weight, axis, n_total)
        return a_mean_new, min_cost

    return local


class ShardedCoVOSampleRollout(MeshSolve):
    """``solve(x0, t0, pos_traj, vel_traj, mean_flat (D,), factor (D, D),
    gamma_mean, discount, params, act_key, step_key) -> (a_mean_new (H,
    dA), min_cost[, metrics])``, all replicated (JAX's signature):
    :func:`make_covo_local_core` over the sample axis."""

    def __init__(self, env, mesh, N, H, lam, axis, engine, rng, collect_metrics, seed,
                 capture):
        super().__init__(env, mesh, seed, capture)
        engine = check_engine(env, engine)
        self.axis = mesh.axis(axis)
        self.n_local = check_divisible(N, self.axis.size)
        self.rng = rng
        self.core = make_covo_local_core(env, H, lam, engine, rng, collect_metrics)

    def solve(self, x0, t0, pos_traj, vel_traj, mean_flat, factor, gamma_mean, discount,
              params, act_key, step_key):
        ax = self.axis
        word = (self.words(ax.size, ax.index) if self.rng == sampling.KERNEL else None)
        return self.core(x0, t0, pos_traj, vel_traj, mean_flat, factor, gamma_mean,
                         discount, params, act_key, step_key, n_local=self.n_local,
                         ids=local_ids(ax, self.n_local, x0.device), seed_word=word,
                         axis=ax)


def make_sharded_covo_sample_rollout(env, mesh: Mesh, N: int, H: int, lam: float,
                                     axis: str = SAMPLE_AXIS, engine: str = "auto",
                                     rng: str = "invariant",
                                     collect_metrics: bool = False, seed: int = 0,
                                     capture: bool = False) -> ShardedCoVOSampleRollout:
    """The sharded CoVO sample -> rollout -> reduce core
    (:class:`ShardedCoVOSampleRollout`; JAX:
    make_sharded_covo_sample_rollout). ``factor`` is any square root of
    Σ. ``rng="kernel"`` runs K1 per rank, ``"invariant"`` K4 or the plain
    rollout on the keys' draws."""
    return ShardedCoVOSampleRollout(env, mesh, N, H, lam, axis, engine, rng,
                                    collect_metrics, seed, capture)


def shift_mean(a_mean: torch.Tensor) -> torch.Tensor:
    """Receding-horizon shift of the mean, repeating the last step."""
    return torch.cat([a_mean[1:], a_mean[-1:]])


def act_step_keys(key: torch.Tensor):
    """JAX's solve chain from ``rng`` (a key, or a (B, 2) stack, each
    scenario's): ``rng, act_key = split(rng)``, ``rng, step_key =
    split(rng)``; returns (act_key, step_key)."""
    rest, act_key = prng.split(key).unbind(-2)
    return act_key, prng.split(rest)[..., 1, :]


class DistributedCoVOSolve(MeshSolve):
    """``solve(x0, t0, pos_traj, vel_traj, a_mean (H, dA), params, key,
    gamma_mean=1.0, discount=1.0) -> (a_mean_new (H, dA), min_cost[,
    metrics])``, all replicated (JAX's signature; ``key`` is JAX's
    ``rng_act``): the mean shift, the Hessian with its draws from ``key``,
    the Newton–Schulz designer (replicated on every rank), then the
    sharded sample -> rollout -> reduce core on the single solver's key
    chain. On a one-rank mesh under ``rng="invariant"`` this is the single
    CoVO solver's update (``solvers/covo.py``, invariant rng, ns), at any
    mesh shape the same. ``collect_metrics`` appends the solve's health
    and Σ's conditioning (``sigma_metrics``: deferred inside an episode
    runner's scope, as the single solvers')."""

    def __init__(self, env, mesh, N, H, lam, sample_sigma, axis, engine, hessian_primal,
                 rng, collect_metrics, hessian_mode, seed, capture):
        super().__init__(env, mesh, seed, capture)
        engine = check_engine(env, engine)
        if hessian_mode not in ("adjoint", "gn"):
            raise ValueError(f"distributed covo supports 'adjoint'/'gn', got {hessian_mode!r}")
        # the kernel primal and tail pair with the kernel engine, as JAX
        # pairs its pallas primal and tail with the pallas engine
        part = hessian_primal or ("cuda" if engine == "cuda" else "torch")
        self.hess = make_hessian_adjoint(env, H, primal=part, tail=part,
                                         second_order=hessian_mode == "adjoint")
        self.core = ShardedCoVOSampleRollout(env, mesh, N, H, lam, axis, engine, rng,
                                             collect_metrics, seed, capture=False)
        self.seeds = self.core.seeds
        self.sample_sigma, self.H, self.D = sample_sigma, H, H * env.action_dim
        self.collect_metrics = collect_metrics
        # the solve's key chain (two splits, ~350 device ops on the card) is
        # read only by the invariant sampler and the uniform draws of
        # "periodic" / "mixed": in-kernel draws of any other model skip it
        self.keyless = (rng == sampling.KERNEL
                        and env.config.disturb_type not in dynamics.UNIFORM_DRAW)

    def solve(self, x0, t0, pos_traj, vel_traj, a_mean, params, key, gamma_mean=1.0,
              discount=1.0):
        a_mean = shift_mean(a_mean)
        R = self.hess(a_mean.flatten(), x0, t0, pos_traj, vel_traj, params,
                      hessian_draws_from_key(self.env, key, self.H))
        a_cov, factor = covariance.optimize_sigma_ns(R, self.sample_sigma, self.D)
        act_key, step_key = (None, None) if self.keyless else act_step_keys(key)
        out = self.core.solve(x0, t0, pos_traj, vel_traj, a_mean.flatten(), factor,
                              gamma_mean, discount, params, act_key, step_key)
        if self.collect_metrics:
            a_new, min_cost, m = out
            return a_new, min_cost, {**m, **metrics.sigma_metrics(a_cov)}
        return out


def make_distributed_covo_solve(env, mesh: Mesh, N: int, H: int, lam: float,
                                sample_sigma: float = 0.5, axis: str = SAMPLE_AXIS,
                                engine: str = "auto",
                                hessian_primal: Optional[str] = None,
                                rng: str = "invariant", collect_metrics: bool = False,
                                hessian_mode: str = "adjoint", seed: int = 0,
                                capture: bool = False) -> DistributedCoVOSolve:
    """The full distributed CoVO-online solve (:class:`DistributedCoVOSolve`;
    JAX: make_distributed_covo_solve): replicated Σ design (K2 + K3 and the
    plain designer on ``engine="cuda"``; ``hessian_primal`` "torch" or
    "cuda" overrides the pairing) and the sharded sample / rollout /
    reduce (K1 under ``rng="kernel"``, K4 under ``"invariant"``)."""
    return DistributedCoVOSolve(env, mesh, N, H, lam, sample_sigma, axis, engine,
                                hessian_primal, rng, collect_metrics, hessian_mode, seed,
                                capture)
