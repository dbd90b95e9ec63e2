"""CoVO-MPC: covariance-optimal sampling-based MPC, online, speculative and
offline.

Counterpart of :class:`covo_mpc_tpu.solvers.covo.CoVOSolver`. One online
solve, in order:

1. shift the mean;
2. the Hessian of the H-step cost around it, Gauss–Newton
   (``hessian_mode="gn"``) or the exact adjoint (``"adjoint"``): primal
   K2, local derivatives, chain K3 + pullback; or one of the reference's
   generic estimators (``"fwd_fwd"``, ``"fwd_rev"``: ``torch.func`` twice
   over one rollout) or the exact second-order sensitivity propagation
   (``"sensitivity"``), plain PyTorch as JAX runs them in XLA;
3. the Newton–Schulz Sigma-designer: matmuls + one Cholesky
   (``sigma_mode="ns"``), K8, the whole designer in one launch
   (``"ns_pallas"`` on ``engine="cuda"``), or eigh (``"eigh"``);
4. the joint sample + rollout: K1 (``rng_mode="kernel"``), or z from the
   solver's device generator (``"fast"``) or from JAX's key (``"parity"``:
   the reference's per-sample keys, sampled through ``cholesky(a_cov)``
   sample-first; ``"invariant"``: a ``fold_in`` a sample, sample-last),
   then K4 (``engine="cuda"``) or the plain rollout (``engine="torch"``);
5. softmax weights and the mean update.

Under "parity" and "invariant" a solve draws from JAX's key ``key=``
(``rng_act``) in JAX's tree: the Hessian's per-step draws from the key
itself, then ``split`` for the samples' key and again for the rollout's
step key (through the reference's chain under parity), the speculative
design from ``fold_in(key, 7919)``, the offline schedule from the reset's
key with two splits a step; without a key such a solve raises.
``collect_debug`` (the plain engine only, as JAX's) also returns the
sampled rollouts' mean and std position a step, ``pos_mean`` and
``pos_std`` (H, 3).

``mode="speculative"`` moves steps 2-3 off the obs->action path:
:meth:`CoVOSolver.act` runs 1, 4 and 5 with the Sigma designed last step,
and :meth:`CoVOSolver.prepare` then designs the next step's Sigma at the
model-predicted next state; ``__call__`` is ``act`` + ``prepare``, and
``reset`` designs step 0's Sigma at the reset state. ``mode="offline"``
designs the whole episode's Sigma schedule at ``reset`` (a PID expansion
episode, then the Hessians and designers of all its states at once) and a
solve reads step t's. Offline always runs the plain designer, as JAX does.

A solve reads no value on the host, and every input it reads is a device
tensor, so a solve (online, speculative ``act`` and ``prepare``, offline's
per-step solve) can be captured as a CUDA graph and replayed
(``runtime/graphs.py``), as JAX jits it. K1's per-solve Philox key is a
device word of the solver's seed stream (:class:`~covo_mpc_tpu_torch.ops.
sampling.SeedStream`), which each solve advances on the device, as JAX
threads a fresh ``rng_act`` key into each jitted solve; the fast sampler's
normals come from the solver's device generator, which a graph advances at
each replay. Under "periodic" and "mixed" a solve also draws its
disturbance uniforms from that generator (the rollout's shared draw, the
Hessian's per-step draws, the speculative model step's draw): CoVO's
rollouts are deterministic, which zeroes the gaussian scale only. Every
other model draws nothing there. Offline's ``reset`` (the schedule) runs
eagerly, once an episode, as JAX jits it apart. ``engine="cuda"`` runs K1
or K4, K2, K3 and, under ``"ns_pallas"``, K8 (their wrappers take the plain
versions for CPU tensors); ``engine="torch"`` is the plain path; ``engine="auto"`` picks
``"cuda"`` for an env on a CUDA device and ``"torch"`` for one on the CPU
or under ``collect_debug``. The ``eigh`` designer reads its status on the
host, so an online or speculative solve with it is not ``capturable`` and
runs eagerly; its reference Hessian, a pure function of the solve's
tensors, then runs as a CUDA graph of its own (``runtime/graphs.Graphed``). ``collect_metrics`` puts
the solve's health in ``info["metrics"]`` (``runtime/metrics.py``: the cost
statistics, the ESS and the conditioning of the step's Sigma).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch

from covo_mpc_tpu_torch.models import dynamics
from covo_mpc_tpu_torch.models.structs import (
    POS,
    QUAT,
    VEL,
    OMEGA,
    EnvState3D,
    expand_params,
    pack_state,
)
from covo_mpc_tpu_torch.ops import covariance, covariance_cuda, reductions, sampling
from covo_mpc_tpu_torch.ops.hessian import (
    make_hessian_adjoint,
    make_hessian_sensitivity,
    vmap_hessian,
)
from covo_mpc_tpu_torch.ops.rollout import hessian_draws_from_key, make_hessian_cost
from covo_mpc_tpu_torch.ops.rollout_cuda import make_rollout_joint_sampling
from covo_mpc_tpu_torch.runtime import graphs
from covo_mpc_tpu_torch.solvers.base import (
    BaseSolver,
    make_cost_rollout,
    resolve_engine,
    solve_info,
)
from covo_mpc_tpu_torch.solvers.pid import PIDParams, PIDSolver
from covo_mpc_tpu_torch.utils import prng

HESSIAN_MODES = ("gn", "adjoint", covariance.FWD_FWD, covariance.FWD_REV, "sensitivity")
# the fold_in that keeps the speculative design's keys apart from the solve's
SPECULATIVE_FOLD = 7919


@dataclasses.dataclass
class CoVOParams:
    gamma_mean: float
    gamma_sigma: float
    discount: float
    sample_sigma: float
    a_mean: torch.Tensor  # (H, dA)
    a_cov: torch.Tensor  # (H*dA, H*dA) joint covariance
    # speculative: the factor designed last step for this step's Sigma
    # (a_factor @ a_factor.T == a_cov)
    a_factor: Optional[torch.Tensor] = None
    # offline, after reset: the episode's Sigma schedule and its factors,
    # (max_steps, H*dA, H*dA) each
    a_cov_offline: Optional[torch.Tensor] = None
    a_factor_offline: Optional[torch.Tensor] = None

    def replace(self, **changes) -> "CoVOParams":
        return dataclasses.replace(self, **changes)


def covo_params_from_numpy(leaves: Mapping[str, Any], device="cuda") -> CoVOParams:
    """Build :class:`CoVOParams` from the JAX struct's leaves as numpy
    arrays: scalars as Python floats, arrays as row-major float32 tensors on
    ``device``. The speculative and offline leaves are read when present."""
    kw = {}
    for f in dataclasses.fields(CoVOParams):
        if f.name not in leaves and f.default is None:
            continue
        v = np.asarray(leaves[f.name])
        kw[f.name] = (float(v) if v.ndim == 0 else
                      torch.from_numpy(np.array(v, np.float32, order="C")).to(device))
    return CoVOParams(**kw)


def _shift(a_mean: torch.Tensor) -> torch.Tensor:
    """Receding-horizon shift of the mean, repeating the last step (CoVO
    re-designs Sigma from scratch, so only the mean shifts)."""
    return torch.cat([a_mean[1:], a_mean[-1:]])


def _at(table: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``table[t]`` for a 0-d device index clamped to the table, as a device
    gather (indexing with a 0-d tensor would read it on the host)."""
    idx = torch.clamp(t, 0, table.shape[0] - 1).long()[None]
    return table.index_select(0, idx)[0]


class CoVOSolver(BaseSolver):
    def __init__(
        self,
        env,
        control_params: CoVOParams,
        N: int,
        H: int,
        lam: float,
        mode: str = "online",
        rng_mode: str = sampling.FAST,
        hessian_mode: str = "gn",
        collect_debug: bool = False,
        engine: str = "auto",
        sigma_mode: str = "ns",
        seed: int = 0,
        collect_metrics: bool = False,
    ) -> None:
        super().__init__(env, control_params)
        # TF32 truncates fp32 matmuls the way the TPU's bf16 default did,
        # which NaNs the NS designer's lambda_min refinement
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if mode not in ("online", "offline", "speculative"):
            raise NotImplementedError(f"unknown CoVO mode {mode!r}")
        if hessian_mode not in HESSIAN_MODES:
            raise ValueError(f"unknown hessian_mode {hessian_mode!r}")
        engine = resolve_engine(env, engine, collect_debug)
        if collect_debug and engine == "cuda":
            # the kernels compute costs only (JAX: the pallas engine refuses it)
            raise ValueError("engine='cuda' requires collect_debug=False")
        if sigma_mode in ("ns", "ns_pallas") and rng_mode == "parity":
            # not bit-identical to eigh, so not a parity path (as JAX)
            raise ValueError(f"sigma_mode={sigma_mode!r} is not a parity path")
        if sigma_mode == "eigh":
            self._optimize_sigma = covariance.optimize_sigma
        elif sigma_mode == "ns" or (sigma_mode == "ns_pallas" and (
                mode == "offline" or engine == "torch")):
            # offline designs the whole schedule at once on a stack (JAX
            # keeps its kernel off the vmapped schedule too)
            self._optimize_sigma = covariance.optimize_sigma_ns
        elif sigma_mode == "ns_pallas":
            self._optimize_sigma = covariance_cuda.optimize_sigma_ns_cuda
        else:
            raise ValueError(f"unknown sigma_mode {sigma_mode!r}")
        self.rollout = make_cost_rollout(env, engine, rng_mode)

        self.N, self.H, self.lam = N, H, lam
        self.collect_metrics = collect_metrics
        self.collect_debug = collect_debug
        self.mode = mode
        self.rng_mode = rng_mode
        self.draws_from_keys = rng_mode in sampling.KEY_MODES
        self.capturable = not (sigma_mode == "eigh" and mode != "offline")
        self.hessian_mode = hessian_mode
        self.sigma_mode = sigma_mode
        self.engine = engine
        self.action_dim = env.action_dim
        self.D = H * env.action_dim
        # the offline schedule's Hessians run at all its states at once, on
        # the plain primal and chain (JAX vmaps its scan primal over them)
        part = "cuda" if engine == "cuda" and mode != "offline" else "torch"
        if hessian_mode in ("gn", "adjoint"):
            hessian = self._hessian = make_hessian_adjoint(
                env, H, primal=part, tail=part, second_order=hessian_mode == "adjoint")
        else:
            if hessian_mode == "sensitivity":
                hessian = make_hessian_sensitivity(env, H)
            else:
                hessian = covariance.make_hessian(make_hessian_cost(env, H), hessian_mode)
            # torch.func's transforms over the H-step rollout cost the host
            # seconds a call on the card: one graph, replayed each solve
            self._hessian = graphs.Graphed(hessian)
        if mode == "offline":
            self._hessian_b = vmap_hessian(hessian)
            # PID expansion policy with the reference's gains
            self.expansion_params = PIDParams.default(
                env.device, Kp=10.0, Kd=5.0, Ki=0.0, Kp_att=10.0)
            self.expansion = PIDSolver(env, self.expansion_params)
        self.rollout_sampling = (make_rollout_joint_sampling(env)
                                 if rng_mode == sampling.KERNEL else None)
        # K1's Philox keys, device words; the device generator for the fast
        # sampler's normals and the disturbance draws
        self.seeds = sampling.SeedStream(env.device)
        self.device_generator = torch.Generator(device=env.device)
        self.seed(seed)

    def seed(self, seed: int) -> None:
        self.seeds.seed(seed)
        self.device_generator.manual_seed(seed)

    def random_streams(self) -> list:
        return [self.seeds, self.device_generator]

    # -- the disturbance draws ---------------------------------------------------
    def _draw(self, *batch: int) -> Optional[torch.Tensor]:
        """The disturbance draws (*batch, 3) of deterministic model steps
        (uniforms for "periodic" / "mixed", else None), from the device
        generator."""
        return self.env.draw_disturb(self.device_generator, *batch,
                                     deterministic=True)

    # -- Sigma design ----------------------------------------------------------
    def _hess_draws(self, draws, key):
        """The Hessian's per-step draws: given, from JAX's key (a key-drawing
        solver: the Hessian's own key chain), or from the device generator."""
        if draws is not None:
            return draws
        if self.draws_from_keys:
            return hessian_draws_from_key(self.env, self._key(key), self.H)
        return self._draw(self.H)

    def get_hessian(self, env_state, env_params, a_mean,
                    draws: Optional[torch.Tensor] = None, key=None):
        """R = d^2 cost / d a^2 around the nominal sequence, by the solver's
        estimator. ``draws`` (H, 3): the per-step uniforms of "periodic" /
        "mixed" (drawn here when not given: from ``key`` under a key-drawing
        rng mode)."""
        return self._hessian(a_mean.flatten(), pack_state(env_state),
                             env_state.time, env_state.pos_traj,
                             env_state.vel_traj, env_params,
                             self._hess_draws(draws, key))

    def design(self, env_state, env_params, a_mean, sample_sigma,
               draws: Optional[torch.Tensor] = None, key=None):
        """(a_cov, factor) around the nominal ``a_mean`` at ``env_state``:
        the Hessian, then the designer."""
        R = self.get_hessian(env_state, env_params, a_mean, draws, key)
        return self._optimize_sigma(R, sample_sigma, self.D)

    @staticmethod
    def _observed(env_state, info):
        """The state the controller acts on: ``info["noisy_state"]`` when
        the env generates one."""
        if info is not None and info.get("noisy_state") is not None:
            return info["noisy_state"]
        return env_state

    # -- speculative mode ------------------------------------------------------
    def prepare(self, env_state, env_params, control_params: CoVOParams,
                info: Optional[dict] = None, draw: Optional[torch.Tensor] = None,
                hess_draws: Optional[torch.Tensor] = None, key=None) -> CoVOParams:
        """Design Sigma for the NEXT step at the model-predicted state: one
        deterministic model step with the action about to be applied
        (``a_mean[0]``; ``draw`` (3,) its disturbance draw), then the
        Hessian (``hess_draws``) and the designer there around the shifted
        nominal; stores ``(a_cov, a_factor)`` for the next :meth:`act`. Off
        the obs->action path: a deployed loop runs it in the idle time after
        the action is sent. From a key (JAX: ``key, k_step = split(key)``):
        the model step's draw from ``k_step``, the Hessian's from ``key``."""
        if self.mode != "speculative":
            raise ValueError("prepare() requires mode='speculative'")
        env_state = self._observed(env_state, info)
        if self.draws_from_keys:
            key, k_step = prng.split(self._key(key))
            if draw is None:
                draw = self.env.disturb_from_key(k_step, deterministic=True)
        elif draw is None:
            draw = self._draw()
        if draw is None:  # the deterministic gaussian step's zero draw
            draw = torch.zeros(3, device=env_state.pos.device)
        x_next = self.env.model_step(env_state, control_params.a_mean[0], env_params,
                                     draw)
        a_cov, factor = self.design(x_next, env_params, _shift(control_params.a_mean),
                                    control_params.sample_sigma, hess_draws, key)
        return control_params.replace(a_cov=a_cov, a_factor=factor)

    def act(self, obs, env_state, env_params, control_params: CoVOParams,
            info: Optional[dict] = None, z: Optional[torch.Tensor] = None,
            draw: Optional[torch.Tensor] = None, key=None):
        """Speculative mode's obs->action path: shift, sample, rollout and
        update with the Sigma prepared last step; no Hessian, no designer."""
        if self.mode != "speculative":
            raise ValueError("act() requires mode='speculative'")
        env_state = self._observed(env_state, info)
        new_mean, costs, weight, poses = self._sample_rollout_update(
            env_state, env_params, control_params, _shift(control_params.a_mean),
            control_params.a_cov, control_params.a_factor, z, draw, key)
        return (new_mean[0], control_params.replace(a_mean=new_mean),
                self._solve_info(costs, weight, control_params.a_cov, poses))

    # -- reset: the speculative cold start and the offline schedule ------------
    def reset(self, env_state=None, env_params=None, control_params=None, key=None):
        """Fresh params for an episode starting at ``env_state``: online
        returns them as they are; speculative designs step 0's Sigma where
        the online mode would (at the reset state, around the shifted
        initial nominal); offline builds the episode's Sigma schedule. A
        key-drawing solver draws both from ``key`` (JAX's ``rng_control``)."""
        if control_params is None:
            control_params = self.init_control_params
        if self.mode == "online" or env_state is None:
            return control_params
        if env_params is None:
            env_params = self.env.default_params
        if self.mode == "speculative":
            a_cov, factor = self.design(env_state, env_params,
                                        _shift(control_params.a_mean),
                                        control_params.sample_sigma, key=key)
            return control_params.replace(a_cov=a_cov, a_factor=factor)
        keys = disturb = None
        if self.draws_from_keys:
            keys, disturb = self.offline_schedule_keys(self._key(key))
        states = self.offline_schedule_inputs(env_state, env_params, disturb)
        a_cov_offline, a_factor_offline = self.offline_sigma_at(
            states, env_params, control_params.sample_sigma, keys)
        return control_params.replace(a_cov_offline=a_cov_offline,
                                      a_factor_offline=a_factor_offline)

    def offline_schedule_keys(self, key: torch.Tensor):
        """The offline schedule's key chain from the reset's key, as JAX's
        (solvers/covo.py:316-318): before step t's state the carried key is
        step t's (returned, (max_steps, 2)); the step then splits twice, the
        PID's key (unused) and the model step's, whose disturbance draws
        (max_steps, 3) are returned beside (None for a model that draws
        nothing). A stack of keys (B, 2) gives (max_steps, B, 2) and
        (max_steps, B, 3), every episode's chain at once."""
        keys, steps = [], []
        for _ in range(self.env.default_params.max_steps_in_episode):
            keys.append(key)
            key = prng.split(key)[..., 1, :]
            rng_step, key = prng.split(key).unbind(-2)
            steps.append(rng_step)
        return (torch.stack(keys),
                self.env.disturb_from_key(torch.stack(steps), deterministic=False))

    def offline_schedule_inputs(self, env_state, env_params,
                                disturb: Optional[torch.Tensor] = None) -> EnvState3D:
        """The offline schedule's states: the PID expansion episode from
        ``env_state``, max_steps stochastic model steps, each state taken
        before its step. ``disturb`` (max_steps, 3) are the steps'
        disturbance draws (tests hand in JAX's; a key-drawing solver its
        key chain's, :meth:`offline_schedule_keys`); by default they come
        from the solver's device generator, in one draw (none for "sin" and
        "drag"). Returns the states stacked on a leading axis."""
        max_steps = self.env.default_params.max_steps_in_episode
        if disturb is None and not self.draws_from_keys:
            disturb = self.env.draw_disturb(self.device_generator, max_steps)
        states, state = [], env_state
        for t in range(max_steps):
            states.append(state)
            action, _, _ = self.expansion(None, state, env_params,
                                          self.expansion_params)
            state = self.env.model_step(state, action, env_params,
                                        None if disturb is None else disturb[t])
        return EnvState3D(**{
            f.name: (torch.stack([getattr(s, f.name) for s in states])
                     if f.name != "control_params" else env_state.control_params)
            for f in dataclasses.fields(EnvState3D)
        })

    def _model_step_b(self, st: EnvState3D, action, params, draw) -> EnvState3D:
        """One deterministic model step of stacked states (leading axis B):
        the fields the PID and the Hessian read. The disturbance after it is
        the model's from the pre-step state under ``draw`` (B, 3) (zero for
        gaussian: the deterministic step zeroes its scale)."""
        u, _ = dynamics.control_to_thrust_omega(action, params)
        det = params.replace(dyn_noise_scale=params.dyn_noise_scale * 0.0)
        for _ in range(self.env.config.substeps):  # as the env's model_step
            x = dynamics.bodyrate_step(pack_state(st), u, params, self.env._dt)
            f = self.env.disturb_fn(det, torch.zeros_like(st.f_disturb) if draw is None
                                    else draw, st.time, st.vel, st.f_disturb)
            time = st.time + 1
            idx = torch.clamp(time, 0, st.pos_traj.shape[-2] - 1).long()
            idx = idx[..., None, None].expand(*idx.shape, 1, 3)

            def at_t(table):
                return torch.gather(table, -2, idx)[..., 0, :]

            st = st.replace(pos=x[..., POS], quat=x[..., QUAT], vel=x[..., VEL],
                            omega=x[..., OMEGA], f_disturb=f,
                            time=time, pos_tar=at_t(st.pos_traj),
                            vel_tar=at_t(st.vel_traj), acc_tar=at_t(st.acc_traj))
        return st

    def _nominal_draws_from_keys(self, keys: torch.Tensor):
        """The per-step draws (H, B, 3) of the nominal PID rollouts from the
        schedule's keys (B, 2), as JAX's (solvers/covo.py:341-343): each step
        splits the carried key twice, the PID's key (unused) and the
        deterministic model step's; None when the model draws nothing
        there."""
        if self.env.config.disturb_type not in dynamics.UNIFORM_DRAW:
            return None
        steps = []
        for _ in range(self.H):
            keys = prng.split(keys)[..., 1, :]
            rng_step, keys = prng.split(keys).unbind(-2)
            steps.append(rng_step)
        return self.env.disturb_from_key(torch.stack(steps), deterministic=True)

    def offline_sigma_at(self, states: EnvState3D, env_params, sample_sigma,
                         keys: Optional[torch.Tensor] = None,
                         step_draws: Optional[torch.Tensor] = None,
                         hess_draws: Optional[torch.Tensor] = None):
        """The schedule's Sigma at B stacked states at once (no loop over
        them): from each, an H-step deterministic PID rollout gives the
        nominal, then the Hessian around it and the plain designer on the
        (B, D, D) stack. ``keys`` (B, 2): each state's schedule key, which a
        key-drawing solver draws the rollout's and the Hessian's draws from,
        as JAX does. Otherwise ``step_draws`` (H, B, 3) and ``hess_draws``
        (B, H, 3), the nominal rollouts' and the Hessians' uniforms of
        "periodic" / "mixed", come from the caller or from the device
        generator. Returns (a_cov, factor), (B, D, D) each."""
        B = states.time.shape[0]
        if self.draws_from_keys:
            step_draws = self._nominal_draws_from_keys(keys)
            hess_draws = hessian_draws_from_key(self.env, keys, self.H)
        elif step_draws is None and hess_draws is None:
            step_draws, hess_draws = self._draw(self.H, B), self._draw(B, self.H)
        st, actions = states, []
        for h in range(self.H):
            action, _, _ = self.expansion(None, st, env_params, self.expansion_params)
            actions.append(action)
            st = self._model_step_b(st, action, env_params,
                                    None if step_draws is None else step_draws[h])
        a_mean = torch.stack(actions, dim=1)  # (B, H, dA)
        R = self._hessian_b(a_mean.reshape(B, self.D), pack_state(states),
                            states.time, states.pos_traj, states.vel_traj,
                            expand_params(env_params, B), hess_draws)
        return self._optimize_sigma(R, sample_sigma, self.D)

    # -- solve -------------------------------------------------------------------
    def __call__(self, obs, env_state, env_params, control_params: CoVOParams,
                 info: Optional[dict] = None, z: Optional[torch.Tensor] = None,
                 draw: Optional[torch.Tensor] = None,
                 hess_draws: Optional[torch.Tensor] = None, key=None):
        """One solve. ``key`` is JAX's ``rng_act`` (key-drawing rng modes).
        ``z`` (N, D) feeds given standard normals to the generator modes'
        sampler, ``draw`` (3,) the rollout's disturbance draw and
        ``hess_draws`` (H, 3) the Hessian's (tests hand in the ones JAX
        drew); by default they come from the solver's generators or key."""
        if self.mode == "speculative":
            action, control_params, out = self.act(obs, env_state, env_params,
                                                   control_params, info, z=z,
                                                   draw=draw, key=key)
            if self.draws_from_keys:
                key = prng.fold_in(key, SPECULATIVE_FOLD)
            return action, self.prepare(env_state, env_params, control_params,
                                        info, hess_draws=hess_draws, key=key), out
        env_state = self._observed(env_state, info)
        a_mean = _shift(control_params.a_mean)
        if self.mode == "online":
            a_cov, factor = self.design(env_state, env_params, a_mean,
                                        control_params.sample_sigma, hess_draws,
                                        key)
        else:
            if control_params.a_factor_offline is None:
                raise ValueError("offline mode: reset(env_state, env_params) "
                                 "builds the Sigma schedule first")
            a_cov = _at(control_params.a_cov_offline, env_state.time)
            factor = _at(control_params.a_factor_offline, env_state.time)
        new_mean, costs, weight, poses = self._sample_rollout_update(
            env_state, env_params, control_params, a_mean, a_cov, factor, z, draw,
            key)
        return (new_mean[0], control_params.replace(a_mean=new_mean, a_cov=a_cov),
                self._solve_info(costs, weight, a_cov, poses))

    def _solve_info(self, costs, weight, a_cov, poses=None) -> dict:
        """The solve's info (JAX: CoVOSolver._solve_info): ``pos_mean`` and
        ``pos_std`` (H, 3) of the sampled rollouts' positions under
        ``collect_debug``, ``metrics`` (the solve and Sigma metrics) under
        ``collect_metrics``."""
        return solve_info(self.collect_metrics, costs, weight, poses,
                          sigma=a_cov)

    def _sample_rollout_update(self, env_state, env_params, control_params,
                               a_mean, a_cov, factor, z, draw=None, key=None):
        """The joint sample + deterministic rollout around the shifted
        ``a_mean`` with the sampling ``factor``, the weights and the mean
        update; returns the new mean (H, dA), the costs (N,), the weights
        (N,) and the poses (H, N, 3) under ``collect_debug`` (else None).
        From a key, JAX's chain: ``key, act_key = split(key)``, ``key,
        step_key = split(key)``; parity samples through ``cholesky(a_cov)``,
        as the reference's ``multivariate_normal`` factors."""
        x0 = pack_state(env_state)
        args = (x0, env_state.time, env_state.pos_traj, env_state.vel_traj)
        kw = dict(deterministic=True, discount=control_params.discount)
        if self.collect_debug:
            kw["collect_poses"] = True
        if self.draws_from_keys:
            rest, act_key = prng.split(self._key(key))
            step_key = prng.split(rest)[1]
            if draw is None:
                draw = self.env.disturb_from_key(
                    step_key, deterministic=True,
                    fast=self.rng_mode != sampling.PARITY)
        elif draw is None:
            draw = self._draw()
        poses = None
        if self.rng_mode == sampling.PARITY:
            chol = torch.linalg.cholesky_ex(a_cov).L.contiguous()
            a = torch.clamp(sampling.sample_joint(act_key, a_mean.flatten(), chol,
                                                  self.N), -1.0, 1.0)
            a = a.reshape(self.N, self.H, self.action_dim)
            out = self.rollout(*args, a, env_params, draw, layout="nhd", **kw)
            a_t = a.permute(1, 2, 0)
        elif self.rollout_sampling is not None:
            out, a_t = self.rollout_sampling(
                *args, a_mean, factor, env_params, self.seeds.next()[0], self.N,
                draw=draw, z=None if z is None else z.T.contiguous(), **kw,
            )
        else:
            src = act_key if self.draws_from_keys else self.device_generator
            a_t = torch.clamp(sampling.sample_joint_t(src, a_mean.flatten(), factor,
                                                      self.N, z=z, mode=self.rng_mode),
                              -1.0, 1.0)
            out = self.rollout(*args, a_t, env_params, draw, layout="hdn", **kw)
        costs = out
        if self.collect_debug:
            costs, poses = out
        weight = reductions.mppi_weights(costs, self.lam)
        new_mean = reductions.mean_update_t(
            weight, a_t.reshape(self.H, self.action_dim, self.N), a_mean,
            control_params.gamma_mean,
        )
        return new_mean, costs, weight, poses

