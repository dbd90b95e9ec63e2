"""CoVO-MPC: covariance-optimal sampling-based MPC, online, speculative and
offline.

Counterpart of :class:`covo_mpc_tpu.solvers.covo.CoVOSolver`. One online
solve, in order:

1. shift the mean;
2. the Hessian of the H-step cost around it, Gauss–Newton
   (``hessian_mode="gn"``) or the exact adjoint (``"adjoint"``): primal
   K2, local derivatives, chain K3 + pullback;
3. the Newton–Schulz Sigma-designer: matmuls + one Cholesky
   (``sigma_mode="ns"``), K8, the whole designer in one launch
   (``"ns_pallas"`` on ``engine="cuda"``), or eigh (``"eigh"``);
4. the joint sample + rollout: K1 (``rng_mode="kernel"``), or z from the
   solver's device generator, then K4 (``engine="cuda"``,
   ``rng_mode="fast"``) or the plain rollout (``engine="torch"``);
5. softmax weights and the mean update.

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
``"cuda"`` for an env on a CUDA device and ``"torch"`` for one on the CPU.
The other Hessian estimators are not ported yet. ``collect_metrics`` puts
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
    pack_state,
    stack_params,
)
from covo_mpc_tpu_torch.ops import covariance, covariance_cuda, reductions, sampling
from covo_mpc_tpu_torch.ops.hessian import make_hessian_adjoint, make_hessian_batched
from covo_mpc_tpu_torch.ops.rollout_cuda import make_rollout_joint_sampling
from covo_mpc_tpu_torch.runtime import metrics
from covo_mpc_tpu_torch.solvers.base import BaseSolver, make_cost_rollout, resolve_engine
from covo_mpc_tpu_torch.solvers.pid import PIDParams, PIDSolver


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
        if hessian_mode not in ("gn", "adjoint"):
            raise NotImplementedError(
                f"hessian_mode {hessian_mode!r} is not ported yet "
                "(use 'gn' or 'adjoint')"
            )
        if collect_debug:
            raise NotImplementedError("debug pose collection is not ported yet")
        engine = resolve_engine(env, engine)
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
        self.mode = mode
        self.rng_mode = rng_mode
        self.hessian_mode = hessian_mode
        self.sigma_mode = sigma_mode
        self.engine = engine
        self.action_dim = env.action_dim
        self.D = H * env.action_dim
        second_order = hessian_mode == "adjoint"
        if mode == "offline":
            # the schedule's Hessians at all its states at once (JAX vmaps
            # its scan primal over the episode); PID expansion policy with
            # the reference's gains
            self._hessian_b = make_hessian_batched(env, H, second_order=second_order)
            self.expansion_params = PIDParams.default(
                env.device, Kp=10.0, Kd=5.0, Ki=0.0, Kp_att=10.0)
            self.expansion = PIDSolver(env, self.expansion_params)
        else:
            part = "cuda" if engine == "cuda" else "torch"
            self._hessian = make_hessian_adjoint(env, H, primal=part, tail=part,
                                                 second_order=second_order)
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
    def get_hessian(self, env_state, env_params, a_mean,
                    draws: Optional[torch.Tensor] = None):
        """R = d^2 cost / d a^2 around the nominal sequence (Gauss–Newton
        or the exact adjoint). ``draws`` (H, 3): the per-step uniforms of
        "periodic" / "mixed" (drawn here when not given)."""
        if draws is None:
            draws = self._draw(self.H)
        return self._hessian(a_mean.flatten(), pack_state(env_state),
                             env_state.time, env_state.pos_traj,
                             env_state.vel_traj, env_params, draws)

    def design(self, env_state, env_params, a_mean, sample_sigma,
               draws: Optional[torch.Tensor] = None):
        """(a_cov, factor) around the nominal ``a_mean`` at ``env_state``:
        the Hessian, then the designer."""
        R = self.get_hessian(env_state, env_params, a_mean, draws)
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
                hess_draws: Optional[torch.Tensor] = None) -> CoVOParams:
        """Design Sigma for the NEXT step at the model-predicted state: one
        deterministic model step with the action about to be applied
        (``a_mean[0]``; ``draw`` (3,) its disturbance draw), then the
        Hessian (``hess_draws``) and the designer there around the shifted
        nominal; stores ``(a_cov, a_factor)`` for the next :meth:`act`. Off
        the obs->action path: a deployed loop runs it in the idle time after
        the action is sent."""
        if self.mode != "speculative":
            raise ValueError("prepare() requires mode='speculative'")
        env_state = self._observed(env_state, info)
        if draw is None:
            draw = self._draw()
        if draw is None:  # the deterministic gaussian step's zero draw
            draw = torch.zeros(3, device=env_state.pos.device)
        x_next = self.env.raw_step(env_state, control_params.a_mean[0], env_params,
                                   draw)
        a_cov, factor = self.design(x_next, env_params, _shift(control_params.a_mean),
                                    control_params.sample_sigma, hess_draws)
        return control_params.replace(a_cov=a_cov, a_factor=factor)

    def act(self, obs, env_state, env_params, control_params: CoVOParams,
            info: Optional[dict] = None, z: Optional[torch.Tensor] = None,
            draw: Optional[torch.Tensor] = None):
        """Speculative mode's obs->action path: shift, sample, rollout and
        update with the Sigma prepared last step; no Hessian, no designer."""
        if self.mode != "speculative":
            raise ValueError("act() requires mode='speculative'")
        env_state = self._observed(env_state, info)
        new_mean, costs, weight = self._sample_rollout_update(
            env_state, env_params, control_params, _shift(control_params.a_mean),
            control_params.a_factor, z, draw)
        return (new_mean[0], control_params.replace(a_mean=new_mean),
                self._solve_info(costs, weight, control_params.a_cov))

    # -- reset: the speculative cold start and the offline schedule ------------
    def reset(self, env_state=None, env_params=None, control_params=None):
        """Fresh params for an episode starting at ``env_state``: online
        returns them as they are; speculative designs step 0's Sigma where
        the online mode would (at the reset state, around the shifted
        initial nominal); offline builds the episode's Sigma schedule."""
        if control_params is None:
            control_params = self.init_control_params
        if self.mode == "online" or env_state is None:
            return control_params
        if env_params is None:
            env_params = self.env.default_params
        if self.mode == "speculative":
            a_cov, factor = self.design(env_state, env_params,
                                        _shift(control_params.a_mean),
                                        control_params.sample_sigma)
            return control_params.replace(a_cov=a_cov, a_factor=factor)
        states = self.offline_schedule_inputs(env_state, env_params)
        a_cov_offline, a_factor_offline = self.offline_sigma_at(
            states, env_params, control_params.sample_sigma)
        return control_params.replace(a_cov_offline=a_cov_offline,
                                      a_factor_offline=a_factor_offline)

    def offline_schedule_inputs(self, env_state, env_params,
                                disturb: Optional[torch.Tensor] = None) -> EnvState3D:
        """The offline schedule's states: the PID expansion episode from
        ``env_state``, max_steps stochastic model steps, each state taken
        before its step. ``disturb`` (max_steps, 3) are the steps'
        disturbance draws (tests hand in JAX's); by default they come from
        the solver's device generator, in one draw (none for "sin" and
        "drag"). Returns the states stacked on a leading axis."""
        max_steps = self.env.default_params.max_steps_in_episode
        if disturb is None:
            disturb = self.env.draw_disturb(self.device_generator, max_steps)
        states, state = [], env_state
        for t in range(max_steps):
            states.append(state)
            action, _, _ = self.expansion(None, state, env_params,
                                          self.expansion_params)
            state = self.env.raw_step(state, action, env_params,
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
        x = dynamics.bodyrate_step(pack_state(st), u, params, self.env._dt)
        det = params.replace(dyn_noise_scale=params.dyn_noise_scale * 0.0)
        f = self.env.disturb_fn(det, torch.zeros_like(st.f_disturb) if draw is None
                                else draw, st.time, st.vel, st.f_disturb)
        time = st.time + 1
        idx = torch.clamp(time, 0, st.pos_traj.shape[-2] - 1).long()
        idx = idx[..., None, None].expand(*idx.shape, 1, 3)

        def at_t(table):
            return torch.gather(table, -2, idx)[..., 0, :]

        return st.replace(pos=x[..., POS], quat=x[..., QUAT], vel=x[..., VEL],
                          omega=x[..., OMEGA], f_disturb=f,
                          time=time, pos_tar=at_t(st.pos_traj),
                          vel_tar=at_t(st.vel_traj), acc_tar=at_t(st.acc_traj))

    def offline_sigma_at(self, states: EnvState3D, env_params, sample_sigma):
        """The schedule's Sigma at B stacked states at once (no loop over
        them): from each, an H-step deterministic PID rollout gives the
        nominal, then the Hessian around it and the plain designer on the
        (B, D, D) stack. Returns (a_cov, factor), (B, D, D) each."""
        B = states.time.shape[0]
        st, actions = states, []
        step_draws = self._draw(self.H, B)
        for h in range(self.H):
            action, _, _ = self.expansion(None, st, env_params, self.expansion_params)
            actions.append(action)
            st = self._model_step_b(st, action, env_params,
                                    None if step_draws is None else step_draws[h])
        a_mean = torch.stack(actions, dim=1)  # (B, H, dA)
        R = self._hessian_b(a_mean.reshape(B, self.D), pack_state(states),
                            states.time, states.pos_traj, states.vel_traj,
                            stack_params([env_params] * B), self._draw(B, self.H))
        return self._optimize_sigma(R, sample_sigma, self.D)

    # -- solve -------------------------------------------------------------------
    def __call__(self, obs, env_state, env_params, control_params: CoVOParams,
                 info: Optional[dict] = None, z: Optional[torch.Tensor] = None,
                 draw: Optional[torch.Tensor] = None,
                 hess_draws: Optional[torch.Tensor] = None):
        """One solve. ``z`` (N, D) feeds given standard normals to the
        sampler, ``draw`` (3,) the rollout's disturbance draw and
        ``hess_draws`` (H, 3) the Hessian's (tests hand in the ones JAX
        drew); by default they come from the solver's generators."""
        if self.mode == "speculative":
            action, control_params, out = self.act(obs, env_state, env_params,
                                                   control_params, info, z=z,
                                                   draw=draw)
            return action, self.prepare(env_state, env_params, control_params,
                                        info, hess_draws=hess_draws), out
        env_state = self._observed(env_state, info)
        a_mean = _shift(control_params.a_mean)
        if self.mode == "online":
            a_cov, factor = self.design(env_state, env_params, a_mean,
                                        control_params.sample_sigma, hess_draws)
        else:
            if control_params.a_factor_offline is None:
                raise ValueError("offline mode: reset(env_state, env_params) "
                                 "builds the Sigma schedule first")
            a_cov = _at(control_params.a_cov_offline, env_state.time)
            factor = _at(control_params.a_factor_offline, env_state.time)
        new_mean, costs, weight = self._sample_rollout_update(
            env_state, env_params, control_params, a_mean, factor, z, draw)
        return (new_mean[0], control_params.replace(a_mean=new_mean, a_cov=a_cov),
                self._solve_info(costs, weight, a_cov))

    def _solve_info(self, costs, weight, a_cov) -> dict:
        """The solve's info: ``{"metrics": solve and Sigma metrics}`` under
        ``collect_metrics`` (JAX: CoVOSolver._solve_info), else empty."""
        if not self.collect_metrics:
            return {}
        return {"metrics": {**metrics.solve_metrics(costs, weight),
                            **metrics.sigma_metrics(a_cov)}}

    def _sample_rollout_update(self, env_state, env_params, control_params,
                               a_mean, factor, z, draw=None):
        """The joint sample + deterministic rollout around the shifted
        ``a_mean`` with the sampling ``factor``, the weights and the mean
        update; returns the new mean (H, dA), the costs (N,) and the
        weights (N,)."""
        x0 = pack_state(env_state)
        args = (x0, env_state.time, env_state.pos_traj, env_state.vel_traj)
        if draw is None:
            draw = self._draw()
        if self.rollout_sampling is not None:
            costs, a_t = self.rollout_sampling(
                *args, a_mean, factor, env_params, self.seeds.next()[0], self.N,
                deterministic=True, discount=control_params.discount, draw=draw,
                z=None if z is None else z.T.contiguous(),
            )
        else:
            a_t = torch.clamp(
                sampling.sample_joint_t(self.device_generator, a_mean.flatten(),
                                        factor, self.N, z=z),
                -1.0, 1.0,
            )
            costs = self.rollout(*args, a_t, env_params, draw, deterministic=True,
                                 discount=control_params.discount, layout="hdn")

        weight = reductions.mppi_weights(costs, self.lam)
        new_mean = reductions.mean_update_t(
            weight, a_t.reshape(self.H, self.action_dim, self.N), a_mean,
            control_params.gamma_mean,
        )
        return new_mean, costs, weight
