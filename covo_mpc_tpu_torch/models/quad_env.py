"""Quad3D environment in PyTorch: reset, step, auto-reset, info, obs.

Counterpart of :mod:`covo_mpc_tpu.models.quad_env`, with a ``device`` (the
card by default; ``device="cpu"`` asks for the CPU). Every random number an
env method needs comes from one small draw method (:meth:`QuadEnv.draw_reset`,
:meth:`QuadEnv.draw_step`, :meth:`QuadEnv.draw_params`) and enters a pure
method (:meth:`QuadEnv.reset_from_draws`, :meth:`QuadEnv.step_from_draws`,
:meth:`QuadEnv.params_from_draws`) as a tensor, so tests can inject the
numbers JAX drew. A draw method takes a ``torch.Generator``, or a JAX key
(``utils/prng.py``), and then draws what JAX's env draws from that key, in
JAX's key tree: ``reset(key)``, ``step(key)`` and ``sample_params(key)``
give JAX's values.

Reference quirks kept: reward and termination on the PRE-step state; the
disturbance updated from the pre-step state; ``noisy_state`` at the
default ``obs_noise_scale``; the auto-reset ``step`` computes both the
stepped and the reset state and selects with ``torch.where`` (no host
sync).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from covo_mpc_tpu_torch.models import dynamics, rewards, trajectory
from covo_mpc_tpu_torch.models.structs import (
    EnvParams3D,
    EnvState3D,
    pack_state,
    tree_select,
)
from covo_mpc_tpu_torch.utils import prng

# obs-noise layout of the (13,) standard-normal draw: field -> (slice of the
# draw, factor on obs_noise_scale)
_NOISE = {"pos": (slice(0, 3), 0.25), "vel": (slice(3, 6), 0.5),
          "quat": (slice(6, 10), 0.02), "omega": (slice(10, 13), 0.5)}


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration (same fields as the JAX EnvConfig)."""

    task: str = "tracking"
    obs_type: str = "quad"
    enable_randomizer: bool = True
    lower_controller: str = "base"
    disturb_type: str = "periodic"
    disable_rollover_terminate: bool = False
    generate_noisy_state: bool = False
    substeps: int = 1


@dataclasses.dataclass
class ResetDraws:
    traj: trajectory.TrajDraws  # the task's generator's draws
    f_disturb: torch.Tensor  # (3,) uniform in [-1, 1)
    obs_noise: Optional[torch.Tensor]  # (13,) standard normals


@dataclasses.dataclass
class StepDraws:
    # (3,) the disturbance model's draw (QuadEnv.draw_disturb): standard
    # normals, uniforms in [-disturb_scale, disturb_scale), or None
    disturb: Optional[torch.Tensor]
    obs_noise: Optional[torch.Tensor]  # (13,) standard normals


class QuadEnv:
    """Crazyflie-2 quadrotor with first-order bodyrate dynamics."""

    def __init__(self, config: EnvConfig = EnvConfig(), device="cuda",
                 **overrides):
        if overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("QuadEnv: no CUDA device; the port runs on the "
                               "card unless asked for the CPU (device='cpu')")

        defaults = EnvParams3D.default("cpu")
        self._max_steps = defaults.max_steps_in_episode
        self._dt = float(defaults.dt)
        self._traj_obs_len = defaults.traj_obs_len
        self._traj_obs_gap = defaults.traj_obs_gap
        self._adapt_horizon = defaults.adapt_horizon
        self._obs_noise_scale = float(defaults.obs_noise_scale)

        self._draw_traj, self._traj_from_draws = trajectory.get_generator(
            config.task
        )
        self.reward_fn = rewards.get_reward_fn(config.task)
        self.reward_name = rewards.get_reward_name(config.task)
        self.disturb_fn = dynamics.get_disturb_fn(config.disturb_type)
        if config.lower_controller != "base":
            raise NotImplementedError("only the 'base' lower controller is supported")
        obs = {
            "quad": (self.get_obs_quadonly, 19 + self._traj_obs_len * 6),
            "quad_params": (self.get_obs_quad_params,
                            19 + self._traj_obs_len * 6 + 18),
            "params": (self.get_obs_paramsonly, 18),
            "adapt_hist": (self.get_obs_adapt_hist, self._adapt_horizon * 22),
        }
        if config.obs_type not in obs:
            raise NotImplementedError(f"unknown obs_type {config.obs_type!r}")
        self.get_obs, self.obs_dim = obs[config.obs_type]
        self.action_dim = 4
        self.default_control_params = 0.0
        self._default_params = EnvParams3D.default(self.device)

    # -- parameters ---------------------------------------------------------
    @property
    def default_params(self) -> EnvParams3D:
        return self._default_params

    def draw_params(self, gen) -> torch.Tensor:
        """The uniforms in [-1, 1) that :meth:`params_from_draws` maps to
        parameters: 17 under domain randomization, else 6. From a key, JAX's
        (quad_env.py:117-133): ``uniform(split(key)[0], (17,))`` under DR,
        ``uniform(key, (6,))`` without."""
        n = 17 if self.config.enable_randomizer else 6
        if prng.is_key(gen):
            key = prng.split(gen)[0] if self.config.enable_randomizer else gen
            return prng.uniform(key, (n,), -1.0, 1.0)
        return torch.rand(n, generator=gen, device=self.device) * 2.0 - 1.0

    def params_from_draws(self, u: torch.Tensor) -> EnvParams3D:
        """Domain-randomized (or default) parameters from the uniforms of
        :meth:`draw_params` (JAX: QuadEnv.sample_params). DR sets m,
        I_diag, action_scale, alpha_bodyrate around their means and
        disturb_params to u[6:12] x disturb_scale (u[12:17] unused, as in
        the reference); without DR only disturb_params is drawn, unscaled."""
        p = self.default_params
        if not self.config.enable_randomizer:
            return p.replace(disturb_params=u)
        return p.replace(
            m=p.m_mean + u[0] * p.m_std,
            I_diag=p.I_diag_mean + u[1:4] * p.I_diag_std,
            action_scale=p.action_scale_mean + u[4] * p.action_scale_std,
            alpha_bodyrate=p.alpha_bodyrate_mean + u[5] * p.alpha_bodyrate_std,
            disturb_params=u[6:12] * p.disturb_scale,
        )

    def sample_params(self, gen) -> EnvParams3D:
        return self.params_from_draws(self.draw_params(gen))

    # -- error metrics ------------------------------------------------------
    @staticmethod
    def get_err_pos(state: EnvState3D) -> torch.Tensor:
        return torch.linalg.norm(state.pos_tar - state.pos)

    @staticmethod
    def get_err_vel(state: EnvState3D) -> torch.Tensor:
        return torch.linalg.norm(state.vel_tar - state.vel)

    # -- draws --------------------------------------------------------------
    def _draw_obs_noise(self, gen):
        """The (13,) normals of ``noisy_state``; from a key (get_info's
        ``info_key``), JAX's four from ``split(key, 5)``: pos (3), vel (3),
        quat (4), omega (3), drawn as one (4, 4) draw of which each takes
        its first elements (a shape's bits are a prefix of a longer one's)."""
        if not self.config.generate_noisy_state:
            return None
        if prng.is_key(gen):
            z = prng.normal(prng.split(gen, 5)[:4], (4,))
            return torch.cat([z[0, :3], z[1, :3], z[2], z[3, :3]])
        return torch.randn(13, generator=gen, device=self.device)

    def draw_reset(self, gen) -> ResetDraws:
        """A reset's draws from a generator, or from a key as JAX's reset_env
        draws them (quad_env.py:149-187): the trajectory from ``split(key,
        3)[0]``, the force's uniforms from ``[1]`` (held here over
        ``disturb_scale``, which the reset multiplies back exactly) and the
        obs noise from ``split(key)[0]``, the trajectory's own key (a split's
        key i does not depend on the count)."""
        if prng.is_key(gen):
            traj_key, disturb_key, _ = prng.split(gen, 3)
            scale = self._default_params.disturb_scale
            f = prng.uniform(disturb_key, (3,), -scale, scale)
            return ResetDraws(
                traj=self._draw_traj(traj_key, self._max_steps, self.device),
                f_disturb=f / scale,
                obs_noise=self._draw_obs_noise(traj_key),
            )
        return ResetDraws(
            traj=self._draw_traj(gen, self._max_steps, self.device),
            f_disturb=torch.rand(3, generator=gen, device=self.device) * 2.0 - 1.0,
            obs_noise=self._draw_obs_noise(gen),
        )

    def draw_disturb(self, gen: torch.Generator, *batch: int,
                     deterministic: bool = False) -> Optional[torch.Tensor]:
        """The draws (*batch, 3) the disturbance model takes for one step,
        or for one rollout (which shares its draw across samples and steps):
        standard normals for "gaussian" and "none" (None when
        ``deterministic``: the zeroed noise scale needs none), uniforms in
        [-disturb_scale, disturb_scale) for "periodic" and "mixed" (drawn
        even when deterministic: only the gaussian scale is zeroed), None
        for "sin" and "drag"."""
        kind = self.config.disturb_type
        if kind in dynamics.UNIFORM_DRAW:
            u = torch.rand(*batch, 3, generator=gen, device=self.device)
            return (u * 2.0 - 1.0) * self._default_params.disturb_scale
        if kind in ("gaussian", "none") and not deterministic:
            return torch.randn(*batch, 3, generator=gen, device=self.device)
        return None

    def disturb_from_key(self, key: torch.Tensor, deterministic: bool = False,
                         fast: bool = False) -> Optional[torch.Tensor]:
        """:meth:`draw_disturb` from a step key as JAX's env step draws it:
        the reference's key chain (``fast``: none), then the model's draw
        (``models/dynamics.disturb_draw_from_key``); maps over a stack of
        keys."""
        return dynamics.disturb_draw_from_key(
            self.config.disturb_type, dynamics.derive_dynamics_keys(key, fast),
            self._default_params.disturb_scale, deterministic)

    def draw_step(self, gen) -> StepDraws:
        """A step's draws from a generator, or from a key as JAX's step_env
        draws them: the disturbance through the reference's key chain
        (quad_env.py:284, dynamics.py:177-200) and the obs noise from
        ``split(key)[0]``."""
        if prng.is_key(gen):
            halves = prng.split(gen)  # [the info key, the chain's first]
            disturb = dynamics.disturb_draw_from_key(
                self.config.disturb_type, dynamics.dynamics_keys_after_split(halves),
                self._default_params.disturb_scale)
            return StepDraws(disturb=disturb, obs_noise=self._draw_obs_noise(halves[0]))
        return StepDraws(
            disturb=self.draw_disturb(gen),
            obs_noise=self._draw_obs_noise(gen),
        )

    # -- reset --------------------------------------------------------------
    def get_zero_state(self, draws: ResetDraws, params: EnvParams3D) -> EnvState3D:
        """Initial state at the origin on a fresh trajectory."""
        pos_traj, vel_traj, acc_traj = self._traj_from_draws(
            self._max_steps, self._dt, draws.traj
        )
        zeros3 = torch.zeros(3, device=self.device)
        hist = self._adapt_horizon + 2
        quat = torch.zeros(4, device=self.device)
        # a fill kernel: item assignment would copy a host scalar to the
        # device, which syncs (and cannot be captured)
        quat[3:].fill_(1.0)
        return EnvState3D(
            pos=zeros3, vel=zeros3, omega=zeros3, omega_tar=zeros3, quat=quat,
            pos_tar=pos_traj[0], vel_tar=vel_traj[0], acc_tar=acc_traj[0],
            pos_traj=pos_traj, vel_traj=vel_traj, acc_traj=acc_traj,
            last_thrust=torch.zeros((), device=self.device),
            last_torque=zeros3,
            time=torch.zeros((), dtype=torch.int32, device=self.device),
            f_disturb=draws.f_disturb * params.disturb_scale,
            vel_hist=torch.zeros(hist, 3, device=self.device),
            omega_hist=torch.zeros(hist, 3, device=self.device),
            action_hist=torch.zeros(hist, 4, device=self.device),
            control_params=self.default_control_params,
        )

    def reset_from_draws(self, draws: ResetDraws, params: EnvParams3D):
        """Returns (obs, info, state)."""
        state = self.get_zero_state(draws, params)
        info = self.get_info(state, state, params, draws.obs_noise)
        return self.get_obs(state, params), info, state

    def reset_env(self, gen, params: EnvParams3D):
        return self.reset_from_draws(self.draw_reset(gen), params)

    def reset(self, gen, params: Optional[EnvParams3D] = None):
        return self.reset_env(gen, self.default_params if params is None else params)

    # -- step ---------------------------------------------------------------
    def raw_step(self, state: EnvState3D, sub_action: torch.Tensor,
                 params: EnvParams3D,
                 disturb_draw: Optional[torch.Tensor]) -> EnvState3D:
        """One dynamics step + bookkeeping over the packed state;
        ``disturb_draw`` is the disturbance model's draw (:meth:`draw_disturb`)."""
        sub_action = torch.clamp(sub_action, -1.0, 1.0)
        u, torque = dynamics.control_to_thrust_omega(sub_action, params)
        thrust = u[..., 0]
        x_new = dynamics.bodyrate_step(pack_state(state), u, params, self._dt)

        # disturbance update from the PRE-step state
        f_disturb = self.disturb_fn(params, disturb_draw, state.time, state.vel,
                                    state.f_disturb)

        time = state.time + 1
        # a (1,) index: indexing with a 0-d tensor would read it on the host
        t_idx = torch.clamp(time, 0, state.pos_traj.shape[0] - 1).long()[None]

        def at_t(table):
            return table.index_select(0, t_idx)[0]

        normed_action = torch.cat(
            [thrust[None] / params.max_thrust * 2.0 - 1.0,
             torque / params.max_torque]
        )
        return state.replace(
            pos=x_new[0:3], quat=x_new[3:7], vel=x_new[7:10],
            omega=x_new[10:13],
            pos_tar=at_t(state.pos_traj), vel_tar=at_t(state.vel_traj),
            acc_tar=at_t(state.acc_traj),
            omega_tar=u[1:4], last_thrust=thrust, last_torque=torque,
            time=time, f_disturb=f_disturb,
            vel_hist=torch.cat([state.vel_hist[1:], state.vel[None]]),
            omega_hist=torch.cat([state.omega_hist[1:], state.omega[None]]),
            action_hist=torch.cat([state.action_hist[1:], normed_action[None]]),
        )

    def model_step(self, state: EnvState3D, action: torch.Tensor, params: EnvParams3D,
                   disturb_draw: Optional[torch.Tensor]) -> EnvState3D:
        """``config.substeps`` calls of :meth:`raw_step` on one action under one
        disturbance draw (JAX scans the lower controller, "base": the
        identity, and ``raw_step`` under one key; quad_env.py:272-280)."""
        for _ in range(self.config.substeps):
            state = self.raw_step(state, action, params, disturb_draw)
        return state

    def step_from_draws(self, draws: StepDraws, state: EnvState3D,
                        action: torch.Tensor, params: EnvParams3D,
                        deterministic: bool = False):
        """Returns (obs, next_state, reward, done, info). Reward and
        termination are evaluated on the PRE-step state."""
        action = torch.clamp(action, -1.0, 1.0)
        if deterministic:
            params = params.replace(dyn_noise_scale=params.dyn_noise_scale * 0.0)
        next_state = self.model_step(state, action, params, draws.disturb)
        reward = self.reward_fn(state, params)
        done = self.is_terminal(state, params)
        info = self.get_info(state, next_state, params, draws.obs_noise)
        return self.get_obs(next_state, params), next_state, reward, done, info

    def step_env(self, gen, state: EnvState3D,
                 action: torch.Tensor, params: EnvParams3D,
                 deterministic: bool = False):
        return self.step_from_draws(self.draw_step(gen), state, action,
                                    params, deterministic)

    def step(self, gen, state: EnvState3D,
             action: torch.Tensor, params: Optional[EnvParams3D] = None):
        """Auto-resetting step: run both step_env and reset_env, select on
        ``done`` with ``torch.where`` (no host sync). ``gen``: a generator,
        both draw from in turn, or a key, split as JAX's step splits it
        (``key, key_reset``; quad_env.py:301)."""
        params = self.default_params if params is None else params
        step_src = reset_src = gen
        if prng.is_key(gen):
            step_src, reset_src = prng.split(gen)
        obs_st, state_st, reward, done, info = self.step_env(
            step_src, state, action, params
        )
        obs_re, info_re, state_re = self.reset_env(reset_src, params)
        state = tree_select(done, state_re, state_st)
        info = tree_select(done, info_re, info)
        obs = torch.where(done, obs_re, obs_st)
        return obs, state, reward, done, info

    # -- info / termination -------------------------------------------------
    def get_info(self, state: EnvState3D, next_state: EnvState3D,
                 params: EnvParams3D, obs_noise: Optional[torch.Tensor]) -> dict:
        """``noisy_state`` injects observation noise into the controller's
        view of the next state at the DEFAULT obs_noise_scale."""
        noisy_state = None
        if self.config.generate_noisy_state:
            s = self._obs_noise_scale
            noisy_state = next_state.replace(**{
                name: getattr(next_state, name) + obs_noise[sl] * s * k
                for name, (sl, k) in _NOISE.items()
            })
        terminal = self.is_terminal(state, params)
        return {
            "discount": torch.where(terminal, 0.0, 1.0),
            "err_pos": self.get_err_pos(state),
            "err_vel": self.get_err_vel(state),
            "obs_param": self.get_obs_paramsonly(state, params),
            "obs_adapt": self.get_obs_adapt_hist(state, params),
            "noisy_state": noisy_state,
        }

    def is_terminal(self, state: EnvState3D, params: EnvParams3D) -> torch.Tensor:
        done = (state.time >= params.max_steps_in_episode) | (
            torch.abs(state.pos) > 3.0
        ).any()
        if not self.config.disable_rollover_terminate:
            rollover = (state.quat[3] < math.cos(math.pi / 4.0)) | (
                torch.abs(state.omega) > 100.0
            ).any()
            done = done | rollover
        return done

    # -- observations -------------------------------------------------------
    def get_obs_quadonly(self, state: EnvState3D, params: EnvParams3D):
        """49-dim state + future-trajectory window."""
        indices = (state.time + 1 + torch.arange(
            self._traj_obs_len, device=self.device) * self._traj_obs_gap)
        indices = torch.clamp(indices, 0, state.pos_traj.shape[0] - 1).long()
        return torch.cat([
            state.pos, state.vel / 3.0, state.quat, state.omega / 5.0,
            state.pos_tar, state.vel_tar / 3.0,
            state.pos_traj[indices].flatten(),
            state.vel_traj[indices].flatten() / 3.0,
        ])

    def get_obs_paramsonly(self, state: EnvState3D, params: EnvParams3D):
        """Normalized parameter observation."""
        return torch.cat([
            (params.I_diag - params.I_diag_mean) / params.I_diag_std,
            state.f_disturb / params.disturb_scale,
            (params.hook_offset - params.hook_offset_mean) / params.hook_offset_std,
            params.disturb_params,
            torch.stack([
                (params.m - params.m_mean) / params.m_std,
                (params.action_scale - params.action_scale_mean)
                / params.action_scale_std,
                (params.alpha_bodyrate - params.alpha_bodyrate_mean)
                / params.alpha_bodyrate_std,
            ]),
        ])

    def get_obs_adapt_hist(self, state: EnvState3D, params: EnvParams3D):
        """History + finite-difference features for adaptation."""
        dvel = torch.diff(state.vel_hist, dim=0)
        ddvel = torch.diff(dvel, dim=0)
        domega = torch.diff(state.omega_hist, dim=0)
        ddomega = torch.diff(domega, dim=0)
        h = self._adapt_horizon
        return torch.cat([
            state.vel_hist[-h:].flatten(), state.omega_hist[-h:].flatten(),
            state.action_hist[-h:].flatten(), dvel[-h:].flatten(),
            ddvel[-h:].flatten(), domega[-h:].flatten(), ddomega[-h:].flatten(),
        ])

    def get_obs_quad_params(self, state: EnvState3D, params: EnvParams3D):
        return torch.cat([self.get_obs_quadonly(state, params),
                          self.get_obs_paramsonly(state, params)])
