"""Batched rollout engine (plain PyTorch path).

Counterpart of :func:`covo_mpc_tpu.ops.rollout.make_rollout`: N samples x
H steps of quadrotor dynamics plus cost accumulation, as one wide tensor
program over packed states ``(N, 16)``, with a Python loop over the
horizon. It is the ``engine="torch"`` rollout and the plain version the
joint sample + rollout kernel is checked against.

Semantics kept: rewards on PRE-step states, frozen once a sample has
terminated (the freeze reads ``d_prev``); termination reads
``max_steps_in_episode`` from the runtime params; one disturbance draw is
shared by every sample and step (the reference's key-reuse quirk). The
force rides each sample's state: step 0 integrates x0's own, step h + 1 the
model's output at time t0 + h from the PRE-step velocity and force (JAX:
ops/rollout.py:132-149; for "gaussian" and "none" that is the one shared
force). A deterministic rollout zeroes only the gaussian scale: "periodic"
and "mixed" still take their uniform draw. ``collect_poses`` also returns
each step's post-step positions, JAX's debug poses.

:func:`make_hessian_cost` is the reference's Hessian objective, one
differentiable deterministic rollout (JAX: ops/rollout.make_hessian_cost),
which the generic estimators (``ops/covariance.make_hessian``) differentiate
twice; :func:`hessian_draws_from_key` gives its per-step draws from JAX's
per-step key split.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from covo_mpc_tpu_torch.models import dynamics, rewards
from covo_mpc_tpu_torch.models.quad_env import QuadEnv
from covo_mpc_tpu_torch.models.structs import FDIST, OMEGA, POS, QUAT, VEL, vmap_trees
from covo_mpc_tpu_torch.utils import prng


def make_reward(env: QuadEnv):
    """``reward(x, pos_tar, vel_tar)`` on a packed state (..., 13 or 16):
    the env's cost model by ``env.reward_name``, penyaw or realworld (which
    reads no velocity target). JAX: ops/rollout._make_reward."""
    if env.reward_name == "realworld":
        def reward(x, pos_tar, vel_tar):
            return rewards.tracking_realworld_reward(x[..., POS], x[..., QUAT], pos_tar)
    else:
        def reward(x, pos_tar, vel_tar):
            return rewards.tracking_penyaw_reward(x[..., POS], x[..., VEL],
                                                  x[..., QUAT], pos_tar, vel_tar)
    return reward


def _make_done(env: QuadEnv):
    check_rollover = not env.config.disable_rollover_terminate
    cos_45 = math.cos(math.pi / 4.0)

    def done_fn(x, t, max_steps):
        """Termination on the pre-step state; ``max_steps`` comes from the
        runtime params."""
        d = (t >= max_steps) | (torch.abs(x[..., POS]) > 3.0).any(dim=-1)
        if check_rollover:
            d = d | (x[..., QUAT][..., 3] < cos_45)
            d = d | (torch.abs(x[..., OMEGA]) > 100.0).any(dim=-1)
        return d

    return done_fn


def check_draw(env: QuadEnv, draw: Optional[torch.Tensor],
               deterministic: bool) -> None:
    """Raise unless a rollout that needs a draw got one: a stochastic
    gaussian rollout its normals, a "periodic" or "mixed" one (deterministic
    or not) its uniforms."""
    kind = env.config.disturb_type
    if draw is None and (kind in dynamics.UNIFORM_DRAW
                         or (kind == "gaussian" and not deterministic)):
        raise ValueError(f"a {'deterministic' if deterministic else 'stochastic'} "
                         f"{kind} rollout needs its draw")


def target_window(t0, pos_traj, vel_traj, H: int, offset: int = 0):
    """(H, 3) position and velocity targets at times t0+offset .. +H-1,
    clamped at the table end (a device gather: no host sync). A leading
    scenario axis on ``t0`` (B,) and the tables (B, T, 3) gives (B, H, 3)."""
    T = pos_traj.shape[-2]
    if not isinstance(t0, torch.Tensor):
        t0 = torch.as_tensor(t0, device=pos_traj.device)
    steps = torch.arange(H, device=pos_traj.device)
    idx = torch.clamp(t0[..., None] + offset + steps, 0, T - 1).long()
    idx = idx[..., None].expand(*idx.shape, 3)
    return torch.gather(pos_traj, -2, idx), torch.gather(vel_traj, -2, idx)


def step_times(t0, K: int, device) -> torch.Tensor:
    """(..., K) the times t0 .. t0 + K - 1 (a leading scenario axis on t0
    carries through)."""
    return torch.as_tensor(t0, device=device)[..., None] + torch.arange(K, device=device)


def sin_table(params, t0, K: int, device) -> torch.Tensor:
    """(..., K, 3): the "sin" model at times t0 .. t0 + K - 1, closed form."""
    times = step_times(t0, K, device).movedim(-1, 0)  # the model's time axes lead
    return dynamics.sin_disturb(params, None, times, None, None).movedim(0, -2)


def periodic_table(params, f0, t0, draws, K: int) -> torch.Tensor:
    """(..., K, 3): the "periodic" model's output at times t0 .. t0 + K - 1
    chained from ``f0``: the draw of the last redraw at or before each time,
    f0 before the first. ``draws`` is one draw (..., 3) every step shares
    (a rollout's) or (..., K, 3), one per step (the Hessian's)."""
    times = step_times(t0, K, f0.device)
    # step index of the last redraw at or before each time (< 0: none yet)
    k = times - times % params.disturb_period - times[..., :1]
    if draws.dim() == f0.dim():
        picked = draws[..., None, :]
    else:
        idx = k.clamp(min=0).long()[..., None].expand(*k.shape, 3)
        picked = torch.gather(draws, -2, idx)
    return torch.where((k >= 0)[..., None], picked, f0[..., None, :])


def disturb_table(env: QuadEnv, params, f0, t0, draws, H: int) -> torch.Tensor:
    """(..., H, 3): the force in effect during each step of a rollout whose
    force does not depend on its state: ``f0`` at step 0, then the model's
    output at time t0 + h - 1 (JAX: rollout_pallas.build_disturb_table and
    hessian.build_hessian_disturb_table). "gaussian" / "none" give zeros
    after f0 (a deterministic rollout's); "periodic" takes ``draws`` (see
    :func:`periodic_table`, one per step of H - 1)."""
    kind = env.config.disturb_type
    if kind in ("gaussian", "none"):
        rest = f0.new_zeros(*f0.shape[:-1], H - 1, 3)
    elif kind == "sin":
        rest = sin_table(params, t0, H - 1, f0.device)
    elif kind == "periodic":
        rest = periodic_table(params, f0, t0, draws, H - 1)
    else:
        raise ValueError(f"the {kind!r} force depends on the state: no table")
    return torch.cat([f0[..., None, :], rest], dim=-2)


def make_rollout(env: QuadEnv):
    """Build ``rollout_costs(x0, t0, pos_traj, vel_traj, actions, params,
    draw=None, deterministic=False, discount=1.0, layout="nhd",
    collect_poses=False) -> costs (N,)``.

    ``actions`` is (N, H, 4) for ``layout="nhd"``, or (H, 4, N) / (H*4, N)
    for ``layout="hdn"`` (the samplers' sample-last layout). Cost is the
    negated discounted sum of the env's reward (:func:`make_reward`).
    ``draw`` (3,) is the disturbance model's draw shared by the rollout
    (:meth:`QuadEnv.draw_disturb`). ``collect_poses`` returns ``(costs,
    poses)`` instead, poses (H, N, 3) the positions after each step (JAX's
    debug poses).
    """
    reward = make_reward(env)
    done_fn = _make_done(env)
    dt = env._dt

    def rollout_costs(x0, t0, pos_traj, vel_traj, actions, params,
                      draw: Optional[torch.Tensor] = None,
                      deterministic: bool = False, discount=1.0,
                      layout: str = "nhd", collect_poses: bool = False):
        if layout == "nhd":
            acts = actions.permute(1, 0, 2)  # (H, N, 4)
        elif layout == "hdn":
            acts = actions.reshape(-1, 4, actions.shape[-1]).permute(0, 2, 1)
        else:
            raise ValueError(f"unknown layout {layout!r}")
        H, N, _ = acts.shape
        ptar, vtar = target_window(t0, pos_traj, vel_traj, H)
        check_draw(env, draw, deterministic)
        if deterministic:
            params = params.replace(dyn_noise_scale=params.dyn_noise_scale * 0.0)
        if draw is None:  # a model that reads none, or a deterministic gaussian
            draw = x0.new_zeros(3)

        x = x0[:16].expand(N, 16)
        r_prev = torch.zeros(N, device=x0.device)
        d_prev = torch.zeros(N, dtype=torch.bool, device=x0.device)
        rews, poses = [], []
        for h in range(H):
            r = reward(x, ptar[h], vtar[h])
            d = done_fn(x, t0 + h, params.max_steps_in_episode)
            r = torch.where(d_prev, r_prev, r)
            d = d | d_prev
            u, _ = dynamics.control_to_thrust_omega(acts[h], params)
            x_new = dynamics.bodyrate_step(x, u, params, dt)
            f_new = env.disturb_fn(params, draw, t0 + h, x[..., VEL], x[..., FDIST])
            x = torch.cat([x_new[:, :13], f_new.expand(N, 3)], dim=-1)
            r_prev, d_prev = r, d
            rews.append(r)
            poses.append(x[:, POS])
        disc = torch.pow(discount, torch.arange(H, device=x0.device,
                                                dtype=torch.float32))
        costs = -torch.einsum("h,hn->n", disc, torch.stack(rews))
        return (costs, torch.stack(poses)) if collect_poses else costs

    return rollout_costs


def hessian_draws_from_key(env: QuadEnv, key: torch.Tensor, H: int,
                           params=None) -> Optional[torch.Tensor]:
    """The per-step disturbance draws (H, 3) of the Hessian's rollout from
    its key, as JAX's splits it (ops/rollout.py:200-212): step h takes
    ``rng_act_h, key = split(key)``, then the reference's chain from
    ``rng_act_h`` to its draw. Only "periodic" and "mixed" read a draw there
    (the deterministic rollout zeroes the gaussian scale), so every other
    model gets None and no key is split. A stack of keys (B, 2) gives (B,
    H, 3)."""
    if env.config.disturb_type not in dynamics.UNIFORM_DRAW:
        return None
    acts = []
    for _ in range(H):
        rng_act, key = prng.split(key).unbind(-2)
        acts.append(rng_act)
    return env.disturb_from_key(torch.stack(acts, dim=-2), deterministic=True)


def make_hessian_cost(env: QuadEnv, H: int):
    """Build ``cost(a_flat, x0, t0, pos_traj, vel_traj, params, draws=None)
    -> scalar``, the reference's Hessian objective (JAX:
    ops/rollout.make_hessian_cost): one deterministic H-step rollout of the
    (H * 4,) action sequence from x0, rewards on the post-step states,
    never frozen, the last one and the constant step-0 term dropped,
    negated. ``draws`` (H, 3) are the per-step disturbance draws
    (:func:`hessian_draws_from_key`; "periodic" and "mixed" only). It is
    what ``ops/covariance.make_hessian`` differentiates twice."""
    reward = make_reward(env)
    dt, dA = env._dt, env.action_dim

    def cost(a_flat, x0, t0, pos_traj, vel_traj, params, draws=None):
        check_draw(env, draws, deterministic=True)
        a_seq = a_flat.reshape(H, dA)
        params = params.replace(dyn_noise_scale=params.dyn_noise_scale * 0.0)
        ptars, vtars = target_window(t0, pos_traj, vel_traj, H, offset=1)
        zero = x0.new_zeros(3)
        # a batch of one: under torch.func.jacfwd a 0-d reward times a
        # Python float gives a float64 tangent, a (1,) one does not
        x, rews = x0[None, :16], []
        for h in range(H):
            u, _ = dynamics.control_to_thrust_omega(dynamics.clip_action(a_seq[h]),
                                                    params)
            x_new = dynamics.bodyrate_step(x, u, params, dt)
            f_new = env.disturb_fn(params, zero if draws is None else draws[h],
                                   t0 + h, x[:, VEL], x[:, FDIST])
            x = torch.cat([x_new[:, :13], f_new.expand(1, 3)], dim=-1)
            rews.append(reward(x, ptars[h], vtars[h]))
        # rews[h] = reward(s_{h+1}); the reference sums reward(s_1 .. s_{H-1})
        # plus terms constant in the actions, so the last entry goes
        return -torch.sum(torch.cat(rews[:-1]))

    return cost


def make_rollout_batched(env: QuadEnv):
    """Build ``rollout_costs_b(x0s (B, 16), t0s (B,), pos_trajs (B, T, 3),
    vel_trajs, actions, params_b, draws=None, deterministic=False,
    discount=1.0, layout="hdn") -> costs (B, N)``: :func:`make_rollout` for
    B scenarios at once (JAX: the jnp engine vmapped over scenarios in
    parallel/scenarios.py), by ``torch.func.vmap`` over its body, so the
    number of ops does not grow with B.

    ``actions`` is (B, N, H, 4) for ``layout="nhd"``, (B, H, 4, N) or
    (B, H*4, N) for ``"hdn"``; ``params_b`` holds each scenario's
    parameters on axis 0 of its tensor leaves (``stack_params``); ``draws``
    (B, 3) are each scenario's disturbance draw.
    """
    rollout = make_rollout(env)

    def rollout_costs_b(x0s, t0s, pos_trajs, vel_trajs, actions, params_b,
                        draws: Optional[torch.Tensor] = None,
                        deterministic: bool = False, discount=1.0,
                        layout: str = "hdn"):
        def one(params, x0, t0, pos_traj, vel_traj, acts, draw):
            return rollout(x0, t0, pos_traj, vel_traj, acts, params, draw,
                           deterministic, discount, layout)

        return vmap_trees(one, (params_b, x0s, t0s, pos_trajs, vel_trajs, actions,
                                draws))

    return rollout_costs_b
