"""Rollout-cost Hessian by forward sensitivities and the second-order adjoint.

Counterpart of :func:`covo_mpc_tpu.ops.hessian.make_hessian_adjoint`. With
z_h = (s_h, a_h) from the nominal rollout (the primal, K2), g_h = r(f(z_h))
and T_h = d z_h / d a the chained first-order forward sensitivities (the
chain, K3),

    R = -sum_h T_h^T M_h T_h

where M_h is, per step,

- exact (``second_order=True``, ``hessian_mode="adjoint"``):
  grad^2 g_h + sum_k mu_{h,k} d^2 f_k / dz^2, with the 13-dim costate mu
  from one backward pass (mu_j = w_{j+1} + A_{j+1}^T mu_{j+1}, w = dg/ds);
- Gauss–Newton (``second_order=False``, ``hessian_mode="gn"``, the main
  path): J_h^T (grad^2 r)(s_{h+1}) J_h, every second-order dynamics term
  dropped.

J_h is the (13, 17) step Jacobian; the local derivatives come from
``torch.func`` vmapped over the horizon. The last step's reward is
constant-trimmed (the mask).
"""

from __future__ import annotations

import torch
from torch.func import grad, jacfwd, vmap
from torch.func import hessian as func_hessian

from covo_mpc_tpu_torch.models import dynamics, rewards
from covo_mpc_tpu_torch.models.quad_env import QuadEnv
from covo_mpc_tpu_torch.models.structs import vmap_scenarios
from covo_mpc_tpu_torch.ops.hessian_cuda import make_tail_pullback, pullback, sens_chain_plain
from covo_mpc_tpu_torch.ops.rollout import check_penyaw_reward, target_window
from covo_mpc_tpu_torch.ops.rollout_cuda import make_primal

_SD = 13  # sensitivity state: pos(3) quat(4) vel(3) omega(3)


def build_hessian_disturb_table(env: QuadEnv, x0, H: int):
    """(H, 3) f_disturb in effect during each Hessian-rollout step: x0's own
    at step 0, zero after (gaussian draws are zeroed by the deterministic
    rollout, "none" is zero)."""
    if env.config.disturb_type not in ("gaussian", "none"):
        raise NotImplementedError(
            f"Hessian disturbance table for {env.config.disturb_type!r} "
            "is not ported yet"
        )
    return torch.cat([x0[13:16][None], x0.new_zeros(H - 1, 3)])


def _local_fns(env: QuadEnv, params):
    """The step f(z, fd) on the 13-dim core state and the penyaw reward
    r(s, pos_tar, vel_tar) that the local derivatives differentiate."""

    def step_z(z, fd):
        return dynamics.core_step(z[:_SD], z[_SD:], fd, params, env._dt)

    def reward(s, pt, vt):
        return rewards.tracking_penyaw_reward(s[0:3], s[7:10], s[3:7], pt, vt)

    return step_z, reward


def _last_step_mask(H: int, like: torch.Tensor) -> torch.Tensor:
    return (torch.arange(H, device=like.device) < H - 1).to(like.dtype)


def gn_curvature(env: QuadEnv, params, zs, aux, ptars, vtars):
    """The Gauss–Newton local derivatives and per-step curvature: J
    (H, 13, 17) step Jacobians at z_h and M = J^T (grad^2 r)(s_{h+1}) J
    (H, 17, 17), the last step masked out."""
    step_z, reward = _local_fns(env, params)

    def local_derivs_gn(z, fd, pt, vt):
        J = jacfwd(step_z)(z, fd)  # (13, 17) = [A | B]
        H_r = func_hessian(reward)(step_z(z, fd), pt, vt)  # (13, 13)
        return J, H_r

    J, H_r = vmap(local_derivs_gn)(zs, aux, ptars, vtars)
    mask = _last_step_mask(zs.shape[0], J)
    M = torch.einsum("hku,hkl,hlv->huv", J, H_r, J) * mask[:, None, None]
    return J, M


def adjoint_curvature(env: QuadEnv, params, zs, aux, ptars, vtars):
    """The exact adjoint's local derivatives and per-step curvature: J
    (H, 13, 17) and M_h = grad^2 g_h + sum_k mu_{h,k} d^2 f_k / dz^2
    (H, 17, 17), with the costate mu from one backward pass over the
    horizon; the last step masked out."""
    step_z, reward = _local_fns(env, params)

    def local_derivs(z, fd, pt, vt):
        def g(zz):
            return reward(step_z(zz, fd), pt, vt)

        J = jacfwd(step_z)(z, fd)  # (13, 17) = [A | B]
        Hf = jacfwd(jacfwd(step_z))(z, fd)  # (13, 17, 17)
        return J, Hf, grad(g)(z), func_hessian(g)(z)

    J, Hf, grad_g, hess_g = vmap(local_derivs)(zs, aux, ptars, vtars)
    H = zs.shape[0]
    mask = _last_step_mask(H, J)
    grad_g = grad_g * mask[:, None]
    hess_g = hess_g * mask[:, None, None]

    # backward costate: mu_j = w_{j+1} + A_{j+1}^T mu_{j+1}, mu_{H-1} = 0
    mu = torch.zeros(_SD, device=zs.device, dtype=zs.dtype)
    mus = [mu]
    for j in range(H - 2, -1, -1):
        mu = grad_g[j + 1, :_SD] + J[j + 1, :, :_SD].T @ mu
        mus.append(mu)
    mus = torch.stack(mus[::-1])  # (H, 13)
    M = hess_g + torch.einsum("hk,hkuv->huv", mus, Hf)
    return J, M


def make_hessian_adjoint(env: QuadEnv, H: int, primal: str = "torch",
                         tail: str = "torch", second_order: bool = True):
    """Build ``hessian(a_flat, x0, t0, pos_traj, vel_traj, params) -> (D, D)``.

    ``second_order``: the exact adjoint (True) or Gauss–Newton (False).
    ``primal`` / ``tail``: "torch" runs the nominal rollout / the
    sensitivity chain as plain PyTorch; "cuda" runs them through the K2 /
    K3 wrappers (which take their plain versions for CPU tensors).
    """
    for name, mode in (("primal", primal), ("tail", tail)):
        if mode not in ("torch", "cuda"):
            raise ValueError(f"unknown {name} mode {mode!r}")
    check_penyaw_reward(env)
    dA = env.action_dim
    curvature = adjoint_curvature if second_order else gn_curvature
    primal_k = make_primal(env, H)
    run_primal = primal_k if primal == "cuda" else primal_k.plain
    if tail == "cuda":
        run_tail = make_tail_pullback(H, dA, _SD)
    else:
        def run_tail(J, M):
            return pullback(sens_chain_plain(J, dA), M)

    def hessian(a_flat, x0, t0, pos_traj, vel_traj, params):
        aux = build_hessian_disturb_table(env, x0, H)
        ptars, vtars = target_window(t0, pos_traj, vel_traj, H, offset=1)
        zs = run_primal(x0, a_flat.reshape(H, dA), aux, params)  # (H, 17)
        J, M = curvature(env, params, zs, aux, ptars, vtars)
        return -run_tail(J, M)

    return hessian


def make_hessian_batched(env: QuadEnv, H: int, second_order: bool = True):
    """Build ``hessian_b(a_flats (B, D), x0s (B, 16), t0s (B,), pos_trajs
    (B, T, 3), vel_trajs, params_b) -> (B, D, D)``: :func:`make_hessian_adjoint`
    for B scenarios at once by ``torch.func.vmap``, with the plain primal and
    chain, as JAX's scenario-batched solve vmaps ``make_hessian_adjoint(
    primal="scan")``: K2 and K3 are ctypes launches, which vmap cannot
    batch, and a loop over B would undo the batching."""
    hess = make_hessian_adjoint(env, H, primal="torch", tail="torch",
                                second_order=second_order)

    def one(params, a_flat, x0, t0, pos_traj, vel_traj):
        return hess(a_flat, x0, t0, pos_traj, vel_traj, params)

    def hessian_b(a_flats, x0s, t0s, pos_trajs, vel_trajs, params_b):
        return vmap_scenarios(one, params_b)(a_flats, x0s, t0s, pos_trajs,
                                            vel_trajs)

    return hessian_b
