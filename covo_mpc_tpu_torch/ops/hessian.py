"""Rollout-cost Hessian by forward sensitivities and the second-order adjoint.

Counterpart of :func:`covo_mpc_tpu.ops.hessian.make_hessian_adjoint`. With
z_h = (s_h, a_h) from the nominal rollout (the primal, K2), g_h = r(f(z_h))
and T_h = d z_h / d a the chained first-order forward sensitivities (the
chain, K3),

    R = -sum_h T_h^T M_h T_h

where M_h is, per step,

- exact (``second_order=True``, ``hessian_mode="adjoint"``):
  grad^2 g_h + sum_k mu_{h,k} d^2 f_k / dz^2, with the costate mu
  from one backward pass (mu_j = w_{j+1} + A_{j+1}^T mu_{j+1}, w = dg/ds);
- Gauss–Newton (``second_order=False``, ``hessian_mode="gn"``, the main
  path): J_h^T (grad^2 r)(s_{h+1}) J_h, every second-order dynamics term
  dropped.

J_h is the (13, 17) step Jacobian; the local derivatives come from
``torch.func`` vmapped over the horizon. The last step's reward is
constant-trimmed (the mask).

Under the velocity-coupled disturbances ("drag", "mixed") the force depends
on the rollout's own velocity, so the sensitivity state widens to 16 (core
13 + the force) with the disturbance update folded into the differentiated
step (:func:`_step16`; J (H, 16, 20), K3 at sd=16); the time- and
draw-dependent parts of "mixed" are per-step constants in an (H, 7) aux
table. Every other model's force does not depend on the actions and enters
as an (H, 3) table (:func:`build_hessian_disturb_table`). "periodic" and
"mixed" take per-step uniform draws (H, 3) from the caller, one per step as
JAX splits one key per step.
"""

from __future__ import annotations

import torch
from torch.func import grad, jacfwd, vmap
from torch.func import hessian as func_hessian

from covo_mpc_tpu_torch.models import dynamics
from covo_mpc_tpu_torch.models.quad_env import QuadEnv
from covo_mpc_tpu_torch.models.structs import vmap_trees
from covo_mpc_tpu_torch.ops.hessian_cuda import make_tail_pullback, pullback, sens_chain_plain
from covo_mpc_tpu_torch.ops.rollout import (
    disturb_table,
    make_reward,
    sin_table,
    step_times,
    target_window,
)
from covo_mpc_tpu_torch.ops.rollout_cuda import make_primal

_SD = 13  # sensitivity state: pos(3) quat(4) vel(3) omega(3)
_SDV = 16  # velocity-coupled sensitivity state: core 13 + f_dist(3)


def _check_draws(env: QuadEnv, draws) -> None:
    if draws is None and env.config.disturb_type in dynamics.UNIFORM_DRAW:
        raise ValueError(f"the {env.config.disturb_type!r} Hessian needs its "
                         "per-step uniform draws (H, 3)")


def build_hessian_disturb_table(env: QuadEnv, x0, t0, params, draws, H: int):
    """(H, 3) f_disturb in effect during each Hessian-rollout step: x0's own
    at step 0, then the model at t0 + h - 1 (zero for "gaussian", whose
    draws the deterministic rollout zeroes, and "none"; the closed form for
    "sin"; for "periodic" chained over ``draws[:H - 1]``)."""
    _check_draws(env, draws)
    if draws is not None:
        draws = draws[..., :H - 1, :]
    return disturb_table(env, params, x0[..., 13:16], t0, draws, H)


def build_hessian_aux_table(env: QuadEnv, t0, params, draws, H: int):
    """(H, 7) per-step constants of the velocity-coupled step: [sin value at
    t0 + h (3), periodic draw (3), redraw mask (1)] for "mixed", zeros for
    "drag" (JAX: hessian.build_hessian_aux_table, with the caller's draws
    in place of its per-step keys)."""
    dev = params.disturb_scale.device
    if env.config.disturb_type == "drag":
        return torch.zeros(H, 7, device=dev)
    _check_draws(env, draws)
    times = step_times(t0, H, dev)
    mask = (times % params.disturb_period == 0).to(draws.dtype)
    return torch.cat([sin_table(params, t0, H, dev), draws, mask[..., None]], dim=-1)


def _step16(z_s, a, aux, params, dt, mixed: bool):
    """One bodyrate step on the 16-dim state (core 13 + the force): the
    step integrates with the state's own force and returns the next one,
    the model's output from the PRE-step velocity (+ the "mixed" model's sin
    and periodic terms, per-step constants in ``aux``)."""
    core = dynamics.core_step(z_s[:13], a, z_s[13:16], params, dt)
    v, f_prev = z_s[7:10], z_s[13:16]
    f = dynamics.drag_disturb(params, None, None, v, f_prev)
    if mixed:
        f = (f + aux[:3] + torch.where(aux[6] > 0, aux[3:6], f_prev)) / 3.0
    return torch.cat([core, f])


def primal16(env: QuadEnv, x0, a_seq, aux, params) -> torch.Tensor:
    """The velocity-coupled Hessian's nominal rollout (plain): z_h = (s_h
    (16), a_h) for each of the H steps of ``a_seq`` (H, 4), under the aux
    table (H, 7), (H, 20)."""
    step_z, _ = _local_fns(env, params)
    s, zs = x0[:_SDV], []
    for h in range(a_seq.shape[0]):
        z = torch.cat([s, a_seq[h]])
        zs.append(z)
        s = step_z(z, aux[h])
    return torch.stack(zs)


def _local_fns(env: QuadEnv, params):
    """The step f(z, aux) on the sensitivity state (13-dim with the force
    table's row as ``aux``; 16-dim under drag / mixed with the aux table's
    row) and the env's reward r(s, pos_tar, vel_tar) (penyaw or realworld;
    s[0:3], s[3:7] and s[7:10] are pos, quat and vel at either width) that
    the local derivatives differentiate."""
    if env.config.disturb_type in dynamics.VEL_COUPLED:
        mixed = env.config.disturb_type == "mixed"

        def step_z(z, aux):
            return _step16(z[:_SDV], z[_SDV:], aux, params, env._dt, mixed)
    else:
        def step_z(z, fd):
            return dynamics.core_step(z[:_SD], z[_SD:], fd, params, env._dt)

    return step_z, make_reward(env)


def _last_step_mask(H: int, like: torch.Tensor) -> torch.Tensor:
    return (torch.arange(H, device=like.device) < H - 1).to(like.dtype)


def gn_curvature(env: QuadEnv, params, zs, aux, ptars, vtars):
    """The Gauss–Newton local derivatives and per-step curvature: J
    (H, sd, sd + 4) step Jacobians at z_h and M = J^T (grad^2 r)(s_{h+1}) J
    (H, sd + 4, sd + 4), the last step masked out (sd 13, or 16 under drag /
    mixed)."""
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
    (H, sd, sd + 4) and M_h = grad^2 g_h + sum_k mu_{h,k} d^2 f_k / dz^2
    (H, sd + 4, sd + 4), with the costate mu from one backward pass over
    the horizon; the last step masked out.

    M_h is taken as ONE Hessian per step, of the scalar m_h g_h(z) + mu_h .
    f(z) with mu_h held fixed (m_h the last-step mask): the same matrix as
    JAX's separate grad^2 g and (sd, sd + 4, sd + 4) step Hessian, for one
    second-order transform instead of two (the torch.func transforms are the
    Hessian's host cost)."""
    step_z, reward = _local_fns(env, params)

    def local_first(z, fd, pt, vt):
        def g(zz):
            return reward(step_z(zz, fd), pt, vt)

        return jacfwd(step_z)(z, fd), grad(g)(z)  # (sd, sd + 4) = [A | B]

    J, grad_g = vmap(local_first)(zs, aux, ptars, vtars)
    H, sd = J.shape[:2]
    mask = _last_step_mask(H, J)
    grad_g = grad_g * mask[:, None]

    # backward costate: mu_j = w_{j+1} + A_{j+1}^T mu_{j+1}, mu_{H-1} = 0
    mu = torch.zeros(sd, device=zs.device, dtype=zs.dtype)
    mus = [mu]
    for j in range(H - 2, -1, -1):
        mu = grad_g[j + 1, :sd] + J[j + 1, :, :sd].T @ mu
        mus.append(mu)
    mus = torch.stack(mus[::-1])  # (H, sd)

    def local_curvature(z, fd, pt, vt, mu, m):
        def lagrangian(zz):
            s = step_z(zz, fd)
            return m * reward(s, pt, vt) + torch.dot(mu, s)

        return func_hessian(lagrangian)(z)

    M = vmap(local_curvature)(zs, aux, ptars, vtars, mus, mask)
    return J, M


def make_hessian_adjoint(env: QuadEnv, H: int, primal: str = "torch",
                         tail: str = "torch", second_order: bool = True):
    """Build ``hessian(a_flat, x0, t0, pos_traj, vel_traj, params,
    draws=None) -> (D, D)``; ``draws`` (H, 3) are the per-step uniforms of
    "periodic" and "mixed" (QuadEnv.draw_disturb(gen, H)), unused otherwise.

    ``second_order``: the exact adjoint (True) or Gauss–Newton (False).
    ``primal`` / ``tail``: "torch" runs the nominal rollout / the
    sensitivity chain as plain PyTorch; "cuda" runs them through the K2 /
    K3 wrappers (which take their plain versions for CPU tensors). Under
    drag and mixed the primal is always the plain 16-dim rollout, as JAX
    forces its scan primal there: K2 integrates against a fixed force
    table, and these forces evolve in the state.
    """
    for name, mode in (("primal", primal), ("tail", tail)):
        if mode not in ("torch", "cuda"):
            raise ValueError(f"unknown {name} mode {mode!r}")
    dA = env.action_dim
    vel = env.config.disturb_type in dynamics.VEL_COUPLED
    sd = _SDV if vel else _SD
    curvature = adjoint_curvature if second_order else gn_curvature
    if vel:
        def run_primal(x0, a_seq, aux, params):
            return primal16(env, x0, a_seq, aux, params)
    else:
        primal_k = make_primal(env, H)
        run_primal = primal_k if primal == "cuda" else primal_k.plain
    if tail == "cuda":
        run_tail = make_tail_pullback(H, dA, sd)
    else:
        def run_tail(J, M):
            return pullback(sens_chain_plain(J, dA), M)

    def hessian(a_flat, x0, t0, pos_traj, vel_traj, params, draws=None):
        if vel:
            aux = build_hessian_aux_table(env, t0, params, draws, H)
        else:
            aux = build_hessian_disturb_table(env, x0, t0, params, draws, H)
        ptars, vtars = target_window(t0, pos_traj, vel_traj, H, offset=1)
        zs = run_primal(x0, a_flat.reshape(H, dA), aux, params)  # (H, sd + 4)
        J, M = curvature(env, params, zs, aux, ptars, vtars)
        return -run_tail(J, M)

    return hessian


def vmap_hessian(hess):
    """``hessian_b(a_flats (B, D), x0s (B, 16), t0s (B,), pos_trajs (B, T,
    3), vel_trajs, params_b, draws=None (B, H, 3)) -> (B, D, D)``: the
    Hessian ``hess`` (any estimator's signature) at B points at once by
    ``torch.func.vmap``, as JAX vmaps its Hessians over scenarios and over
    the offline schedule."""
    def one(params, a_flat, x0, t0, pos_traj, vel_traj, draws):
        return hess(a_flat, x0, t0, pos_traj, vel_traj, params, draws)

    def hessian_b(a_flats, x0s, t0s, pos_trajs, vel_trajs, params_b, draws=None):
        return vmap_trees(one, (params_b, a_flats, x0s, t0s, pos_trajs, vel_trajs,
                                draws))

    return hessian_b


def make_hessian_batched(env: QuadEnv, H: int, second_order: bool = True):
    """:func:`make_hessian_adjoint` for B scenarios at once
    (:func:`vmap_hessian`), with the plain primal and chain, as JAX's
    scenario-batched solve vmaps ``make_hessian_adjoint(primal="scan")``: K2
    and K3 are ctypes launches, which vmap cannot batch, and a loop over B
    would undo the batching."""
    return vmap_hessian(make_hessian_adjoint(env, H, primal="torch", tail="torch",
                                             second_order=second_order))


def make_hessian_sensitivity(env: QuadEnv, H: int):
    """Build ``hessian(a_flat, x0, t0, pos_traj, vel_traj, params,
    draws=None) -> (D, D)``, the exact Hessian by second-order sensitivity
    propagation (the module docstring): per step h, with T = [S1; E_h]
    (E_h the step's action block of the identity), S1' = J T and S2' =
    J_s S2 + T^T Hf T; R accumulates S1'^T (grad^2 r) S1' + sum_k (grad
    r)_k S2'_k over every step but the last (constant-trimmed), negated.
    ``draws`` as :func:`make_hessian_adjoint`'s."""
    dA = env.action_dim
    D = H * dA
    vel = env.config.disturb_type in dynamics.VEL_COUPLED
    sd = _SDV if vel else _SD

    def hessian(a_flat, x0, t0, pos_traj, vel_traj, params, draws=None):
        if vel:
            aux = build_hessian_aux_table(env, t0, params, draws, H)
        else:
            aux = build_hessian_disturb_table(env, x0, t0, params, draws, H)
        step_z, reward = _local_fns(env, params)
        step_jac, step_hess = jacfwd(step_z), jacfwd(jacfwd(step_z))
        reward_grad, reward_hess = grad(reward), func_hessian(reward)
        ptars, vtars = target_window(t0, pos_traj, vel_traj, H, offset=1)
        a_seq = a_flat.reshape(H, dA)
        eye = torch.eye(D, device=a_flat.device, dtype=a_flat.dtype)
        s = x0[:sd]
        S1 = a_flat.new_zeros(sd, D)
        S2 = a_flat.new_zeros(sd, D, D)
        R = a_flat.new_zeros(D, D)
        for h in range(H):
            z = torch.cat([s, a_seq[h]])
            s_new = step_z(z, aux[h])
            J, Hf = step_jac(z, aux[h]), step_hess(z, aux[h])
            T = torch.cat([S1, eye[h * dA:(h + 1) * dA]])  # (sd + dA, D)
            S1 = J @ T
            S2 = (torch.einsum("kl,lab->kab", J[:, :sd], S2)
                  + torch.einsum("kuv,ua,vb->kab", Hf, T, T))
            if h < H - 1:
                g_r = reward_grad(s_new, ptars[h], vtars[h])
                H_r = reward_hess(s_new, ptars[h], vtars[h])
                R = R + S1.T @ H_r @ S1 + torch.einsum("k,kab->ab", g_r, S2)
            s = s_new
        return -R

    return hessian
