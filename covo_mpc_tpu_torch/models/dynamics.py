"""First-order bodyrate quadrotor dynamics, batch-first, on packed states.

Counterpart of :mod:`covo_mpc_tpu.models.dynamics` (same ODE, same
action map). The CUDA kernels run the component-form twin in
``csrc/quad_core.cuh``; this array form is what the plain rollout
integrates and what the Hessian differentiates.

Disturbances: every model of the JAX package. A disturbance function takes
JAX's arguments with its random draw in place of the key, ``fn(params,
draw, time, vel, f_disturb)``, so callers and tests choose where the draw
comes from. ``draw`` is the model's raw random input: standard normals for
"gaussian" (and "none", which ignores them), uniforms in
``[-disturb_scale, disturb_scale)`` for "periodic" and "mixed", unused (None)
for "sin" and "drag". :func:`disturb_draw_from_key` makes a model's draw
from a JAX key as JAX's model draws it, and :func:`derive_dynamics_keys`
is the reference's key chain from a step's key down to that draw.
"""

from __future__ import annotations

import math

import torch

from covo_mpc_tpu_torch.models import rotation
from covo_mpc_tpu_torch.models.rewards import _abs
from covo_mpc_tpu_torch.models.structs import FDIST, OMEGA, POS, QUAT, VEL, EnvParams3D
from covo_mpc_tpu_torch.utils import prng


def clip_action(a: torch.Tensor) -> torch.Tensor:
    """``a`` clipped to [-1, 1], with JAX's derivative at the bounds:
    ``jnp.clip`` is a min of a max, whose derivative at a tie is 1/2 to each
    operand, so it is 1/2 at a = +-1, where ``torch.clamp``'s is 1. The
    Hessian meets a nominal action exactly on a bound whenever the weighted
    mean's heavy samples were all clipped there. The values are
    ``torch.clamp``'s."""
    one = a.new_ones(())
    return torch.minimum(torch.maximum(a, -one), one)


def control_to_thrust_omega(action: torch.Tensor, params: EnvParams3D):
    """Map a normalized action in [-1, 1]^4 to ([thrust, omega_tar], torque)."""
    action = clip_action(action)
    thrust = (action[..., 0:1] + 1.0) / 2.0 * params.max_thrust
    torque = action[..., 1:4] * params.max_torque
    omega_tar = torque / params.max_torque * params.max_omega
    return torch.cat([thrust, omega_tar], dim=-1), torque


def bodyrate_step(x: torch.Tensor, u: torch.Tensor, params: EnvParams3D, dt):
    """One Euler step of the packed-state dynamics ``(..., 16)``; ``u`` is
    the physical control [thrust, omega_tar], scaled by ``action_scale``
    here. Returns the packed next state with a normalized quaternion and
    the disturbance carried unchanged."""
    u = u * params.action_scale
    thrust = u[..., 0]
    omega_tar = u[..., 1:4]

    r = x[..., POS]
    q = rotation.quat_normalize(x[..., QUAT])
    v = x[..., VEL]
    omega = x[..., OMEGA]
    f_disturb = x[..., FDIST]

    thrust_world = rotation.body_z_world(q) * thrust[..., None]
    acc = (thrust_world + f_disturb) / params.m
    # gravity on z only: x/y keep acc exactly, as 0 + acc does
    v_dot = torch.cat([acc[..., :2], acc[..., 2:] - params.g], dim=-1)

    omega_quat = torch.cat([omega, torch.zeros_like(omega[..., :1])], dim=-1)
    q_dot = 0.5 * rotation.quat_mul(q, omega_quat)

    r_new = r + v * dt
    q_new = rotation.quat_normalize(q + q_dot * dt)
    v_new = v + v_dot * dt
    omega_new = (params.alpha_bodyrate * omega
                 + (1.0 - params.alpha_bodyrate) * omega_tar)
    return torch.cat([r_new, q_new, v_new, omega_new, f_disturb], dim=-1)


def core_step(s: torch.Tensor, a: torch.Tensor, fdist: torch.Tensor,
              params: EnvParams3D, dt) -> torch.Tensor:
    """One bodyrate step on the 13-dim core state (pos, quat, vel, omega)
    under the normalized action ``a`` (clipped, as step_env does) and the
    force ``fdist``: the step the Hessian differentiates and the plain
    primal rollout integrates (JAX: ops/hessian._step13)."""
    u, _ = control_to_thrust_omega(clip_action(a), params)
    return bodyrate_step(torch.cat([s, fdist], dim=-1), u, params, dt)[..., :13]


def periodic_disturb(params: EnvParams3D, draw, time, vel, f_disturb):
    """The uniform ``draw`` every ``disturb_period`` steps, else the
    previous force carried through."""
    redraw = torch.as_tensor(time % params.disturb_period == 0)
    return torch.where(redraw[..., None], draw, f_disturb)


def sin_disturb(params: EnvParams3D, draw, time, vel, f_disturb):
    """A per-axis sinusoid of the step count (the period in floats, as
    JAX's). ``time``'s last axis lines up with the params' scenario axis;
    leading axes of ``time`` are free (a table of times)."""
    time = torch.as_tensor(time)[..., None]
    dp = params.disturb_params
    scale = dp[..., :3] * params.disturb_scale[..., None]
    period = dp[..., :3] * (params.disturb_period / 3) + params.disturb_period
    phase = dp[..., 3:6] * 2.0 * math.pi
    d = scale * torch.sin(2.0 * math.pi / period * time + phase)
    return d if f_disturb is None else d.expand_as(f_disturb)


def drag_disturb(params: EnvParams3D, draw, time, vel, f_disturb):
    """Quadratic drag against the relative wind; |rel_v| takes JAX's
    derivative at 0 (``rewards._abs``), so the exact Hessian, which
    differentiates this twice, keeps d^2(x|x|)/dx^2 = 2 there."""
    rel_vel = vel - params.disturb_params[..., :3] * 0.5
    return (-torch.abs(params.disturb_scale)[..., None] * rel_vel * _abs(rel_vel)
            / (1.5**2))


def mixed_disturb(params: EnvParams3D, draw, time, vel, f_disturb):
    """(drag + sin + periodic) / 3; the periodic term passes the previous
    MIXED force through between redraws."""
    d = (drag_disturb(params, draw, time, vel, f_disturb)
         + sin_disturb(params, draw, time, vel, f_disturb)
         + periodic_disturb(params, draw, time, vel, f_disturb))
    return d / 3.0


def gaussian_disturb(params: EnvParams3D, draw, time=None, vel=None,
                     f_disturb=None) -> torch.Tensor:
    """i.i.d. Gaussian force noise: ``dyn_noise_scale * draw`` (the scale is
    zeroed in deterministic rollouts); a leading scenario axis on both, the
    scale (B,) and the draws (B, 3), carries through."""
    return params.dyn_noise_scale[..., None] * draw


def none_disturb(params: EnvParams3D, draw, time=None, vel=None,
                 f_disturb=None) -> torch.Tensor:
    return torch.zeros_like(draw if f_disturb is None else f_disturb)


DISTURB_FNS = {
    "periodic": periodic_disturb,
    "sin": sin_disturb,
    "drag": drag_disturb,
    "mixed": mixed_disturb,
    "gaussian": gaussian_disturb,
    "none": none_disturb,
}
# the models whose draw is a uniform, and the velocity-coupled ones (the
# force depends on the rollout's own velocity)
UNIFORM_DRAW = ("periodic", "mixed")
VEL_COUPLED = ("drag", "mixed")


def get_disturb_fn(disturb_type: str):
    """Disturbance name -> ``fn(params, draw, time, vel, f_disturb) -> (..., 3)``."""
    if disturb_type not in DISTURB_FNS:
        raise NotImplementedError(f"unknown disturb_type {disturb_type!r}")
    return DISTURB_FNS[disturb_type]


def derive_dynamics_keys(step_key: torch.Tensor, fast: bool = False) -> torch.Tensor:
    """The reference's key chain from a step's key down to its disturbance
    draw (JAX: models/dynamics.derive_dynamics_keys): ``split(k)[1]``, then
    ``split(.)[0]`` twice. ``fast`` skips it (the step key itself), as JAX's
    non-parity samplers do. Maps over a stack of keys (..., 2)."""
    if fast:
        return step_key
    return dynamics_keys_after_split(prng.split(step_key))


def dynamics_keys_after_split(halves: torch.Tensor) -> torch.Tensor:
    """:func:`derive_dynamics_keys` given ``split(step_key)`` (..., 2, 2),
    which a caller that also takes ``split(step_key)[0]`` (the env step's
    info key) splits once for both."""
    key = prng.split(halves[..., 1, :])[..., 0, :]
    return prng.split(key)[..., 0, :]


def disturb_draw_from_key(disturb_type: str, key: torch.Tensor, disturb_scale,
                          deterministic: bool = False):
    """The draw (..., 3) JAX's ``disturb_type`` model makes from ``key`` (a
    disturb key, or a stack of them): the normals of "gaussian" (JAX:
    dynamics.py:152; and "none", which ignores them) or None when
    ``deterministic`` zeroes their scale; the uniforms in [-disturb_scale,
    disturb_scale) of "periodic" and "mixed" (dynamics.py:117), drawn
    deterministic or not; None for "sin" and "drag", which draw nothing."""
    if disturb_type in UNIFORM_DRAW:
        scale = torch.as_tensor(disturb_scale, device=key.device)
        return prng.uniform(key, (3,), -scale, scale)
    if disturb_type in ("gaussian", "none") and not deterministic:
        return prng.normal(key, (3,))
    return None
