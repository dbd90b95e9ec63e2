"""Geometric PID controller.

Counterpart of :mod:`covo_mpc_tpu.solvers.pid`: three broadcasting stages,
force setpoint -> tilt setpoint -> SO(3) rate command, over ``(..., 3)``
tensors, so one code path serves the closed loop and CoVO-offline's
expansion policy on many states at once. Reference quirks kept: the
physical constants come from ``env.default_params``, not the episode's
params; the small-angle test runs on the already-replaced angle, so a
near-zero tilt snaps to a 5e-4 rotation about e_z; the ``integral`` /
``quat_desired`` carry.
"""

from __future__ import annotations

import dataclasses

import torch

from covo_mpc_tpu_torch.models import rotation
from covo_mpc_tpu_torch.solvers.base import BaseSolver


@dataclasses.dataclass
class PIDParams:
    """Gains and the controller carry (JAX: PIDParams, the same fields).
    Build with :meth:`default`."""

    Kp: float
    Kd: float
    Ki: float
    Kp_att: float
    Ki_att: float
    integral: torch.Tensor  # (3,)
    quat_desired: torch.Tensor  # (4,)
    att_integral: torch.Tensor  # (3,)

    @classmethod
    def default(cls, device="cuda", Kp=4.0, Kd=4.0, Ki=1.0, Kp_att=4.0,
                Ki_att=1.0) -> "PIDParams":
        """The given gains with a zero carry on ``device``."""
        return cls(Kp=Kp, Kd=Kd, Ki=Ki, Kp_att=Kp_att, Ki_att=Ki_att,
                   integral=torch.zeros(3, device=device),
                   quat_desired=torch.tensor([0.0, 0.0, 0.0, 1.0], device=device),
                   att_integral=torch.zeros(3, device=device))

    def replace(self, **changes) -> "PIDParams":
        return dataclasses.replace(self, **changes)


def _e_z(like: torch.Tensor) -> torch.Tensor:
    e_z = torch.zeros_like(like)
    e_z[..., 2:3].fill_(1.0)  # a fill kernel, not a host-to-device copy
    return e_z


def force_setpoint(gains, plant, *, pos_err, vel_err, integral, acc_ff):
    """Stage 1: world-frame PD+I force with gravity and the feed-forward
    acceleration, ``f = m (g e_z - Kp e_p - Kd e_v - Ki int e_p + a_ff)``."""
    accel_cmd = (plant.g * _e_z(pos_err) - gains.Kp * pos_err - gains.Kd * vel_err
                 - gains.Ki * integral + acc_ff)
    return plant.m * accel_cmd


def tilt_setpoint(f_d):
    """Stage 2: the attitude whose body z-axis carries the force: axis-angle
    from e_z to its direction (``e_z x z_d = (-z_y, z_x, 0)``). The
    small-angle test runs on the replaced angle (reference quirk)."""
    nrm = torch.linalg.norm(f_d, dim=-1, keepdim=True)
    z_d = f_d / torch.clamp(nrm, min=1e-3)
    axis_angle = torch.cat([-z_d[..., 1:2], z_d[..., 0:1],
                            torch.zeros_like(z_d[..., 0:1])], dim=-1)
    angle = torch.linalg.norm(axis_angle, dim=-1)
    angle = torch.where(angle < 1e-3, torch.full_like(angle, 5e-4), angle)
    axis = torch.where((angle < 1e-3)[..., None], _e_z(axis_angle),
                       axis_angle / angle[..., None])
    return rotation.axis_angle_to_rotmat(axis, angle)


def so3_rate_command(R_d, R, kp_att):
    """Stage 3: body-rate command from the SO(3) attitude error
    ``vee(R_e - R_e^T)`` with ``R_e = R_d^T R``."""
    R_e = R_d.mT @ R
    return -kp_att * rotation.vee(R_e - R_e.mT)


class PIDSolver(BaseSolver):
    def __init__(self, env, control_params: PIDParams) -> None:
        super().__init__(env, control_params)
        # the DEFAULT params' physics, not the (possibly randomized) episode
        # params: reference quirk
        self.param = env.default_params

    def __call__(self, obs, state, env_params, control_params: PIDParams,
                 info=None):
        """One control step on ``state`` (the true state, as the reference
        reads it); every field may carry leading batch axes."""
        p = self.param
        f_d = force_setpoint(control_params, p, pos_err=state.pos - state.pos_tar,
                             vel_err=state.vel - state.vel_tar,
                             integral=control_params.integral,
                             acc_ff=state.acc_tar)
        # thrust = the body-z component of the commanded force <R e_z, f>
        R = rotation.quat_to_rotmat(state.quat)
        thrust = (R[..., :, 2] * f_d).sum(dim=-1)
        thrust = torch.minimum(torch.clamp(thrust, min=0.0), p.max_thrust)
        R_d = tilt_setpoint(f_d)
        omega_d = so3_rate_command(R_d, R, control_params.Kp_att)
        action = torch.cat([thrust[..., None] / p.max_thrust * 2.0 - 1.0,
                            omega_d / p.max_omega], dim=-1)
        carry = control_params.replace(
            quat_desired=rotation.rotmat_to_quat(R_d),
            integral=control_params.integral
            + (state.pos - state.pos_tar) * env_params.dt,
        )
        return action, carry, {}
