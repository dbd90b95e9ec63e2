"""Batch-first quaternion and SO(3) algebra: the pieces the dynamics, the
rewards and the PID controller use.

Counterpart of :mod:`covo_mpc_tpu.models.rotation`. Quaternions are
(x, y, z, w); every function broadcasts over leading batch dimensions.

Components are taken as (..., 1) slices, not 0-d scalars: under
``torch.func.jacfwd`` a 0-d tensor times a Python float gives a float64
tangent (torch 2.13), which would turn the Hessian's Jacobians float64.
"""

from __future__ import annotations

import torch


def _xyzw(q: torch.Tensor):
    return q[..., 0:1], q[..., 1:2], q[..., 2:3], q[..., 3:4]


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (x, y, z, w) quaternions; broadcasts."""
    x1, y1, z1, w1 = _xyzw(q1)
    x2, y2, z2, w2 = _xyzw(q2)
    w = w1 * w2 - (x1 * x2 + y1 * y2 + z1 * z2)
    x = w1 * x2 + w2 * x1 + (y1 * z2 - z1 * y2)
    y = w1 * y2 + w2 * y1 + (z1 * x2 - x1 * z2)
    z = w1 * z2 + w2 * z1 + (x1 * y2 - y1 * x2)
    return torch.cat([x, y, z, w], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    """Quaternion conjugate: (-x, -y, -z, w)."""
    return torch.cat([-q[..., 0:3], q[..., 3:4]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize to a unit quaternion."""
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """One Euler step of quaternion kinematics, renormalized:
    ``normalize(q + dt * 0.5 * q x (omega, 0))``; ``omega`` (..., 3) is the
    body angular velocity."""
    omega_quat = torch.cat([omega, torch.zeros_like(omega[..., :1])], dim=-1)
    return quat_normalize(q + dt * (0.5 * quat_mul(q, omega_quat)))


def rotate_vec(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) ``v`` (..., 3) by quaternion(s) ``q``: the vector
    part of q x (v, 0) x q*."""
    vq = torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
    return quat_mul(quat_mul(q, vq), quat_conj(q))[..., 0:3]


def body_z_world(q: torch.Tensor) -> torch.Tensor:
    """Third column of R(q), homogeneous (scales by ||q||^2)."""
    x, y, z, w = _xyzw(q)
    return torch.cat(
        [
            2.0 * (x * z + w * y),
            2.0 * (y * z - w * x),
            w * w - x * x - y * y + z * z,
        ],
        dim=-1,
    )


def quat_to_rpy(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> (roll, pitch, yaw) Euler angles (..., 3)."""
    x, y, z, w = _xyzw(q)
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.arcsin(2.0 * (w * y - z * x))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.cat([roll, pitch, yaw], dim=-1)


def rp_to_quat(rp: torch.Tensor) -> torch.Tensor:
    """Rodrigues parameters (..., 3) -> unit quaternion (x, y, z, w):
    [rp, 1] / sqrt(1 + |rp|^2)."""
    n = torch.sqrt(1.0 + torch.sum(rp * rp, dim=-1, keepdim=True))
    return torch.cat([rp, torch.ones_like(rp[..., :1])], dim=-1) / n


def quat_to_rp(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (x, y, z, w) -> Rodrigues parameters q_xyz / q_w;
    singular at q_w = 0 (180-degree rotations), as the reference."""
    return q[..., 0:3] / q[..., 3:4]


def yaw_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Yaw only — the piece the tracking reward needs; shape (...)."""
    x, y, z, w = _xyzw(q)
    return torch.atan2(2.0 * (w * z + x * y),
                       1.0 - 2.0 * (y * y + z * z)).squeeze(-1)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> rotation matrix (..., 3, 3), homogeneous form: it
    scales by ||q||^2 for a non-unit q, as the reference's composition does
    (the PID is fed un-normalized noisy quaternions)."""
    x, y, z, w = _xyzw(q)
    xx, yy, zz, ww = x * x, y * y, z * z, w * w
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.cat([ww + xx - yy - zz, 2.0 * (xy - wz), 2.0 * (xz + wy)], dim=-1)
    row1 = torch.cat([2.0 * (xy + wz), ww - xx + yy - zz, 2.0 * (yz - wx)], dim=-1)
    row2 = torch.cat([2.0 * (xz - wy), 2.0 * (yz + wx), ww - xx - yy + zz], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (x, y, z, w) by the w-branch formula
    only (valid for w bounded away from 0), as the reference."""
    tr = R[..., 0, 0:1] + R[..., 1, 1:2] + R[..., 2, 2:3]
    w = 0.5 * torch.sqrt(1.0 + tr)
    scale = 0.5 / torch.sqrt(1.0 + tr)
    x = scale * (R[..., 2, 1:2] - R[..., 1, 2:3])
    y = scale * (R[..., 0, 2:3] - R[..., 2, 0:1])
    z = scale * (R[..., 1, 0:1] - R[..., 0, 1:2])
    return torch.cat([x, y, z, w], dim=-1)


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric (cross-product) matrix (..., 3, 3) of v (..., 3)."""
    vx, vy, vz = v[..., 0:1], v[..., 1:2], v[..., 2:3]
    zero = torch.zeros_like(vx)
    return torch.stack([torch.cat([zero, -vz, vy], dim=-1),
                        torch.cat([vz, zero, -vx], dim=-1),
                        torch.cat([-vy, vx, zero], dim=-1)], dim=-2)


def vee(R: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: skew matrix (..., 3, 3) -> vector (..., 3)."""
    return torch.cat([R[..., 2, 1:2], R[..., 0, 2:3], R[..., 1, 0:1]], dim=-1)


def axis_angle_to_rotmat(axis: torch.Tensor, angle) -> torch.Tensor:
    """Rodrigues' formula; normalizes ``axis`` (..., 3), ``angle`` (...)."""
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    K = hat(axis)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device).expand(K.shape)
    ang = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)[..., None, None]
    return eye + torch.sin(ang) * K + (1.0 - torch.cos(ang)) * (K @ K)
