"""Batch-first quaternion algebra: the pieces the dynamics and rewards use.

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


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize to a unit quaternion."""
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


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


def yaw_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Yaw only — the piece the tracking reward needs; shape (...)."""
    x, y, z, w = _xyzw(q)
    return torch.atan2(2.0 * (w * z + x * y),
                       1.0 - 2.0 * (y * y + z * z)).squeeze(-1)
