"""Small reference utilities kept for the API (JAX: ``covo_mpc_tpu.models.
misc``; reference: quadjax/dynamics/utils.py:11-46, 476-487).

The reference's ``get_hit_penalty`` (utils.py:17-31) is dead code there (a
jumping-task leftover); JAX leaves it out, and so does the port.
"""

from __future__ import annotations

import math

import torch

from covo_mpc_tpu_torch.utils import prng


def angle_normalize(x: torch.Tensor) -> torch.Tensor:
    """Wrap an angle to [-pi, pi)."""
    return ((x + math.pi) % (2 * math.pi)) - math.pi


def constant_disturbance(x, u, params):
    """The constant disturbance: the params' ``d_offset``."""
    return params.d_offset


def sample_sphere(key: torch.Tensor, R, center: torch.Tensor) -> torch.Tensor:
    """A point inside a sphere of radius ``R`` about ``center`` (3,), from
    three uniform draws (angle, polar angle, radius) of JAX's key tree:
    ``theta, phi, r = split(key, 3)``, as JAX's ``sample_sphere``."""
    theta_key, phi_key, r_key = prng.split(key, 3).unbind(-2)
    theta = prng.uniform(theta_key, (1,), 0.0, 2 * math.pi)
    phi = prng.uniform(phi_key, (1,), 0.0, math.pi)
    r = prng.uniform(r_key, (1,), 0.0, R)
    x = r * torch.sin(phi) * torch.cos(theta) + center[0]
    y = r * torch.sin(phi) * torch.sin(theta) + center[1]
    z = r * torch.cos(phi) + center[2]
    return torch.cat([x, y, z])
