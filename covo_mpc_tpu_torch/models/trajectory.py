"""Reference-trajectory generators, split into a draw part and a pure part.

Counterpart of :mod:`covo_mpc_tpu.models.trajectory`. Only the zigzag
generator is ported. Its random numbers come from :func:`draw_zigzag`
(a ``torch.Generator``); :func:`zigzag_from_draws` turns them into the
tables, so tests can hand it the numbers JAX drew.
"""

from __future__ import annotations

import dataclasses
import math

import torch

POINT_PER_SEG = 40


def num_segments(max_steps: int) -> int:
    return max_steps // POINT_PER_SEG + 1


@dataclasses.dataclass
class ZigzagDraws:
    """The uniforms of one zigzag trajectory.

    ``start`` (3,) in [-1, 1): the first keypoint's direction.
    ``segs`` (num_seg, 3): per segment draw j, (delta_theta, delta_phi) in
    [-pi/3, pi/3) and the segment length in [1, 1.5). Draw 0 is never
    used: segments 0 and 1 both take draw 1 (the reference's key-carry
    quirk, JAX trajectory.py:115-119), segment j >= 2 takes draw j.
    """

    start: torch.Tensor
    segs: torch.Tensor


def draw_zigzag(gen: torch.Generator, max_steps: int, device) -> ZigzagDraws:
    n = num_segments(max_steps)
    start = torch.rand(3, generator=gen, device=device) * 2.0 - 1.0
    u = torch.rand(n, 3, generator=gen, device=device)
    angles = u[:, :2] * (2.0 * math.pi / 3.0) - math.pi / 3.0
    dist = u[:, 2:] * 0.5 + 1.0
    return ZigzagDraws(start=start, segs=torch.cat([angles, dist], dim=1))


def zigzag_from_draws(max_steps: int, dt: float, draws: ZigzagDraws):
    """Piecewise-linear zigzag toward randomly rotated directions:
    40-step segments, each heading roughly back toward the origin.
    Returns ``(pos_traj, vel_traj, acc_traj)``, each (num_seg * 40, 3)."""
    n = num_segments(max_steps)
    prev = draws.start / torch.linalg.norm(draws.start) * 0.1
    frac = (torch.arange(POINT_PER_SEG, device=prev.device, dtype=prev.dtype)
            / POINT_PER_SEG)[:, None]
    pos_segs, vel_segs = [], []
    for i in range(n):
        d = draws.segs[max(i, 1)]
        vec_to_center = -prev / torch.linalg.norm(prev)
        theta = torch.arccos(vec_to_center[2]) + d[0]
        phi = torch.atan2(vec_to_center[1], vec_to_center[0]) + d[1]
        direction = torch.stack([
            torch.sin(theta) * torch.cos(phi),
            torch.sin(theta) * torch.sin(phi),
            torch.cos(theta),
        ])
        nxt = prev + d[2] * direction
        pos_segs.append(prev[None, :] + (nxt - prev)[None, :] * frac)
        vel_segs.append(((nxt - prev) / (POINT_PER_SEG + 1) / dt)
                        .expand(POINT_PER_SEG, 3))
        prev = nxt
    pos = torch.cat(pos_segs)
    pos = pos - pos[0]
    vel = torch.cat(vel_segs)
    return pos, vel, torch.zeros_like(pos)


_GENERATORS = {"tracking_zigzag": (draw_zigzag, zigzag_from_draws)}


def get_generator(task: str):
    """Task -> (draw fn, pure fn). Only the zigzag task is ported yet."""
    if task not in _GENERATORS:
        raise NotImplementedError(
            f"trajectory for task {task!r} is not ported yet"
        )
    return _GENERATORS[task]
