"""Reference-trajectory generators, split into a draw part and a pure part.

Counterpart of :mod:`covo_mpc_tpu.models.trajectory`: the Lissajous
(``tracking``), slow Lissajous (``tracking_slow``), zigzag
(``tracking_zigzag``) and fixed (``hovering``) generators. Each one's random
numbers come from its draw function, from a ``torch.Generator`` or from a
JAX key (``utils/prng.py``: then the very numbers JAX's generator draws
from that key, in its order); its pure function turns them into the
``(pos_traj, vel_traj, acc_traj)`` tables, so tests can hand it the numbers
JAX drew. ``generate_*`` take the draw from a key and return the tables
at once, under the JAX generators' names and signatures.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple, Union

import torch

from covo_mpc_tpu_torch.utils import prng

POINT_PER_SEG = 40
LISSAJOUS_PAD = 50  # table steps past the episode end, for horizons that overrun it


def num_segments(max_steps: int) -> int:
    return max_steps // POINT_PER_SEG + 1


@dataclasses.dataclass
class FixedDraws:
    """The fixed generator draws nothing; this names only the tables' device."""

    device: torch.device


@dataclasses.dataclass
class LissajousDraws:
    """The uniforms of one Lissajous trajectory: ``amp`` (3, 2) in [-1, 1)
    and ``phase`` (3, 2) in [-pi, pi), per axis and harmonic."""

    amp: torch.Tensor
    phase: torch.Tensor


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


TrajDraws = Union[FixedDraws, LissajousDraws, ZigzagDraws]


def draw_fixed(src, max_steps: int, device) -> FixedDraws:
    return FixedDraws(device=torch.device(device))


def fixed_from_draws(max_steps: int, dt: float, draws: FixedDraws):
    """The all-zeros hover target: three (max_steps, 3) tables."""
    zeros = torch.zeros(max_steps, 3, device=draws.device)
    return zeros, zeros, zeros


def draw_lissajous(gen, max_steps: int, device) -> LissajousDraws:
    """The amplitudes and phases from a generator, or from a key as JAX's
    generator draws them: ``split(key, 2)``, one uniform (3, 2) each."""
    if prng.is_key(gen):
        key_amp, key_phase = prng.split(gen, 2)
        return LissajousDraws(amp=prng.uniform(key_amp, (3, 2), -1.0, 1.0),
                              phase=prng.uniform(key_phase, (3, 2), -math.pi, math.pi))
    amp = torch.rand(3, 2, generator=gen, device=device) * 2.0 - 1.0
    phase = torch.rand(3, 2, generator=gen, device=device) * (2.0 * math.pi) - math.pi
    return LissajousDraws(amp=amp, phase=phase)


def lissajous_from_draws(max_steps: int, dt: float, draws: LissajousDraws,
                         f1: float, f2: float):
    """Two-harmonic Lissajous tables at ``f1`` and ``f2`` Hz, each
    (max_steps + 50, 3), in fp32 with JAX's order of operations: the times
    are fp32 ``arange * dt`` (the sine arguments reach ~18 rad, where a
    float64 clock would drift from JAX's tables), and only the positions
    are shifted to start at the origin."""
    amp, phase = draws.amp, draws.phase
    ts = torch.arange(max_steps + LISSAJOUS_PAD, dtype=torch.float32,
                      device=amp.device) * dt
    w1 = 2.0 * math.pi * f1
    w2 = 2.0 * math.pi * f2
    arg1 = w1 * ts[:, None] + phase[None, :, 0]
    arg2 = w2 * ts[:, None] + phase[None, :, 1]
    a1, a2 = amp[None, :, 0], amp[None, :, 1]
    pos = torch.sin(arg1) * a1 + torch.sin(arg2) * a2
    pos = pos - pos[0]
    vel = torch.cos(arg1) * a1 * w1 + torch.cos(arg2) * a2 * w2
    acc = -torch.sin(arg1) * a1 * w1**2 - torch.sin(arg2) * a2 * w2**2
    return pos, vel, acc


def draw_zigzag(gen, max_steps: int, device) -> ZigzagDraws:
    """The zigzag's uniforms from a generator, or from a key as JAX's
    generator draws them (JAX trajectory.py:84-104): ``split(key, num_seg)``,
    the start from key 0 (a uniform (3,)), and from key j the two angles (a
    uniform (2,)) and the length (a uniform of shape ()). All of them are
    prefixes of one (num_seg, 3) draw of bits."""
    n = num_segments(max_steps)
    if prng.is_key(gen):
        b = prng.random_bits(prng.split(gen, n), (3,))
        angles = prng.uniform_from_bits(b[:, :2], -math.pi / 3, math.pi / 3)
        dist = prng.uniform_from_bits(b[:, :1], 1.0, 1.5)
        return ZigzagDraws(start=prng.uniform_from_bits(b[0], -1.0, 1.0),
                           segs=torch.cat([angles, dist], dim=1))
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


Traj = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def generate_fixed_traj(max_steps: int, dt: float, key) -> Traj:
    """The all-zeros hover target on ``key``'s device (``key`` draws nothing)."""
    return fixed_from_draws(max_steps, dt, draw_fixed(key, max_steps, key.device))


def generate_lissa_traj(max_steps: int, dt: float, key) -> Traj:
    """The Lissajous tables (0.2 Hz + 0.4 Hz) drawn from ``key`` (a key of
    ``utils/prng.py``: JAX's draws; or a generator)."""
    return lissajous_from_draws(max_steps, dt, draw_lissajous(key, max_steps, key.device),
                                0.2, 0.4)


def generate_lissa_traj_slow(max_steps: int, dt: float, key) -> Traj:
    """The slow Lissajous tables (0.1 Hz + 0.1 Hz) drawn from ``key``."""
    return lissajous_from_draws(max_steps, dt, draw_lissajous(key, max_steps, key.device),
                                0.1, 0.1)


def generate_zigzag_traj(max_steps: int, dt: float, key) -> Traj:
    """The zigzag tables drawn from ``key``."""
    return zigzag_from_draws(max_steps, dt, draw_zigzag(key, max_steps, key.device))


_GENERATORS = {
    "tracking": (draw_lissajous,
                 functools.partial(lissajous_from_draws, f1=0.2, f2=0.4)),
    "tracking_slow": (draw_lissajous,
                      functools.partial(lissajous_from_draws, f1=0.1, f2=0.1)),
    "tracking_zigzag": (draw_zigzag, zigzag_from_draws),
    "hovering": (draw_fixed, fixed_from_draws),
}


def get_generator(task: str):
    """Task -> (draw fn, pure fn) (JAX: trajectory.get_generator)."""
    if task not in _GENERATORS:
        raise ValueError(f"unknown task {task!r}")
    return _GENERATORS[task]
