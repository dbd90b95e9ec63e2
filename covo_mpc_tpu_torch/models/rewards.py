"""Reward functions, batch-first.

Counterpart of :mod:`covo_mpc_tpu.models.rewards`: the hovering and
tracking rewards, the penyaw cost model and the realworld quadratic cost.
The CUDA kernels run the component-form twins of the last two in
``csrc/quad_core.cuh``.
"""

from __future__ import annotations

import torch

from covo_mpc_tpu_torch.models.rotation import yaw_from_quat


def log_pos_penalty(err_pos: torch.Tensor) -> torch.Tensor:
    """Multi-scale log barrier on the position error."""
    log1p = torch.log(err_pos + 1.0)
    return (
        err_pos * 0.4
        + torch.clamp(log1p * 4.0, 0.0, 1.0) * 0.4
        + torch.clamp(log1p * 8.0, 0.0, 1.0) * 0.2
        + torch.clamp(log1p * 16.0, 0.0, 1.0) * 0.1
        + torch.clamp(log1p * 32.0, 0.0, 1.0) * 0.1
    )


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's derivative at 0 (+1, where torch.abs has 0): the
    Hessian at a state of exactly zero yaw (a reset state, hovering with
    zero body rates) keeps the yaw penalty's curvature, as JAX's does."""
    return torch.where(x >= 0, x, -x)


def hovering_reward(pos, vel, pos_tar, vel_tar) -> torch.Tensor:
    err_pos = torch.linalg.norm(pos_tar - pos, dim=-1)
    err_vel = torch.linalg.norm(vel_tar - vel, dim=-1)
    return 1.0 - 0.6 * err_pos - 0.1 * err_vel


def tracking_reward(pos, vel, pos_tar, vel_tar) -> torch.Tensor:
    err_pos = torch.linalg.norm(pos_tar - pos, dim=-1)
    err_vel = torch.linalg.norm(vel_tar - vel, dim=-1)
    return 1.0 - 0.05 * err_vel - log_pos_penalty(err_pos)


def tracking_penyaw_reward(pos, vel, quat, pos_tar, vel_tar) -> torch.Tensor:
    """The MPPI / CoVO cost model: tracking reward with a yaw penalty."""
    err_pos = torch.linalg.norm(pos_tar - pos, dim=-1)
    err_vel = torch.linalg.norm(vel_tar - vel, dim=-1)
    yaw = yaw_from_quat(quat)
    return 1.3 - 0.05 * err_vel - log_pos_penalty(err_pos) - _abs(yaw) * 0.2


def tracking_realworld_reward(pos, quat, pos_tar) -> torch.Tensor:
    """Quadratic real-world cost."""
    pos_err = torch.mean((pos - pos_tar) ** 2, dim=-1)
    quat_err = 1.0 - quat[..., 3] ** 2
    return -(5.0 * pos_err + 3.0 * quat_err) * 0.02


def hovering_reward_fn(state, params=None):
    return hovering_reward(state.pos, state.vel, state.pos_tar, state.vel_tar)


def tracking_reward_fn(state, params=None):
    return tracking_reward(state.pos, state.vel, state.pos_tar, state.vel_tar)


def tracking_penyaw_reward_fn(state, params=None):
    return tracking_penyaw_reward(
        state.pos, state.vel, state.quat, state.pos_tar, state.vel_tar
    )


def tracking_realworld_reward_fn(state, params=None):
    return tracking_realworld_reward(state.pos, state.quat, state.pos_tar)


def get_reward_name(task: str) -> str:
    """Task -> reward-kernel name."""
    rewards = {
        "tracking": "penyaw",
        "tracking_slow": "realworld",
        "tracking_zigzag": "penyaw",
        "hovering": "penyaw",
    }
    if task not in rewards:
        raise NotImplementedError(f"unknown task {task!r}")
    return rewards[task]


def get_reward_fn(task: str):
    """Task -> state-based reward function."""
    return {
        "penyaw": tracking_penyaw_reward_fn,
        "realworld": tracking_realworld_reward_fn,
    }[get_reward_name(task)]
