"""Episode statistics for the auto-resetting env (JAX: ``covo_mpc_tpu.
models.wrappers``; reference: quadjax/envs/base.py:53-107).

Running return and length accumulators that latch into the last episode's
fields when an episode ends, across the env's auto-reset. The log is its
own tree of tensors, advanced by the pure :func:`advance_log` (a select on
``done``, no host read), and :class:`LogWrapper` binds it to an env's
``reset`` and ``step``. The MPC path does not use it; the reference's RL
branch did.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class EpisodeLog:
    """The episode in flight and the last finished one; 0-d tensors, so it
    stacks and selects like any carry."""

    returns: torch.Tensor  # the return so far this episode
    length: torch.Tensor  # its steps so far (int32)
    last_returns: torch.Tensor  # latched at the last done
    last_length: torch.Tensor
    last_reward: torch.Tensor  # the reward of the terminal step


def fresh_log(device="cpu") -> EpisodeLog:
    z = torch.zeros((), device=device)
    n = torch.zeros((), dtype=torch.int32, device=device)
    return EpisodeLog(z, n, z, n, z)


def advance_log(log: EpisodeLog, reward: torch.Tensor, done: torch.Tensor) -> EpisodeLog:
    """One step: accumulate; on ``done``, latch the totals and zero the
    accumulators (the env auto-resets in the same step)."""
    ret = log.returns + reward
    n = log.length + 1

    def latch(finished, held):
        return torch.where(done, finished, held)

    return EpisodeLog(
        returns=latch(torch.zeros_like(ret), ret),
        length=latch(torch.zeros_like(n), n),
        last_returns=latch(ret, log.last_returns),
        last_length=latch(n, log.last_length),
        last_reward=latch(reward, log.last_reward),
    )


def log_info(log: EpisodeLog, done) -> dict:
    """The info keys the reference's consumers read (base.py:96-102)."""
    return {
        "returned_episode_returns": log.last_returns,
        "returned_episode_lengths": log.last_length,
        "returned_episode": done,
        "final_reward": log.last_reward,
    }


@dataclasses.dataclass
class LogEnvState:
    env_state: Any
    log: EpisodeLog

    # the reference's flat field names (base.py:62-68)
    @property
    def episode_returns(self):
        return self.log.returns

    @property
    def episode_lengths(self):
        return self.log.length

    @property
    def returned_episode_returns(self):
        return self.log.last_returns

    @property
    def returned_episode_lengths(self):
        return self.log.last_length

    @property
    def final_reward(self):
        return self.log.last_reward


class LogWrapper:
    """An env with an :class:`EpisodeLog` threaded beside its state; every
    other attribute is the env's."""

    def __init__(self, env):
        self._env = env

    def __getattr__(self, name):
        return getattr(self._env, name)

    def reset(self, gen, params=None):
        """``env.reset`` (a generator or a key), with a fresh log."""
        obs, info, env_state = self._env.reset(gen, params)
        log = fresh_log(self._env.device)
        done = torch.zeros((), dtype=torch.bool, device=self._env.device)
        return obs, {**info, **log_info(log, done)}, LogEnvState(env_state, log)

    def step(self, gen, state: LogEnvState, action, params=None):
        """``env.step``, advancing the log by the step's reward and done."""
        obs, env_state, reward, done, info = self._env.step(gen, state.env_state,
                                                            action, params)
        log = advance_log(state.log, reward, done)
        return obs, LogEnvState(env_state, log), reward, done, {**info,
                                                               **log_info(log, done)}
