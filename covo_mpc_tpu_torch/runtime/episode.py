"""Episode runner: a Python loop of controller solve + auto-resetting env step.

Counterpart of :func:`covo_mpc_tpu.runtime.episode.make_episode_runner`.
Nothing in the loop reads a device value on the host, so on a GPU the host
runs ahead and queues the whole episode.
"""

from __future__ import annotations

from typing import Optional

import torch


def make_episode_runner(env, controller, steps: Optional[int] = None):
    """Build ``run_one_ep(reset_gen, gen, env_params=None) -> (err_pos (T,),
    dones (T,))``. ``err_pos[t]`` is the tracking error of the PRE-step
    state at step t; ``reset_gen`` draws the reset, ``gen`` the steps."""
    T = steps or env.default_params.max_steps_in_episode

    def run_one_ep(reset_gen: torch.Generator, gen: torch.Generator,
                   env_params=None):
        if env_params is None:
            env_params = env.default_params
        obs, info, env_state = env.reset(reset_gen, env_params)
        control_params = controller.reset(env_state, env_params,
                                          controller.init_control_params)
        err_pos, dones = [], []
        for _ in range(T):
            action, control_params, _ = controller(
                obs, env_state, env_params, control_params, info
            )
            obs, env_state, _, done, info = env.step(gen, env_state, action,
                                                     env_params)
            err_pos.append(info["err_pos"])
            dones.append(done)
        return torch.stack(err_pos), torch.stack(dones)

    return run_one_ep
