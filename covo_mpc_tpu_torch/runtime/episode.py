"""Episode runner: controller solve + auto-resetting env step, T times.

Counterpart of :func:`covo_mpc_tpu.runtime.episode.make_episode_runner`,
which jits the episode as one ``lax.scan`` over the control step. For an env
on the card, the runner captures that control step (the solve, ``env.step``
with its auto-reset select, and the write-back of obs, state, solver params
and info into the carried buffers, with ``err_pos[t]`` and ``done[t]`` into
(T,) device buffers) as one CUDA graph (``runtime/graphs.py``) and replays
it T times; the solver's random streams and the step generator advance at
each replay. The reset at an episode's start (and the solver's ``reset``:
the speculative cold start, offline's schedule) runs eagerly, then loads the
graph's buffers. For an env the caller put on the CPU, the runner is the
eager loop (:func:`eager_episode`), as is every env inside
``runtime.debug.debug_mode()``, where each solve is also checked finite.
Nothing reads a device value on the host inside a captured episode.

A solver built with ``collect_metrics`` reports each solve's health
(``runtime/metrics.py``); the runner returns them as (T,) tensors, one per
metric. The captured step writes each scalar into a (T,) buffer and CoVO's
Sigma into a (T, D, D) one (its eigensolve reads the host, so it runs once
over the stack after the episode's replays); the eager loop stacks them the
same way, so both give the same bits.
"""

from __future__ import annotations

from typing import Optional

import torch

from covo_mpc_tpu_torch.runtime import debug, graphs, metrics


def _start(env, controller, reset_gen, env_params):
    obs, info, env_state = env.reset(reset_gen, env_params)
    control_params = controller.reset(env_state, env_params,
                                      controller.init_control_params)
    return obs, env_state, control_params, info


def _stack_metrics(per_step: list) -> dict:
    """The solves' metrics dicts stacked to (T,) tensors (Sigma's resolved
    over its (T, D, D) stack); ``{}`` when the solver collects none."""
    if not per_step or not per_step[0]:
        return {}
    return metrics.resolve_sigma({k: torch.stack([m[k] for m in per_step])
                                  for k in per_step[0]})


def eager_episode(env, controller, steps: int, reset_gen: torch.Generator,
                  gen: torch.Generator, env_params=None):
    """One episode as a Python loop of eager solves and env steps: returns
    (err_pos (T,), dones (T,), metrics). Inside ``debug_mode()`` each
    solve's action and new mean are checked finite."""
    if env_params is None:
        env_params = env.default_params
    obs, env_state, control_params, info = _start(env, controller, reset_gen,
                                                  env_params)
    check = debug.nans_checked()
    err_pos, dones, per_step = [], [], []
    with metrics.deferred_sigma():
        for t in range(steps):
            action, control_params, out = controller(
                obs, env_state, env_params, control_params, info
            )
            if check:
                debug.check_finite(action, control_params, f"step {t}")
            obs, env_state, _, done, info = env.step(gen, env_state, action,
                                                     env_params)
            err_pos.append(info["err_pos"])
            dones.append(done)
            per_step.append((out or {}).get("metrics", {}))
    return torch.stack(err_pos), torch.stack(dones), _stack_metrics(per_step)


class CapturedEpisode:
    """``run_one_ep`` for an env on the card: one captured control step,
    replayed T times (see the module docstring). The step is captured at the
    first episode of a step generator and replayed for every later one."""

    def __init__(self, env, controller, steps: int):
        self.env, self.controller, self.steps = env, controller, steps
        self._step: Optional[graphs.CapturedCall] = None
        self._gen: Optional[torch.Generator] = None

    def _metric_buffers(self, carry, env_params) -> dict:
        """(T, ...) device buffers, one per metric the solver reports, shaped
        by one eager solve on the episode's first carry (its random streams
        put back as they were)."""
        controller, T = self.controller, self.steps
        if not getattr(controller, "collect_metrics", False):
            return {}
        streams = controller.random_streams()
        saved = [s.get_state() for s in streams]
        obs, env_state, control_params, info = carry
        with metrics.deferred_sigma():
            _, _, out = controller(obs, env_state, env_params, control_params, info)
        for s, state in zip(streams, saved):
            s.set_state(state)
        return {k: torch.zeros((T, *v.shape), dtype=v.dtype, device=v.device)
                for k, v in out["metrics"].items()}

    def _capture(self, gen, env_params, carry):
        env, controller, T = self.env, self.controller, self.steps

        def step(carry, env_params, t, err_pos, dones, bufs):
            obs, env_state, control_params, info = carry
            action, control_params, out = controller(obs, env_state, env_params,
                                                     control_params, info)
            obs, env_state, _, done, info = env.step(gen, env_state, action,
                                                     env_params)
            idx = torch.clamp(t, max=T - 1)  # the warm-up calls stay in bounds
            err_pos.index_copy_(0, idx, info["err_pos"].reshape(1))
            dones.index_copy_(0, idx, done.reshape(1))
            for k, v in (out or {}).get("metrics", {}).items():
                bufs[k].index_copy_(0, idx, v.unsqueeze(0))
            t.add_(1)
            graphs.copy_into(carry, (obs, env_state, control_params, info))

        dev = env.device
        t = torch.zeros(1, dtype=torch.int64, device=dev)
        err_pos = torch.zeros(T, device=dev)
        dones = torch.zeros(T, dtype=torch.bool, device=dev)
        bufs = self._metric_buffers(carry, env_params)
        streams = [*controller.random_streams(), gen]
        with metrics.deferred_sigma():
            self._step = graphs.capture(step, carry, env_params, t, err_pos, dones,
                                        bufs, streams=streams)
        self._gen = gen

    def __call__(self, reset_gen: torch.Generator, gen: torch.Generator,
                 env_params=None):
        if env_params is None:
            env_params = self.env.default_params
        carry = _start(self.env, self.controller, reset_gen, env_params)
        if self._step is None:
            self._capture(gen, env_params, carry)
        elif gen is not self._gen:
            raise ValueError("captured episode: the step generator is part of the "
                             "capture; make a runner for another one")
        buf_carry, buf_params, t, err_pos, dones, bufs = self._step.args
        graphs.copy_into(buf_carry, carry)
        graphs.copy_into(buf_params, env_params)
        t.zero_()
        for _ in range(self.steps):
            self._step.replay()
        return (err_pos.clone(), dones.clone(),
                metrics.resolve_sigma({k: v.clone() for k, v in bufs.items()}))


def make_episode_runner(env, controller, steps: Optional[int] = None):
    """Build ``run_one_ep(reset_gen, gen, env_params=None) -> (err_pos (T,),
    dones (T,), metrics)``. ``err_pos[t]`` is the tracking error of the
    PRE-step state at step t; ``reset_gen`` draws the reset, ``gen`` the
    steps; ``metrics`` holds a (T,) tensor per solve metric (``{}`` when
    the solver collects none). On the card, the control step is a captured
    CUDA graph (:class:`CapturedEpisode`); on the CPU, and inside
    ``debug_mode()``, the eager loop."""
    T = steps or env.default_params.max_steps_in_episode
    if torch.device(env.device).type == "cuda" and not debug.jit_disabled():
        return CapturedEpisode(env, controller, T)

    def run_one_ep(reset_gen: torch.Generator, gen: torch.Generator,
                   env_params=None):
        return eager_episode(env, controller, T, reset_gen, gen, env_params)

    return run_one_ep
