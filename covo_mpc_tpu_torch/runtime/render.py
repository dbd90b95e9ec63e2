"""Render harness: record a full episode trace for plotting or replay.

Counterpart of :mod:`covo_mpc_tpu.runtime.render`, with the same channels
and shapes: ``RECORD_FIELDS`` of the pre-step state, plus ``reward``,
``done``, ``err_pos`` and ``action``, each (T, ...), saved as ``.npz``.

On the card the recording step (the solve, the env step, each channel
written at row t of its (T, ...) device buffer) is captured as one CUDA
graph (``runtime/graphs.py``) and replayed T times, as JAX scans its jitted
step. On the CPU, inside ``runtime.debug.debug_mode()`` and for a
controller that reads the host (``capturable`` False: the eigh designer),
the step runs as an eager loop.

A controller that draws from JAX keys (``draws_from_keys``) records under
JAX's key chain (render.py:30-113): ``split`` for the params, the reset
and the controller's reset, ``split(rng, 3)`` each step (the solve's key,
the env step's), and on a done the reference's splits for the new params
and the controller's reset; captured, the key is part of the graph's
carry. Any other controller draws from generators seeded from ``seed``.

``reset_on_done`` re-samples the env params and resets the controller
whenever an episode ends inside the recording (JAX: render.py:75-90). On
the card that is the one host read of the loop: after each replay the
step's ``done`` is read; on a done the params are drawn
(``env.sample_params``) and the controller reset eagerly, and both are
loaded into the graph's buffers, so the new draw takes effect from the
next step, as in JAX. A redraw must keep the captured integer constants
of the params (``sample_params`` keeps the defaults').
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from covo_mpc_tpu_torch.runtime import debug, graphs, metrics
from covo_mpc_tpu_torch.utils import prng

RECORD_FIELDS = (
    "pos", "vel", "quat", "omega", "omega_tar", "pos_tar", "vel_tar",
    "last_thrust", "last_torque", "f_disturb", "time",
)


def _step(env, controller, gen, obs, state, env_params, control_params, info,
          rng=None):
    """One recorded control step: the new carry and the step's record. The
    step-RETURNED info's err_pos is evaluated on the PRE-step state, the
    one this record snapshots (the carried info holds the previous
    step's). Under JAX's key schedule ``rng`` is the carried key: ``rng,
    rng_act, rng_step = split(rng, 3)`` (render.py:68), and the new carry
    holds the new ``rng``."""
    record = {f: getattr(state, f) for f in RECORD_FIELDS}
    kw = {}
    if rng is not None:
        rng, rng_act, gen = prng.split(rng, 3)
        kw = {"key": rng_act}
    action, control_params, _ = controller(obs, state, env_params,
                                           control_params, info, **kw)
    next_obs, next_state, reward, done, next_info = env.step(gen, state, action,
                                                             env_params)
    record.update(reward=reward, done=done, err_pos=next_info["err_pos"],
                  action=action)
    new = (next_obs, next_state, control_params, next_info)
    return new + ((rng,) if rng is not None else ()), record


def _on_done(env, controller, param_gen, state, control_params, rng=None):
    """The reference's reset on done (render.py:76-85): new env params, and
    the controller reset with the PRE-step state, the CURRENT control
    params and the NEW params. Under the key schedule both draw from the
    carried key: ``rng, rng_params = split(rng)``, ``rng, rng_control =
    split(rng)``; returns (params, control params, the new key)."""
    if rng is None:
        env_params = env.sample_params(param_gen)
        return env_params, controller.reset(state, env_params, control_params), None
    rng, rng_params = prng.split(rng)
    env_params = env.sample_params(rng_params)
    rng, rng_control = prng.split(rng)
    return env_params, controller.reset(state, env_params, control_params,
                                        key=rng_control), rng


def _render_eager(env, controller, T, gen, param_gen, carry, env_params,
                  reset_on_done):
    check = debug.nans_checked()
    records = []
    for t in range(T):
        obs, state, control_params, info = carry[:4]
        carry, record = _step(env, controller, gen, obs, state, env_params,
                              control_params, info, *carry[4:])
        if check:
            debug.check_finite(record["action"], carry[2], f"step {t}")
        records.append(record)
        if reset_on_done and bool(record["done"]):
            env_params, control_params, rng = _on_done(env, controller, param_gen, state,
                                                       carry[2], *carry[4:])
            carry = (*carry[:2], control_params, carry[3],
                     *(() if rng is None else (rng,)))
    return {k: torch.stack([r[k] for r in records]) for k in records[0]}


def _render_captured(env, controller, T, gen, param_gen, carry, env_params,
                     reset_on_done):
    state = carry[1]
    keyed = len(carry) == 5
    dev = state.pos.device
    bufs = {f: torch.zeros((T, *getattr(state, f).shape),
                           dtype=getattr(state, f).dtype, device=dev)
            for f in RECORD_FIELDS}
    bufs.update(reward=torch.zeros(T, device=dev),
                done=torch.zeros(T, dtype=torch.bool, device=dev),
                err_pos=torch.zeros(T, device=dev),
                action=torch.zeros(T, env.action_dim, device=dev))

    def step(carry, env_params, t, bufs):
        obs, state, control_params, info = carry[:4]
        new, record = _step(env, controller, gen, obs, state, env_params,
                            control_params, info, *(carry[4:5] if keyed else ()))
        idx = torch.clamp(t, max=T - 1)  # the warm-up calls stay in bounds
        for k, v in record.items():
            bufs[k].index_copy_(0, idx, v.to(bufs[k].dtype).unsqueeze(0))
        t.add_(1)
        # under reset_on_done the carry's last slot keeps the pre-step
        # state, which the controller's reset takes
        graphs.copy_into(carry, (*new, state) if reset_on_done else new)

    t = torch.zeros(1, dtype=torch.int64, device=dev)
    args = (*carry, carry[1]) if reset_on_done else carry
    streams = [*controller.random_streams(), *([] if keyed else [gen])]
    with metrics.deferred_sigma():
        cap = graphs.capture(step, args, env_params, t, bufs, streams=streams)
    buf_carry, buf_params, t, bufs = cap.args
    graphs.copy_into(buf_carry, args)
    t.zero_()
    for i in range(T):
        cap.replay()
        if reset_on_done and bool(bufs["done"][i]):
            new_params, control_params, rng = _on_done(
                env, controller, param_gen, buf_carry[-1], buf_carry[2],
                *((buf_carry[4],) if keyed else ()))
            graphs.copy_into(buf_params, new_params)
            graphs.copy_into(buf_carry[2], control_params)
            if keyed:
                buf_carry[4].copy_(rng)
    return {k: v.clone() for k, v in bufs.items()}


def render_episode(env, controller, seed: int = 1, steps: Optional[int] = None,
                   env_params=None, reset_on_done: bool = False) -> dict:
    """Run one recorded episode. Returns a dict of numpy arrays with keys
    ``RECORD_FIELDS`` + reward / done / err_pos / action, each (T, ...).

    From ``seed``: the env params (``env.sample_params``, unless given),
    the reset, the step generator and the controller's streams; or, for a
    key-drawing controller, JAX's key chain from ``PRNGKey(seed)``.
    ``reset_on_done`` reproduces the reference harness's mid-recording
    resets: when an episode ends inside the recording, the env params are
    re-sampled and the controller reset (with the PRE-step state, the
    CURRENT control params and the NEW params). The auto-reset inside
    ``env.step`` has already re-initialized the state under the OLD params;
    the new draw takes effect from the following step, as in JAX. Off by
    default: the env params then stay fixed."""
    T = steps or env.default_params.max_steps_in_episode
    dev = env.device
    controller.seed(seed)
    if getattr(controller, "draws_from_keys", False):
        # JAX's chain (render.py:53-62): the params, the reset and the
        # controller's reset each from a split of PRNGKey(seed)
        rng, rng_params = prng.split(prng.PRNGKey(seed, dev))
        if env_params is None:
            env_params = env.sample_params(rng_params)
        rng, rng_reset = prng.split(rng)
        obs, info, state = env.reset(rng_reset, env_params)
        rng, rng_control = prng.split(rng)
        control_params = controller.reset(state, env_params,
                                          controller.init_control_params, key=rng_control)
        carry, gen, param_gen = (obs, state, control_params, info, rng), None, None
    else:
        meta = torch.Generator().manual_seed(seed)
        param_seed, reset_seed, step_seed = torch.randint(0, 2**62, (3,),
                                                          generator=meta).tolist()
        param_gen = torch.Generator(device=dev).manual_seed(param_seed)
        if env_params is None:
            env_params = env.sample_params(param_gen)
        obs, info, state = env.reset(torch.Generator(device=dev).manual_seed(reset_seed),
                                     env_params)
        control_params = controller.reset(state, env_params,
                                          controller.init_control_params)
        gen = torch.Generator(device=dev).manual_seed(step_seed)
        carry = (obs, state, control_params, info)
    captured = (torch.device(dev).type == "cuda" and not debug.jit_disabled()
                and getattr(controller, "capturable", True))
    run = _render_captured if captured else _render_eager
    records = run(env, controller, T, gen, param_gen, carry, env_params, reset_on_done)
    return {k: v.cpu().numpy() for k, v in records.items()}


def save_trace(trace: dict, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **trace)
    return path


def load_trace(path: str) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}
