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
Nothing reads a device value on the host inside a captured episode. A
solver that reads the host (``capturable`` False: CoVO's ``eigh``
designer) runs the eager loop on the card too.

JAX's key schedule (``make_episode_runner``, runtime/episode.py:32-69):
when the step source is a JAX key (``utils/prng.py``), the runner follows
it as JAX does: ``rng_control, rng = split(rng)`` for the solver's reset,
then each step ``rng, rng_act, rng_step, _ = split(rng, 4)`` (the solve's
key, the env step's), and ``rng = split(rng)[0]``; the episode's last key
is written back into the caller's key tensor, as a generator advances in
place. A solver that draws from keys (``draws_from_keys``) gets
``rng_act`` and needs this schedule; any other solver draws from its own
streams beside it. Captured, the key is a device buffer of the graph's
carry.

The batched protocol's runner (:class:`BatchedEpisodes`, JAX: the
``jax.vmap`` of ``run_one_ep`` in ``evaluate_batched``) steps a chunk of B
episodes at once: the controller's batched twin
(``parallel.batched_controller``) and the env's vmapped auto-resetting
step (``models/batched.py``). A key-drawing controller runs on JAX's
per-episode keys and chain (:func:`batched_keys`); any other draws from
each episode's own reset, step and solve generators, seeded from the
protocol's seed and the episode's index alone (:func:`episode_seeds`). On
the card the batched control step is one CUDA graph per B, replayed T
times.

A solver built with ``collect_metrics`` reports each solve's health
(``runtime/metrics.py``); the runner returns them as (T,) tensors, one per
metric. The captured step writes each scalar into a (T,) buffer and CoVO's
Sigma into a (T, D, D) one (its eigensolve reads the host, so it runs once
over the stack after the episode's replays); the eager loop stacks them the
same way, so both give the same bits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from covo_mpc_tpu_torch.models.batched import BatchedEnv
from covo_mpc_tpu_torch.parallel import scenarios
from covo_mpc_tpu_torch.runtime import debug, graphs, metrics
from covo_mpc_tpu_torch.utils import prng


def _keyed(controller, gen) -> bool:
    """True when ``gen`` is a JAX key (the episode follows JAX's key
    schedule); raises for a key-drawing solver given a generator."""
    if prng.is_key(gen):
        return True
    if getattr(controller, "draws_from_keys", False):
        raise ValueError(f"{type(controller).__name__} draws from JAX keys: run its "
                         "episode on a key (runtime.eval.evaluate makes them)")
    return False


def _key_kw(controller, key) -> dict:
    return {"key": key} if getattr(controller, "draws_from_keys", False) else {}


def _start(env, controller, reset_gen, env_params, rng=None) -> tuple:
    """The episode's first carry (obs, state, solver params, info), plus the
    carried key under the key schedule (``rng``: the episode's key)."""
    obs, info, env_state = env.reset(reset_gen, env_params)
    if rng is None:
        control_params = controller.reset(env_state, env_params,
                                          controller.init_control_params)
        return obs, env_state, control_params, info
    rng_control, rng = prng.split(rng)
    control_params = controller.reset(env_state, env_params,
                                      controller.init_control_params,
                                      **_key_kw(controller, rng_control))
    return obs, env_state, control_params, info, rng


def _control_step(env, controller, carry: tuple, env_params, gen, where=None):
    """One control step: the solve, then the auto-resetting env step.
    Returns (the new carry, err_pos of the PRE-step state, done, the solve's
    metrics). A carry of five holds the key of JAX's schedule, which draws
    the step in place of ``gen``. ``where`` names the step for
    ``debug_mode()``'s finite check of the solve."""
    obs, env_state, control_params, info = carry[:4]
    kw = {}
    if len(carry) == 5:
        rng, rng_act, gen, _ = prng.split(carry[4], 4)
        kw = _key_kw(controller, rng_act)
    action, control_params, out = controller(obs, env_state, env_params,
                                             control_params, info, **kw)
    if where is not None and debug.nans_checked():
        debug.check_finite(action, control_params, where)
    obs, env_state, _, done, info = env.step(gen, env_state, action, env_params)
    new = (obs, env_state, control_params, info)
    if len(carry) == 5:
        new += (prng.split(rng)[0],)
    return new, info["err_pos"], done, (out or {}).get("metrics", {})


def _stack_metrics(per_step: list) -> dict:
    """The solves' metrics dicts stacked to (T,) tensors (Sigma's resolved
    over its (T, D, D) stack); ``{}`` when the solver collects none."""
    if not per_step or not per_step[0]:
        return {}
    return metrics.resolve_sigma({k: torch.stack([m[k] for m in per_step])
                                  for k in per_step[0]})


def eager_episode(env, controller, steps: int, reset_gen, gen, env_params=None):
    """One episode as a Python loop of eager solves and env steps: returns
    (err_pos (T,), dones (T,), metrics). ``reset_gen`` / ``gen``: generators,
    or JAX keys (the key schedule; ``gen`` receives the episode's last
    key). Inside ``debug_mode()`` each solve's action and new mean are
    checked finite."""
    if env_params is None:
        env_params = env.default_params
    keyed = _keyed(controller, gen)
    carry = _start(env, controller, reset_gen, env_params, gen if keyed else None)
    err_pos, dones, per_step = [], [], []
    with metrics.deferred_sigma():
        for t in range(steps):
            carry, err, done, m = _control_step(env, controller, carry, env_params,
                                                gen, where=f"step {t}")
            err_pos.append(err)
            dones.append(done)
            per_step.append(m)
    if keyed:
        gen.copy_(carry[4])
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
        obs, env_state, control_params, info = carry[:4]
        kw = _key_kw(controller, carry[4]) if len(carry) == 5 else {}
        with metrics.deferred_sigma():
            _, _, out = controller(obs, env_state, env_params, control_params, info,
                                   **kw)
        for s, state in zip(streams, saved):
            s.set_state(state)
        return {k: torch.zeros((T, *v.shape), dtype=v.dtype, device=v.device)
                for k, v in out["metrics"].items()}

    def _capture(self, gen, env_params, carry):
        env, controller, T = self.env, self.controller, self.steps

        def step(carry, env_params, t, err_pos, dones, bufs):
            new, err, done, step_metrics = _control_step(env, controller, carry,
                                                         env_params, gen)
            idx = torch.clamp(t, max=T - 1)  # the warm-up calls stay in bounds
            err_pos.index_copy_(0, idx, err.reshape(1))
            dones.index_copy_(0, idx, done.reshape(1))
            for k, v in step_metrics.items():
                bufs[k].index_copy_(0, idx, v.unsqueeze(0))
            t.add_(1)
            graphs.copy_into(carry, new)

        dev = env.device
        t = torch.zeros(1, dtype=torch.int64, device=dev)
        err_pos = torch.zeros(T, device=dev)
        dones = torch.zeros(T, dtype=torch.bool, device=dev)
        bufs = self._metric_buffers(carry, env_params)
        streams = [*controller.random_streams(), *([] if prng.is_key(gen) else [gen])]
        with metrics.deferred_sigma():
            self._step = graphs.capture(step, carry, env_params, t, err_pos, dones,
                                        bufs, streams=streams)
        self._gen = gen

    def __call__(self, reset_gen, gen, env_params=None):
        if env_params is None:
            env_params = self.env.default_params
        keyed = _keyed(self.controller, gen)
        carry = _start(self.env, self.controller, reset_gen, env_params,
                       gen if keyed else None)
        if self._step is None:
            self._capture(gen, env_params, carry)
        elif not keyed and gen is not self._gen:
            raise ValueError("captured episode: the step generator is part of the "
                             "capture; make a runner for another one")
        buf_carry, buf_params, t, err_pos, dones, bufs = self._step.args
        graphs.copy_into(buf_carry, carry)
        graphs.copy_into(buf_params, env_params)
        t.zero_()
        for _ in range(self.steps):
            self._step.replay()
        if keyed:
            gen.copy_(buf_carry[4])
        return (err_pos.clone(), dones.clone(),
                metrics.resolve_sigma({k: v.clone() for k, v in bufs.items()}))


def make_episode_runner(env, controller, steps: Optional[int] = None):
    """Build ``run_one_ep(reset_gen, gen, env_params=None) -> (err_pos (T,),
    dones (T,), metrics)``. ``err_pos[t]`` is the tracking error of the
    PRE-step state at step t; ``reset_gen`` draws the reset, ``gen`` the
    steps (two generators, or two JAX keys: the key schedule, which writes
    the episode's last key into ``gen``); ``metrics`` holds a (T,) tensor
    per solve metric (``{}`` when the solver collects none). On the card,
    the control step is a captured CUDA graph (:class:`CapturedEpisode`);
    on the CPU, inside ``debug_mode()`` and for a solver that is not
    ``capturable``, the eager loop."""
    T = steps or env.default_params.max_steps_in_episode
    if (torch.device(env.device).type == "cuda" and not debug.jit_disabled()
            and getattr(controller, "capturable", True)):
        return CapturedEpisode(env, controller, T)

    def run_one_ep(reset_gen, gen, env_params=None):
        return eager_episode(env, controller, T, reset_gen, gen, env_params)

    return run_one_ep


# --- the batched protocol: B episodes at once ----------------------------------

# each episode's generators, in the order episode_seeds gives their seeds
STREAMS = ("reset", "step", "solve")


def episode_seeds(seed: int, episode: int) -> tuple:
    """The seeds of episode ``episode``'s reset, step and solve generators
    in the batched protocol from ``seed`` (JAX: ``split(fold_in(base, 0 |
    1), num_eps)``): a pure function of the two, so an episode draws the
    same whatever its chunk and its batch."""
    return tuple(int(w) for w in
                 np.random.SeedSequence([seed, episode]).generate_state(3, np.uint64))


def batched_keys(seed: int, lo: int, hi: int, device) -> tuple:
    """Episodes [lo, hi)'s reset and run keys (B, 2) of JAX's batched
    protocol from ``seed`` (runtime/eval.py:128-129): ``reset_keys =
    split(fold_in(PRNGKey(seed), 0), num_eps)``, ``run_keys =
    split(fold_in(PRNGKey(seed), 1), num_eps)``, taken at [lo, hi) (a
    split's key i does not depend on the count, so a chunk's keys are the
    whole run's)."""
    base = prng.PRNGKey(seed, device)
    return tuple(prng.split(prng.fold_in(base, i), hi)[lo:hi] for i in (0, 1))


class BatchedEpisodes:
    """``run(seed, lo, hi, env_params=None) -> (err_pos (B, T), dones (B,
    T))``: episodes [lo, hi) of the batched protocol from ``seed``, B = hi
    - lo at once. Nothing random is carried between chunks, as in JAX.

    A controller that draws from JAX keys (``draws_from_keys``) runs on
    JAX's keys (:func:`batched_keys`) and each episode follows JAX's
    per-episode chain (``make_episode_runner``, over the leading axis of
    the (B, 2) key stack): the env's reset from its reset key, ``rng_control,
    rng = split(run_key)`` for the twin's reset, then each step ``rng,
    rng_act, rng_step, _ = split(rng, 4)`` and ``rng = split(rng)[0]``. Any
    other controller keeps the port's generators: each chunk restarts the
    twin's streams from ``seed`` and seeds every episode's reset, step and
    solve generators from its index (:func:`episode_seeds`); K7 reads
    ``lo`` as its episode offset. Either way an episode draws the same in
    any chunk.

    On the card one batched control step (the twin's solve, the vmapped env
    step with its auto-reset select, the write-back of the carry and of
    ``err_pos[:, t]``, ``done[:, t]``) is captured once per B, with every
    generator and seed stream it draws from registered (the keys are part
    of the carry), and replayed T times; the reset (and the twin's: the
    speculative step-0 design, the offline schedules) runs eagerly. On the
    CPU, inside ``debug_mode()`` (each solve checked finite there) and for
    a twin that is not ``capturable`` (eigh), the eager loop."""

    def __init__(self, env, controller, steps: int):
        self.env, self.steps = env, steps
        self.twin = scenarios.batched_controller(controller)
        self.benv = BatchedEnv(env)
        self.keyed = getattr(controller, "draws_from_keys", False)
        self._gens: dict = {}  # B -> one list of B generators a stream
        self.captured: dict = {}  # B -> the captured control step (CapturedCall)

    def _generators(self, seed: int, lo: int, hi: int) -> list:
        B = hi - lo
        if B not in self._gens:
            self._gens[B] = [[torch.Generator(device=self.env.device) for _ in range(B)]
                             for _ in STREAMS]
        gens = self._gens[B]
        for b in range(B):
            for stream, s in zip(gens, episode_seeds(seed, lo + b)):
                stream[b].manual_seed(s)
        return gens

    def _control_step(self, carry, env_params, offset, step_src, solve_src):
        """One step of every episode: (the new carry, err_pos (B,) of the
        pre-step states, done (B,)). A carry of five holds the episodes'
        keys, which give the step's sources in place of the generators."""
        obs, state, tcarry, info = carry[:4]
        if self.keyed:
            rng, solve_src, step_src, _ = prng.split(carry[4], 4).unbind(-2)
        action, tcarry = self.twin(state, info, env_params, tcarry, solve_src, offset)
        if debug.nans_checked():
            debug.check_finite(action, None, "batched solve")
        obs, state, _, done, info = self.benv.step(step_src, state, action, env_params)
        new = (obs, state, tcarry, info)
        if self.keyed:
            new += (prng.split(rng)[..., 0, :],)
        return new, info["err_pos"], done

    def _capture(self, B, carry, env_params, step_gens, solve_gens):
        T, dev = self.steps, self.env.device

        def step(carry, env_params, offset, t, err_pos, dones):
            new, err, done = self._control_step(carry, env_params, offset, step_gens,
                                                solve_gens)
            idx = torch.clamp(t, max=T - 1)  # the warm-up calls stay in bounds
            err_pos.index_copy_(1, idx, err[:, None])
            dones.index_copy_(1, idx, done[:, None])
            t.add_(1)
            graphs.copy_into(carry, new)

        gens = [] if self.keyed else [*step_gens, *solve_gens]
        self.captured[B] = graphs.capture(
            step, carry, env_params, torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.int64, device=dev), torch.zeros(B, T, device=dev),
            torch.zeros(B, T, dtype=torch.bool, device=dev),
            streams=[*self.twin.random_streams(), *gens])

    def _first_carry(self, seed: int, lo: int, hi: int, env_params):
        """The chunk's first carry and its step and solve sources (None
        under the key schedule, whose keys the carry holds)."""
        B = hi - lo
        self.twin.seed(seed)
        if self.keyed:
            reset_keys, run_keys = batched_keys(seed, lo, hi, self.env.device)
            obs, info, state = self.benv.reset(reset_keys, env_params)
            rng_control, rng = prng.split(run_keys).unbind(-2)
            tcarry = self.twin.reset(B, state, env_params, rng_control)
            return (obs, state, tcarry, info, rng), None, None
        reset_gens, step_gens, solve_gens = self._generators(seed, lo, hi)
        obs, info, state = self.benv.reset(reset_gens, env_params)
        tcarry = self.twin.reset(B, state, env_params, solve_gens)
        return (obs, state, tcarry, info), step_gens, solve_gens

    def __call__(self, seed: int, lo: int, hi: int, env_params=None):
        if env_params is None:
            env_params = self.env.default_params
        B = hi - lo
        carry, step_gens, solve_gens = self._first_carry(seed, lo, hi, env_params)
        if (torch.device(self.env.device).type != "cuda" or debug.jit_disabled()
                or not self.twin.capturable):
            errs, dones = [], []
            for _ in range(self.steps):
                carry, err, done = self._control_step(carry, env_params, lo, step_gens,
                                                      solve_gens)
                errs.append(err)
                dones.append(done)
            return torch.stack(errs, dim=1), torch.stack(dones, dim=1)
        if B not in self.captured:
            self._capture(B, carry, env_params, step_gens, solve_gens)
        cap = self.captured[B]
        buf_carry, buf_params, offset, t, err_pos, dones = cap.args
        graphs.copy_into(buf_carry, carry)
        graphs.copy_into(buf_params, env_params)
        offset.fill_(lo)
        t.zero_()
        for _ in range(self.steps):
            cap.replay()
        return err_pos.clone(), dones.clone()


def make_batched_episode_runner(env, controller, steps: Optional[int] = None):
    """The batched protocol's episode runner (:class:`BatchedEpisodes`) for
    ``controller``'s batched twin; T = ``steps`` or the env's episode
    length. Raises for a controller with no batched twin."""
    return BatchedEpisodes(env, controller,
                           steps or env.default_params.max_steps_in_episode)
