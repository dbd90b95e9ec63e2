"""Failure-detecting, checkpointed evaluation: recovery for long runs.

Counterpart of :mod:`covo_mpc_tpu.runtime.supervisor`. ``run_supervised``
runs the exact
:func:`covo_mpc_tpu_torch.runtime.eval.evaluate` protocol as a sequence of
chunks (runs of episodes) and adds around each chunk:

1. **Checkpoint/resume.** After every chunk, ``checkpoint_dir`` receives
   the protocol's random state (the step generator's ``get_state()`` and
   each of the solver's streams, ``random_streams()``; for a solver that
   draws from JAX keys, the key that runs through the episodes, as JAX's
   chunk carries it), the partial
   per-episode errors, the ``failed`` mask and a manifest carrying the
   caller's fingerprint. A re-invocation with the same protocol resumes at
   the first incomplete chunk, and its result equals an uninterrupted
   run's bit for bit; a checkpoint of another protocol is refused.
2. **Numeric failure detection.** A chunk whose episode errors come back
   non-finite is retried from the same state; a deterministic failure is
   recorded in the ``failed`` mask and EXCLUDED from the summary.
3. **Backend failure detection.** An exception out of a chunk is retried
   (with backoff, after an optional ``probe``); when the retries run out
   the run raises AFTER checkpointing, and the same command resumes.

Every event is appended to ``checkpoint_dir/events.jsonl``. Between chunks
the random state lives on the host (numpy arrays), so a chunk's input is
exactly what a checkpoint holds.

``run_supervised_batched`` is the same recovery over the throughput
protocol (:func:`~covo_mpc_tpu_torch.runtime.eval.evaluate_batched`),
chunked over blocks of episodes. That protocol carries no random state
between episodes (each has its own generators, seeded from the protocol's
seed and its index), so the chunks are independent and the carry is a
dummy, as in JAX; the manifest says ``"protocol": "batched"``.

``CellStore`` lifts recovery to the level of a sweep (a matrix of config
cells): each finished cell's summary goes into ``root/cells.json``, so a
sweep interrupted between cells resumes without recomputing a finished
one, and the cell in flight resumes from its own checkpoint under
``root/<slug>/``. It is host code only and keeps JAX's file layout, so
either package reads the other's store.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from covo_mpc_tpu_torch.runtime.episode import (
    make_batched_episode_runner,
    make_episode_runner,
)
from covo_mpc_tpu_torch.runtime.eval import EvalResult, key_protocol, protocol, run_episode

_MANIFEST = "manifest.json"
_STATE = "state.npz"
_EVENTS = "events.jsonl"


@dataclasses.dataclass
class SupervisedResult(EvalResult):
    failed: Optional[np.ndarray] = None  # (num_eps,) bool: excluded episodes
    events: Optional[list] = None  # recovery-event records
    resumed_at_chunk: int = 0  # 0 = fresh run

    def summary(self) -> str:
        base = super().summary()
        n_fail = int(self.failed.sum()) if self.failed is not None else 0
        if n_fail:
            base += f" ({n_fail} episode(s) FAILED and excluded)"
        return base


class _EventLog:
    def __init__(self, path: Optional[str]):
        self._fh = open(path, "a") if path else None
        self.records = []

    def emit(self, kind: str, **detail):
        rec = {"ts": time.time(), "kind": kind, **detail}
        self.records.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()


def _save_state(ckpt_dir, manifest, carry, err_pos, failed, completed):
    """Crash-atomic checkpoint commit: state.npz (the carry, the errors, the
    mask and ``completed``) is written to a temporary file and moved into
    place, so a kill at any instant leaves the previous checkpoint or the
    new one. The manifest keeps a copy of ``completed`` for readers; resume
    trusts the npz."""
    spath = os.path.join(ckpt_dir, _STATE)
    stmp = spath + ".tmp"
    with open(stmp, "wb") as fh:
        np.savez(fh, **{f"carry_{i}": c for i, c in enumerate(carry)},
                 err_pos=err_pos, failed=failed,
                 completed=np.asarray(completed, np.int64))
    os.replace(stmp, spath)
    manifest = dict(manifest, completed=completed)
    tmp = os.path.join(ckpt_dir, _MANIFEST + ".tmp")
    with open(tmp, "w") as fh:
        json.dump(manifest, fh)
    os.replace(tmp, os.path.join(ckpt_dir, _MANIFEST))


def _try_resume(ckpt_dir, manifest, log):
    """Load a matching checkpoint; a mismatched protocol is refused."""
    mpath = os.path.join(ckpt_dir, _MANIFEST)
    spath = os.path.join(ckpt_dir, _STATE)
    if not (os.path.exists(mpath) and os.path.exists(spath)):
        return None
    with open(mpath) as fh:
        on_disk = json.load(fh)
    on_disk.pop("completed", None)
    if on_disk != manifest:
        raise ValueError(
            f"checkpoint at {ckpt_dir} belongs to a different protocol "
            f"({on_disk} != {manifest}); pass a fresh --checkpoint-dir"
        )
    with np.load(spath) as data:
        completed = int(data["completed"])
        n = sum(k.startswith("carry_") for k in data.files)
        carry = tuple(data[f"carry_{i}"].copy() for i in range(n))
        state = (carry, data["err_pos"].copy(), data["failed"].copy())
    log.emit("resume", completed_chunks=completed)
    return completed, state


def _stream_state(s) -> np.ndarray:
    return s.get_state().cpu().numpy()


def _set_stream_state(s, state: np.ndarray) -> None:
    t = torch.from_numpy(np.array(state))
    s.set_state(t if isinstance(s, torch.Generator) else t.to(s.counter.device))


def run_supervised(
    env,
    controller,
    total_steps: int = 12000,
    num_trajs: int = 4,
    seed: int = 1,
    checkpoint_dir: Optional[str] = None,
    chunk_episodes: int = 4,
    max_retries: int = 2,
    backoff_s: float = 0.0,
    probe: Optional[Callable[[], bool]] = None,
    fingerprint: str = "",
    _fault_hook: Optional[Callable[[int, int], None]] = None,
) -> SupervisedResult:
    """:func:`~covo_mpc_tpu_torch.runtime.eval.evaluate` with
    checkpoint/resume and failure recovery.

    Args:
      checkpoint_dir: where chunk checkpoints live; None disables
        persistence (detection and retry still run).
      chunk_episodes: episodes per chunk, the recovery granularity (one
        episode runner, on the card one captured step, serves every chunk).
      max_retries: per-chunk retries for numeric or backend failures.
      backoff_s: sleep between backend-failure retries.
      probe: optional health check called before a backend retry; returning
        False skips the retry and raises at once.
      fingerprint: caller-supplied config digest folded into the manifest
        so a checkpoint is never resumed under another solver or env.
      _fault_hook: test-only injection point, called as (chunk, attempt)
        inside the chunk's try-block, so a raise exercises the
        backend-failure path.
    """
    run_one_ep = make_episode_runner(env, controller)
    controller.seed(seed)
    if getattr(controller, "draws_from_keys", False):
        # JAX's schedule (runtime/supervisor.py:163-235): evaluate's keys,
        # the chunk's carry the key that runs through every episode
        num_eps, reps, reset_keys, rng = key_protocol(env, total_steps, num_trajs, seed)

        def run_chunk(carry, lo, hi):
            key = torch.from_numpy(np.array(carry[0])).to(env.device)
            errs = [run_one_ep(reset_keys[i // reps], key)[0].mean()
                    for i in range(lo, hi)]
            return (key.cpu().numpy(),), torch.stack(errs).cpu()

        carry = (rng.cpu().numpy(),)
    else:
        num_eps, reps, reset_seeds, step_seed = protocol(env, total_steps, num_trajs,
                                                         seed)
        gen = torch.Generator(device=env.device).manual_seed(step_seed)
        streams = [gen, *controller.random_streams()]

        def run_chunk(carry, lo, hi):
            for s, state in zip(streams, carry):
                _set_stream_state(s, state)
            errs = [run_episode(env, run_one_ep, reset_seeds[i // reps], gen)[0]
                    for i in range(lo, hi)]
            errs = torch.stack(errs).cpu()
            return tuple(_stream_state(s) for s in streams), errs

        carry = tuple(_stream_state(s) for s in streams)

    manifest = {
        "seed": seed,
        "num_eps": num_eps,
        "num_trajs": min(num_trajs, num_eps),
        "chunk_episodes": chunk_episodes,
        "fingerprint": fingerprint,
    }
    return _run_chunked(
        run_chunk, carry, num_eps, chunk_episodes, manifest, checkpoint_dir,
        max_retries, backoff_s, probe, _fault_hook,
    )


def _run_chunked(run_chunk, carry, num_eps, chunk_episodes, manifest,
                 checkpoint_dir, max_retries, backoff_s, probe,
                 _fault_hook) -> SupervisedResult:
    """The recovery loop: ``run_chunk(carry, lo, hi) -> (carry, errs
    (hi - lo,))`` runs episodes [lo, hi) from the host-side ``carry`` (a
    tuple of numpy arrays), which is threaded between chunks and through the
    checkpoint."""
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
    log = _EventLog(os.path.join(checkpoint_dir, _EVENTS) if checkpoint_dir else None)
    err_pos = np.full((num_eps,), np.nan, np.float64)
    failed = np.zeros((num_eps,), bool)
    start_chunk = 0
    starts = list(range(0, num_eps, chunk_episodes))
    if checkpoint_dir:
        resumed = _try_resume(checkpoint_dir, manifest, log)
        if resumed is not None:
            start_chunk, (carry, err_pos, failed) = resumed

    resumed_at = start_chunk
    try:
        for ci in range(start_chunk, len(starts)):
            lo = starts[ci]
            hi = min(lo + chunk_episodes, num_eps)
            for attempt in range(max_retries + 1):
                try:
                    if _fault_hook is not None:
                        _fault_hook(ci, attempt)
                    # retries re-run the chunk from the same carry
                    carry_out, errs = run_chunk(carry, lo, hi)
                    errs = errs.numpy().astype(np.float64)
                except Exception as e:  # noqa: BLE001 — the backend failure path
                    log.emit("backend_failure", chunk=ci, attempt=attempt,
                             error=f"{type(e).__name__}: {e}"[:300])
                    if attempt >= max_retries or (probe is not None and not probe()):
                        raise RuntimeError(
                            f"chunk {ci} failed after {attempt + 1} attempt(s); "
                            f"progress through chunk {ci - 1} is checkpointed"
                            + (f" in {checkpoint_dir} — re-run the same command "
                               "to resume" if checkpoint_dir else
                               " (no checkpoint_dir — pass one to make this "
                               "resumable)")
                        ) from e
                    if backoff_s:
                        time.sleep(backoff_s * (attempt + 1))
                    continue
                if np.isfinite(errs).all():
                    break
                bad = [int(lo + i) for i in np.flatnonzero(~np.isfinite(errs))]
                log.emit("numeric_failure", chunk=ci, attempt=attempt, episodes=bad)
            else:
                # retries exhausted on a numeric failure: deterministic, so
                # mark it and go on with the carry the chunk produced
                failed[lo:hi] = ~np.isfinite(errs)
            err_pos[lo:hi] = errs
            carry = carry_out
            if checkpoint_dir:
                _save_state(checkpoint_dir, manifest, carry, err_pos, failed,
                            completed=ci + 1)
            log.emit("chunk_done", chunk=ci, episodes=[int(lo), int(hi)])
    finally:
        log.close()

    ok = ~failed & np.isfinite(err_pos)
    mean = float(err_pos[ok].mean()) if ok.any() else float("nan")
    std = float(err_pos[ok].std()) if ok.any() else float("nan")
    return SupervisedResult(
        err_pos_ep=torch.from_numpy(err_pos),
        mean=mean,
        std=std,
        failed=failed,
        events=log.records,
        resumed_at_chunk=resumed_at,
    )


def run_supervised_batched(
    env,
    controller,
    num_eps: int = 40,
    seed: int = 1,
    env_params=None,
    checkpoint_dir: Optional[str] = None,
    chunk_episodes: int = 8,
    max_retries: int = 2,
    backoff_s: float = 0.0,
    probe: Optional[Callable[[], bool]] = None,
    fingerprint: str = "",
    _fault_hook: Optional[Callable[[int, int], None]] = None,
) -> SupervisedResult:
    """:func:`~covo_mpc_tpu_torch.runtime.eval.evaluate_batched` with
    checkpoint/resume and failure recovery, chunked over blocks of
    ``chunk_episodes`` episodes (the arguments as :func:`run_supervised`'s).

    Each chunk runs its episodes with their own generators and the twin's
    streams restarted from ``seed`` (K7 offset to the chunk's first
    episode), so an episode's draws do not depend on its chunk: a resumed
    run equals an uninterrupted one bit for bit, and the per-episode values
    equal ``evaluate_batched``'s up to the arithmetic of another batch
    width (on the card one captured step per chunk width). A dummy carry
    keeps the checkpoint format shared with :func:`run_supervised`.
    """
    run = make_batched_episode_runner(env, controller)

    def run_chunk(carry, lo, hi):
        err_pos, _ = run(seed, lo, hi, env_params)
        return carry, err_pos.mean(dim=1).cpu()

    manifest = {
        "seed": seed,
        "num_eps": num_eps,
        "chunk_episodes": chunk_episodes,
        "fingerprint": fingerprint,
        "protocol": "batched",
    }
    return _run_chunked(
        run_chunk, (), num_eps, chunk_episodes, manifest, checkpoint_dir,
        max_retries, backoff_s, probe, _fault_hook,
    )


def _clear_checkpoint(ckpt_dir: str) -> None:
    """Remove a chunked run's checkpoint (manifest and state) from ``ckpt_dir``."""
    for f in (_MANIFEST, _STATE):
        p = os.path.join(ckpt_dir, f)
        if os.path.exists(p):
            os.remove(p)


class CellStore:
    """Sweep-level resume for the scripts that run a matrix of config cells
    (JAX: ``runtime.supervisor.CellStore``, the same files).

    Every finished cell's summary is recorded in ``root/cells.json``
    (replaced atomically) under its key with the config's fingerprint;
    re-running the same sweep skips finished cells, and the cell in flight
    resumes from its own :func:`run_supervised` /
    :func:`run_supervised_batched` checkpoint under :meth:`cell_dir`. A
    fingerprint change invalidates that cell only.
    """

    _CELLS = "cells.json"

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._path = os.path.join(root, self._CELLS)
        self._cells = {}
        if os.path.exists(self._path):
            with open(self._path) as fh:
                self._cells = json.load(fh)

    @staticmethod
    def _slug(key: str) -> str:
        """A file-system-safe, unique directory name for a cell key: a
        readable prefix (unsafe characters as '_', which can collide: 'covo
        N=8' and 'covo_N.8') and the first 8 hex digits of the key's SHA-1,
        so one cell's clearing of a stale checkpoint never touches another's."""
        safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in key)
        return f"{safe}-{hashlib.sha1(key.encode()).hexdigest()[:8]}"

    def cell_dir(self, key: str) -> str:
        return os.path.join(self.root, self._slug(key))

    def get(self, key: str, fingerprint: str):
        rec = self._cells.get(key)
        if rec is not None and rec.get("fingerprint") == fingerprint:
            return rec["value"]
        return None

    def put(self, key: str, fingerprint: str, value) -> None:
        self._cells[key] = {"fingerprint": fingerprint, "value": value}
        self._flush()

    def drop(self, key: str, clear_checkpoint: bool = False) -> None:
        """Forget a finished cell (a fresh re-measurement).
        ``clear_checkpoint=True`` also deletes the cell's chunk checkpoint,
        so the re-run recomputes (a finished checkpoint would resume at its
        end)."""
        if self._cells.pop(key, None) is not None:
            self._flush()
        if clear_checkpoint:
            _clear_checkpoint(self.cell_dir(key))

    def _flush(self) -> None:
        tmp = self._path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self._cells, fh, indent=1)
        os.replace(tmp, self._path)

    def run_cell(self, key: str, fingerprint: str, fn):
        """Memoized cell: ``fn(checkpoint_dir) -> json-able``. Returns
        ``(value, was_cached)``; on a miss, runs ``fn`` with the cell's own
        checkpoint directory (pass it to :func:`run_supervised` or
        :func:`run_supervised_batched`) and records the result.

        A miss must recompute, not crash, on a stale checkpoint: one whose
        manifest has another fingerprint is cleared first, and a refusal of
        a checkpoint of a different protocol (a field the fingerprint does
        not encode: seed, chunk_episodes, num_trajs) clears it and retries
        once."""
        cached = self.get(key, fingerprint)
        if cached is not None:
            return cached, True
        d = self.cell_dir(key)
        mpath = os.path.join(d, _MANIFEST)
        if os.path.exists(mpath):
            try:
                with open(mpath) as fh:
                    stale = json.load(fh).get("fingerprint") != fingerprint
            except (OSError, ValueError):
                stale = True  # an unreadable manifest: clear it too
            if stale:
                _clear_checkpoint(d)
        try:
            value = fn(d)
        except ValueError as e:
            if "different protocol" not in str(e):
                raise
            _clear_checkpoint(d)
            value = fn(d)
        self.put(key, fingerprint, value)
        return value, False
