"""Latency of a solve: per-call percentiles, chained calls, profiler traces.

Counterpart of the latency half of :mod:`covo_mpc_tpu.runtime.profiling`:
:func:`time_blocking` (host wall per call, synced on one result leaf, the
same keys as JAX's), :func:`time_chained` (CUDA events over k dependent
calls, in the place of JAX's chained ``lax.scan``), :func:`trace` (a
``torch.profiler`` session, a no-op without a directory) and
:func:`device_info` (the card's name and power limit beside a number).
JAX's XLA-trace readers are not ported (ROADMAP.md queue 1).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import numpy as np
import torch

from covo_mpc_tpu_torch.runtime.graphs import flatten

_clock = time.perf_counter


def _sync(out):
    """Wait for a result by copying one of its tensor leaves to the host
    (all earlier work on its stream is then done): what a host-in-the-loop
    controller waits for."""
    leaves, _ = flatten(out)
    if leaves:
        leaves[0].reshape(-1)[:1].cpu()
    return out


def _stats(seconds, **extra) -> dict:
    arr = np.sort(np.asarray(seconds, dtype=np.float64))
    return {
        "p50": float(np.percentile(arr, 50)),
        "p90": float(np.percentile(arr, 90)),
        "p99": float(np.percentile(arr, 99)),
        "mean": float(arr.mean()),
        "iters": len(arr),
        **extra,
    }


def time_blocking(fn: Callable, iters: int = 30, warmup: int = 2, *args, **kw) -> dict:
    """Per-call latency of ``fn(*args, **kw)``: host wall seconds from the
    call to one result leaf on the host, ``iters`` calls after ``warmup``.
    Returns p50 / p90 / p99 / mean seconds and ``iters``."""
    for _ in range(warmup):
        _sync(fn(*args, **kw))
    times = []
    for _ in range(iters):
        t0 = _clock()
        _sync(fn(*args, **kw))
        times.append(_clock() - t0)
    return _stats(times)


def time_chained(step: Callable, carry, iters: int = 8, k: int = 32,
                 warmup: int = 1) -> dict:
    """Device seconds per call of a chain of k dependent calls ``carry =
    step(carry)`` (a control loop's shape): CUDA events around each chain of
    k, ``iters`` chains after ``warmup``. Returns the per-call p50 / p90 /
    p99 / mean over the chains, ``iters``, ``k`` and ``method``. Needs the
    card: a CUDA event times the device's timeline."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_chained: CUDA events need a CUDA device")
    for _ in range(warmup):
        for _ in range(k):
            carry = step(carry)
    pairs = []
    for _ in range(iters):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(k):
            carry = step(carry)
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    per_call = [a.elapsed_time(b) / 1e3 / k for a, b in pairs]
    return _stats(per_call, k=k, method="cuda_events")


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """A ``torch.profiler`` session (host and, on the card, device
    activity) that writes a Chrome trace into ``log_dir`` when it ends; a
    no-op when ``log_dir`` is None. Yields the profiler (or None)."""
    if log_dir is None:
        yield None
        return
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / f"trace_{int(time.time() * 1e3)}.json"))


def device_info(device) -> dict:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, for a device on the
    card; ``{"name": "cpu", "power_limit": None}`` for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    index = torch.cuda.current_device() if device.index is None else device.index
    name, power = (x.strip() for x in out[index].rsplit(",", 1))
    return {"name": name, "power_limit": power}
