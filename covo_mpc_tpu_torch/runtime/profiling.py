"""Latency of a solve and profiler traces of the card: per-call percentiles,
chained calls, device timestamps.

Counterpart of :mod:`covo_mpc_tpu.runtime.profiling`:

- host and CUDA-event timing: :func:`time_blocking` (host wall per call,
  synced on one result leaf, the same keys as JAX's), :func:`time_chained`
  (CUDA events over k dependent calls, in the place of JAX's chained
  ``lax.scan``), :func:`per_solve_events` (each call's device time in such
  chains), :func:`time_slope` (JAX's two-point fit over chains of k and
  5k) and :func:`device_info` (the card's name and power limit beside a
  number);
- ``torch.profiler`` sessions: :func:`trace` (a Chrome trace into a
  directory, a no-op without one), :func:`profiled`, :func:`device_profile`
  and :func:`graph_profile` (device time counted only from sessions that
  lost no event), :func:`graph_nodes` (the device ops of a captured graph);
- the trace readers, JAX's XLA-trace readers translated to the Chrome trace
  ``torch.profiler`` writes: :func:`load_device_trace`,
  :func:`step_durations`, :func:`per_solve_distribution`,
  :func:`hlo_summary`, :func:`trace_chains` and :func:`time_trace` /
  :func:`trace_seconds` (device seconds per call of a chain of graph
  replays).

On the H100 a profiler session can lose device events, more of them in a
large session and as a process has run more sessions; the host calls that
enqueue device work are recorded in every session. So device time is read
only from a complete session: one whose device ops number the graph
replays' nodes plus the host's enqueue calls (:data:`ENQUEUE_CALLS`). A
session also slows the replays of a captured graph (its launch is
instrumented node by node on the host), so the gaps between device ops
under a trace are not those of an untraced run: :func:`per_solve_events`
and :func:`time_chained` time the device timeline with CUDA events.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import shutil
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from covo_mpc_tpu_torch.ops import kernels
from covo_mpc_tpu_torch.runtime.graphs import flatten

_clock = time.perf_counter

# idle seconds at both ends of a profiler session's window
PROFILER_PAD_S = 0.05
# CUDA API calls that enqueue device work (kernel launches, copies, fills);
# a graph launch is counted by its nodes instead
ENQUEUE_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset",
                 "cuMemset")
# the Chrome trace's categories of device ops (a record_function range's
# device-side twin, "gpu_user_annotation", is not one)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# host events kept by load_device_trace: CUDA API calls and record_function
HOST_CATEGORIES = ("cuda_runtime", "cuda_driver", "user_annotation")
CHAIN_RANGE = "covo_chain"  # the record_function name around a traced chain


class LostEvents(RuntimeError):
    """A profiler session recorded fewer (or more) device ops than the host
    enqueued: its device times are not read."""


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


def per_solve_events(step: Callable, carry, chains: int = 8, chain: int = 256) -> dict:
    """Each call's device-timeline seconds in ``chains`` chains of ``chain``
    dependent calls ``carry = step(carry)``, from CUDA events recorded
    between consecutive calls (after one warm-up chain): the
    :func:`per_solve_distribution` dict, its ``marker`` "cuda_events". A
    call's duration holds everything between its start and the next call's,
    as successive marker starts do in a trace. Needs the card."""
    if not torch.cuda.is_available():
        raise RuntimeError("per_solve_events: CUDA events need a CUDA device")
    for _ in range(chain):
        carry = step(carry)
    durations = []
    for _ in range(chains):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(chain + 1)]
        events[0].record()
        for e in events[1:]:
            carry = step(carry)
            e.record()
        torch.cuda.synchronize()
        durations += [a.elapsed_time(b) * 1e-3 for a, b in zip(events, events[1:])]
    d = np.asarray(durations, dtype=np.float64)
    pct = lambda q: float(np.percentile(d, q))  # noqa: E731
    return {"marker": "cuda_events", "p50": pct(50), "p90": pct(90), "p99": pct(99),
            "max": float(d.max()), "n": int(len(d))}


def time_slope(make_run, k: int = 32, reps: int = 5):
    """Amortized per-iteration seconds by a two-point slope fit (JAX's
    ``time_slope``): ``make_run(length)`` returns ``run(i)``, which runs
    ``length`` chained iterations (i is the rep index); each run is synced
    by copying one leaf of its result to the host. Chains of k and 5k, reps
    of the two interleaved, the minimum of each, and the slope between them:
    a fixed per-run cost cancels. Host clock (:data:`_clock`). Returns
    ``(seconds_per_iteration, implied_overhead_s)``."""
    k2 = 5 * k
    run1, run2 = make_run(k), make_run(k2)
    _sync(run1(0))  # warm-up
    _sync(run2(0))
    t1s, t2s = [], []
    for i in range(reps):
        t0 = _clock()
        _sync(run1(i))
        t1s.append(_clock() - t0)
        t0 = _clock()
        _sync(run2(i))
        t2s.append(_clock() - t0)
    per = (min(t2s) - min(t1s)) / (k2 - k)
    overhead = min(t1s) - k * per
    return per, overhead


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


# --- profiler sessions counted for completeness -------------------------------


def graph_nodes(cap) -> int:
    """The nodes of a captured call's CUDA graph (kernels, copies, fills:
    the device ops one replay runs), read with libcuda's
    cuGraphGetNodes."""
    import ctypes

    count = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(cap.graph.raw_cuda_graph()), None, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes: CUresult {err}")
    return count.value


def profiled(fn, reps: int = 1):
    """``reps`` calls of ``fn`` under one torch.profiler session whose
    window has PROFILER_PAD_S of idle time at both ends: ``(device kernels
    and copies recorded, host calls that enqueued device work, wall ms of
    the calls)``. On the H100 a session can lose device events, up to a few
    hundred and more as the process has run more sessions; the host calls
    that enqueue them are counted exactly in every session."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_PAD_S)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILER_PAD_S)
    events = prof.events()
    return ([e for e in events if e.device_type == DeviceType.CUDA],
            sum(e.device_type == DeviceType.CPU and e.name.startswith(ENQUEUE_CALLS)
                for e in events), wall_ms)


def device_profile(fn, reps: int = 1, sessions: int = 3, name: str = "") -> dict:
    """``sessions`` profiler sessions of ``reps`` calls of ``fn`` each,
    after one warm-up call. Device time is read only from the complete
    sessions, those that recorded every device kernel and copy the host
    enqueued: one that lost events would undercount. Returns a dict with
    ``ops``, the device kernels and copies enqueued per call (the same in
    every session, or this raises); ``enqueued``, those of one session; the
    medians over the complete sessions of ``ms``, device ms per call,
    ``kernel_ms``, the same for the kernels whose name contains ``name``,
    ``wall_ms`` per call (profiler on) and ``busy``, the device's busy share
    of that wall time, each None when no session was complete; and
    ``complete``, "k of n"."""
    fn()
    torch.cuda.synchronize()
    enqueued, full = set(), []
    for _ in range(sessions):
        device, launches, wall_ms = profiled(fn, reps)
        enqueued.add(launches)
        if len(device) == launches:
            ms = sum(e.self_device_time_total for e in device) / 1e3 / reps
            kernel_ms = sum(e.self_device_time_total for e in device
                            if name and name in e.name) / 1e3 / reps
            full.append((ms, kernel_ms, wall_ms / reps, ms * reps / wall_ms))
    if len(enqueued) != 1:
        raise RuntimeError(f"device_profile: the host enqueued other device work in "
                           f"each session: {enqueued}")
    med = [float(np.median(v)) for v in zip(*full)] or [None] * 4
    n = enqueued.pop()
    return dict(zip(("ms", "kernel_ms", "wall_ms", "busy"), med),
                ops=n // reps, enqueued=n, complete=f"{len(full)} of {sessions}")


def graph_profile(replay, nodes: int, reps: int = 10, sessions: int = 3):
    """Profiler sessions of ``reps`` replays of a captured solve whose graph
    holds ``nodes`` device ops: the device ms a replay, from the sessions
    that lost no event (each recorded reps x nodes device ops, and one more
    for each host call that enqueued device work around the replays, the
    generators' offsets). Returns (device ms a replay or None, "k of n"
    sessions complete, the device ops each session recorded)."""
    replay()
    torch.cuda.synchronize()
    full, seen = [], []
    for _ in range(sessions):
        device, host_ops, _ = profiled(replay, reps)
        seen.append(len(device))
        if len(device) == reps * nodes + host_ops:
            full.append(sum(e.self_device_time_total for e in device) / 1e3 / reps)
    return (float(np.median(full)) if full else None), f"{len(full)} of {sessions}", seen


# --- the trace readers ---------------------------------------------------------


def load_device_trace(log_dir: str, counts: Optional[dict] = None):
    """Parse the newest ``trace_*.json`` under ``log_dir`` (the Chrome trace
    :func:`trace` writes). Returns ``(device_events, host_events)``, each
    sorted by start time:

    - device events, the kernels, copies and fills (:data:`DEVICE_CATEGORIES`):
      dicts with ``name``, ``ts_us``, ``dur_us``, ``category`` (the trace's
      ``cat``), ``stream`` and ``correlation`` (the id of the host call that
      enqueued it: a graph's nodes share their launch's); a kernel of
      ``csrc/`` whose device function (``kernels.device_kernel``) is a key
      of ``counts`` also carries that entry's ``flops`` and ``bytes`` per
      launch;
    - host events, the CUDA API calls (graph launches, kernel launches,
      copies, syncs) and ``record_function`` ranges: dicts with ``name``,
      ``ts_us``, ``dur_us``, ``category`` and ``correlation`` (JAX's module
      events' place).

    Raises FileNotFoundError when there is no trace file."""
    paths = sorted(glob.glob(os.path.join(log_dir, "trace_*.json")))
    if not paths:
        raise FileNotFoundError(f"no trace_*.json under {log_dir}")
    with open(paths[-1]) as fh:
        events = json.load(fh)["traceEvents"]
    counts = counts or {}
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        rec = {"name": e["name"], "ts_us": float(e["ts"]), "dur_us": float(e["dur"]),
               "category": cat}
        rec["correlation"] = e.get("args", {}).get("correlation")
        if cat in DEVICE_CATEGORIES:
            rec["stream"] = e.get("args", {}).get("stream")
            own = kernels.device_kernel(e["name"]) if cat == "kernel" else None
            if own in counts:
                rec["flops"] = counts[own]["flops"]
                rec["bytes"] = counts[own]["bytes"]
            device.append(rec)
        elif cat in HOST_CATEGORIES:
            host.append(rec)
    device.sort(key=lambda r: r["ts_us"])
    host.sort(key=lambda r: r["ts_us"])
    return device, host


def hlo_summary(events, top: int = 20):
    """Aggregate device events by name (JAX's per-HLO summary). Returns rows
    sorted by total device time: ``name, category, count, total_us,
    mean_us, flops_per_call, bytes_per_call, tflops_per_s, gbytes_per_s``.
    The last four come from the counts the events carry (the kernels of
    ``csrc/``, see :func:`load_device_trace`) and are None for an op whose
    count the port does not know."""
    agg = {}
    for r in events:
        a = agg.setdefault(
            r["name"],
            {"name": r["name"], "category": r["category"], "count": 0,
             "total_us": 0.0, "flops": 0, "bytes": 0, "counted": True},
        )
        a["count"] += 1
        a["total_us"] += r["dur_us"]
        if "flops" in r:
            a["flops"] += r["flops"]
            a["bytes"] += r["bytes"]
        else:
            a["counted"] = False
    rows = sorted(agg.values(), key=lambda a: -a["total_us"])[:top]
    for a in rows:
        a["mean_us"] = a["total_us"] / a["count"]
        sec = a["total_us"] * 1e-6
        if a.pop("counted"):
            a["flops_per_call"] = a["flops"] // a["count"]
            a["bytes_per_call"] = a["bytes"] // a["count"]
            a["tflops_per_s"] = (a["flops"] / sec / 1e12) if sec else 0.0
            a["gbytes_per_s"] = (a["bytes"] / sec / 1e9) if sec else 0.0
        else:
            a["flops_per_call"] = a["bytes_per_call"] = None
            a["tflops_per_s"] = a["gbytes_per_s"] = None
        del a["flops"], a["bytes"]
    return rows


def per_solve_distribution(events, n_solves: int, marker: str = "auto"):
    """Per-solve latency percentiles from device timestamps (JAX's
    ``per_solve_distribution``): the chained solves are cut at a marker
    kernel that starts once a solve, by default ("auto") the one of the
    repo's own kernels (``kernels.DEVICE_KERNELS``) with the largest total
    time among those that fired exactly ``n_solves`` times. Returns
    ``marker``, ``p50``, ``p90``, ``p99``, ``max`` (seconds) and ``n``."""
    if marker == "auto":
        best = None
        agg = {}
        for r in events:
            if r["category"] == "kernel" and kernels.device_kernel(r["name"]):
                a = agg.setdefault(r["name"], [0.0, 0])
                a[0] += r["dur_us"]
                a[1] += 1
        for name, (tot, cnt) in agg.items():
            if cnt == n_solves and (best is None or tot > best[1]):
                best = (name, tot)
        if best is None:
            raise ValueError("no once-per-solve kernel of csrc/ found as a marker")
        marker = best[0]
    deltas = step_durations(events, marker)
    pct = lambda q: float(np.percentile(deltas, q))  # noqa: E731
    return {
        "marker": marker,
        "p50": pct(50),
        "p90": pct(90),
        "p99": pct(99),
        "max": float(deltas.max()),
        "n": int(len(deltas)),
    }


def step_durations(events, marker: str):
    """Per-iteration durations from a once-per-iteration marker (JAX's
    ``step_durations``): successive start timestamps of the events whose
    name is ``marker`` (or, when none is, contains it) give each solve's
    duration, every gap between its kernels included. Returns seconds,
    (K-1,) per chain, concatenated over chains.

    Chains are split at ``min(max(100x median, 2 ms), median + 10 ms)``:
    a delta more than 10 ms above the median is the idle time between two
    chains, a slow solve below that stays in. Raises below 3 matches."""
    exact = any(r["name"] == marker for r in events)
    match = (lambda n: n == marker) if exact else (lambda n: marker in n)
    starts = np.array(
        [r["ts_us"] for r in events if match(r["name"])], np.float64
    )
    if len(starts) < 3:
        raise ValueError(
            f"marker {marker!r} matched {len(starts)} events; need >= 3"
        )
    deltas = np.diff(np.sort(starts))
    med = np.median(deltas)
    boundary_us = min(max(100.0 * med, 2000.0), med + 10_000.0)
    return deltas[deltas < boundary_us] * 1e-6


def chain_windows(host_events):
    """The ``(start, end)`` µs of each :data:`CHAIN_RANGE` range, in order."""
    return [(r["ts_us"], r["ts_us"] + r["dur_us"]) for r in host_events
            if r["category"] == "user_annotation" and r["name"] == CHAIN_RANGE]


def trace_chains(run, iters: int, nodes: int, trace_dir: str, gap_s: float = 0.0,
                 counts: Optional[dict] = None):
    """``iters`` chains ``_sync(run(i + 1))`` under one profiler session,
    each inside a :data:`CHAIN_RANGE` range, ``gap_s`` of idle device time
    after each; ``run`` replays a graph of ``nodes`` device ops once an
    iteration; small device ops before and after the chains take the
    losses a session has at its ends (:func:`_pad_work`). Returns the
    device events of each chain, a list of ``iters`` lists: a chain's are
    those that start inside its range (its ops end before the range does,
    at its sync). Raises
    :class:`LostEvents` unless the session is complete: device ops in the
    ranges = graph launches x ``nodes`` + the host's enqueue calls."""
    if os.path.isdir(trace_dir):
        shutil.rmtree(trace_dir)
    from torch.profiler import record_function

    with trace(trace_dir):
        _pad_work()
        time.sleep(PROFILER_PAD_S)
        for i in range(iters):
            with record_function(CHAIN_RANGE):
                _sync(run(i + 1))
            time.sleep(gap_s)
        _pad_work()
        time.sleep(PROFILER_PAD_S)
    device, host = load_device_trace(trace_dir, counts)
    windows = chain_windows(host)
    if len(windows) != iters:
        raise LostEvents(f"{len(windows)} chain ranges recorded of {iters}")
    inside = lambda r: any(a <= r["ts_us"] <= b for a, b in windows)  # noqa: E731
    chains = [[r for r in device if a <= r["ts_us"] <= b] for a, b in windows]
    calls = [r for r in host if r["category"] != "user_annotation" and inside(r)]
    launches = sum(r["name"].startswith("cudaGraphLaunch") for r in calls)
    enqueued = sum(r["name"].startswith(ENQUEUE_CALLS) for r in calls)
    seen = sum(map(len, chains))
    expected = launches * nodes + enqueued
    if seen != expected:
        raise LostEvents(f"{seen} device ops recorded of {expected} ({launches} graph "
                         f"launches x {nodes} nodes + {enqueued} enqueue calls; "
                         f"{_short_calls(calls, chains, nodes)})")
    if not all(chains):
        raise LostEvents("a chain recorded no device op (no device activity traced)")
    return chains


def trace_seconds(make_run, chain: int = 256, iters: int = 4,
                  trace_dir: Optional[str] = None, nodes: Optional[int] = None,
                  counts: Optional[dict] = None) -> dict:
    """:func:`time_trace`'s session, read three ways: ``per_iteration``,
    the mean over the chains of a chain's wall (its first device op's start
    to its last one's end) / ``chain``; ``device``, the device ops' summed
    durations / (``iters`` x ``chain``), seconds; and ``events``, the
    chains' device events (``counts`` as :func:`load_device_trace` takes
    them), for :func:`hlo_summary`. Raises :class:`LostEvents` when the
    session is not complete."""
    if trace_dir is None:
        trace_dir = os.path.join(tempfile.gettempdir(), f"covo_time_trace_{os.getpid()}")
    run = make_run(chain)
    _sync(run(0))  # warm-up
    chains = trace_chains(run, iters, run.nodes if nodes is None else nodes, trace_dir,
                          counts=counts)
    walls = [max(r["ts_us"] + r["dur_us"] for r in c) - min(r["ts_us"] for r in c)
             for c in chains]
    events = [r for c in chains for r in c]
    return {"per_iteration": float(np.mean(walls)) / chain * 1e-6,
            "device": sum(r["dur_us"] for r in events) / (iters * chain) * 1e-6,
            "events": events}


def _pad_work() -> None:
    """A few small device ops before and after the traced chains, inside
    the session and outside every chain's range: on the H100 a session late
    in a process loses the records of its first few device ops."""
    if torch.cuda.is_available():
        x = torch.zeros(1, device="cuda")
        for _ in range(32):
            x.add_(1.0)
        torch.cuda.synchronize()


def _short_calls(calls, chains, nodes: int, shown: int = 6) -> str:
    """Which host calls of the chains lack device ops: (position among the
    calls, name, device ops with its correlation id, expected)."""
    ops = {}
    for r in (r for c in chains for r in c):
        ops[r["correlation"]] = ops.get(r["correlation"], 0) + 1
    short = []
    for i, r in enumerate(calls):
        want = (nodes if r["name"].startswith("cudaGraphLaunch")
                else int(r["name"].startswith(ENQUEUE_CALLS)))
        got = ops.get(r["correlation"], 0)
        if got != want:
            short.append((i, r["name"], got, want))
    return f"{len(short)} of {len(calls)} calls short: {short[:shown]}"


def time_trace(make_run, chain: int = 256, iters: int = 4,
               trace_dir: Optional[str] = None, nodes: Optional[int] = None) -> float:
    """Per-iteration device seconds from a profiler trace (JAX's
    ``time_trace``, which reads the largest while op, its scan). Same
    ``make_run(length) -> run(i)`` contract as :func:`time_slope`; here one
    iteration replays a captured graph of ``nodes`` device ops (default
    ``run.nodes``), and a chain is ``chain`` replays between two host syncs.
    A chain's wall is its first device op's start to its last one's end;
    returns the mean over ``iters`` chains / ``chain``, in seconds. Raises
    :class:`LostEvents` when the session is not complete (the caller falls
    back to CUDA events). ``trace_dir`` defaults to a per-process directory
    under the temporary directory, so concurrent benches do not clobber each
    other's traces."""
    return trace_seconds(make_run, chain, iters, trace_dir, nodes)["per_iteration"]
