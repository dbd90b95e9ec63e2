"""Whether the captured main-path solve runs at more than one speed on the
card, and what sets its speed: the card's clocks, the host's enqueue time,
or what the process did just before (``--triggers``).

    python -m covo_mpc_tpu_torch.tools.clock_probe [--chains 48] [--chain 64] \
        [--out results/clock_probe.json]
    python -m covo_mpc_tpu_torch.tools.clock_probe --triggers [--trigger-set sixth]

On the main path's captured solve (covo_online gn, ns, kernel rng, N=8192,
H=32), while ``nvidia-smi`` samples the SM and memory clocks, power draw,
temperature and clock event reasons every 20 ms:

1. one second idle;
2. ``--chains`` chains of ``--chain`` chained replays, each timed by CUDA
   events and synced, with idle gaps of 0, 10, 100 and 1000 ms between them
   in turn; after each, 16 chained calls enqueued behind a 100 ms spin of
   the card (``torch.cuda._sleep``), so that the host has enqueued them all
   before the card starts: their CUDA-event ms a call is the card's time
   alone, the host's perf_counter ms a call its enqueue time alone (a
   call: copy in, ``cudaGraphLaunch``, clone out); then 16 bare
   ``graph.replay()`` calls the same way (the graph launch's host time);
   part 2 stops 8 chains after the card's time a call first falls 5% below
   its first chain's;
3. one continuous run of 2048 replays, an event every 16;
4. a profiler session of 4 replays before 2 and after 3: the card's us a
   replay by op in each, and the ops whose time moved most;
5. a second capture of the same solve, timed beside the first in turns.

Each chain (and each block of 16 in 3) is printed with its ms per solve,
the mean SM clock that ``nvidia-smi`` read inside its window and their
product (kilocycles of the SM clock per solve); each chain also with the
card's and the host's ms a call, the host's CPU, that CPU's clock as
``/sys`` reads it, the memory clock and the temperature.

``--triggers`` runs instead: the card's ms a call (16 calls behind a spin,
as in 2) every half second until it falls below ``FAST_MS``; then, for each
trigger of the set (:data:`TRIGGER_SETS`, :func:`make_triggers`), polled
until fast again (at most 40 s), the trigger, and ``TRIGGER_WINDOW_S`` of
polls after it. Prints when the card went slow and fast again after each.

``--events`` runs instead, after the card has been fast for 30 s of
polls: ``EVENT_ROUNDS`` rounds, each of four chains of 256 replays in
turn: CUDA events only around the chain (``time_chained``'s way) and an
event after every replay (``per_solve_events``' way), each on the current
stream and on a side stream (the capture replayed there). Prints each
chain's ms a solve.

Writes one JSON file. Needs the card.
"""

from __future__ import annotations

import argparse
import collections
import datetime
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

T_START = time.time()  # the process's start, near enough
N, H = 8192, 32
GAPS_S = (0.0, 0.01, 0.1, 1.0)
SPLIT_CALLS = 16
SPIN_S = 0.1
FAST_MS = 1.96  # between the two speeds the probe found (1.85 and 2.06 ms)
TRIGGER_WINDOW_S = 24.0
EVENT_ROUNDS = 6
EVENT_CHAIN = 256
FIELDS = ("timestamp", "clocks.sm", "clocks.mem", "power.draw", "temperature.gpu")
REASON_FIELDS = ("clocks_event_reasons.active", "clocks_throttle_reasons.active")


def reason_field():
    """The clock-event-reasons field this driver's ``nvidia-smi`` knows, or
    None."""
    for field in REASON_FIELDS:
        probe = subprocess.run(["nvidia-smi", f"--query-gpu={field}",
                                "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=60)
        if probe.returncode == 0:
            return field
    return None


def parse_samples(path: str, fields) -> list[dict]:
    """The sampler's CSV lines as dicts, ``t`` the host's epoch seconds."""
    out = []
    with open(path) as fh:
        for line in fh:
            parts = [s.strip() for s in line.split(",")]
            if len(parts) != len(fields):
                continue
            try:
                t = datetime.datetime.strptime(parts[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
                row = {"t": t, "sm_mhz": float(parts[1]), "mem_mhz": float(parts[2]),
                       "power_w": float(parts[3]), "temp_c": float(parts[4])}
            except ValueError:
                continue
            if len(fields) > 5:
                row["reasons"] = parts[5]
            out.append(row)
    return out


def window_clock(samples, t0: float, t1: float) -> dict:
    """Mean SM clock, power and the reasons seen in [t0, t1]; the nearest
    sample where none falls inside."""
    inside = [s for s in samples if t0 <= s["t"] <= t1]
    if not inside and samples:
        inside = [min(samples, key=lambda s: abs(s["t"] - (t0 + t1) / 2))]
    if not inside:
        return {"sm_mhz": None, "mem_mhz": None, "temp_c": None, "power_w": None,
                "samples": 0, "reasons": []}
    return {"sm_mhz": float(np.mean([s["sm_mhz"] for s in inside])),
            "mem_mhz": float(np.mean([s["mem_mhz"] for s in inside])),
            "temp_c": float(np.mean([s["temp_c"] for s in inside])),
            "power_w": float(np.mean([s["power_w"] for s in inside])),
            "samples": len(inside),
            "reasons": sorted({s.get("reasons", "") for s in inside})}


def summary(rows) -> dict:
    """The spread of ms per solve and of kilocycles per solve, and their
    correlation with the clock."""
    ms = np.array([r["ms"] for r in rows if r["sm_mhz"]])
    mhz = np.array([r["sm_mhz"] for r in rows if r["sm_mhz"]])
    kcyc = ms * mhz
    return {"n": int(len(ms)), "ms_min": float(ms.min()), "ms_max": float(ms.max()),
            "ms_rel_std": float(ms.std() / ms.mean()),
            "kcycles_min": float(kcyc.min()), "kcycles_max": float(kcyc.max()),
            "kcycles_rel_std": float(kcyc.std() / kcyc.mean()),
            "sm_mhz_min": float(mhz.min()), "sm_mhz_max": float(mhz.max()),
            "corr_ms_inverse_clock": float(np.corrcoef(ms, 1.0 / mhz)[0, 1])
            if mhz.std() > 0 and ms.std() > 0 else None}


def host_cpu() -> tuple:
    """(the CPU this process last ran on, that CPU's clock in MHz or None),
    from /proc/self/stat and cpufreq's scaling_cur_freq."""
    with open("/proc/self/stat") as fh:
        cpu = int(fh.read().rsplit(")", 1)[1].split()[36])
    try:
        with open(f"/sys/devices/system/cpu/cpu{cpu}/cpufreq/scaling_cur_freq") as fh:
            return cpu, int(fh.read()) / 1e3
    except OSError:
        return cpu, None


def split_times(call, c0, spin_cycles: int) -> dict:
    """The card's ms a call and the host's enqueue ms a call, for
    SPLIT_CALLS chained ``call``s enqueued behind a spin of the card."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(spin_cycles)
    e0.record()
    t0 = time.perf_counter()
    c = c0
    for _ in range(SPLIT_CALLS):
        c = call(c)
    host = time.perf_counter() - t0
    e1.record()
    torch.cuda.synchronize()
    return {"device_ms": e0.elapsed_time(e1) / SPLIT_CALLS,
            "host_ms": host * 1e3 / SPLIT_CALLS, "host_within_spin": host < SPIN_S}


def kernel_breakdown(step, c0, log_dir: str, replays: int = 4) -> dict:
    """The card's us a replay by device op (name cut to 90 characters) from
    one profiler session of ``replays`` chained calls."""
    from covo_mpc_tpu_torch.runtime import profiling

    c = c0
    with profiling.trace(log_dir):
        time.sleep(profiling.PROFILER_PAD_S)
        for _ in range(replays):
            c = step(c)
        torch.cuda.synchronize()
        time.sleep(profiling.PROFILER_PAD_S)
    device, _ = profiling.load_device_trace(log_dir)
    by = collections.defaultdict(float)
    for r in device:
        by[r["name"][:90]] += r["dur_us"] / replays
    return {"ops": len(device), "total_us": float(sum(by.values())), "by_op": dict(by)}


def moved(first: dict, last: dict, top: int = 12) -> list:
    """The ops whose us a replay moved most between two breakdowns."""
    names = set(first["by_op"]) | set(last["by_op"])
    diffs = [(n, first["by_op"].get(n, 0.0), last["by_op"].get(n, 0.0)) for n in names]
    diffs.sort(key=lambda d: -abs(d[2] - d[1]))
    return [{"op": n, "first_us": a, "last_us": b} for n, a, b in diffs[:top]]


def poll(step, cp0, spin_cycles: int, seconds: float, until_fast: bool = False) -> list:
    """(seconds from the start, the card's ms a call) every half second for
    ``seconds``, or until the card is fast if ``until_fast``."""
    t0, out = time.time(), []
    while time.time() - t0 < seconds:
        ms = split_times(step, cp0, spin_cycles)["device_ms"]
        out.append((round(time.time() - t0, 2), round(ms, 4)))
        if until_fast and ms < FAST_MS:
            break
        time.sleep(max(0.0, 0.5 - (time.time() - t0 - out[-1][0])))
    return out


def trigger_run(step, cp0, spin_cycles: int, triggers: dict) -> dict:
    """The card's speed after each trigger (``--triggers``)."""
    out = {"until_fast": poll(step, cp0, spin_cycles, 90.0, until_fast=True)}
    for name, fire in triggers.items():
        out[f"{name}_wait"] = poll(step, cp0, spin_cycles, 40.0, until_fast=True)
        t0 = time.time()
        handle = fire()
        fired = time.time() - t0
        line = poll(step, cp0, spin_cycles, TRIGGER_WINDOW_S)
        if handle is not None:
            handle.wait(timeout=60)
        slow = [t for t, ms in line if ms >= FAST_MS]
        back = [t for t, ms in line if slow and t > slow[0] and ms < FAST_MS]
        out[name] = {"fire_s": fired, "line": line,
                     "slow_from_s": slow[0] if slow else None,
                     "fast_again_s": back[0] if back else None}
        print(f"{name}: fired in {fired:.2f} s; slow from {out[name]['slow_from_s']} s, "
              f"fast again at {out[name]['fast_again_s']} s; "
              + " ".join(f"{t}:{ms}" for t, ms in line), flush=True)
    return out


# the triggers of each ``--trigger-set``; sets first-fourth as they ran
# while ``graphs.capture`` warmed up on a side stream (their captures do so
# here: ``*_side``), fifth with the warm-up on the caller's stream
TRIGGER_SETS = {
    "first": ("empty_cache", "second_process", "profiler_session", "capture_addition",
              "capture_side"),
    "second": ("eager_solves", "eager_solves_then_empty_cache", "alloc_free_1gib",
               "capture_side"),
    "third": ("capture_side_then_gc", "capture_side_gc_off"),
    "fourth": ("capture_side_upload", "capture_side_idle_30s"),
    "fifth": ("capture", "side_stream_eager"),
    "sixth": ("capture", "capture_side"),
}


def make_triggers(solver, args: tuple, step) -> dict:
    """Every trigger of :data:`TRIGGER_SETS` by name: each a callable that
    returns None or a handle whose ``wait`` ends it after the window.
    ``args`` are the main path's solve arguments (obs, state, p, cp, info).

    ``capture`` / ``capture_side``: the main path captured again (from a
    side stream, where its warm-up then runs), and ``capture_side_then_gc``
    followed by ``gc.collect()``, ``_gc_off`` with the collector off for the
    window, ``_upload`` by ``cuGraphUpload`` of its executable graph,
    ``_idle_30s`` by 30 s idle; ``capture_addition``: a graph of one
    addition, from a side stream; ``eager_solves``: two eager solves (then
    ``empty_cache``), ``side_stream_eager`` on a side stream;
    ``alloc_free_1gib``: 1 GiB allocated, filled, freed and released;
    ``second_process``: a process that opens a CUDA context and sleeps
    8 s; ``profiler_session``: one of 4 replays; ``empty_cache``."""
    import ctypes

    from covo_mpc_tpu_torch.runtime import graphs

    kept = []  # every graph captured stays alive
    cp0 = args[3]

    def on_side_stream(fn):
        side, current = torch.cuda.Stream(), torch.cuda.current_stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = fn()
        current.wait_stream(side)
        torch.cuda.synchronize()
        return out

    def capture(side: bool = False):
        """The main path captured; ``side``: from a side stream, so that its
        warm-up runs there."""
        make = lambda: graphs.capture_solver(solver, solver, *args)  # noqa: E731
        kept.append(on_side_stream(make) if side else make())
        return kept[-1]

    def eager(release: bool):
        for _ in range(2):
            solver(*args)
        torch.cuda.synchronize()
        if release:
            torch.cuda.empty_cache()

    def alloc_free():
        block = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
        block.fill_(1)
        torch.cuda.synchronize()
        del block
        torch.cuda.empty_cache()

    def capture_then_gc():
        capture(side=True)
        gc.set_debug(gc.DEBUG_SAVEALL)
        found = gc.collect()
        kinds = collections.Counter(type(o).__name__ for o in gc.garbage)
        gc.set_debug(0)
        del gc.garbage[:]
        gc.collect()
        print(f"gc.collect() after the capture: {found} unreachable, "
              f"{dict(kinds.most_common(15))}", flush=True)

    class GcOff:
        """Holds the collector off until the window ends (``wait``)."""

        def __init__(self):
            gc.disable()
            capture(side=True)

        def wait(self, timeout=None):
            gc.enable()

    def capture_upload():
        new = capture(side=True)
        rc = ctypes.CDLL("libcuda.so.1").cuGraphUpload(
            ctypes.c_void_p(new.graph.raw_cuda_graph_exec()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        torch.cuda.synchronize()
        print(f"cuGraphUpload returned {rc}", flush=True)

    def capture_idle():
        capture(side=True)
        time.sleep(30.0)

    x = torch.zeros((), device="cuda")
    return {
        "empty_cache": torch.cuda.empty_cache,
        "second_process": lambda: subprocess.Popen(
            [sys.executable, "-c", "import time, torch; torch.zeros(1, device='cuda'); "
             "time.sleep(8)"]),
        "profiler_session": lambda: kernel_breakdown(
            step, cp0, tempfile.mkdtemp(prefix="clock_probe_")) and None,
        "capture_addition": lambda: on_side_stream(
            lambda: kept.append(graphs.capture(lambda v: v + 1, x))),
        "capture": lambda: capture() and None,
        "capture_side": lambda: capture(side=True) and None,
        "eager_solves": lambda: eager(False),
        "eager_solves_then_empty_cache": lambda: eager(True),
        "alloc_free_1gib": alloc_free,
        "capture_side_then_gc": capture_then_gc,
        "capture_side_gc_off": GcOff,
        "capture_side_upload": capture_upload,
        "capture_side_idle_30s": capture_idle,
        "side_stream_eager": lambda: on_side_stream(lambda: eager(False)),
    }


def chain_ms(step, c0, per_solve: bool) -> float:
    """ms a solve of a chain of EVENT_CHAIN chained calls on the current
    stream, timed by events around it, with (``per_solve``) or without an
    event recorded after every call."""
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(EVENT_CHAIN + 1 if per_solve else 2)]
    c = c0
    events[0].record()
    for i in range(EVENT_CHAIN):
        c = step(c)
        if per_solve:
            events[i + 1].record()
    events[-1].record()
    torch.cuda.synchronize()
    return events[0].elapsed_time(events[-1]) / EVENT_CHAIN


def event_rounds(step, c0) -> list:
    """:data:`EVENT_ROUNDS` rounds of the four chains (``--events``)."""
    side = torch.cuda.Stream()
    rounds = []
    for _ in range(EVENT_ROUNDS):
        row = {}
        for where in ("current", "side"):
            for per_solve in (False, True):
                if where == "side":
                    side.wait_stream(torch.cuda.current_stream())
                    with torch.cuda.stream(side):
                        ms = chain_ms(step, c0, per_solve)
                    torch.cuda.current_stream().wait_stream(side)
                else:
                    ms = chain_ms(step, c0, per_solve)
                row[f"{where}_{'event_each' if per_solve else 'chain_only'}"] = ms
        rounds.append(row)
        print("  " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
    return rounds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="results/clock_probe.json")
    ap.add_argument("--chains", type=int, default=48)
    ap.add_argument("--chain", type=int, default=64)
    ap.add_argument("--triggers", action="store_true",
                    help="time the card after each trigger instead (module docstring)")
    ap.add_argument("--trigger-set", choices=tuple(TRIGGER_SETS), default="first")
    ap.add_argument("--events", action="store_true",
                    help="time chains with and without an event after every replay instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("clock_probe: no CUDA device", file=sys.stderr)
        return 2
    from covo_mpc_tpu_torch.bench import make_env
    from covo_mpc_tpu_torch.runtime import graphs, profiling
    from covo_mpc_tpu_torch.solvers import get_solver

    out = {"device": profiling.device_info("cuda")}
    print(out["device"], flush=True)
    env = make_env("gaussian", "cuda")
    p = env.default_params
    obs, info, state = env.reset(torch.Generator("cuda").manual_seed(0), p)
    solver, cp0 = get_solver(env, "covo_online", f"N{N}_H{H}_lam0.01", rng_mode="kernel",
                             hessian_mode="gn", sigma_mode="ns", engine="cuda",
                             collect_debug=False)
    cap = graphs.capture_solver(solver, solver, obs, state, p, cp0, info)
    t_capture = time.time()
    out["capture_s_after_start"] = t_capture - T_START

    def step(c):
        return cap(obs, state, p, c, info)[1]

    c = cp0
    for _ in range(args.chain):
        c = step(c)
    torch.cuda.synchronize()
    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    spin_cycles = int(SPIN_S * max_mhz * 1e6)

    def bare(c):
        cap.replay()
        return c

    if args.events:
        out["until_fast"] = poll(step, cp0, spin_cycles, 90.0, until_fast=True)
        out["settle"] = poll(step, cp0, spin_cycles, 30.0)
        print("until fast: " + " ".join(f"{t}:{ms}" for t, ms in out["until_fast"])
              + "; then " + " ".join(f"{t}:{ms}" for t, ms in out["settle"][::10]))
        out["events"] = event_rounds(step, cp0)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
        print(f"wrote {args.out}")
        return 0
    if args.triggers:
        triggers = make_triggers(solver, (obs, state, p, cp0, info), step)
        triggers = {name: triggers[name] for name in TRIGGER_SETS[args.trigger_set]}
        out["triggers"] = trigger_run(step, cp0, spin_cycles, triggers)
        print("until fast: " + " ".join(f"{t}:{ms}" for t, ms in out["triggers"]["until_fast"]))
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
        print(f"wrote {args.out}")
        return 0

    reasons = reason_field()
    fields = FIELDS + ((reasons,) if reasons else ())
    tmp = tempfile.mkdtemp(prefix="clock_probe_")
    log = os.path.join(tmp, "smi.csv")
    out["breakdown_first"] = kernel_breakdown(step, cp0, os.path.join(tmp, "first"))
    with open(log, "w") as fh:
        sampler = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={','.join(fields)}", "--format=csv,noheader,nounits",
             "-lms", "20"], stdout=fh, stderr=subprocess.DEVNULL)
    try:
        time.sleep(1.0)
        idle = (time.time() - 1.0, time.time())
        chains = []
        for i in range(args.chains):
            gap = GAPS_S[i % len(GAPS_S)]
            time.sleep(gap)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.time()
            e0.record()
            c = cp0
            for _ in range(args.chain):
                c = step(c)
            e1.record()
            torch.cuda.synchronize()
            row = {"gap_s": gap, "t0": t0, "t1": time.time(),
                   "ms": e0.elapsed_time(e1) / args.chain}
            row["cpu"], row["cpu_mhz"] = host_cpu()
            row["call"] = split_times(step, cp0, spin_cycles)
            row["replay"] = split_times(bare, cp0, spin_cycles)
            row["s_after_capture"] = t0 - t_capture
            chains.append(row)
            first = chains[0]["call"]["device_ms"]
            switched = [j for j, r in enumerate(chains)
                        if r["call"]["device_ms"] < 0.95 * first]
            if switched and i >= switched[0] + 8:
                break
        # the continuous run: an event every 16 replays, each block's window
        # placed on the host's clock from the first event
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2048 // 16 + 1)]
        t0 = time.time()
        events[0].record()
        c = cp0
        for e in events[1:]:
            for _ in range(16):
                c = step(c)
            e.record()
        torch.cuda.synchronize()
        t_end = time.time()
        at = [events[0].elapsed_time(e) / 1e3 for e in events]
        shift = (t_end - t0) - at[-1]  # host launch lead before the first event ran
        blocks = [{"t0": t0 + shift + a, "t1": t0 + shift + b, "ms": (b - a) * 1e3 / 16}
                  for a, b in zip(at, at[1:])]
        out["breakdown_last"] = kernel_breakdown(step, cp0, os.path.join(tmp, "last"))
        # a second capture of the same solve beside the first, in turns
        cap2 = graphs.capture_solver(solver, solver, obs, state, p, cp0, info)
        fresh = []
        for _ in range(6):
            for tag, g in (("first", cap), ("second", cap2)):
                fresh.append((tag, split_times(lambda c, g=g: g(obs, state, p, c, info)[1],
                                               cp0, spin_cycles)["device_ms"]))
        out["second_capture"] = fresh
        time.sleep(0.2)
    finally:
        sampler.terminate()
        sampler.wait(timeout=30)
    samples = parse_samples(log, fields)
    out["fields"] = list(fields)
    out["samples"] = len(samples)
    out["samples_raw"] = [{**s, "t": s["t"] - T_START} for s in samples]
    out["idle"] = window_clock(samples, *idle)
    for rows in (chains, blocks):
        for r in rows:
            r.update(window_clock(samples, r["t0"], r["t1"]))
            r["kcycles"] = r["ms"] * r["sm_mhz"] if r["sm_mhz"] else None
    out["chains"], out["blocks"] = chains, blocks
    out["chains_summary"], out["blocks_summary"] = summary(chains), summary(blocks)
    out["sm_mhz_seen"] = sorted({s["sm_mhz"] for s in samples})
    print(f"idle: {out['idle']}")
    print(f"{len(samples)} nvidia-smi samples; SM clocks seen (MHz): {out['sm_mhz_seen']}")
    for r in chains:
        print(f"  chain gap {r['gap_s']:5.2f} s: {r['ms']:.4f} ms a solve, SM "
              f"{r['sm_mhz'] or float('nan'):7.1f} MHz ({r['samples']} samples), "
              f"{r['power_w'] or float('nan'):6.1f} W, {r['kcycles'] or float('nan'):8.1f} "
              f"kcycles, reasons {r['reasons']}; card {r['call']['device_ms']:.4f} ms, "
              f"host {r['call']['host_ms']:.4f} ms a call (graph launch "
              f"{r['replay']['host_ms']:.4f}; within the spin: "
              f"{r['call']['host_within_spin'] and r['replay']['host_within_spin']}); "
              f"cpu {r['cpu']} at {r['cpu_mhz']} MHz; mem {r['mem_mhz']} MHz, "
              f"{r['temp_c']} C, {r['s_after_capture']:.1f} s after the capture")
    for i in range(0, len(blocks), 8):
        r = blocks[i]
        print(f"  continuous block {i:3d}: {r['ms']:.4f} ms a solve, SM "
              f"{r['sm_mhz'] or float('nan'):7.1f} MHz, {r['kcycles'] or float('nan'):8.1f} "
              f"kcycles, reasons {r['reasons']}")
    host = np.array([r["call"]["host_ms"] for r in chains])
    card = np.array([r["call"]["device_ms"] for r in chains])
    ms = np.array([r["ms"] for r in chains])
    out["split_summary"] = {
        "card_ms_min": float(card.min()), "card_ms_max": float(card.max()),
        "host_ms_min": float(host.min()), "host_ms_max": float(host.max()),
        "launch_ms_min": float(min(r["replay"]["host_ms"] for r in chains)),
        "launch_ms_max": float(max(r["replay"]["host_ms"] for r in chains)),
        "corr_chain_ms_host_ms": float(np.corrcoef(ms, host)[0, 1]),
        "corr_chain_ms_card_ms": float(np.corrcoef(ms, card)[0, 1]),
        "chains_above_card_by_5pct": int((ms > 1.05 * card).sum())}
    print("split: " + json.dumps(out["split_summary"]))
    out["moved"] = moved(out["breakdown_first"], out["breakdown_last"])
    for tag in ("breakdown_first", "breakdown_last"):
        b = out[tag]
        print(f"{tag}: {b['ops']} device ops, {b['total_us']:.1f} us a replay")
    for m in out["moved"]:
        print(f"  {m['first_us']:9.2f} -> {m['last_us']:9.2f} us a replay  {m['op']}")
    print("second capture beside the first, card ms a call: "
          + ", ".join(f"{tag} {ms:.4f}" for tag, ms in out["second_capture"]))
    print("chains: " + json.dumps(out["chains_summary"]))
    print("continuous: " + json.dumps(out["blocks_summary"]))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
