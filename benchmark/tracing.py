"""Profiler sessions of the traced run and what is read from them.

Two kinds of session, both after the measured window:

- replays: a few replays of the cell's captured step under
  ``torch.profiler``, bracketed by a ``bench.window`` range. From it come
  each device op's duration (the breakdown's top ops, the rollout kernels'
  ms a replay), the busy seconds (the union of device op intervals) and
  the idle gaps labelled by what the host was doing in them. A profiler
  session slows the host's graph launch, so the gaps and the window here
  are not those of the untraced run: the idle share that the benchmark
  reports as a per-layer metric divides traced kernel time by the
  untraced window's ms a step.
- spans: a few eager steps with ``record_function`` ranges that the
  benchmark's own code puts around its call of the solve (``bench.solve``)
  and of the env step (``bench.env``). A range's device time is the sum of
  the device ops whose launches (matched by correlation id) lie inside it.

A session on the H100 can lose device events; each kind is retried up to
``SESSIONS`` times until the ops it recorded number what the host
enqueued (spans: 99% of the launches matched; a few enqueue calls, such
as an empty copy, make no device op), and the most complete session is
read.
"""

from __future__ import annotations

import json
import os
import re
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
ENQUEUES = ("Launch", "Memcpy", "Memset")
WINDOW = "bench.window"
SPANS = ("bench.solve", "bench.env")
SESSIONS = 3
TOP = 10


def _session(fn):
    """Run ``fn`` under a profiler session; returns its Chrome-trace events."""
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"]


def _split(events):
    device, host, ranges = [], [], []
    for e in events:
        cat = e.get("cat")
        rec = dict(name=e["name"], t0=float(e["ts"]), t1=float(e["ts"]) + float(e["dur"]),
                   corr=e.get("args", {}).get("correlation"), tid=e.get("tid"))
        if cat in DEVICE_CATS:
            device.append(rec)
        elif cat in HOST_CATS:
            host.append(rec)
        elif cat == "user_annotation":
            ranges.append(rec)
    return device, host, ranges


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _short(name: str) -> str:
    return re.sub(r"\s+", " ", name)[:96]


def replays(step, reps: int, nodes: int) -> dict:
    """``reps`` calls of ``step`` (one replay each, with whatever the cell
    does around it) in a ``bench.window`` range. Returns the device ops
    recorded and expected, ``busy_s`` (union of device op intervals inside
    the range), ``window_s`` (the range's length), ``kernel_s`` by name
    (summed), and ``idle_gaps`` (the longest gaps between device ops inside
    the range, each named by the host call that overlaps it most, or
    ``host_idle``)."""
    best = None
    for _ in range(SESSIONS):
        def run():
            with torch.profiler.record_function(WINDOW):
                for _ in range(reps):
                    step()
                torch.cuda.synchronize()

        device, host, ranges = _split(_session(run))
        win = [r for r in ranges if r["name"] == WINDOW]
        if not win:
            continue
        w0, w1 = win[0]["t0"], win[0]["t1"]
        inside = [d for d in device if d["t0"] >= w0 and d["t1"] <= w1 + 1e3]
        got = dict(ops=len(inside), expected=reps * nodes, w0=w0, w1=w1,
                   inside=inside, host=host)
        if best is None or got["ops"] > best["ops"]:
            best = got
        if got["ops"] >= got["expected"]:
            break
    if best is None:
        raise RuntimeError("no profiler session recorded the traced window")
    busy = _merge([(d["t0"], d["t1"]) for d in best["inside"]])
    by_name: dict = {}
    for d in best["inside"]:
        by_name[_short(d["name"])] = by_name.get(_short(d["name"]), 0.0) + (d["t1"] - d["t0"]) * 1e-6
    gaps, prev = [], best["w0"]
    for a, b in busy + [[best["w1"], best["w1"]]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for a, b in gaps[:TOP]:
        over = {}
        for h in best["host"]:
            o = min(b, h["t1"]) - max(a, h["t0"])
            if o > 0:
                over[h["name"]] = over.get(h["name"], 0.0) + o
        labelled.append([max(over, key=over.get) if over else "host_idle", (b - a) * 1e-6])
    return dict(ops=best["ops"], expected=best["expected"],
                busy_s=sum(b - a for a, b in busy) * 1e-6,
                window_s=(best["w1"] - best["w0"]) * 1e-6,
                kernel_s=by_name, idle_gaps=labelled)


def top_ops(kernel_s: dict):
    return [[k, v] for k, v in sorted(kernel_s.items(), key=lambda kv: -kv[1])[:TOP]]


def kernel_seconds(kernel_s: dict, names) -> float:
    """Summed seconds of the device ops whose name holds one of ``names`` as
    a whole identifier."""
    want = set(names)
    return sum(v for k, v in kernel_s.items()
               if want & set(re.findall(r"[A-Za-z_]\w*", k)))


def spans(step, steps: int) -> dict:
    """``steps`` calls of ``step`` (an eager step that opens the SPANS
    ranges itself) under a session: the device seconds a step of each span,
    with the device ops matched and the enqueue calls seen inside the
    spans."""
    best = None
    for _ in range(SESSIONS):
        device, host, ranges = _split(_session(lambda: [step() for _ in range(steps)]))
        by_corr: dict = {}
        for d in device:
            by_corr.setdefault(d["corr"], []).append(d)
        out, enq, matched = {}, 0, 0
        for name in SPANS:
            total = 0.0
            for r in (r for r in ranges if r["name"] == name):
                for h in host:
                    if h["tid"] == r["tid"] and r["t0"] <= h["t0"] <= r["t1"] and any(
                            k in h["name"] for k in ENQUEUES):
                        enq += 1
                        ops = by_corr.get(h["corr"], [])
                        matched += bool(ops)
                        total += sum(d["t1"] - d["t0"] for d in ops)
            out[name] = total * 1e-6 / steps
        got = dict(seconds=out, enqueued=enq, matched=matched)
        if best is None or got["matched"] > best["matched"]:
            best = got
        if enq and matched >= 0.99 * enq:
            break
    return best

