"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell's entry in ``BENCHMARK.json``, its
configuration file (the entry's ``file``), its traffic mix
(``benchmark/traffic/<traffic>.json``), its limits
(``benchmark/limits/<cell>.json``) and one reader a metric
(``benchmark/metrics/<metric>.py``, ``read(run) -> float | None``). A new
cell, mix or metric is new files and new entries; nothing here changes.

A run: build the system (``system.py``; the first run in a checkout
compiles the kernels into ``build/kernels``), warm up, then the measured
window (``window.py``). ``setup_s`` runs from process start to the
window. After the window: the peak memory, the traced sessions
(``--trace 1``), then the program is freed and the reference judges the
checked replays (``check.py``). The last line on standard output is the
result; the compared numbers and their limits close standard error.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from benchmark import check, system as system_mod, tracing, window, yardstick

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "covo_mpc_tpu")


def forbidden() -> list:
    """The top-level names (compared whole) of JAX or the JAX package that
    ``sys.modules`` holds."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(*parts):
    with open(os.path.join(ROOT, *parts)) as fh:
        return json.load(fh)


def cell_spec(name: str) -> dict:
    """The cell's entry with its configuration, traffic and limits, and the
    metrics it reports: the end-to-end ones, and each per-layer one whose
    ``workloads`` name the cell (without the key: whose ``moves`` the cell
    reports)."""
    bench = load_json("BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def has(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if has(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return dict(cell=cell, config=load_json(cfg_entry["file"]),
                traffic=load_json("benchmark", "traffic", f"{cell['traffic']}.json"),
                limits=load_json("benchmark", "limits", f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


def reader(metric: str):
    path = os.path.join(BENCH, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_query() -> subprocess.Popen:
    """``nvidia-smi``'s name and power limit of the cards, started in the
    background (:func:`card` waits for it)."""
    return subprocess.Popen(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)


def card(query: subprocess.Popen = None) -> dict:
    """The card's name and power limit, the device count."""
    query = query or power_query()
    out = query.communicate(timeout=60)[0].strip().splitlines()
    power = out[0].rsplit(",", 1)[1].strip() if out else "unknown"
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=1,
                power_limit=power)


def check_steps(seed: int, traffic: dict, restart: int) -> list:
    """The replays of the window whose answers are judged: ``check_steps``
    drawn from the seed among the first ``check_within``, and the replay
    ``restart``, in which an episode restarts inside the graph."""
    rng = np.random.default_rng([seed, 11])
    drawn = rng.choice(int(traffic["check_within"]), int(traffic["check_steps"]), replace=False)
    return sorted({int(k) for k in drawn} | {int(restart)})


def measure(metrics: list, run: dict) -> dict:
    """Each metric's reading from its reader, with its unit; a metric whose
    reader finds nothing to read is left out."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(verdict: dict, attempted: int, metrics: dict, device: dict,
                limits: dict, breakdown=None) -> dict:
    """The result's keys in order, the compared numbers last."""
    line = dict(correct=verdict["correct"], attempted=attempted, failed=verdict["failed"],
                metrics=metrics, device=device)
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v, "limit": limits[k]}
                      for k, v in verdict["numbers"].items()}
    return line


def steps_summary(w: dict) -> str:
    """Median ms a step by fifth of the window (and a fleet's host ms a
    launch), for the log."""
    def fifths(xs):
        k = max(len(xs) // 5, 1)
        return " ".join(f"{statistics.median(xs[j:j + k]) * 1e3:.3f}"
                        for j in range(0, k * 5, k) if xs[j:j + k])
    out = f"ms by fifth {fifths(w['step_s'])}"
    if len(w["step_s"]) >= 5:
        out += f", early_slowdown {yardstick.early_slowdown(w['step_s']):.4f}"
    if w["host_s"]:
        out += f"; host ms a launch by fifth {fifths(w['host_s'])}"
    return out


def log(t0: float, msg: str) -> None:
    print(f"[{time.monotonic() - t0:8.2f} s] {msg}", file=sys.stderr, flush=True)


def main(argv=None, t0: float = None, age0: float = 0.0) -> int:
    t0 = time.monotonic() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)
    cfg, traffic, cell = spec["config"], spec["traffic"], spec["cell"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"no result: the cell needs {cell['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    query = power_query()

    sut = system_mod.build(cfg, traffic, args.seed, log=lambda m: log(t0, m))
    for _ in range(int(traffic["warmup_steps"])):
        sut.step()
    torch.cuda.synchronize()
    if float(traffic["settle_s"]) > 0:
        # replays until the slow spell that follows a capture has passed
        settle = window.run(sut, float(traffic["settle_s"]), [])
        log(t0, f"settled over {settle['steps']} replays: " + steps_summary(settle))
    setup_s = time.monotonic() - t0 + age0
    device = card(query)
    log(t0, f"set-up done, setup_s {setup_s:.3f}")

    checked = check_steps(args.seed, traffic, sut.to_restart())
    w = window.run(sut, args.seconds, checked)
    window.catch_up(sut, w)
    device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    log(t0, f"window closed: {w['steps']} steps in {w['window_s']:.3f} s")
    log(t0, "steps: " + steps_summary(w))
    c = cfg["controller"]
    run = dict(vehicles=int(traffic["vehicles"]), steps=w["steps"], window_s=w["window_s"],
               step_s=w["step_s"], setup_s=setup_s, N=int(c["N"]), H=int(c["H"]),
               rollout=cfg["rollout"])
    breakdown = None
    if args.trace:
        run["graph_nodes"] = sut.nodes()
        reps = int(traffic["trace_replays"])
        rep = tracing.replays(sut.step, reps, run["graph_nodes"] + sut.closed_loop)
        run.update(trace=rep, trace_reps=reps)
        device.update(busy_s=rep["busy_s"], window_s=rep["window_s"])
        breakdown = dict(device_ops=tracing.top_ops(rep["kernel_s"]),
                         idle_gaps=rep["idle_gaps"])
        sut.eager_step()
        torch.cuda.synchronize()
        log(t0, "replays traced")
        run["spans"] = tracing.spans(sut.eager_step, int(traffic["trace_eager_steps"]))
        log(t0, "spans traced")
        print(f"trace: {rep['ops']} of {rep['expected']} device ops in the replays; "
              f"spans matched {run['spans']['matched']} of {run['spans']['enqueued']} "
              "launches", file=sys.stderr)
    records = w["records"]
    del sut
    gc.collect()
    torch.cuda.empty_cache()

    verdict = check.judge(cfg, records, spec["limits"])
    log(t0, f"reference checked: replays {checked} of the window")

    metrics = measure(spec["per_layer"] if args.trace else spec["end_to_end"], run)
    line = result_line(verdict, run["vehicles"] * run["steps"], metrics, device,
                       spec["limits"], breakdown)
    print(f"card: {device['kind']}, power limit {device['power_limit']}; "
          f"{run['steps']} steps in {run['window_s']:.3f} s; "
          f"{verdict['answers']} answers checked, {verdict['failed']} failed",
          file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    found = forbidden()
    if found:
        print(f"no result: modules of {found} were loaded", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(line))
    return 0
