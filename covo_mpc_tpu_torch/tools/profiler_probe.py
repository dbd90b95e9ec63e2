"""How much a ``torch.profiler`` session on the card keeps: a probe of the
Chrome trace the port's trace readers parse (``runtime/profiling.py``).

    python -m covo_mpc_tpu_torch.tools.profiler_probe [--out results/profiler_probe.json]

In one fresh process, on the main path's captured solve (covo_online gn,
ns, kernel rng, N=8192, H=32) and the captured batched CoVO solve (B=16):

1. the trace's layout: each (ph, cat) with its count and one example, the
   ``kernels.device_kernel`` names of its kernels, whether every device op
   of a chain starts inside the chain's ``record_function`` range, and a
   chain's wall per replay from the trace beside CUDA events over replays;
2. what a session costs the replays: 16 replays under a session of CPU and
   CUDA activity and under one of CUDA activity alone, the device wall and
   busy time a replay, the host's graph-launch call;
3. sessions of one chain of r replays (r = 16 ... 1024): device ops
   recorded against those expected (replays x graph nodes + the host's
   enqueue calls), the session's wall (stop, export and parse included),
   the file's size;
4. sessions of 10 replays, in turns ``graph_profile``'s (all device ops
   counted) and ``trace_chains``' (those in the chain's range, the host
   calls short of device ops named): which are complete, as the process
   runs more sessions;
5. the batched CoVO solve (B=16): sessions of 2, 8 and 32 replays;
6. the size scan of 3 again, after all of them.

Writes one JSON file and prints a summary. Needs the card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile
import time

import torch

N, H = 8192, 32


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="results/profiler_probe.json")
    ap.add_argument("--sizes", type=int, nargs="*", default=[16, 64, 256, 1024])
    ap.add_argument("--sessions", type=int, default=20)
    ap.add_argument("--batched", type=int, nargs="*", default=[2, 8, 32])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA device", file=sys.stderr)
        return 2
    from covo_mpc_tpu_torch.bench import batched_inputs, chain_runner, make_env
    from covo_mpc_tpu_torch.ops import kernels
    from covo_mpc_tpu_torch.parallel import make_batched_covo_solve
    from covo_mpc_tpu_torch.runtime import graphs, profiling
    from covo_mpc_tpu_torch.solvers import get_solver

    out = {"device": profiling.device_info("cuda")}
    print(out["device"], flush=True)
    tmp = tempfile.mkdtemp(prefix="profiler_probe_")
    env = make_env("gaussian", "cuda")
    p = env.default_params
    obs, info, state = env.reset(torch.Generator("cuda").manual_seed(0), p)
    solver, cp = get_solver(env, "covo_online", f"N{N}_H{H}_lam0.01", rng_mode="kernel",
                            hessian_mode="gn", sigma_mode="ns", engine="cuda", collect_debug=False)
    cap = graphs.capture_solver(solver, solver, obs, state, p, cp, info)
    nodes = profiling.graph_nodes(cap)
    out["main_path_nodes"] = nodes

    make_run = chain_runner(lambda c: cap(obs, state, p, c, info)[1], cp)

    # 1. the layout
    run = make_run(2)
    profiling._sync(run(0))
    tdir = os.path.join(tmp, "layout")
    from torch.profiler import record_function

    with profiling.trace(tdir):
        for i in range(2):
            with record_function(profiling.CHAIN_RANGE):
                profiling._sync(run(i))
    path = sorted(os.listdir(tdir))[-1]
    with open(os.path.join(tdir, path)) as fh:
        raw = json.load(fh)
    kinds = collections.Counter((e.get("ph"), e.get("cat")) for e in raw["traceEvents"])
    examples = {}
    for e in raw["traceEvents"]:
        examples.setdefault(f"{e.get('ph')} {e.get('cat')}", e)
    device, host = profiling.load_device_trace(tdir)
    windows = profiling.chain_windows(host)
    out["layout"] = {
        "top_level_keys": sorted(raw),
        "kinds": {f"{ph} {cat}": n for (ph, cat), n in sorted(kinds.items(), key=str)},
        "examples": {k: json.dumps(v)[:600] for k, v in examples.items()},
        "own_kernels": dict(collections.Counter(
            kernels.device_kernel(r["name"]) for r in device if r["category"] == "kernel")),
        "kernel_names": sorted({r["name"][:200] for r in device
                                if r["category"] == "kernel"})[:80],
        "device_ops": len(device),
        "device_ops_in_windows": sum(any(a <= r["ts_us"] <= b for a, b in windows)
                                     for r in device),
        "windows": windows,
        "first_last_device": [device[0]["ts_us"], device[-1]["ts_us"]] if device else None,
    }
    # units: a chain's trace wall per replay beside CUDA events over replays
    out["layout"]["trace_wall_us_per_replay"] = [
        (max(r["ts_us"] + r["dur_us"] for r in device if a <= r["ts_us"] <= b)
         - min(r["ts_us"] for r in device if a <= r["ts_us"] <= b)) / 2 for a, b in windows]
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(20):
        cap(obs, state, p, cp, info)
    e1.record()
    torch.cuda.synchronize()
    out["layout"]["events_us_per_replay"] = e0.elapsed_time(e1) / 20 * 1e3
    print(json.dumps(out["layout"]["kinds"]), flush=True)

    # 2. what a session costs the replays: CPU + CUDA activity, CUDA alone
    from torch.profiler import ProfilerActivity, profile

    run = make_run(16)
    profiling._sync(run(0))
    over = {"events_us_per_replay": out["layout"]["events_us_per_replay"]}
    for label, acts in (("cpu+cuda", [ProfilerActivity.CPU, ProfilerActivity.CUDA]),
                        ("cuda", [ProfilerActivity.CUDA])):
        d = os.path.join(tmp, f"over_{label}")
        os.makedirs(d, exist_ok=True)
        with profile(activities=acts) as prof:
            time.sleep(profiling.PROFILER_PAD_S)
            profiling._sync(run(1))
            time.sleep(profiling.PROFILER_PAD_S)
        prof.export_chrome_trace(os.path.join(d, "trace_1.json"))
        dev, host = profiling.load_device_trace(d)
        launches = sorted(r["dur_us"] for r in host if r["name"] == "cudaGraphLaunch")
        over[label] = {
            "device_ops": len(dev),
            "wall_us_per_replay": (max(r["ts_us"] + r["dur_us"] for r in dev)
                                   - min(r["ts_us"] for r in dev)) / 16 if dev else None,
            "busy_us_per_replay": sum(r["dur_us"] for r in dev) / 16,
            "graph_launch_host_us_median": launches[len(launches) // 2] if launches else None,
            "host_events": len(host),
        }
        print("overhead", label, over[label], flush=True)
    out["overhead"] = over

    def size_scan(label):
        rows = []
        for r in args.sizes:
            run = make_run(r)
            profiling._sync(run(0))
            t0 = time.perf_counter()
            row = {"replays": r}
            try:
                chains = profiling.trace_chains(run, 1, nodes, os.path.join(tmp, f"s{r}"))
                row.update(complete=True, ops=len(chains[0]),
                           wall_us=max(e["ts_us"] + e["dur_us"] for e in chains[0])
                           - min(e["ts_us"] for e in chains[0]))
            except profiling.LostEvents as e:
                row.update(complete=False, lost=str(e))
            row["session_s"] = time.perf_counter() - t0
            d = os.path.join(tmp, f"s{r}")
            row["file_mb"] = sum(os.path.getsize(os.path.join(d, f))
                                 for f in os.listdir(d)) / 2**20
            print(label, row, flush=True)
            rows.append(row)
        return rows

    # 3. sizes
    out["size_scan"] = size_scan("size")
    # 4. many sessions
    seq = []
    run10 = make_run(10)
    for i in range(args.sessions):
        dev_ms, complete, seen = profiling.graph_profile(cap.replay, nodes, reps=10,
                                                         sessions=1)
        row = {"session": i, "graph_profile": complete, "seen": seen, "ms": dev_ms}
        try:
            profiling.trace_chains(run10, 1, nodes, os.path.join(tmp, "seq"))
            row["trace_chains"] = "complete"
        except profiling.LostEvents as e:
            row["trace_chains"] = str(e)
        seq.append(row)
        print("session", row, flush=True)
    out["session_count_scan"] = seq
    # 5. batched CoVO at B=16 (when asked)
    rows_b = []
    if args.batched:
        args_b, pb, a_means, _ = batched_inputs(env, 16, seed=23)
        solve = make_batched_covo_solve(env, N, H, 0.01, rng="kernel", engine="cuda")
        cap_b = graphs.capture_solver(solve, solve, *args_b, a_means, pb)
        nodes_b = profiling.graph_nodes(cap_b)
        for r in args.batched:
            run_b = chain_runner(lambda a: cap_b(*args_b, a, pb)[0], a_means)(r)
            profiling._sync(run_b(0))
            t0 = time.perf_counter()
            row = {"replays": r, "nodes": nodes_b}
            try:
                chains = profiling.trace_chains(run_b, 1, nodes_b, os.path.join(tmp, f"b{r}"))
                row.update(complete=True, ops=len(chains[0]))
            except profiling.LostEvents as e:
                row.update(complete=False, lost=str(e))
            row["session_s"] = time.perf_counter() - t0
            print("batched", row, flush=True)
            rows_b.append(row)
    out["batched_b16"] = rows_b
    # 6. sizes again
    out["size_scan_after"] = size_scan("size after")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
