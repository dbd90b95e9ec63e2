"""Multi-rank benchmark: the solve rate over a rank mesh.

Port of the JAX package's ``scripts/bench_mesh.py``, with its flags and one
JSON line per configuration::

    python -m covo_mpc_tpu_torch.scripts.bench_mesh                  # one rank
    python -m covo_mpc_tpu_torch.scripts.bench_mesh --samples 2      # 1 and 2 ranks
    python -m covo_mpc_tpu_torch.scripts.bench_mesh --scenarios 2 --b 16
    python -m covo_mpc_tpu_torch.scripts.bench_mesh --offline --pipeline \\
        --metrics mesh_metrics.jsonl
    # one process a card, through the launcher contract, NCCL:
    COORDINATOR_ADDRESS=host:port NUM_PROCESSES=k PROCESS_ID=i \\
        python -m covo_mpc_tpu_torch.scripts.bench_mesh --distributed

Modes (JAX's): SAMPLE sharding, one CoVO-online solve's N samples split
over the ranks (the distributed solve: three collectives a solve), a row
at 1 and at ``--samples`` ranks; SCENARIO data parallelism, B randomized
episodes stepped by the multichip CoVO step, a row at 1 and at
``--scenarios`` ranks; ``--offline``, CoVO offline's Σ schedule designed
over the ranks; ``--pipeline``, the two-stage speculative pipeline on 2
ranks; ``--metrics``, a short episode of distributed solves writing each
solve's health as JSONL.

Ranks. In one process a mesh has one rank. A width w > 1 is measured in w
ranks launched on this host (``parallel.run_ranks``): they share this
process's device, so on the card they run under gloo, whose collectives go
through the host and run eagerly, and their numbers are labelled
``"plumbing": true`` (they test the layout, not the scaling; so are all
the CPU's). ``--distributed`` instead joins the job the launcher contract
describes (one process a rank and a card, ``--backend nccl``) and
measures at its world size; every rank runs, rank 0 prints.

Timing (on the card): CUDA events around chains of ``--k`` dependent
solves (``runtime/profiling.time_chained``), each solve captured as a CUDA
graph where the collectives allow it (one rank, or NCCL), eager under
gloo; the CPU's rows time the host's wall over the chain. Every line
carries the card's name and power limit, the backend, the method, and
whether it is plumbing. Rows go to stdout as JSON, a summary to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import torch

from covo_mpc_tpu_torch.scripts import add_device_flag

LAUNCH_TIMEOUT_S = 600.0  # seconds a launch of ranks may take


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=8192, help="samples per solve")
    ap.add_argument("--h", type=int, default=32, help="horizon")
    ap.add_argument("--lam", type=float, default=0.01)
    ap.add_argument("--k", type=int, default=32, help="solves per timed chain")
    ap.add_argument("--samples", type=int, default=0,
                    help="sample-shard width to bench beside 1 rank (0: the job's world)")
    ap.add_argument("--scenarios", type=int, default=0,
                    help="scenario-DP width to bench beside 1 rank (0: skip)")
    ap.add_argument("--b", type=int, default=0,
                    help="total scenario batch of the scenario rows (default: one a rank)")
    ap.add_argument("--engine", default="auto", choices=["auto", "cuda", "torch"])
    ap.add_argument("--rng", default="invariant", choices=["invariant", "kernel"],
                    help="invariant: mesh-shape-invariant global-id draws; kernel: "
                         "in-kernel Philox draws a rank (engine cuda)")
    ap.add_argument("--hessian", default="adjoint", choices=["adjoint", "gn"])
    ap.add_argument("--offline", action="store_true",
                    help="also bench CoVO offline's Σ schedule designed over the ranks")
    ap.add_argument("--pipeline", action="store_true",
                    help="also bench the two-stage speculative pipeline on 2 ranks")
    ap.add_argument("--metrics", default="",
                    help="write each solve's health for a short mesh episode as JSONL")
    ap.add_argument("--metrics-steps", type=int, default=32)
    ap.add_argument("--distributed", action="store_true",
                    help="join the job of COORDINATOR_ADDRESS / NUM_PROCESSES / "
                         "PROCESS_ID (one process a rank and a card)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="--distributed's backend (default: nccl on the card, gloo "
                         "on the CPU)")
    add_device_flag(ap)
    return ap


def make_env(device, randomize: bool = False):
    """The bench's env (tracking_zigzag, the main path's settings)."""
    from covo_mpc_tpu_torch.scripts import make_env as protocol_env

    env = protocol_env("tracking_zigzag", "gaussian", device)
    if not randomize:
        return env
    from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv

    return QuadEnv(EnvConfig(**{**vars(env.config), "enable_randomizer": True}),
                   device=device)


def _engine(args) -> str:
    """``--engine`` resolved as ``solvers.base.resolve_engine`` resolves
    "auto": the kernels on the card, the plain path on the CPU."""
    if args.engine != "auto":
        return args.engine
    return "cuda" if args.device == "cuda" else "torch"


def _rng(args) -> str:
    return args.rng if _engine(args) == "cuda" else "invariant"


def _measure(step, carry, args, device) -> dict:
    """Seconds a call of ``carry = step(carry)``: CUDA events around chains
    of ``--k`` on the card, the host's wall over them on the CPU."""
    from covo_mpc_tpu_torch.runtime import profiling

    if torch.device(device).type == "cuda":
        return profiling.time_chained(step, carry, iters=4, k=args.k)
    for _ in range(2):
        carry = step(carry)
    t0 = time.perf_counter()
    for _ in range(args.k):
        carry = step(carry)
    profiling._sync(carry)
    per = (time.perf_counter() - t0) / args.k
    return {"p50": per, "mean": per, "iters": 1, "k": args.k, "method": "host_wall"}


def _row(mesh, args, device, **values) -> dict:
    from covo_mpc_tpu_torch.runtime.profiling import device_info

    capture = _capturable(mesh, device)
    return {**values, "rng": _rng(args), "engine": _engine(args),
            "backend": mesh.backend, "captured": capture,
            "plumbing": torch.device(device).type != "cuda" or not mesh.capturable,
            "device": device_info(device)}


def _capturable(mesh, device) -> bool:
    return torch.device(device).type == "cuda" and mesh.capturable


def _reset(env, key=0):
    from covo_mpc_tpu_torch.models.structs import pack_state
    from covo_mpc_tpu_torch.utils import prng

    _, _, state = env.reset(prng.PRNGKey(key, device=env.device))
    return (pack_state(state), state.time, state.pos_traj, state.vel_traj)


def bench_samples(env, args, mesh) -> dict:
    """One CoVO-online solve's samples over the mesh's ranks (the
    distributed solve), chained as a control loop would chain them."""
    from covo_mpc_tpu_torch.parallel import make_distributed_covo_solve
    from covo_mpc_tpu_torch.solvers import hover_sequence
    from covo_mpc_tpu_torch.utils import prng

    dev = env.device
    solve = make_distributed_covo_solve(
        env, mesh, args.n, args.h, args.lam, engine=_engine(args), rng=_rng(args),
        hessian_mode=args.hessian, capture=_capturable(mesh, dev))
    x = _reset(env)
    p = env.default_params

    def step(carry):
        a_mean, key = carry
        key, sub = prng.split(key).unbind(-2)
        return solve(*x, a_mean, p, sub)[0], key

    t = _measure(step, (hover_sequence(env, args.h), prng.PRNGKey(2, device=dev)), args,
                 dev)
    return _row(mesh, args, dev, axis="samples", shards=mesh.size,
                ms_per_solve=t["p50"] * 1e3, solves_per_s=1.0 / t["p50"], method=t["method"])


def scenario_batch(env, B: int, key: int = 1):
    """B randomized scenarios from JAX-style keys: (states, params_b, keys)."""
    from covo_mpc_tpu_torch.models.structs import stack, stack_params
    from covo_mpc_tpu_torch.utils import prng

    keys = prng.split(prng.PRNGKey(key, device=env.device), B)
    params = [env.sample_params(keys[b]) for b in range(B)]
    states = stack([env.reset(keys[b], params[b])[2] for b in range(B)])
    return states, stack_params(params), keys


def bench_scenarios(env, args, mesh, B: int) -> dict:
    """B randomized episodes data parallel over the mesh's ranks, each
    rank stepping its block with the multichip CoVO step."""
    from covo_mpc_tpu_torch.parallel import SCENARIO_AXIS, make_multichip_covo_step
    from covo_mpc_tpu_torch.solvers import hover_sequence
    from covo_mpc_tpu_torch.utils import prng

    dev = env.device
    states, params_b, _ = scenario_batch(env, B)
    states = mesh.shard(states, SCENARIO_AXIS)
    params_b = mesh.shard(params_b, SCENARIO_AXIS)
    b = B // mesh.size
    step_fn = make_multichip_covo_step(env, mesh, args.n, args.h, args.lam,
                                       engine=_engine(args), rng=_rng(args),
                                       hessian_mode=args.hessian,
                                       capture=_capturable(mesh, dev))
    key0 = prng.fold_in(prng.PRNGKey(3, device=dev), mesh.axis(SCENARIO_AXIS).index)

    def step(carry):
        st, a_means, key = carry
        key, sub = prng.split(key).unbind(-2)
        st, a_means, _, _ = step_fn(st, params_b, a_means, prng.split(sub, b))
        return st, a_means, key

    carry = (states, hover_sequence(env, args.h).expand(b, args.h, 4).clone(), key0)
    t = _measure(step, carry, args, dev)
    return _row(mesh, args, dev, axis="scenarios", chips=mesh.size, scenario_batch=B,
                ms_per_step=t["p50"] * 1e3, aggregate_solves_per_s=B / t["p50"],
                method=t["method"])


def bench_offline(env, args, mesh) -> dict:
    """CoVO offline's Σ schedule (300 designs) over the mesh's ranks: one
    schedule after a warm one, wall seconds to its result on the host."""
    from covo_mpc_tpu_torch.parallel import make_distributed_offline_schedule
    from covo_mpc_tpu_torch.solvers import get_solver
    from covo_mpc_tpu_torch.utils import prng

    dev = env.device
    solver, cp0 = get_solver(env, "covo_offline", f"N{args.n}_H{args.h}_lam{args.lam}",
                             rng_mode="invariant", hessian_mode=args.hessian,
                             sigma_mode="ns", engine=_engine(args), collect_debug=False)
    schedule = make_distributed_offline_schedule(solver, mesh)
    _, _, state = env.reset(prng.PRNGKey(0, device=dev))
    key = prng.PRNGKey(7, device=dev)
    float(schedule(state, env.default_params, cp0, key).a_cov_offline.sum())
    t0 = time.perf_counter()
    float(schedule(state, env.default_params, cp0, key).a_cov_offline.sum())
    return _row(mesh, args, dev, axis="offline_schedule", shards=mesh.size,
                precompute_s=time.perf_counter() - t0, method="host_wall")


def bench_pipeline(env, args, mesh) -> dict:
    """The speculative pipeline's control loop: act and design on the two
    pipe ranks, a step chained after the other."""
    from covo_mpc_tpu_torch.parallel import make_init_factor, make_pipeline_step
    from covo_mpc_tpu_torch.solvers import hover_sequence
    from covo_mpc_tpu_torch.utils import prng

    dev = env.device
    eng = _engine(args)
    step_fn = make_pipeline_step(env, mesh, args.n, args.h, args.lam, engine=eng,
                                 rng=_rng(args), hessian_mode=args.hessian,
                                 capture=_capturable(mesh, dev))
    x, p, a0 = _reset(env), env.default_params, hover_sequence(env, args.h)
    f0 = make_init_factor(env, args.h, hessian_primal=eng if eng == "cuda" else "torch",
                          hessian_mode=args.hessian)(*x, a0, p, prng.PRNGKey(4, device=dev))

    def step(carry):
        a_mean, factor, key = carry
        key, sub = prng.split(key).unbind(-2)
        a_mean, factor, _ = step_fn(*x, a_mean, factor, p, sub)
        return a_mean, factor, key

    t = _measure(step, (a0, f0, prng.PRNGKey(5, device=dev)), args, dev)
    return _row(mesh, args, dev, axis="pipe", chips=mesh.size,
                ms_per_step=t["p50"] * 1e3, solves_per_s=1.0 / t["p50"], method=t["method"])


def emit_metrics_episode(env, args, mesh, path: Optional[str], steps: int = 32) -> dict:
    """A short episode of distributed CoVO solves with ``collect_metrics``
    on the mesh; rank 0 writes one JSONL health record a solve (the cost
    min / mean / max and the ESS from all-reduced partials, Σ's
    conditioning). Returns the (steps,) metric stacks."""
    from covo_mpc_tpu_torch.parallel import make_distributed_covo_solve
    from covo_mpc_tpu_torch.runtime.metrics import MetricsLogger
    from covo_mpc_tpu_torch.solvers import hover_sequence
    from covo_mpc_tpu_torch.utils import prng

    dev = env.device
    solve = make_distributed_covo_solve(env, mesh, args.n, args.h, args.lam,
                                        engine=_engine(args), rng=_rng(args),
                                        hessian_mode=args.hessian, collect_metrics=True)
    x, p = _reset(env), env.default_params
    a_mean, key, records = hover_sequence(env, args.h), prng.PRNGKey(11, device=dev), []
    for _ in range(steps):
        key, sub = prng.split(key).unbind(-2)
        a_mean, _, m = solve(*x, a_mean, p, sub)
        records.append(m)
    out = {k: torch.stack([r[k] for r in records]) for k in records[0]}
    if mesh.rank == 0 and path:
        logger = MetricsLogger(path)
        for t in range(steps):
            logger.log(step=t, shards=mesh.size, **{k: v[t] for k, v in out.items()})
        logger.close()
        print(f"[mesh] wrote {steps} per-solve health records (shards={mesh.size}) "
              f"to {path}", file=sys.stderr)
    return out


def _device(args):
    return torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda" \
        else torch.device("cpu")


def run_tasks(args, tasks) -> list:
    """Each task, a (name, width, extra) tuple, on this job's mesh of that
    width (the job's world: 1 in a process of its own); rank 0's rows."""
    from covo_mpc_tpu_torch.parallel import make_mesh, make_pipeline_mesh

    dev = _device(args)
    rows = []
    for name, width, extra in tasks:
        env = make_env(dev, randomize=name == "scenarios")
        if name == "pipeline":
            mesh = make_pipeline_mesh(samples=width // 2, device=dev)
        elif name == "scenarios":
            mesh = make_mesh(samples=1, scenarios=width, device=dev)
        else:
            mesh = make_mesh(samples=width, device=dev)
        if name == "samples":
            row = bench_samples(env, args, mesh)
        elif name == "scenarios":
            row = bench_scenarios(env, args, mesh, extra)
        elif name == "offline":
            row = bench_offline(env, args, mesh)
        elif name == "pipeline":
            row = bench_pipeline(env, args, mesh)
        else:
            emit_metrics_episode(env, args, mesh, args.metrics, args.metrics_steps)
            continue
        if mesh.rank == 0:
            rows.append(row)
    return rows


def _rank_tasks(rank: int, args, tasks) -> list:
    if args.device == "cuda":
        torch.cuda.set_device(0)
    return run_tasks(args, tasks)


def plan(args, world: int) -> dict:
    """The tasks by width: the sample rows at 1 and ``--samples`` (or the
    world), the scenario rows at 1 and ``--scenarios``, offline at the
    sample widths, the pipeline at 2 ranks, the metrics episode at the
    widest sample width."""
    by_width: dict = {}

    def add(name, width, extra=None):
        by_width.setdefault(width, []).append((name, width, extra))

    sample_widths = sorted({1, args.samples or world})
    for w in sample_widths:
        add("samples", w)
    if args.scenarios:
        B = args.b or args.scenarios
        for w in sorted({1, args.scenarios}):
            if B % w:
                raise ValueError(f"--b {B} not divisible by {w} scenario ranks")
            add("scenarios", w, B)
    if args.offline:
        for w in sample_widths:
            add("offline", w)
    if args.pipeline:
        add("pipeline", 2)
    if args.metrics:
        add("metrics", sample_widths[-1])
    return by_width


def summarize(rows) -> list:
    """JAX's speedup and efficiency columns against each axis's one-rank
    row: the rate's ratio (the precompute time's, inverted, for offline)
    and that over the width (plumbing where either row is)."""
    base = {r["axis"]: r for r in rows if r.get("shards", r.get("chips")) == 1}
    for r in rows:
        b = base.get(r["axis"])
        if b is None or r is b:
            continue
        rate = next((k for k in ("solves_per_s", "aggregate_solves_per_s") if k in r), None)
        speed = r[rate] / b[rate] if rate else b["precompute_s"] / r["precompute_s"]
        r["speedup_vs_1rank"] = speed
        r["scaling_efficiency"] = speed / r.get("shards", r.get("chips"))
    return rows


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from covo_mpc_tpu_torch.parallel import initialize_distributed, run_ranks
    from covo_mpc_tpu_torch.scripts import check_run

    check_run(args, [])
    if args.distributed:
        backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
        if args.device == "cuda":
            import os

            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        rank = initialize_distributed(backend=backend)
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_initialized() else 1
        print(f"[mesh] process {rank} of {world} up ({backend})", file=sys.stderr)
        tasks = [t for w, ts in plan(args, world).items() if w == world for t in ts]
        rows = run_tasks(args, tasks)
        if rank != 0:
            return 0
    else:
        rows = []
        for width, tasks in sorted(plan(args, 1).items()):
            if width == 1:
                rows += run_tasks(args, tasks)
            else:
                rows += run_ranks(_rank_tasks, width, args, tasks, backend="gloo",
                                  timeout_s=LAUNCH_TIMEOUT_S)[0]
    for r in summarize(rows):
        width = r.get("shards", r.get("chips"))
        print(f"[mesh] {r['axis']} width {width} ({r['backend'] or 'one rank'}, "
              f"{'plumbing' if r['plumbing'] else 'measured'}): "
              + ", ".join(f"{k} {v:.4f}" for k, v in r.items()
                          if isinstance(v, float)), file=sys.stderr)
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
