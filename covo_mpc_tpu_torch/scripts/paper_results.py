"""Reproduce the paper's headline comparison on the card.

Port of the JAX package's ``scripts/paper_results.py``: the reference
evaluation protocol (40 episodes = 4 fixed trajectories x 10 reps, tracking
error in cm; reference: quadjax/envs/quadrotor.py:506-591) for PID / MPPI /
CoVO-online / CoVO-offline on tracking_zigzag without domain randomization,
written to RESULTS_TORCH.md. The paper (arXiv:2401.07369) reports CoVO
beating MPPI by 43-54% on tracking cost.

Each controller row runs SUPERVISED (runtime/supervisor.py): finished rows
are memoized in <checkpoint-root>/cells.json and the in-flight row
checkpoints per 4-episode chunk, so an interrupted table resumes instead of
restarting. --fresh forces re-measurement, --unsupervised restores bare
evaluate().

The JAX script's flags, cell keys and printed lines, with the port's
engines (``--engine auto | torch | cuda``, ``cuda`` the default in the
place of ``pallas``; PID runs on the env's device, whatever the engine) and ``--device cuda |
cpu`` (the card by default, raising without one). Each cell's fingerprint
is the JAX script's with the device appended, and its value also keeps the
count of failed episodes. Every Hessian estimator runs. ``--rng
invariant`` draws from JAX's keys: a supervised cell carries the key from
chunk to chunk and checkpoints it, as JAX's does, and ``--unsupervised``
runs ``evaluate``'s key schedule.

Usage: python -m covo_mpc_tpu_torch.scripts.paper_results [--n 8192] [--h 32] [--quick]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from covo_mpc_tpu_torch.runtime.config import ENGINES
from covo_mpc_tpu_torch.scripts import (
    add_device_flag,
    check_run,
    device_text,
    make_env,
    protocol_steps,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--h", type=int, default=32)
    ap.add_argument("--task", default="tracking_zigzag")
    ap.add_argument("--disturb-type", default="gaussian",
                    choices=["gaussian", "none", "sin", "periodic", "drag",
                             "mixed"])
    ap.add_argument("--quick", action="store_true",
                    help="1 rep per trajectory instead of 10")
    ap.add_argument("--out", default="RESULTS_TORCH.md")
    ap.add_argument("--controllers", nargs="+",
                    default=["pid", "mppi", "covo_online", "covo_offline"])
    ap.add_argument("--engine", default="cuda", choices=ENGINES)
    ap.add_argument("--sigma-mode", default="ns", choices=["eigh", "ns", "ns_pallas"])
    ap.add_argument("--rng", default="fast", choices=["fast", "invariant", "kernel"],
                    help="sampler mode for the sampled controllers (kernel = "
                         "in-kernel Philox draw; quality-gates that mode)")
    ap.add_argument("--hessian-mode", default="adjoint",
                    choices=["fwd_fwd", "fwd_rev", "sensitivity", "adjoint", "gn"],
                    help="CoVO Hessian estimator (gn = Gauss-Newton "
                         "approximation; quality-gates that mode)")
    ap.add_argument("--checkpoint-root", default="results/ckpt_paper_torch")
    ap.add_argument("--fresh", action="store_true",
                    help="discard memoized cells (force re-measurement)")
    ap.add_argument("--unsupervised", action="store_true",
                    help="bare evaluate() per cell (no checkpoint/resume)")
    add_device_flag(ap)
    return ap


def run_rows(args, total_steps: int) -> list:
    """Run one cell per controller at ``total_steps``; returns one dict a
    row: name, mean, std (cm), wall (s), failed (episodes), cached."""
    from covo_mpc_tpu_torch.ops import sampling
    from covo_mpc_tpu_torch.runtime import CellStore, evaluate, run_supervised
    from covo_mpc_tpu_torch.solvers import get_solver

    env = make_env(args.task, args.disturb_type, args.device)
    pstr = f"N{args.n}_H{args.h}_lam0.01"

    store = None if args.unsupervised else CellStore(args.checkpoint_root)
    rows = []
    for name in args.controllers:
        sampled = name != "pid"
        solver, _ = get_solver(
            env, name, pstr, rng_mode=args.rng if sampled else sampling.FAST,
            hessian_mode=args.hessian_mode if "covo" in name else "fwd_fwd",
            collect_debug=False, engine=args.engine, sigma_mode=args.sigma_mode,
        )
        fp = (f"{args.task}/{name}/{pstr}/{args.rng}/{args.hessian_mode}/"
              f"{args.engine}/{args.sigma_mode}/{args.disturb_type}/"
              f"steps={total_steps}/{args.device}")

        def cell(ckpt_dir, solver=solver, fp=fp):
            t0 = time.time()
            res = run_supervised(
                env, solver, total_steps=total_steps,
                checkpoint_dir=ckpt_dir, chunk_episodes=4, fingerprint=fp,
            )
            return [res.mean * 100, res.std * 100, time.time() - t0,
                    int(res.failed.sum())]

        if store is None:
            t0 = time.time()
            res = evaluate(env, solver, total_steps=total_steps)
            rec, cached = [res.mean * 100, res.std * 100,
                           time.time() - t0, 0], False
        else:
            key = f"{name}_{args.task}_{args.disturb_type}"
            if args.fresh:
                store.drop(key, clear_checkpoint=True)
            rec, cached = store.run_cell(key, fp, cell)
        rows.append(dict(name=name, mean=rec[0], std=rec[1], wall=rec[2],
                         failed=rec[3], cached=cached))
        print(f"{name:14s} err_pos = {rec[0]:6.2f} +/- {rec[1]:5.2f} cm"
              f"  (eval wall {rec[2]:.0f}s{', cached' if cached else ''}"
              f"{', %d ep FAILED' % rec[3] if rec[3] else ''})",
              file=sys.stderr, flush=True)
    return rows


def table(args, rows: list, total_steps: int, device: str) -> str:
    """RESULTS_TORCH.md's text: the JAX script's table, then each cell's
    host wall."""
    mppi = next((r for r in rows if r["name"] == "mppi"), None)
    lines = [
        f"# Results — {args.task}, N={args.n}, H={args.h}, lam=0.01, noDR"
        + (f", disturb={args.disturb_type}"
           if args.disturb_type != "gaussian" else ""),
        "",
        f"Protocol: {total_steps//300} episodes = 4 fixed trajectories x "
        f"{total_steps//1200} reps x 300 steps @ 50 Hz "
        "(reference: quadrotor.py:506-591). Error = mean ||pos - pos_tar|| "
        "over the episode, in cm. Device: "
        f"{device}. Fast path: engine={args.engine}, "
        f"sigma_mode={args.sigma_mode}, {args.hessian_mode} Hessian, "
        f"{args.rng} sampler.",
        "",
        "| controller | err_pos (cm) | vs MPPI |",
        "|---|---|---|",
    ]
    for r in rows:
        rel = (f"{(1 - r['mean'] / mppi['mean']) * 100:+.1f}%"
               if mppi and r["name"] != "mppi" else "—")
        lines.append(f"| {r['name']} | {r['mean']:.2f} ± {r['std']:.2f} | {rel} |")
    lines += [
        "",
        "Host wall per cell (s): "
        + ", ".join(f"{r['name']} {r['wall']:.1f}" for r in rows)
        + "; failed episodes: "
        + ", ".join(f"{r['name']} {r['failed']}" for r in rows) + ".",
        "",
        "The paper (arXiv:2401.07369) reports CoVO-MPC improving tracking "
        "cost 43-54% over MPPI. The port's solve latency is in PERF.md §5; "
        "its N-ablation in RESULTS_N_TORCH.md.",
        "",
    ]
    return "\n".join(lines)


def run(args, total_steps: int) -> list:
    """The whole script at ``total_steps``: the cells, then ``args.out``.
    Returns the rows."""
    check_run(args, [args.out])
    rows = run_rows(args, total_steps)
    with open(args.out, "w") as f:
        f.write(table(args, rows, total_steps, device_text(args.device)))
    print(json.dumps({r["name"]: round(r["mean"], 2) for r in rows}))
    return rows


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    run(args, protocol_steps(args.quick))
    return 0


if __name__ == "__main__":
    sys.exit(main())
