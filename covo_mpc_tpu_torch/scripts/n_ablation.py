"""Sample-count ablation (the paper's second experiment), on the card.

Port of the JAX package's ``scripts/n_ablation.py``: sweeps N in {16, 32,
64, 128, 256, 512, 1024} at H=32, lam=0.01 over {mppi, covo_online,
covo_offline} on tracking_zigzag without domain randomization (reference:
quadjax/scripts/covo_quadrotor_N.sh:1-12) and writes RESULTS_N_TORCH.md.
The paper's claim: CoVO's advantage over MPPI grows as the sample budget
shrinks (optimal Σ matters most when samples are scarce).

Runs ``engine="auto"`` at every N: on the card the hand-written kernels (a
sample count below one block, or ragged over a few, runs with the last
block's idle lanes masked), the fast sampler, the adjoint Hessian and the
ns designer.

Every cell runs SUPERVISED (runtime/supervisor.py — finished cells
memoized in <checkpoint-root>/cells.json, in-flight cell checkpointed per
episode chunk), so an interrupted sweep resumes instead of restarting.
--fresh forces re-measurement, --unsupervised restores bare evaluate().

The JAX script's flags, cell keys and printed lines, with ``--device cuda
| cpu`` (the card by default, raising without one); each cell's
fingerprint is the JAX script's with the device appended, and its value
also keeps the cell's host wall and its count of failed episodes.

Usage: python -m covo_mpc_tpu_torch.scripts.n_ablation [--quick] [--ns 16 64 256]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from covo_mpc_tpu_torch.scripts import (
    add_device_flag,
    check_run,
    device_text,
    make_env,
    protocol_steps,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ns", nargs="+", type=int,
                    default=[16, 32, 64, 128, 256, 512, 1024])
    ap.add_argument("--h", type=int, default=32)
    ap.add_argument("--task", default="tracking_zigzag")
    ap.add_argument("--quick", action="store_true",
                    help="1 rep per trajectory instead of 10")
    ap.add_argument("--out", default="RESULTS_N_TORCH.md")
    ap.add_argument("--controllers", nargs="+",
                    default=["mppi", "covo_online", "covo_offline"])
    ap.add_argument("--checkpoint-root", default="results/ckpt_n_ablation_torch")
    ap.add_argument("--fresh", action="store_true",
                    help="discard memoized cells (force re-measurement)")
    ap.add_argument("--unsupervised", action="store_true",
                    help="bare evaluate() per cell (no checkpoint/resume)")
    add_device_flag(ap)
    return ap


def run_cells(args, total_steps: int) -> dict:
    """Run every (N, controller) cell at ``total_steps``; returns
    ``{(n, name): dict(mean, std (cm), wall (s), failed, cached)}``."""
    from covo_mpc_tpu_torch.ops import sampling
    from covo_mpc_tpu_torch.runtime import CellStore, evaluate, run_supervised
    from covo_mpc_tpu_torch.solvers import get_solver

    env = make_env(args.task, "gaussian", args.device)
    store = None if args.unsupervised else CellStore(args.checkpoint_root)
    results = {}
    for n in args.ns:
        for name in args.controllers:
            solver, _ = get_solver(
                env, name, f"N{n}_H{args.h}_lam0.01", rng_mode=sampling.FAST,
                hessian_mode="adjoint" if "covo" in name else "fwd_fwd",
                collect_debug=False, sigma_mode="ns" if "covo" in name else "eigh",
                engine="auto",
            )
            fp = (f"{args.task}/{name}/N{n}_H{args.h}/fast/auto/"
                  f"steps={total_steps}/{args.device}")

            def cell(ckpt_dir, solver=solver, fp=fp):
                t0 = time.time()
                res = run_supervised(
                    env, solver, total_steps=total_steps,
                    checkpoint_dir=ckpt_dir, chunk_episodes=4,
                    fingerprint=fp,
                )
                return [res.mean * 100, res.std * 100, time.time() - t0,
                        int(res.failed.sum())]

            t0 = time.time()
            if store is None:
                res = evaluate(env, solver, total_steps=total_steps)
                rec, cached = [res.mean * 100, res.std * 100,
                               time.time() - t0, 0], False
            else:
                key = f"N{n}_{name}"
                if args.fresh:
                    store.drop(key, clear_checkpoint=True)
                rec, cached = store.run_cell(key, fp, cell)
            results[(n, name)] = dict(mean=rec[0], std=rec[1], wall=rec[2],
                                      failed=rec[3], cached=cached)
            print(
                f"N={n:5d} {name:14s} err_pos = {rec[0]:6.2f} "
                f"+/- {rec[1]:5.2f} cm  ({time.time()-t0:.0f}s"
                f"{', cached' if cached else ''}"
                f"{', %d ep FAILED' % rec[3] if rec[3] else ''})",
                file=sys.stderr, flush=True,
            )
    return results


def table(args, results: dict, total_steps: int, device: str) -> str:
    """RESULTS_N_TORCH.md's text: the JAX script's table, then each cell's
    host wall."""
    lines = [
        f"# N-ablation — {args.task}, H={args.h}, lam=0.01, noDR",
        "",
        f"Protocol: {total_steps//300} episodes per cell "
        "(reference sweep: scripts/covo_quadrotor_N.sh). err_pos in cm, "
        f"mean ± std over episodes. Device: {device}. "
        "engine=auto (the hand-written CUDA kernels on the card at every N — "
        "a block's idle lanes masked), adjoint Hessian, ns designer, fast "
        "sampler.",
        "",
        "| N | " + " | ".join(args.controllers) + " | CoVO-on vs MPPI |",
        "|---|" + "---|" * (len(args.controllers) + 1),
    ]
    for n in args.ns:
        cells = [f"{results[(n, c)]['mean']:.2f} ± {results[(n, c)]['std']:.2f}"
                 for c in args.controllers]
        rel = "—"
        if ("mppi" in args.controllers and "covo_online" in args.controllers):
            m, c = results[(n, "mppi")]["mean"], results[(n, "covo_online")]["mean"]
            rel = f"{(1 - c / m) * 100:+.1f}%"
        lines.append(f"| {n} | " + " | ".join(cells) + f" | {rel} |")
    lines += [
        "",
        "Host wall per cell (s): " + ", ".join(
            f"N={n} {c} {results[(n, c)]['wall']:.1f}"
            for n in args.ns for c in args.controllers)
        + "; failed episodes: "
        + str(sum(r["failed"] for r in results.values())) + ".",
        "",
    ]
    return "\n".join(lines)


def run(args, total_steps: int) -> dict:
    """The whole script at ``total_steps``: the cells, then ``args.out``.
    Returns the cells."""
    check_run(args, [args.out])
    results = run_cells(args, total_steps)
    with open(args.out, "w") as f:
        f.write(table(args, results, total_steps, device_text(args.device)))
    print(json.dumps({f"N{n}_{c}": round(v["mean"], 2)
                      for (n, c), v in results.items()}))
    return results


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    run(args, protocol_steps(args.quick))
    return 0


if __name__ == "__main__":
    sys.exit(main())
