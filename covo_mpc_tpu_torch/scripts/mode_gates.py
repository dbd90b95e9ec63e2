"""Quality gates for the non-parity speed modes, on the full eval protocol,
on the card.

Port of the JAX package's ``scripts/mode_gates.py``. Every speed mode the
port runs (in-kernel Philox sampling, the Gauss-Newton Hessian, the
speculative act/design pipeline) must carry an err_pos measured under the
reference's 40-episode protocol (reference: quadjax/envs/quadrotor.py:
564-579) before a throughput number counts. This script runs the mode
matrix and rewrites the "Speed-mode quality gates" section of
RESULTS_TORCH.md between marker comments (idempotent; appended when the
markers are absent), and writes the raw rows to
results_mode_gates_torch.json.

Every cell runs SUPERVISED (runtime/supervisor.py): finished cells are
memoized in <checkpoint-root>/cells.json and the in-flight cell
checkpoints every chunk, so re-running the same command resumes without
recomputing a finished episode. --fresh discards the memo AND each cell's
episode-level checkpoint (a full re-measurement from episode 0);
--unsupervised restores the bare evaluate() path.

The JAX script's flags, cell keys and printed lines, with the port's
engines (``--engine auto | torch | cuda``, ``cuda`` the default in the
place of ``pallas``) and ``--device cuda | cpu`` (the card by default,
raising without one); each cell's fingerprint is the JAX script's with the
device appended.

Usage: python -m covo_mpc_tpu_torch.scripts.mode_gates [--quick] [--n 8192]
"""

from __future__ import annotations

import argparse
import json
import os
import re
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

BEGIN = "<!-- mode-gates:begin -->"
END = "<!-- mode-gates:end -->"


def default_matrix(n: int) -> list:
    """The JAX script's matrix: (tag, controller, rng_mode, hessian_mode, N)."""
    return [
        ("mppi fast (anchor)", "mppi", "fast", "adjoint", n),
        ("mppi kernel-rng", "mppi", "kernel", "adjoint", n),
        ("covo adjoint+kernel-rng", "covo_online", "kernel", "adjoint", n),
        ("covo gn", "covo_online", "fast", "gn", n),
        ("covo gn+kernel-rng", "covo_online", "kernel", "gn", n),
        ("covo speculative", "covo_speculative", "fast", "adjoint", n),
        # one N-ablation point for the fastest composite mode
        ("mppi kernel-rng N=1024", "mppi", "kernel", "adjoint", 1024),
        ("covo gn+kernel-rng N=1024", "covo_online", "kernel", "gn", 1024),
    ]


def run_matrix(args, total_steps: int, matrix=None) -> list:
    """Run ``matrix`` (the JAX script's by default) at ``total_steps``;
    returns one dict a cell: tag, name, rng, hessian, n, mean, std (cm),
    wall (s), failed (episodes)."""
    from covo_mpc_tpu_torch.runtime import CellStore, evaluate, run_supervised
    from covo_mpc_tpu_torch.solvers import get_solver

    env = make_env(args.task, "gaussian", args.device)
    store = None if args.unsupervised else CellStore(args.checkpoint_root)
    rows = []
    for tag, name, rng, hmode, n in matrix or default_matrix(args.n):
        pstr = f"N{n}_H{args.h}_lam0.01"
        solver, _ = get_solver(
            env, name, pstr, rng_mode=rng, hessian_mode=hmode,
            collect_debug=False, engine=args.engine, sigma_mode=args.sigma_mode,
        )
        fp = (f"{args.task}/{name}/{pstr}/{rng}/{hmode}/{args.engine}/"
              f"{args.sigma_mode}/steps={total_steps}/{args.device}")

        def cell(ckpt_dir, solver=solver, fp=fp):
            t0 = time.time()
            res = run_supervised(
                env, solver, total_steps=total_steps,
                checkpoint_dir=ckpt_dir, chunk_episodes=4, fingerprint=fp,
            )
            return dict(mean=res.mean * 100, std=res.std * 100,
                        wall=time.time() - t0,
                        failed=int(res.failed.sum()))

        if store is None:
            t0 = time.time()
            res = evaluate(env, solver, total_steps=total_steps)
            rec, cached = dict(mean=res.mean * 100, std=res.std * 100,
                               wall=time.time() - t0, failed=0), False
        else:
            key = f"{name}_N{n}_{rng}_{hmode}"
            if args.fresh:
                store.drop(key, clear_checkpoint=True)
            rec, cached = store.run_cell(key, fp, cell)
        rows.append(dict(tag=tag, name=name, rng=rng, hessian=hmode, n=n,
                         **rec))
        print(f"{tag:28s} err_pos = {rec['mean']:6.2f} +/- "
              f"{rec['std']:5.2f} cm  (wall {rec['wall']:.0f}s"
              f"{', cached' if cached else ''}"
              f"{', %d ep FAILED' % rec['failed'] if rec['failed'] else ''})",
              file=sys.stderr, flush=True)
    return rows


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--h", type=int, default=32)
    ap.add_argument("--task", default="tracking_zigzag")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--engine", default="cuda", choices=ENGINES)
    ap.add_argument("--sigma-mode", default="ns")
    ap.add_argument("--out", default="RESULTS_TORCH.md")
    ap.add_argument("--json", default="results_mode_gates_torch.json")
    ap.add_argument("--checkpoint-root", default="results/ckpt_mode_gates_torch",
                    help="CellStore root: finished cells memoized, "
                         "in-flight cell checkpointed per 4-episode chunk")
    ap.add_argument("--fresh", action="store_true",
                    help="discard memoized cells (force re-measurement)")
    ap.add_argument("--unsupervised", action="store_true",
                    help="bare evaluate() per cell (no checkpoint/resume)")
    add_device_flag(ap)
    return ap


def section(args, rows: list, total_steps: int, device: str) -> str:
    """The marked section: the JAX script's table, between BEGIN and END."""
    anchor = next(r for r in rows if r["tag"].startswith("mppi fast"))
    lines = [
        BEGIN,
        "## Speed-mode quality gates (full 40-episode protocol)",
        "",
        f"Same protocol as above ({total_steps//300} episodes, "
        f"tracking_zigzag, H={args.h}, lam=0.01, noDR, engine={args.engine}, "
        f"sigma_mode={args.sigma_mode}); device {device}. Each non-parity "
        "speed mode the port runs, gated on tracking quality. "
        "'vs MPPI' compares against the same-run fast-sampler MPPI anchor.",
        "",
        "| mode | N | err_pos (cm) | vs MPPI |",
        "|---|---|---|---|",
    ]
    for r in rows:
        if r["n"] == args.n:
            rel = (
                "anchor" if r is anchor
                else f"{(1 - r['mean'] / anchor['mean']) * 100:+.1f}%"
            )
        else:
            rel = "(N-ablation)"
        lines.append(
            f"| {r['tag']} | {r['n']} | {r['mean']:.2f} ± {r['std']:.2f} | {rel} |"
        )
    lines += [
        "",
        f"Raw rows: `{os.path.basename(args.json)}` (includes per-run wall time).",
        END,
    ]
    return "\n".join(lines)


def rewrite(doc: str, text: str) -> str:
    """``doc`` with the marked section replaced by ``text``, or ``text``
    appended when ``doc`` has no markers."""
    if BEGIN in doc:
        return re.sub(re.escape(BEGIN) + r".*?" + re.escape(END),
                      lambda _: text, doc, flags=re.S)
    return doc.rstrip("\n") + "\n\n" + text + "\n"


def run(args, total_steps: int, matrix=None) -> list:
    """The whole script at ``total_steps``: the cells, the JSON rows, then
    the section of ``args.out`` (a missing file counts as empty). Returns
    the rows."""
    check_run(args, [args.out, args.json])
    rows = run_matrix(args, total_steps, matrix)
    with open(args.json, "w") as f:
        json.dump(rows, f, indent=1)
    doc = ""
    if os.path.exists(args.out):
        with open(args.out) as f:
            doc = f.read()
    with open(args.out, "w") as f:
        f.write(rewrite(doc, section(args, rows, total_steps,
                                     device_text(args.device))))
    print(json.dumps({r["tag"]: round(r["mean"], 2) for r in rows}))
    return rows


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    run(args, protocol_steps(args.quick))
    return 0


if __name__ == "__main__":
    sys.exit(main())
