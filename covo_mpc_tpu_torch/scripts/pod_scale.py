"""Pod-scale (BASELINE config #5) evidence on the card.

Port of the JAX package's ``scripts/pod_scale.py``. Config #5 is 1024
domain-randomized scenarios x CoVO online at N=8192, H=32, the scenarios
sharded over chips. Two measured halves:

  --sweep: one rank's scenario-batch capacity. B grows from ``--b-start``
    (doubling) at N=8192, H=32 through the batched CoVO solve, captured as
    a CUDA graph, up to ``--b-max`` or the card's memory; each B's
    aggregate solves/s (CUDA events on chains of solves) and peak memory
    (``torch.cuda.max_memory_allocated``), beside :func:`hbm_arithmetic`.

  --block: the per-rank block of config #5 at full size, on one card:
    1024 scenarios over 8 ranks gives 128 scenarios x N=8192 x H=32, one
    multichip CoVO step of a one-rank mesh (kernel rng: K7 joint),
    captured; its ms a step and peak memory beside :func:`hbm_arithmetic`.
    JAX's ``--aot`` compiled the full 1024-scenario step over 8 virtual
    devices and read XLA's memory analysis, which has no torch
    counterpart; this runs the block it would place on each device.

Run: python -m covo_mpc_tpu_torch.scripts.pod_scale --block [--sweep]
Each prints one JSON line (the card's name and power limit in it) and a
table to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

POD_SCENARIOS, POD_RANKS = 1024, 8
# config #5's Hessian (JAX's batched solve's default)
HESSIAN = "adjoint"


def hbm_arithmetic(B, N, H, out=sys.stderr, total_bytes=None) -> int:
    """Static per-rank memory accounting of the batched CoVO solve (JAX's
    rows), in bytes; ``total_bytes`` (the card's memory) is printed beside
    when given."""
    f = 4  # fp32 bytes
    rows = [
        ("action samples (B,N,H,4)", B * N * H * 4 * f),
        ("sample z-draws (B,N,D)", B * N * H * 4 * f),
        ("costs + weights (2*B,N)", 2 * B * N * f),
        ("Hessian/Σ/factor (3*B,D,D)", 3 * B * (H * 4) ** 2 * f),
        ("packed states+trajs (B,~16+2*T*3)", B * (16 + 6 * 300) * f),
    ]
    total = sum(b for _, b in rows)
    print(f"  static memory arithmetic at B={B}, N={N}, H={H}:", file=out)
    for name, b in rows:
        print(f"    {name:36s} {b / 2**20:10.1f} MiB", file=out)
    of = f" of {total_bytes / 2**30:.1f} GiB on the card" if total_bytes else ""
    print(f"    {'total (excl. temporaries)':36s} {total / 2**20:10.1f} MiB{of}", file=out)
    return total


def make_env(device):
    """Config #5's env: tracking_zigzag with domain randomization."""
    from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv

    return QuadEnv(EnvConfig(task="tracking_zigzag", enable_randomizer=True,
                             disturb_type="gaussian", disable_rollover_terminate=True,
                             generate_noisy_state=True), device=device)


def _device():
    if not torch.cuda.is_available():
        raise RuntimeError("pod_scale measures the card: no CUDA device here")
    return torch.device("cuda", torch.cuda.current_device())


def _card():
    from covo_mpc_tpu_torch.runtime.profiling import device_info

    return device_info(_device())


def sweep(args) -> list:
    """The B sweep of the batched CoVO solve (module docstring); returns
    (B, aggregate solves/s or None, peak GiB or None) rows, None where B
    did not fit."""
    from covo_mpc_tpu_torch.parallel import make_batched_covo_solve
    from covo_mpc_tpu_torch.runtime import graphs, profiling
    from covo_mpc_tpu_torch.scripts.bench_mesh import scenario_batch
    from covo_mpc_tpu_torch.solvers import hover_sequence

    dev = _device()
    env = make_env(dev)
    N, H = args.n, args.h
    total = torch.cuda.get_device_properties(dev).total_memory
    results, B = [], args.b_start
    while B <= args.b_max:
        try:
            torch.cuda.reset_peak_memory_stats(dev)
            solve = make_batched_covo_solve(env, N, H, 0.01, rng=args.rng,
                                            hessian_mode=HESSIAN, engine="cuda")
            states, params_b, _ = scenario_batch(env, B, key=11)
            from covo_mpc_tpu_torch.parallel.scenarios import _inputs

            x = _inputs(states)
            a0 = hover_sequence(env, H).expand(B, H, 4).clone()
            cap = graphs.capture_solver(solve, solve, *x, a0, params_b)
            t = profiling.time_chained(lambda a: cap(*x, a, params_b)[0], a0, iters=3,
                                       k=args.k)
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
        except torch.cuda.OutOfMemoryError as e:
            print(f"[pod-scale] B={B}: out of memory ({str(e)[:160]})", file=sys.stderr)
            results.append((B, None, None))
            break
        agg = B / t["p50"]
        results.append((B, agg, peak))
        print(f"[pod-scale] B={B:5d}: {t['p50'] * 1e3:8.3f} ms/batch-step -> {agg:10.1f} "
              f"aggregate solves/s ({agg / B:7.1f}/s/scenario), peak {peak:.2f} GiB",
              file=sys.stderr, flush=True)
        hbm_arithmetic(B, N, H, total_bytes=total)
        del cap, solve
        torch.cuda.empty_cache()
        B *= 2
    ok = [r for r in results if r[1] is not None]
    if ok:
        best = max(ok, key=lambda r: r[1])
        ranks = max(POD_SCENARIOS // best[0], 1)
        print(f"best per-rank block: B={best[0]} at {best[1]:.0f} aggregate solves/s -> "
              f"config #5 ({POD_SCENARIOS} scenarios) needs {ranks} ranks at this block",
              file=sys.stderr)
    return results


def block(args) -> dict:
    """Config #5's per-rank block, one multichip CoVO step of B scenarios
    (module docstring): ms a step (CUDA events on chains of ``--k``
    captured steps), aggregate solves/s, peak GiB, and the static
    estimate."""
    from covo_mpc_tpu_torch.parallel import make_mesh, make_multichip_covo_step
    from covo_mpc_tpu_torch.runtime import profiling
    from covo_mpc_tpu_torch.scripts.bench_mesh import scenario_batch
    from covo_mpc_tpu_torch.solvers import hover_sequence
    from covo_mpc_tpu_torch.utils import prng

    dev = _device()
    env = make_env(dev)
    B, N, H = POD_SCENARIOS // POD_RANKS, args.n, args.h
    torch.cuda.reset_peak_memory_stats(dev)
    states, params_b, keys = scenario_batch(env, B, key=0)
    step = make_multichip_covo_step(env, make_mesh(1, device=dev), N, H, 0.01,
                                    rng=args.rng, hessian_mode=HESSIAN,
                                    engine="cuda", capture=True)

    def chain(carry):
        st, a_means, key = carry
        key, sub = prng.split(key).unbind(-2)
        st, a_means, _, _ = step(st, params_b, a_means, prng.split(sub, B))
        return st, a_means, key

    carry = (states, hover_sequence(env, H).expand(B, H, 4).clone(),
             prng.PRNGKey(1, device=dev))
    t = profiling.time_chained(chain, carry, iters=3, k=args.k)
    peak = torch.cuda.max_memory_allocated(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    est = hbm_arithmetic(B, N, H, total_bytes=total)
    rec = {"block": {"scenarios": B, "of": POD_SCENARIOS, "ranks": POD_SCENARIOS // B,
                     "N": N, "H": H, "rng": args.rng, "hessian": HESSIAN,
                     "ms_per_step": t["p50"] * 1e3, "aggregate_solves_per_s": B / t["p50"],
                     "peak_gib": peak / 2**30, "estimate_gib": est / 2**30,
                     "card_gib": total / 2**30, "method": t["method"],
                     "device": _card()}}
    print(f"[pod-scale] block B={B} N={N} H={H}: {t['p50'] * 1e3:.3f} ms a step, "
          f"{B / t['p50']:.1f} aggregate solves/s, peak {peak / 2**30:.2f} GiB against the "
          f"estimate {est / 2**30:.2f} GiB", file=sys.stderr)
    return rec


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--block", action="store_true")
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--h", type=int, default=32)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--rng", default="kernel", choices=["fast", "kernel", "invariant"])
    ap.add_argument("--b-start", type=int, default=8)
    ap.add_argument("--b-max", type=int, default=256)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not (args.sweep or args.block):
        print("pass --block and/or --sweep (each on the card)", file=sys.stderr)
        return 1
    if args.block:
        if args.rng == "fast":
            raise ValueError("--block: the multichip step draws rng 'kernel' or 'invariant'")
        print(json.dumps(block(args)))
    if args.sweep:
        if args.rng == "invariant":
            raise ValueError("--sweep: the batched solve draws rng 'fast' or 'kernel'")
        rows = sweep(args)
        print(json.dumps({"sweep": [{"B": b, "aggregate_solves_per_s": a, "peak_gib": g}
                                    for b, a, g in rows], "device": _card()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
