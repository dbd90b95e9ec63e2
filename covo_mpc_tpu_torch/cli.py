"""Command-line entry point of the port.

Counterpart of :mod:`covo_mpc_tpu.cli`, with the same flags (the fields of
:class:`~covo_mpc_tpu_torch.runtime.config.RunConfig`, kebab-case) plus
``--device``:

    python -m covo_mpc_tpu_torch.cli --task tracking_zigzag --controller covo_online \\
        --controller-params N8192_H32_lam0.01 --mode eval

Modes: eval (the 40-episode protocol by default; ``--supervised`` runs it
chunked with checkpoints), render (a recorded episode: ``.npz`` trace and a
dashboard PNG) and bench (solve-latency percentiles, one JSON line). It
runs on the card (``--device cuda``, the default) and raises without one;
``--device cpu`` runs the plain path on the CPU. ``--engine cuda`` (the
kernels) needs the card. ``--debug`` gives N=4, H=2 and runs inside
``runtime.debug.debug_mode()``: eager episodes, each solve checked finite.
The PNGs need matplotlib: without it they are skipped, with a message.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

from covo_mpc_tpu_torch.runtime.config import RunConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    for field in dataclasses.fields(RunConfig):
        flag = "--" + field.name.replace("_", "-")
        if isinstance(field.default, bool):
            # a --no-<flag> negator keeps a default-True bool clearable
            p.add_argument(flag, action=argparse.BooleanOptionalAction,
                           default=field.default)
        else:
            p.add_argument(flag, type=type(field.default), default=field.default)
    return p


def main(argv=None) -> int:
    cfg = RunConfig(**vars(build_parser().parse_args(argv)))
    if cfg.engine == "cuda" and torch.device(cfg.device).type != "cuda":
        raise ValueError("--engine cuda runs the kernels on the card: it takes "
                         "--device cuda (--device cpu takes --engine torch or auto)")
    if torch.device(cfg.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {cfg.device}: no CUDA device here "
                           "(pass --device cpu to run on the CPU)")
    if cfg.debug:
        # a scope, restored on exit: main() is also called in-process
        from covo_mpc_tpu_torch.runtime.debug import debug_mode

        with debug_mode():
            return _run(cfg)
    return _run(cfg)


def _png(draw, path: str) -> str:
    """Draw the PNG at ``path`` by ``draw()``; without matplotlib, say so
    and go on (the arrays are saved regardless)."""
    try:
        return draw()
    except ImportError as e:
        print(f"matplotlib is not available ({e}): skipped {path}")
        return "no PNG"


def _run(cfg) -> int:
    from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv
    from covo_mpc_tpu_torch.runtime import evaluate
    from covo_mpc_tpu_torch.runtime.checkpoint import save_eval_result
    from covo_mpc_tpu_torch.runtime.render import render_episode, save_trace
    from covo_mpc_tpu_torch.solvers import get_solver
    from covo_mpc_tpu_torch.utils.plotting import plot_episode, plot_eval_errors

    env = QuadEnv(
        EnvConfig(
            task=cfg.task,
            obs_type=cfg.obs_type,
            enable_randomizer=not cfg.noDR,
            lower_controller=cfg.lower_controller,
            disturb_type=cfg.disturb_type,
            disable_rollover_terminate=True,
            generate_noisy_state=True,
        ),
        device=cfg.device,
    )
    solver, _ = get_solver(
        env,
        cfg.controller,
        cfg.controller_params,
        debug=cfg.debug,
        rng_mode=cfg.rng_mode,
        hessian_mode=cfg.hessian_mode,
        engine=cfg.engine,
        sigma_mode=cfg.sigma_mode,
        # the kernels compute costs only; the debug poses need the plain path
        collect_debug=(cfg.engine == "torch"),
        collect_metrics=cfg.metrics,
    )
    name = cfg.name or f"{cfg.controller}_{cfg.task}"
    os.makedirs(cfg.results_dir, exist_ok=True)

    if cfg.mode == "eval":
        metrics_path = (f"{cfg.results_dir}/metrics_{name}.jsonl" if cfg.metrics
                        else None)
        if cfg.supervised:
            from covo_mpc_tpu_torch.runtime.supervisor import run_supervised

            if metrics_path:
                # the chunked supervisor keeps no per-solve metrics (they
                # would bloat every checkpoint): run unsupervised for them
                print("warning: --metrics is not supported with --supervised; "
                      "no metrics JSONL will be written", file=sys.stderr)
                metrics_path = None
            fingerprint = (
                f"{cfg.task}/{cfg.controller}/{cfg.controller_params}/"
                f"{cfg.rng_mode}/{cfg.hessian_mode}/{cfg.engine}/"
                f"{cfg.sigma_mode}/{cfg.disturb_type}/noDR={cfg.noDR}/{cfg.device}"
            )
            result = run_supervised(
                env, solver, total_steps=cfg.total_steps, seed=cfg.seed,
                checkpoint_dir=cfg.checkpoint_dir or f"{cfg.results_dir}/ckpt_{name}",
                chunk_episodes=cfg.chunk_episodes, fingerprint=fingerprint,
            )
        else:
            result = evaluate(env, solver, total_steps=cfg.total_steps,
                              seed=cfg.seed, metrics_path=metrics_path)
        print(result.summary())
        out = save_eval_result(result, f"{cfg.results_dir}/eval_{name}.npz")
        png = f"{cfg.results_dir}/eval_{name}.png"
        _png(lambda: plot_eval_errors(result.err_pos_ep, png, name), png)
        print(f"saved {out}")
        if metrics_path:
            print(f"metrics: {metrics_path}")
    elif cfg.mode == "render":
        trace = render_episode(env, solver, seed=cfg.seed,
                               reset_on_done=cfg.render_reset_on_done)
        out = save_trace(trace, f"{cfg.results_dir}/trace_{name}.npz")
        path = f"{cfg.results_dir}/render_{name}.png"
        png = _png(lambda: plot_episode(trace, float(env.default_params.dt), path, name),
                   path)
        err = float(trace["err_pos"].mean())
        print(f"mean err_pos: {err*100:.2f} cm; saved {out} and {png}")
    elif cfg.mode == "bench":
        print(json.dumps(_bench(env, solver, cfg.trace_dir or None)))
        if cfg.trace_dir:
            print(f"profiler trace: {cfg.trace_dir}")
    else:
        raise SystemExit(f"unknown mode {cfg.mode!r}")
    return 0


def _bench(env, solver, trace_dir) -> dict:
    """Latency of one solve from a reset state: per call (``time_blocking``,
    20 calls after 2) and per solve of a chain (``time_chained``, CUDA
    events; on the card only). On the card the solve is captured as a CUDA
    graph (``runtime/graphs.capture_solver``), as JAX jits it, unless
    ``debug_mode()`` disables capture or the solve reads the host (``eigh``);
    on the CPU it runs eagerly. A solver that draws from JAX keys takes
    the reset's and every solve's from ``PRNGKey(0)`` (a graph input when
    captured)."""
    from covo_mpc_tpu_torch.runtime import debug, graphs, metrics, profiling
    from covo_mpc_tpu_torch.utils import prng

    p = env.default_params
    obs, info, state = env.reset(torch.Generator(device=env.device).manual_seed(0), p)
    keys = ((prng.PRNGKey(0, env.device),) if getattr(solver, "draws_from_keys", False)
            else ())
    cp = solver.reset(state, p, solver.init_control_params, *keys)
    card = torch.device(env.device).type == "cuda"
    solve = ((lambda o, s, pp, c, i, k: solver(o, s, pp, c, i, key=k)) if keys
             else solver)
    if card and not debug.jit_disabled() and solver.capturable:
        with metrics.deferred_sigma():
            solve = graphs.capture_solver(solve, solver, obs, state, p, cp, info, *keys)
    with profiling.trace(trace_dir):
        stats = profiling.time_blocking(solve, 20, 2, obs, state, p, cp, info, *keys)
        amort = (profiling.time_chained(lambda c: solve(obs, state, p, c, info, *keys)[1],
                                        cp) if card else None)
    rnd = lambda d: {k: round(v, 6) if isinstance(v, float) else v
                     for k, v in d.items()}
    return {"per_dispatch": rnd(stats),
            "amortized_per_solve": None if amort is None else rnd(amort),
            "device": profiling.device_info(env.device)}


if __name__ == "__main__":
    sys.exit(main())
