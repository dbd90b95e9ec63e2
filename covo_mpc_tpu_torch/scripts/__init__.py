"""The paper's reproduction sweeps on the port, each a port of the JAX
script of the same name in the repo's ``scripts/``:

  paper_results  PID / MPPI / CoVO online / CoVO offline on the
                 40-episode protocol -> RESULTS_TORCH.md
  mode_gates     the 8-cell speed-mode matrix -> its marked section of
                 RESULTS_TORCH.md and results_mode_gates_torch.json
  n_ablation     N in {16 ... 1024} x {mppi, covo_online, covo_offline}
                 -> RESULTS_N_TORCH.md

Run as ``python -m covo_mpc_tpu_torch.scripts.<name>``. Each runs on the
card (``--device cuda``, the default) and raises without one; ``--device
cpu`` runs the plain path on the CPU. Every cell runs supervised through
a :class:`~covo_mpc_tpu_torch.runtime.CellStore` under its
``--checkpoint-root``: the same command resumes an interrupted sweep.

This module holds what the three share: the device flag and its checks,
the "Device:" text, and the refusal to write the JAX package's results
files.
"""

from __future__ import annotations

import os

import torch

# the JAX package's results files, measured on a TPU: a port run never
# writes them
TPU_FILES = ("RESULTS.md", "RESULTS_N.md", "RESULTS_DRAG.md", "results_mode_gates.json")


def protocol_steps(quick: bool) -> int:
    """The protocol's length: 4 trajectories x 10 reps (1 with ``quick``)
    x 300 steps."""
    return 300 * 4 * (1 if quick else 10)


def add_device_flag(ap) -> None:
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default; raises without one) or the CPU")


def check_run(args, outs) -> None:
    """Refuse what cannot run here before any cell runs: the card asked for
    where there is none, the kernels asked for on the CPU, or an output
    path that names one of the JAX package's results files."""
    engine = getattr(args, "engine", "auto")
    if engine == "cuda" and args.device != "cuda":
        raise ValueError("--engine cuda runs the kernels on the card: it takes "
                         "--device cuda (--device cpu takes --engine torch or auto)")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device here "
                           "(pass --device cpu to run on the CPU)")
    for path in outs:
        if os.path.basename(path) in TPU_FILES:
            raise ValueError(f"{path} holds the JAX package's TPU results; "
                             "write the port's results elsewhere")


def device_text(device: str) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit`` gives them ("cpu" on the CPU)."""
    from covo_mpc_tpu_torch.runtime.profiling import device_info

    info = device_info(device)
    return info["name"] if info["power_limit"] is None else \
        f"{info['name']}, {info['power_limit']}"


def make_env(task: str, disturb_type: str, device: str):
    """The protocol's env: ``task`` without domain randomization, rollover
    termination off, the noisy-state injection, on ``device``."""
    from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv

    return QuadEnv(
        EnvConfig(
            task=task,
            enable_randomizer=False,
            disturb_type=disturb_type,
            disable_rollover_terminate=True,
            generate_noisy_state=True,
        ),
        device=device,
    )
