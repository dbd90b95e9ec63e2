"""covo_mpc_tpu_torch: the CoVO-MPC system in PyTorch, with hand-written
CUDA kernels for an NVIDIA H100 (Hopper, sm_90a).

A port of :mod:`covo_mpc_tpu` (the JAX package, which stays the reference)
that mirrors its layout and public names:

  models/   structs, rotation math, bodyrate dynamics, rewards, the four
            tasks' trajectories, the Quad3D environment and its batched
            form, the episode-log wrapper
  ops/      the plain rollout, the CUDA kernel wrappers (rollout_cuda,
            hessian_cuda, covariance_cuda, built by ops/kernels), the
            Hessians (Gauss–Newton, the exact adjoint and the reference's
            fwd_fwd, fwd_rev and sensitivity), the Sigma-designers, JAX's
            samplers, reductions and operation counts
  solvers/  CoVO (online, speculative, offline), MPPI, PID, Random and the
            factory
  parallel/ the scenario-batched solves and every controller's batched
            twin, and the multi-device layer on torch.distributed (mesh,
            sharded and distributed solves, the multichip steps, the
            offline schedule over ranks, the two-stage pipeline)
  runtime/  the captured solves and episode (CUDA graphs), the eval,
            render and supervised protocols (single and batched), the run
            config, solve metrics, checkpoints, debug mode, profiling and
            the latency helpers
  utils/    JAX's threefry key tree, the statistical bound for kernel-rng
            solves, episode plotting (matplotlib, imported when drawing)
  viz/      the meshcat viewer (imported when viewing)
  cli.py    the command line: ``python -m covo_mpc_tpu_torch.cli``
            (eval, render, bench)
  scripts/  the paper's sweeps: ``python -m covo_mpc_tpu_torch.scripts.
            paper_results`` (and mode_gates, n_ablation), bench_mesh and
            pod_scale
  bench.py  the bench: ``python -m covo_mpc_tpu_torch.bench``
  csrc/     the CUDA C++ kernels (compiled by nvcc at first use)
  tools/    chip-only measurement tools (not imported here)

Importing the package imports torch and never jax, and builds no kernel.
Its entry points run on the card unless asked for the CPU (``device="cpu"``).
"""

import os

from covo_mpc_tpu_torch import models, ops, parallel, runtime, solvers, utils

__version__ = "0.1.0"

__all__ = ["get_package_path", "models", "ops", "parallel", "runtime", "solvers", "utils"]


def get_package_path() -> str:
    """Absolute path of the installed package (its directory)."""
    return os.path.dirname(os.path.abspath(__file__))
