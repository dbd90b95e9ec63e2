"""covo_mpc_tpu_torch: the CoVO-MPC system in PyTorch, with hand-written
CUDA kernels for an NVIDIA H100 (Hopper, sm_90a).

A port of :mod:`covo_mpc_tpu` (the JAX package, which stays the reference)
that mirrors its layout and public names:

  models/   structs, rotation math, bodyrate dynamics, rewards, the zigzag
            trajectory, the Quad3D environment
  ops/      the plain rollout, the CUDA kernel wrappers (rollout_cuda,
            hessian_cuda, covariance_cuda, built by ops/kernels), the
            Hessian (Gauss–Newton and exact adjoint), the Sigma-designers,
            sampling and reductions
  solvers/  CoVO (online, speculative, offline), MPPI, PID, Random and the
            factory
  parallel/ the scenario-batched CoVO and MPPI solves (B scenarios per call)
  runtime/  the captured solves and episode (CUDA graphs), the eval,
            render and supervised protocols, the run config, solve
            metrics, checkpoints, debug mode and the latency helpers
  utils/    episode plotting (matplotlib, imported when drawing)
  cli.py    the command line: ``python -m covo_mpc_tpu_torch.cli``
            (eval, render, bench)
  scripts/  the paper's sweeps: ``python -m covo_mpc_tpu_torch.scripts.
            paper_results`` (and mode_gates, n_ablation)
  csrc/     the CUDA C++ kernels (compiled by nvcc at first use)
  tools/    chip-only measurement tools (not imported here)

Importing the package imports torch and never jax, and builds no kernel.
Its entry points run on the card unless asked for the CPU (``device="cpu"``).
"""

from covo_mpc_tpu_torch import models, ops, parallel, runtime, solvers

__version__ = "0.1.0"

__all__ = ["models", "ops", "parallel", "runtime", "solvers"]
