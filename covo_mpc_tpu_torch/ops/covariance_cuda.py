"""Wrapper of the fused Newton–Schulz Sigma-designer kernel (K8).

Counterpart of :mod:`covo_mpc_tpu.ops.covariance_pallas`: the whole
designer of :func:`covo_mpc_tpu_torch.ops.covariance.optimize_sigma_ns`
(power squaring, the refined lambda_min, both coupled Newton–Schulz roots,
one Cholesky with its log det) in one launch of ``csrc/sigma_ns.cu``, on one
(D, D) matrix, as the JAX kernel takes it. The launch is one thread-block
cluster whose CTAs hold every working matrix in their shared memory, so it
needs no workspace. CUDA tensors launch the kernel or raise (a cluster the
card refuses raises too); CPU tensors take the plain version, which is
``optimize_sigma_ns`` itself. The iteration counts and the quintic-lift
coefficients are the plain version's own, passed to the kernel by value.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from covo_mpc_tpu_torch.ops import covariance, kernels

SIGMA_KERNEL = kernels.Kernel(
    "sigma_ns", "covo_mpc_tpu_torch/csrc/sigma_ns.cu",
    replaces="covo_mpc_tpu/ops/covariance_pallas.py:173",
)
MAX_D = 128  # the cluster's slabs hold D <= 128 (csrc/sigma_ns.cu kMaxD)


def optimize_sigma_ns_cuda(
    R: torch.Tensor,
    sample_sigma,
    horizon_dim: int,
    *,
    squarings: int = 14,
    ns_rough: Tuple[int, int] = (3, 4),
    ns_main: Tuple[int, int] = (8, 5),
):
    """Drop-in for :func:`~covo_mpc_tpu_torch.ops.covariance.optimize_sigma_ns`
    on one (D, D) matrix: ``(a_cov, factor)``, factor lower-triangular and
    row-major with ``factor @ factor.T == a_cov``. ``sample_sigma`` is a host
    number (no device copy, no sync); D = horizon_dim is a multiple of 4, at
    most 128."""
    if kernels.route(R) == "plain":
        return covariance.optimize_sigma_ns(
            R, sample_sigma, horizon_dim, squarings=squarings,
            ns_rough=ns_rough, ns_main=ns_main)
    D = horizon_dim
    if D > MAX_D or D % 4:
        raise ValueError(f"the sigma_ns kernel takes D a multiple of 4 up to "
                         f"{MAX_D}, got {D}")
    kernels.check_cuda("R", R, (D, D))
    a_cov = torch.empty(D, D, device=R.device)
    factor = torch.empty(D, D, device=R.device)
    SIGMA_KERNEL.launch(
        R.data_ptr(), a_cov.data_ptr(), factor.data_ptr(), D,
        float(sample_sigma), covariance._LIFT_A, covariance._LIFT_B,
        covariance._LIFT_C, squarings, *ns_rough, *ns_main,
    )
    return a_cov, factor


def kernel_info() -> dict:
    """The kernel's launch geometry and resources, read from the built
    library: CTAs of its cluster, threads, dynamic and static shared memory
    (bytes) of a CTA, registers and local memory (bytes) of a thread."""
    out = (ctypes.c_int * 6)()
    err = kernels.library().sigma_ns_info(out)
    if err != 0:
        raise RuntimeError(f"sigma_ns_info: cudaError {err}")
    return dict(zip(("cluster", "threads", "dynamic_smem", "static_smem",
                     "registers", "local_bytes"), out))
