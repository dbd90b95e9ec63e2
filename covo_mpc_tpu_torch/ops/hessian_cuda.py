"""Wrapper of the sensitivity-chain kernel (K3) and the pullback around it.

Counterpart of :mod:`covo_mpc_tpu.ops.hessian_pallas`. The chain

    T_h = [S1_h; E_h],   S1_{h+1} = J_h T_h

runs in ``csrc/sens_chain.cu`` for CUDA tensors and in its plain version
for CPU tensors; the pullback sum_h T_h^T M_h T_h stays in two fp32
einsums (TF32 off), as JAX kept it outside its kernel.
"""

from __future__ import annotations

import torch

from covo_mpc_tpu_torch.ops import kernels

CHAIN_KERNEL = kernels.Kernel(
    "sens_chain", "covo_mpc_tpu_torch/csrc/sens_chain.cu",
    replaces="covo_mpc_tpu/ops/hessian_pallas.py:80",
)


def sens_chain_plain(J: torch.Tensor, dA: int) -> torch.Tensor:
    """T (H, sd + dA, D) from the step Jacobians J (H, sd, sd + dA)."""
    H, sd, _ = J.shape
    D = H * dA
    eye = torch.eye(D, device=J.device, dtype=J.dtype)
    S1 = torch.zeros(sd, D, device=J.device, dtype=J.dtype)
    T = []
    for h in range(H):
        T_h = torch.cat([S1, eye[h * dA:(h + 1) * dA]], dim=0)
        T.append(T_h)
        S1 = J[h] @ T_h
    return torch.stack(T)


def sens_chain(J: torch.Tensor, dA: int) -> torch.Tensor:
    """The chain on CUDA tensors through the kernel (sd 13 or 16, dA 4);
    on CPU tensors through :func:`sens_chain_plain`."""
    if kernels.route(J) == "plain":
        return sens_chain_plain(J, dA)
    H, sd, Z = J.shape
    if Z != sd + dA:
        raise ValueError(f"J has {Z} columns, expected sd + dA = {sd + dA}")
    kernels.check_cuda("J", J, (H, sd, Z))
    T = torch.empty(H, Z, H * dA, device=J.device)
    CHAIN_KERNEL.launch(J.data_ptr(), T.data_ptr(), H, sd, dA)
    return T


def pullback(T: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """sum_h T_h^T M_h T_h, (D, D)."""
    MT = torch.einsum("huv,hvx->hux", M, T)
    return torch.einsum("hux,huy->xy", T, MT)


def make_tail_pullback(H: int, dA: int, sd: int = 13):
    """Build ``tail(J, M) -> (D, D)`` = sum_h T_h^T M_h T_h (chained T);
    J (H, sd, sd + dA), M (H, sd + dA, sd + dA)."""

    def tail(J, M):
        if J.shape != (H, sd, sd + dA):
            raise ValueError(f"J shape {tuple(J.shape)}, expected {(H, sd, sd + dA)}")
        return pullback(sens_chain(J.contiguous(), dA), M)

    return tail
