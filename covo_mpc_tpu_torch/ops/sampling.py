"""Correlated-noise action sampling, fast mode: CoVO's joint MVN and
MPPI's per-step MVN blocks.

Counterpart of :func:`covo_mpc_tpu.ops.sampling.sample_joint_t` and
:func:`~covo_mpc_tpu.ops.sampling.sample_per_step_t`. Modes: ``FAST``
draws z with ``torch.randn`` from the caller's generator; ``KERNEL`` draws
inside the sample + rollout kernels (Philox) and never comes here. The
parity and invariant modes are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

FAST = "fast"
KERNEL = "kernel"


def sample_joint_t(gen: Optional[torch.Generator], mean_flat: torch.Tensor,
                   factor: torch.Tensor, N: int,
                   z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """N samples of mean + factor z (fast mode), emitted sample-last as (D, N).

    ``z`` (N, D) feeds given normals (tests hand in the ones JAX drew);
    otherwise they come from ``gen`` on ``mean_flat``'s device. A leading
    scenario axis on mean (B, D), factor (B, D, D) and z (B, N, D) gives
    (B, D, N): the batched correlate of JAX's scenario-batched CoVO solve,
    one batched matmul."""
    *batch, D = mean_flat.shape
    if z is None:
        z = torch.randn(*batch, N, D, generator=gen, device=mean_flat.device)
    return mean_flat[..., None] + torch.einsum("...ed,...nd->...en", factor, z)


def sample_per_step_t(gen: Optional[torch.Generator], a_mean: torch.Tensor,
                      chol: torch.Tensor, N: int,
                      z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """N samples of a_h = mean_h + chol_h z_h per step (fast mode), emitted
    sample-last as (H, dA, N).

    ``chol`` (H, dA, dA) is each step's Cholesky factor. ``z`` (N, H, dA)
    feeds given normals (tests hand in the ones JAX drew); otherwise they
    come from ``gen`` on ``a_mean``'s device. A leading scenario axis on
    all three gives (B, H, dA, N)."""
    *batch, H, dA = a_mean.shape
    if z is None:
        z = torch.randn(*batch, N, H, dA, generator=gen, device=a_mean.device)
    return a_mean[..., None] + torch.einsum("...hij,...nhj->...hin", chol, z)
