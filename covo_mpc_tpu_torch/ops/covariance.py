"""CoVO's sampling-covariance design: Sigma ∝ R^{-1/2} at fixed determinant.

Counterpart of :mod:`covo_mpc_tpu.ops.covariance` (``optimize_sigma``,
the Newton–Schulz ``optimize_sigma_ns`` and the generic Hessian estimators
``make_hessian``). Every matmul here must run in
true fp32: TF32 on Hopper truncates like the TPU's default bf16 matmuls,
which NaN the lambda_min refinement; the solver turns TF32 off when it is
built. The one Cholesky is ``cholesky_ex``, which does not read its error
flag on the host (no sync inside a solve).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch.func import grad, jacfwd

FWD_FWD = "fwd_fwd"  # jacfwd of jacfwd: the reference's estimator
FWD_REV = "fwd_rev"  # jacfwd of grad: one reverse pass a tangent


def optimize_sigma(R: torch.Tensor, sample_sigma, horizon_dim: int):
    """The reference recipe by eigh: symmetrize, shift the spectrum by
    ``-lambda_min + 1e-2``, then ``log s = ½ log c - ½ log lambda`` with c
    chosen so that ``det Sigma = det(sigma^2 I)``. Returns (a_cov, factor)
    with ``factor @ factor.T == a_cov``; on one (D, D) matrix or a stack."""
    R = (R + R.mT) / 2.0
    eigs, u = torch.linalg.eigh(R)
    offset = -torch.amin(eigs, dim=-1, keepdim=True) + 1e-2
    log_o = torch.log(eigs + offset)
    log_det_a_cov = horizon_dim * (math.log(sample_sigma) * 2.0)
    log_const = (log_det_a_cov * 2.0 + torch.sum(log_o, dim=-1, keepdim=True)) / horizon_dim
    log_s = 0.5 * log_const - 0.5 * log_o
    # eigh and cholesky return column-major matrices; the factor feeds the
    # joint sample + rollout kernel, which takes row-major operands
    factor = (u * torch.exp(0.5 * log_s)[..., None, :]).contiguous()
    a_cov = (u * torch.exp(log_s)[..., None, :]) @ u.mT
    return (a_cov + a_cov.mT) / 2.0, factor


def _fro(M: torch.Tensor) -> torch.Tensor:
    """||M||_F of each matrix of a (..., D, D) stack, shaped (..., 1, 1)."""
    return torch.linalg.norm(M, dim=(-2, -1), keepdim=True)


def _unit(M: torch.Tensor) -> torch.Tensor:
    """M / ||M||_F, leaving a zero (or underflowed) M as it is."""
    n = _fro(M)
    return M / torch.where(n > 0, n, torch.ones_like(n))


def _vdot(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return (A * B).sum(dim=(-2, -1), keepdim=True)


def _extreme_eig(B: torch.Tensor, squarings: int, norm_every: int = 3):
    """lambda_max of symmetric PSD ``B`` by power iteration with repeated
    squaring, normalized every ``norm_every`` squarings (``squarings`` is
    rounded up to whole blocks), then a Rayleigh quotient."""
    blocks = -(-squarings // norm_every)
    M = _unit(B)
    for _ in range(blocks):
        for _ in range(norm_every):
            M = M @ M
        M = _unit(M)
    return _vdot(M, B @ M) / (_vdot(M, M) + 1e-30)


# Quintic lift coefficients (Muon's polar Newton–Schulz a, b, c): the coupled
# eigenvalue map is x -> x q(x)^2 with q(x) = a + b x + c x^2.
_LIFT_A, _LIFT_B, _LIFT_C = 3.4445, -4.7750, 2.0315


def _ns_sqrt(Ahat: torch.Tensor, lift: int, polish: int):
    """Coupled iteration (Y, Z) -> (A^{1/2}, A^{-1/2}): ``lift`` quintic
    steps then ``polish`` cubic steps. Requires spec(Ahat) in (0, 1]."""
    eye = torch.eye(Ahat.shape[-1], dtype=Ahat.dtype, device=Ahat.device)
    Y, Z = Ahat, eye
    for _ in range(lift):
        X = Z @ Y
        Q = _LIFT_A * eye + _LIFT_B * X + _LIFT_C * (X @ X)
        Y, Z = Y @ Q, Q @ Z
    for _ in range(polish):
        T = 0.5 * (3.0 * eye - Z @ Y)
        Y, Z = Y @ T, T @ Z
    return Y, Z


def optimize_sigma_ns(
    R: torch.Tensor,
    sample_sigma,
    horizon_dim: int,
    *,
    squarings: int = 14,
    ns_rough: Tuple[int, int] = (3, 4),
    ns_main: Tuple[int, int] = (8, 5),
):
    """Eigh-free :func:`optimize_sigma`: matmuls plus one Cholesky, on one
    (D, D) matrix or a stack of B scenarios' (B, D, D): every norm, inner
    product and log det is per matrix (JAX vmaps it over scenarios).

    1. lambda_max bound ``||R||_F`` and a rough lambda_min by power squaring;
    2. lambda_min refined through the inverse of a generously shifted A1;
    3. ``A^{-1/2}`` of the reference-shifted A by coupled Newton–Schulz;
    4. one Cholesky of Z ~ (A/s)^{-1/2}: its diagonal gives log det A and
       its factor is the sampling factor.
    See the JAX twin for the derivation of every constant.
    """
    D = horizon_dim
    R = (R + R.mT) / 2.0
    eye = torch.eye(D, dtype=R.dtype, device=R.device)
    fnorm = _fro(R) + 1e-30  # (..., 1, 1), as every scalar below

    bound = fnorm  # >= lambda_max(R), certified
    lam_min_rough = bound - _extreme_eig(bound * eye - R, squarings)
    spread = bound - lam_min_rough

    delta1 = 1e-2 + 5e-3 * spread
    off1 = -lam_min_rough + delta1
    s1 = (bound + off1) * 1.05
    _, Z1 = _ns_sqrt((R + off1 * eye) / s1, *ns_rough)
    lam_min = s1 / _extreme_eig(Z1 @ Z1, squarings) - off1

    offset = -lam_min + 1e-2
    A = R + offset * eye
    s = (bound + offset) * 1.05 + 1e-30  # >= lambda_max(A), certified
    _, Z = _ns_sqrt(A / s, *ns_main)

    Z = (Z + Z.mT) / 2.0
    Lz, _ = torch.linalg.cholesky_ex(Z)
    log_diag = torch.log(torch.diagonal(Lz, dim1=-2, dim2=-1))
    log_det_A = D * torch.log(s) - 4.0 * log_diag.sum(dim=-1)[..., None, None]
    # a Python float: a host scalar must not become a device copy mid-solve
    log_det_a_cov = D * (math.log(sample_sigma) * 2.0)
    log_const = (log_det_a_cov * 2.0 + log_det_A) / D
    c = torch.exp(0.5 * log_const)

    scale = c / torch.sqrt(s)
    a_cov = scale * Z
    factor = (torch.sqrt(scale) * Lz).contiguous()  # row-major, as above
    return a_cov, factor


def make_hessian(cost_fn, mode: str = FWD_FWD):
    """The Hessian of a scalar rollout cost with respect to the flattened
    action sequence: ``cost_fn(a_flat, *args) -> scalar`` gives
    ``hessian(a_flat, *args) -> (D, D)`` (JAX: covariance.make_hessian).
    ``fwd_fwd`` is the reference's forward-over-forward estimator, ``fwd_rev``
    forward over one reverse pass; the same matrix to rounding."""
    if mode == FWD_FWD:
        return jacfwd(jacfwd(cost_fn, argnums=0), argnums=0)
    if mode == FWD_REV:
        return jacfwd(grad(cost_fn, argnums=0), argnums=0)
    raise ValueError(f"unknown hessian mode {mode!r}")
