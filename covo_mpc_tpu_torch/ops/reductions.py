"""Cross-sample reductions: exponential weighting, the mean update and
MPPI's covariance update.

Counterpart of :mod:`covo_mpc_tpu.ops.reductions` (the sample-last forms).
Every function reduces over the sample axis only, so a leading scenario
axis (costs (B, N), a_t (B, H, dA, N), ...) gives each scenario its own
update, as JAX's vmap over scenarios does.
``gamma_sigma`` is a Python float, so the ``gamma_sigma == 0`` branch that
JAX takes with ``lax.cond`` is a Python ``if`` here: no device read.
"""

from __future__ import annotations

import torch


def mppi_weights(costs: torch.Tensor, lam: float) -> torch.Tensor:
    """Softmax weights ``exp(-(c - min c)/lambda) / sum`` over the samples
    (the last axis)."""
    shifted = torch.exp(-(costs - torch.amin(costs, dim=-1, keepdim=True)) / lam)
    return shifted / torch.sum(shifted, dim=-1, keepdim=True)


def mean_update_t(weight, a_t, a_mean, gamma_mean):
    """Weighted-mean blend on (H, dA, N) samples (sample-last layout)."""
    weighted = torch.einsum("...n,...hdn->...hd", weight, a_t)
    return weighted * gamma_mean + a_mean * (1.0 - gamma_mean)


def _blend_cov(weight, a_t, a_mean_new, a_cov, gamma_sigma):
    """Weighted per-step covariance around the UPDATED mean (the
    reference's quirk), blended with the carried one."""
    dev = a_t - a_mean_new[..., None]
    weighted = torch.einsum("...n,...hin,...hjn->...hij", weight, dev, dev)
    return weighted * gamma_sigma + a_cov * (1.0 - gamma_sigma)


def cov_update_t(weight, a_t, a_mean_new, a_cov, gamma_sigma: float):
    """Per-step covariance update on (H, dA, N) samples; ``a_cov``
    untouched when ``gamma_sigma == 0``."""
    if gamma_sigma == 0.0:
        return a_cov
    return _blend_cov(weight, a_t, a_mean_new, a_cov, gamma_sigma)


def cov_factor_update_t(weight, a_t, a_mean_new, a_cov, a_chol,
                        gamma_sigma: float):
    """:func:`cov_update_t` that also carries the per-step Cholesky factor
    the sampler reads: ``(a_cov, a_chol)`` untouched when ``gamma_sigma ==
    0``, else the blend and its factor (``cholesky_ex``: no host sync; made
    row-major, as the kernels read it)."""
    if gamma_sigma == 0.0:
        return a_cov, a_chol
    new_cov = _blend_cov(weight, a_t, a_mean_new, a_cov, gamma_sigma)
    return new_cov, torch.linalg.cholesky_ex(new_cov).L.contiguous()
