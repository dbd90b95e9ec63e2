"""Cross-sample reductions: exponential weighting, the mean update and
MPPI's covariance update.

Counterpart of :mod:`covo_mpc_tpu.ops.reductions`: the sample-last forms
(``*_t``, on (H, dA, N) samples, which the solvers use) and the
sample-first ones on (N, H, dA) samples. Every function reduces over the
sample axis only, so a leading scenario axis (costs (B, N), a_t (B, H, dA,
N), ...) gives each scenario its own update, as JAX's vmap over scenarios
does.
``gamma_sigma`` is a Python float, so the ``gamma_sigma == 0`` branch that
JAX takes with ``lax.cond`` is a Python ``if`` here: no device read.

``axis`` (a bound mesh axis, ``parallel/mesh.py``) holds the samples split
over ranks: each rank passes its own, and the minimum, the normalizer and
the weighted sums are all-reduced over the axis (JAX's ``lax.pmin`` /
``lax.psum`` inside ``shard_map``). None: every sample is here.
"""

from __future__ import annotations

import torch


def _psum(x: torch.Tensor, axis) -> torch.Tensor:
    return x if axis is None else axis.psum(x)


def weights_from_stats(costs: torch.Tensor, min_cost, lam: float):
    """:func:`mppi_weights` split for samples held in parts: given the
    minimum cost over all of them, the unnormalized weights
    ``exp(-(c - min_cost)/lambda)`` of these samples and their local
    normalizer (their sum over the last axis)."""
    unnorm = torch.exp(-(costs - min_cost) / lam)
    return unnorm, torch.sum(unnorm, dim=-1)


def mppi_weights(costs: torch.Tensor, lam: float, axis=None) -> torch.Tensor:
    """Softmax weights ``exp(-(c - min c)/lambda) / sum`` over the samples
    (the last axis; and over ``axis``)."""
    min_cost = torch.amin(costs, dim=-1, keepdim=True)
    if axis is not None:
        min_cost = axis.pmin(min_cost)
    unnorm, total = weights_from_stats(costs, min_cost, lam)
    return unnorm / _psum(total[..., None], axis)


def mean_update_t(weight, a_t, a_mean, gamma_mean, axis=None):
    """Weighted-mean blend on (H, dA, N) samples (sample-last layout)."""
    weighted = _psum(torch.einsum("...n,...hdn->...hd", weight, a_t), axis)
    return weighted * gamma_mean + a_mean * (1.0 - gamma_mean)


def _blend_cov(weight, a_t, a_mean_new, a_cov, gamma_sigma, axis=None):
    """Weighted per-step covariance around the UPDATED mean (the
    reference's quirk), blended with the carried one."""
    dev = a_t - a_mean_new[..., None]
    weighted = _psum(torch.einsum("...n,...hin,...hjn->...hij", weight, dev, dev), axis)
    return weighted * gamma_sigma + a_cov * (1.0 - gamma_sigma)


def cov_update_t(weight, a_t, a_mean_new, a_cov, gamma_sigma: float, axis=None):
    """Per-step covariance update on (H, dA, N) samples; ``a_cov``
    untouched when ``gamma_sigma == 0``."""
    if gamma_sigma == 0.0:
        return a_cov
    return _blend_cov(weight, a_t, a_mean_new, a_cov, gamma_sigma, axis)


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


# --- the sample-first forms, on (N, H, dA) samples: the sample-last ones on
# --- the samples' view with the sample axis moved last ----------------------


def mean_update(weight, a_sampled, a_mean, gamma_mean):
    """:func:`mean_update_t` on (N, H, dA) samples."""
    return mean_update_t(weight, a_sampled.movedim(-3, -1), a_mean, gamma_mean)


def cov_update(weight, a_sampled, a_mean_new, a_cov, gamma_sigma: float):
    """:func:`cov_update_t` on (N, H, dA) samples."""
    return cov_update_t(weight, a_sampled.movedim(-3, -1), a_mean_new, a_cov, gamma_sigma)


def cov_factor_update(weight, a_sampled, a_mean_new, a_cov, a_chol,
                      gamma_sigma: float):
    """:func:`cov_factor_update_t` on (N, H, dA) samples."""
    return cov_factor_update_t(weight, a_sampled.movedim(-3, -1), a_mean_new, a_cov,
                               a_chol, gamma_sigma)
