"""Cross-sample reductions: exponential weighting and the mean update.

Counterpart of :mod:`covo_mpc_tpu.ops.reductions` (main-path pieces).
"""

from __future__ import annotations

import torch


def mppi_weights(costs: torch.Tensor, lam: float) -> torch.Tensor:
    """Softmax weights ``exp(-(c - min c)/lambda) / sum``."""
    shifted = torch.exp(-(costs - torch.min(costs)) / lam)
    return shifted / torch.sum(shifted)


def mean_update_t(weight, a_t, a_mean, gamma_mean):
    """Weighted-mean blend on (H, dA, N) samples (sample-last layout)."""
    weighted = torch.einsum("n,hdn->hd", weight, a_t)
    return weighted * gamma_mean + a_mean * (1.0 - gamma_mean)
