"""Key helpers for sampling that does not depend on how the samples are
split (JAX: ``covo_mpc_tpu.utils.keys``)."""

from __future__ import annotations

import torch

from covo_mpc_tpu_torch.utils import prng


def fold_in_batch(key: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """One key per integer id, ``fold_in(key, id)`` (n, 2): each sample's
    key depends only on its global index, so a solve draws the same noise
    however its sample axis is divided."""
    return prng.fold_in(key, ids)
