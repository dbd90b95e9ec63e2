"""Correlated-noise action sampling, fast mode: CoVO's joint MVN and
MPPI's per-step MVN blocks; and the solvers' Philox seed stream.

Counterpart of :func:`covo_mpc_tpu.ops.sampling.sample_joint_t` and
:func:`~covo_mpc_tpu.ops.sampling.sample_per_step_t`. Modes: ``FAST``
draws z with ``torch.randn`` from the caller's generator; ``KERNEL`` draws
inside the sample + rollout kernels (Philox) and never comes here. The
parity and invariant modes are not ported.

:class:`SeedStream` keys the kernels' Philox draws. JAX passes each solve a
fresh key as traced data (``rng_act``, split per step); here the key lives
on the device: a counter that each solve advances by one op, mixed with the
solver's seed by splitmix64 into that solve's words. The eager solve and a
CUDA graph's replay of it both read the words on the device, so every replay
draws afresh, and no word is read on the host.
"""

from __future__ import annotations

from typing import Optional

import torch

FAST = "fast"
KERNEL = "kernel"

_MASK64 = (1 << 64) - 1


def as_int64(c: int) -> int:
    """The int64 with the bits of the uint64 ``c``."""
    c &= _MASK64
    return c - (1 << 64) if c >> 63 else c


# splitmix64's increment and multipliers (Steele, Lea, Flood, OOPSLA'14)
GOLDEN = as_int64(0x9E3779B97F4A7C15)
_MIX1 = as_int64(0xBF58476D1CE4E5B9)
_MIX2 = as_int64(0x94D049BB133111EB)


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 words taken as uint64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 words taken as uint64 (products
    wrap modulo 2^64): a bijection of the 64-bit words."""
    x = (x ^ _shr(x, 30)) * _MIX1
    x = (x ^ _shr(x, 27)) * _MIX2
    return x ^ _shr(x, 31)


class SeedStream:
    """Per-solve Philox keys on a device: ``next(n)`` advances the counter
    c by one (in place) and returns the (n,) int64 words
    ``splitmix64(key + GOLDEN * (n c + j))``, j = 0..n-1. For a fixed n no
    word repeats within 2^64 / n solves: the states differ and splitmix64
    is a bijection."""

    def __init__(self, device, seed: int = 0):
        self.key = torch.zeros((), dtype=torch.int64, device=device)
        self.counter = torch.zeros((), dtype=torch.int64, device=device)
        self.seed(seed)

    def seed(self, seed: int) -> None:
        """Key the stream with ``seed`` and restart its counter (fills in
        place: a captured solve reads the new words)."""
        self.key.fill_(as_int64(seed))
        self.counter.zero_()

    def next(self, n: int = 1) -> torch.Tensor:
        self.counter.add_(1)
        j = torch.arange(n, dtype=torch.int64, device=self.counter.device)
        return splitmix64(self.key + (self.counter * n + j) * GOLDEN)

    # the state a capture's warm-up must leave as it found it
    def get_state(self) -> torch.Tensor:
        return self.counter.clone()

    def set_state(self, state: torch.Tensor) -> None:
        self.counter.copy_(state)


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
