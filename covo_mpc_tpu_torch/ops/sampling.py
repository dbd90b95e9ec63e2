"""Correlated-noise action sampling: CoVO's joint MVN and MPPI's per-step
MVN blocks; and the solvers' Philox seed stream.

Counterpart of :mod:`covo_mpc_tpu.ops.sampling`. Modes:

- ``FAST`` draws z with ``torch.randn`` from the caller's generator;
- ``KERNEL`` draws inside the sample + rollout kernels (Philox) and never
  comes here;
- ``PARITY`` draws JAX's z from a JAX key (``utils/prng.py``) in the
  reference's key tree: one key a sample (``split(key, N)``), and for
  MPPI one a step under it. Samples come sample-first, (N, D) or
  (N, H, dA), as JAX's parity sampler gives them; the sample-last forms
  refuse it, as JAX's do;
- ``INVARIANT`` draws JAX's z from ``fold_in(key, sample_id)`` per sample,
  in either layout.

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

from covo_mpc_tpu_torch.utils import prng
from covo_mpc_tpu_torch.utils.keys import fold_in_batch

PARITY = "parity"
FAST = "fast"
INVARIANT = "invariant"
KERNEL = "kernel"
# the modes that draw from a JAX key, as JAX does (the others from generators)
KEY_MODES = (PARITY, INVARIANT)

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


def _z_from(gen, shape: tuple, device, mode: str, sample_ids=None):
    """The standard normals (*shape) of a sample-last draw: from a JAX key
    under the invariant mode (parity's layout is sample-first: refused, as
    JAX refuses it), else from the generator ``gen``."""
    if not prng.is_key(gen):
        return torch.randn(*shape, generator=gen, device=device)
    if mode == PARITY:
        raise ValueError("transposed sampling is a fast-path layout: parity "
                         "samples come sample-first (sample_joint, sample_per_step)")
    N, *block = shape
    return std_normal_invariant(gen, N, tuple(block), sample_ids)


def sample_joint_t(gen, mean_flat: torch.Tensor, factor: torch.Tensor, N: int,
                   z: Optional[torch.Tensor] = None, mode: str = FAST,
                   sample_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """N samples of mean + factor z, emitted sample-last as (D, N).

    ``z`` (N, D) feeds given normals (tests hand in the ones JAX drew);
    otherwise they come from ``gen``: a generator, on ``mean_flat``'s
    device, or a JAX key under ``mode="invariant"``. A leading scenario
    axis on mean (B, D), factor (B, D, D) and z (B, N, D) gives (B, D, N):
    the batched correlate of JAX's scenario-batched CoVO solve, one batched
    matmul."""
    *batch, D = mean_flat.shape
    if z is None:
        z = _z_from(gen, (*batch, N, D), mean_flat.device, mode, sample_ids)
    return mean_flat[..., None] + torch.einsum("...ed,...nd->...en", factor, z)


def sample_per_step_t(gen, a_mean: torch.Tensor, chol: torch.Tensor, N: int,
                      z: Optional[torch.Tensor] = None, mode: str = FAST,
                      sample_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """N samples of a_h = mean_h + chol_h z_h per step, emitted sample-last
    as (H, dA, N).

    ``chol`` (H, dA, dA) is each step's Cholesky factor. ``z`` (N, H, dA)
    feeds given normals (tests hand in the ones JAX drew); otherwise they
    come from ``gen``: a generator, on ``a_mean``'s device, or a JAX key
    under ``mode="invariant"``. A leading scenario axis on all three gives
    (B, H, dA, N)."""
    *batch, H, dA = a_mean.shape
    if z is None:
        z = _z_from(gen, (*batch, N, H, dA), a_mean.device, mode, sample_ids)
    return a_mean[..., None] + torch.einsum("...hij,...nhj->...hin", chol, z)


def std_normal_invariant(key: torch.Tensor, N: int, shape: tuple,
                         sample_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, *shape) standard normals, sample n's from ``fold_in(key, id_n)``
    (ids ``0 .. N-1`` unless given): JAX's invariant ``_std_normal``."""
    if sample_ids is None:
        sample_ids = torch.arange(N, device=key.device)
    return prng.normal(fold_in_batch(key, sample_ids), shape)


def _z_joint(key, N: int, D: int, mode: str, sample_ids=None) -> torch.Tensor:
    if mode == PARITY:
        return prng.normal(prng.split(key, N), (D,))
    if mode == INVARIANT:
        return std_normal_invariant(key, N, (D,), sample_ids)
    raise ValueError(f"rng mode {mode!r} does not draw from a key")


def _z_per_step(key, N: int, H: int, dA: int, mode: str,
                sample_ids=None) -> torch.Tensor:
    if mode == PARITY:
        # per sample n a key, per step h a key under it (reference mppi.py:53-65)
        return prng.normal(prng.split(prng.split(key, N), H), (dA,))
    if mode == INVARIANT:
        return std_normal_invariant(key, N, (H, dA), sample_ids)
    raise ValueError(f"rng mode {mode!r} does not draw from a key")


def sample_joint(key: torch.Tensor, mean_flat: torch.Tensor, factor: torch.Tensor,
                 N: int, mode: str = PARITY,
                 sample_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CoVO's joint draw from a key, sample-first: (N, D) = mean + z
    factor^T. Parity must be fed ``cholesky(cov)``, as the reference's
    ``multivariate_normal`` factors."""
    z = _z_joint(key, N, mean_flat.shape[-1], mode, sample_ids)
    return mean_flat[None] + z @ factor.T


def sample_per_step(key: torch.Tensor, a_mean: torch.Tensor, chol: torch.Tensor,
                    N: int, mode: str = PARITY,
                    sample_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MPPI's per-step draw from a key, sample-first: (N, H, dA), a[n, h] =
    mean_h + chol_h z[n, h]."""
    H, dA = a_mean.shape
    z = _z_per_step(key, N, H, dA, mode, sample_ids)
    return a_mean[None] + torch.einsum("hij,nhj->nhi", chol, z)
