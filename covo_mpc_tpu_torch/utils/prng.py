"""JAX's threefry key tree in PyTorch: ``PRNGKey``, ``split``, ``fold_in``,
random bits, ``uniform`` and ``normal``.

Counterpart of ``jax.random`` as the JAX package uses it, with JAX's
default ``jax_threefry_partitionable=True``: the same keys give the same
draws. A key is a (2,) int64 tensor holding the two uint32 words of a JAX
key, on an explicit device; a stack of keys is (..., 2), and every function
here takes one and maps over its leading axes (JAX's ``vmap`` of the same
call). All arithmetic is int64 tensor ops masked to 32 bits (torch's
uint32 support is partial), so nothing reads a value on the host: a draw
runs on the card as tensor ops and can be captured in a CUDA graph.

- ``split``, ``fold_in`` and ``uniform`` give JAX's bits exactly.
- ``normal`` is ``sqrt(2) * erfinv(u)`` on JAX's uniform, with the
  single-precision erfinv polynomial XLA lowers ``erf_inv`` to (Giles,
  "Approximating the erfinv function", GPU Computing Gems, 2011), its
  constants read off the optimized HLO of ``jax.jit(jax.lax.erf_inv)`` on
  the CPU, each step a fused multiply-add as XLA emits it. XLA's own
  ``log1p`` is not correctly rounded, so a draw can differ from JAX's by up
  to two ulps of max(|draw|, 1) (``tests/test_torch_prng.py``).
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA  # threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Shape = Union[int, Sequence[int]]


def _f32(x: float) -> float:
    """The float32 nearest ``x``, as a Python float (exact)."""
    return float(np.float32(x))


def is_key(src) -> bool:
    """True for a key or a stack of keys (an int64 tensor whose last axis
    holds the two words); False for a ``torch.Generator``."""
    return (isinstance(src, torch.Tensor) and src.dtype == torch.int64
            and src.shape[-1:] == (2,))


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """JAX's ``PRNGKey(seed)``: the words (0, seed) for a 32-bit seed, the
    seed's high and low words for a wider one."""
    seed = int(seed)
    hi = 0 if -(1 << 31) <= seed < (1 << 31) else (seed >> 32) & MASK32
    return torch.tensor([hi, seed & MASK32], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The threefry2x32 hash of the count words (x1, x2) under the key words
    (k1, k2), 20 rounds, as XLA's unrolled lowering; the arguments
    broadcast. Every word is an int64 in [0, 2^32)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & MASK32, (x2 + ks[1]) & MASK32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x[0], x[1]


def _shape(shape: Shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _hash_counts(key: torch.Tensor, size: int):
    """threefry of the counts 0 .. size-1 (JAX's uint64 iota, split into
    high and low words) under each key of the stack: two (..., size)
    word tensors."""
    lo = torch.arange(size, dtype=torch.int64, device=key.device)
    return threefry2x32(key[..., 0:1], key[..., 1:2], lo >> 32, lo & MASK32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """JAX's ``split(key, num)``: (..., num, 2), new key i being the hash of
    count i. ``split(key, n)[i]`` does not depend on n, and equals
    ``fold_in(key, i)``."""
    b1, b2 = _hash_counts(key, num)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """JAX's ``fold_in(key, data)``: the hash of the count words (0, data).
    ``data`` is an int or an int tensor; a tensor of ids (n,) under one key
    gives the (n, 2) keys of ``utils/keys.fold_in_batch``."""
    k1, k2 = key[..., 0], key[..., 1]
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & MASK32
        if data.dim():
            k1, k2 = k1[..., None], k2[..., None]
    else:  # a fill, not a copy from the host (which a capture cannot hold)
        data = torch.full_like(k1, int(data) & MASK32)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """JAX's 32-bit random bits of ``shape`` (..., *shape) as int64 words:
    the two hash words of each element's count, xor'ed. Elements lie in
    row-major order, so a shape's bits are a prefix of a longer one's."""
    shape = _shape(shape)
    b1, b2 = _hash_counts(key, math.prod(shape))
    return (b1 ^ b2).reshape(key.shape[:-1] + shape)


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """Floats in [0, 1) from 32 random bits: the top 23 as the mantissa of a
    float in [1, 2), minus one (JAX's bit trick), which is exactly the
    integer m of those 23 bits times 2^-23: computed so, because a view of
    int words as floats has no batching rule under ``torch.func.vmap`` in
    every torch (2.11 has none), and the batched protocol vmaps the env's
    keyed draws."""
    return (bits >> 9).to(torch.float32) * 2.0**-23


def _as_f32(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), _f32(v), device=device)


def uniform(key: torch.Tensor, shape: Shape = (), minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """JAX's ``uniform(key, shape, float32, minval, maxval)``
    (:func:`uniform_from_bits` on the key's :func:`random_bits`)."""
    return uniform_from_bits(random_bits(key, shape), minval, maxval)


def uniform_from_bits(bits: torch.Tensor, minval=0.0, maxval=1.0) -> torch.Tensor:
    """JAX's uniform of given random bits: ``f (maxval - minval) + minval``
    with f in [0, 1) from the bits, floored at ``minval``; the bounds are
    Python floats (rounded to float32 first, as JAX converts them) or
    float32 tensors that broadcast against the draw. XLA fuses the product
    and the sum into one fused multiply-add; here the product of two float32
    words and the sum are exact in float64, so one rounding to float32 gives
    its bits. Draws of one key that share bits (a shape's are a prefix of a
    longer one's) can come from one :func:`random_bits`."""
    f = _unit_floats(bits).double()
    if not isinstance(minval, torch.Tensor) and not isinstance(maxval, torch.Tensor):
        lo = _f32(minval)
        width = _f32(np.float32(maxval) - np.float32(lo))
        return torch.clamp_min((f * width + lo).float(), lo)
    lo, hi = _as_f32(minval, bits.device), _as_f32(maxval, bits.device)
    return torch.maximum((f * (hi - lo).double() + lo.double()).float(), lo)


# Giles' single-precision erfinv, as XLA's optimized HLO holds it: the
# polynomial in w - 2.5 for w < 5 and in sqrt(w) - 3 beyond, w = -log1p(-x^2),
# highest degree first
_ERFINV_CENTRAL = tuple(_f32(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_ERFINV_TAIL = tuple(_f32(c) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))
_SQRT2 = _f32(math.sqrt(2.0))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def _poly(coefs, w: torch.Tensor) -> torch.Tensor:
    """Horner's rule in float32 with each step one fused multiply-add, as
    XLA emits it: ``p w + c`` is exact in float64, then rounded once."""
    w = w.double()
    p = torch.full_like(w, coefs[0], dtype=torch.float32)
    for c in coefs[1:]:
        p = (p.double() * w + c).float()
    return p


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: +-inf at +-1, the two-branch polynomial
    times x elsewhere. ``w = -log1p(-x^2)`` is rounded from float64 (the
    float32 ``log1p`` strays further from XLA's)."""
    w = (-torch.log1p(-(x * x).double())).float()
    p = torch.where(w < 5.0, _poly(_ERFINV_CENTRAL, w - 2.5),
                    _poly(_ERFINV_TAIL, torch.sqrt(w) - 3.0))
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """JAX's ``normal(key, shape)`` in float32: ``sqrt(2) erfinv(u)``, u
    uniform on (nextafter(-1, 0), 1)."""
    return erfinv(uniform(key, shape, _NORMAL_LO, 1.0)) * _SQRT2
