"""covo_mpc_tpu_torch.utils.prng against jax.random on the same keys.

Keys, splits, fold_ins, random bits and uniforms must equal JAX's bit for
bit (threefry2x32, partitionable layout). Normals are ``sqrt(2) *
erfinv(u)`` on the same uniform with XLA's float32 erfinv polynomial; XLA's
own ``log1p`` is not correctly rounded, so a normal may differ from JAX's
by at most 2 ulp of max(|x|, 1) (the ulp of 1 below 1 in magnitude).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covo_mpc_tpu.utils.keys import fold_in_batch as j_fold_in_batch
from covo_mpc_tpu_torch.utils import prng
from covo_mpc_tpu_torch.utils.keys import fold_in_batch

SEEDS = [0, 1, 42, 2**31 - 1]
SHAPES = [(), (1,), (7,), (5, 3), (64, 32), (3, 2, 5)]
BOUNDS = [(0.0, 1.0), (-1.0, 1.0), (-0.2, 0.2), (-np.pi / 3, np.pi / 3),
          (1.0, 1.5), (-np.pi, np.pi)]


def words(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def normal_ulps(ours, ref) -> float:
    """The largest |ours - ref| in ulps of max(|ref|, 1)."""
    ref = np.asarray(ref, np.float32)
    scale = np.spacing(np.maximum(np.abs(ref), np.float32(1.0)))
    return float((np.abs(np.asarray(ours, np.float32) - ref) / scale).max())


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_and_fold_in_equal_jax(seed):
    jk, k = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert torch.equal(k, words(jk))
    for num in (2, 3, 5, 8):
        assert torch.equal(prng.split(k, num), words(jax.random.split(jk, num)))
    for data in (0, 1, 7919, 2**32 - 1):
        assert torch.equal(prng.fold_in(k, data), words(jax.random.fold_in(jk, data)))
    # batched: split over a stack of keys, as jax.vmap(split)
    ks, jks = prng.split(k, 4), jax.random.split(jk, 4)
    assert torch.equal(prng.split(ks, 3), words(jax.vmap(lambda q: jax.random.split(q, 3))(jks)))
    ids = jnp.arange(9)
    assert torch.equal(fold_in_batch(k, torch.arange(9)), words(j_fold_in_batch(jk, ids)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_equal_jax(seed, shape):
    jk, k = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    jbits = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64)
    assert np.array_equal(prng.random_bits(k, shape).numpy(), jbits)
    for lo, hi in BOUNDS:
        u = prng.uniform(k, shape, lo, hi)
        assert u.shape == shape and u.dtype == torch.float32
        assert np.array_equal(bits(u), bits(jax.random.uniform(jk, shape, minval=lo,
                                                               maxval=hi))), (lo, hi)
    # tensor bounds, as the disturbance models pass params.disturb_scale
    s = jnp.float32(0.2)
    u = prng.uniform(k, shape, -torch.tensor(0.2), torch.tensor(0.2))
    assert np.array_equal(bits(u), bits(jax.random.uniform(jk, shape, minval=-s, maxval=s)))


def test_batched_uniform_and_normal_equal_jax_vmap():
    jks = jax.random.split(jax.random.PRNGKey(3), 16)
    ks = words(jks)
    ju = jax.vmap(lambda q: jax.random.uniform(q, (6,), minval=-1.0, maxval=1.0))(jks)
    assert np.array_equal(bits(prng.uniform(ks, (6,), -1.0, 1.0)), bits(ju))
    jn = jax.vmap(lambda q: jax.random.normal(q, (4, 3)))(jks)
    assert normal_ulps(prng.normal(ks, (4, 3)), jn) <= 2.0


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_two_ulp_of_jax(seed):
    jk, k = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    n = prng.normal(k, (50_000,))
    jn = jax.random.normal(jk, (50_000,))
    assert n.dtype == torch.float32
    assert normal_ulps(n, jn) <= 2.0
    # most draws are JAX's bits exactly
    assert np.mean(bits(n) != bits(jn)) < 0.02


def test_erfinv_at_the_ends_and_in_the_tail():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.999999, -0.9999999, 0.5], dtype=torch.float32)
    jx = jnp.asarray(x.numpy())
    ours, ref = prng.erfinv(x).numpy(), np.asarray(jax.lax.erf_inv(jx))
    assert np.isinf(ours[:2]).all() and np.array_equal(np.sign(ours[:2]), [-1.0, 1.0])
    assert ours[2] == 0.0
    assert normal_ulps(ours[3:], ref[3:]) <= 2.0


def test_keys_are_words_on_their_device_and_not_generators():
    k = prng.PRNGKey(5)
    assert k.dtype == torch.int64 and k.shape == (2,)
    assert prng.is_key(k) and prng.is_key(prng.split(k, 3))
    assert not prng.is_key(torch.Generator())
    assert not prng.is_key(torch.zeros(2))
    # every word stays in [0, 2^32)
    w = prng.split(prng.split(k, 64), 8)
    assert int(w.min()) >= 0 and int(w.max()) <= prng.MASK32
