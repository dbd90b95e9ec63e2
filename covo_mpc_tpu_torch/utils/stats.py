"""A statistical bound for pinning a solve of one random stream against a
solve of another (JAX: ``covo_mpc_tpu.utils.stats``).

The kernels' in-kernel Philox draws (``rng_mode="kernel"``: K1, K5, K7) do
not reproduce the fast sampler's ``torch.randn`` stream, so their solves
can only be pinned against it statistically: both are MPPI-weighted means
over N samples of the same problem, so their difference is sampling noise,
whose scale S independent solves of one stream measure. With a
per-coordinate std ``sd`` over the S solves, the S-mean has std sd/sqrt(S)
and the single reference solve about sd, so

    |mean_S(samples) - ref| <= z * sd * sqrt(1/S + 1) + floor

elementwise; ``floor`` covers coordinates where the weights concentrate
and sd falls toward 0. JAX's calibration (N=8192, H=4: per-coordinate sd
1e-3 to 1e-2) set z=5 and floor=5e-3, which rejects an injected bias of
0.05 and passes unbiased solves with a margin over 5x.
"""

from __future__ import annotations

import numpy as np


def assert_sampled_mean_agreement(samples, ref, z: float = 5.0, floor: float = 5e-3,
                                  what: str = "sampled-mean agreement"):
    """Assert that S >= 2 independent solve outputs ``samples`` (arrays or
    tensors of one shape) agree with the reference solve ``ref`` within
    the bound above. Returns (the largest |mean - ref|, the smallest
    bound); raises AssertionError where a coordinate exceeds its bound."""
    arrs = [np.asarray(s, np.float64) for s in samples]
    S = len(arrs)
    if S < 2:
        raise ValueError("need >= 2 samples to estimate the sampling std")
    stack = np.stack(arrs)
    mu = stack.mean(axis=0)
    sd = stack.std(axis=0, ddof=1)
    # a coordinate's sd from a few solves underestimates often enough to
    # make z=5 flaky: the RMS spread over all coordinates floors each one
    sd_eff = np.maximum(sd, np.sqrt(np.mean(sd**2)))
    bound = z * sd_eff * np.sqrt(1.0 / S + 1.0) + floor
    diff = np.abs(mu - np.asarray(ref, np.float64))
    excess = diff - bound
    if (excess > 0).any():
        i = int(np.argmax(excess))
        raise AssertionError(
            f"{what}: |mean_S - ref| exceeds the z={z} sampling bound at flat index "
            f"{i}: diff={diff.flat[i]:.5f} > bound={bound.flat[i]:.5f} "
            f"(sd={sd.flat[i]:.5f}, S={S}): the stream is biased, not just noisy")
    return float(diff.max()), float(bound.min())
