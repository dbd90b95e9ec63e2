"""The fused Newton–Schulz Sigma-designer (K8): its plain version against
the JAX Pallas kernel, and the wrapper's routing.

The JAX side runs ``optimize_sigma_ns_pallas(..., interpret=True)``, as
tests/test_covo.py runs it on the CPU. The plain version of K8 is
``covariance.optimize_sigma_ns`` (the JAX kernel is its "drop-in"); the
CUDA kernel itself is held against it on the card (tests/test_torch_cuda.py,
chip_smoke.py). Bar: relative Frobenius 1e-3 on a_cov and the factor, the
JAX package's own between its two designers (test_covo.py:176).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covo_mpc_tpu.ops.covariance_pallas import optimize_sigma_ns_pallas
from covo_mpc_tpu_torch.ops import covariance, covariance_cuda


def _R(D: int, scale: float, seed: int = 0) -> np.ndarray:
    """The JAX kernel test's R = A A^T / D * scale - 0.3 * scale * I."""
    A = np.random.default_rng(seed).standard_normal((D, D))
    return ((A @ A.T / D) * scale - 0.3 * scale * np.eye(D)).astype(np.float32)


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 / np.linalg.norm(np.asarray(b, np.float64)))


@pytest.mark.parametrize("scale", [1.0, 100.0])
@pytest.mark.parametrize("D", [32, 100, 128])  # 100: the card test's ragged width
def test_plain_designer_matches_pallas_kernel(D, scale):
    R = _R(D, scale)
    c_ref, f_ref = optimize_sigma_ns_pallas(jnp.asarray(R), 0.5, D, interpret=True)
    c, f = covariance.optimize_sigma_ns(torch.from_numpy(R), 0.5, D)
    c, f = c.numpy(), f.numpy()
    assert _rel(c, c_ref) <= 1e-3 and _rel(f, f_ref) <= 1e-3
    if scale == 1.0:
        # at scale 100 the spectrum's floor is an absolute 1e-2 under a
        # lambda_min of -30: fp32 ulps of lambda_min move a_cov by ~1e-4
        assert float(np.abs(c - np.asarray(c_ref)).max()) <= 2e-4
    np.testing.assert_array_equal(f, np.tril(f))
    np.testing.assert_allclose(f @ f.T, c, atol=2e-6)


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    """On CPU tensors the wrapper returns exactly the plain version's
    result; a tensor that lies neither on the CPU nor on a CUDA device
    raises, as a mix of the two does."""
    D = 32
    R = torch.from_numpy(_R(D, 1.0, seed=1))
    got = covariance_cuda.optimize_sigma_ns_cuda(R, 0.5, D)
    ref = covariance.optimize_sigma_ns(R, 0.5, D)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    launches = covariance_cuda.SIGMA_KERNEL.launches
    with pytest.raises(ValueError):
        covariance_cuda.optimize_sigma_ns_cuda(torch.empty(D, D, device="meta"), 0.5, D)
    assert covariance_cuda.SIGMA_KERNEL.launches == launches


def test_eigh_designer_takes_a_stack():
    """``optimize_sigma`` on a (B, D, D) stack equals it on each matrix
    (offline mode designs its whole schedule at once)."""
    D = 16
    R = torch.from_numpy(np.stack([_R(D, s, seed=2) for s in (1.0, 3.0, 10.0)]))
    c, f = covariance.optimize_sigma(R, 0.5, D)
    for b in range(3):
        c_b, f_b = covariance.optimize_sigma(R[b], 0.5, D)
        torch.testing.assert_close(c[b], c_b, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(f[b] @ f[b].T, c_b, atol=1e-5, rtol=1e-5)
