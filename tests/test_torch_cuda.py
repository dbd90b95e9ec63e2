"""The CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA GPU and
``nvcc``; without them each skips. On a machine with a card:
``python -m pytest tests/test_torch_cuda.py -q``. ``chip_smoke.py`` checks
the kernels at the main path's shapes; these tests take the shapes it does
not: a ragged sample count (N not a multiple of the block), a short
horizon, the 16-dim sensitivity state of K3, and the exact-adjoint
Hessian through K2 and K3. Tolerances are the ones ``chip_smoke.py``
states (the JAX kernel tests' own).
"""

import pytest
import torch

from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv, pack_state
from covo_mpc_tpu_torch.ops import hessian_cuda, rollout_cuda
from covo_mpc_tpu_torch.ops.hessian import make_hessian_adjoint

N, H = 1000, 8  # N ragged for blocks of 64 and 128
D = 4 * H

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _env_state(dev):
    env = QuadEnv(EnvConfig(task="tracking_zigzag", enable_randomizer=False,
                            disturb_type="gaussian",
                            disable_rollover_terminate=True,
                            generate_noisy_state=True), device=dev)
    _, info, _ = env.reset(torch.Generator(dev).manual_seed(0))
    return env, env.default_params, info["noisy_state"]


def test_joint_sample_rollout_matches_plain(dev):
    env, p, st = _env_state(dev)
    g = torch.Generator(dev).manual_seed(1)
    a_mean = torch.randn(H, 4, generator=g, device=dev) * 0.2
    factor = torch.randn(D, D, generator=g, device=dev) * 0.1
    z = torch.randn(D, N, generator=g, device=dev)
    args = (pack_state(st), st.time, st.pos_traj, st.vel_traj, a_mean, factor,
            p, 0, N)
    k1 = rollout_cuda.make_rollout_joint_sampling(env, block=128)
    c_k, a_k = k1(*args, deterministic=True, discount=0.98, z=z)
    c_p, a_p = k1.plain(*args, deterministic=True, discount=0.98, z=z)
    torch.testing.assert_close(a_k, a_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(c_k, c_p, atol=2e-4, rtol=1e-5)
    c_64, a_64 = rollout_cuda.make_rollout_joint_sampling(env, block=64)(
        *args, deterministic=True, discount=0.98, z=z)
    assert torch.equal(c_64, c_k) and torch.equal(a_64, a_k)
    # a stochastic gaussian rollout: the shared draw from step 1 on
    draw = torch.randn(3, generator=g, device=dev)
    c_k, _ = k1(*args, discount=0.98, draw=draw, z=z)
    c_p, _ = k1.plain(*args, discount=0.98, draw=draw, z=z)
    torch.testing.assert_close(c_k, c_p, atol=2e-4, rtol=1e-5)


def test_primal_matches_plain(dev):
    env, p, st = _env_state(dev)
    g = torch.Generator(dev).manual_seed(2)
    a_seq = torch.rand(H, 4, generator=g, device=dev) * 2.6 - 1.3  # raw
    dist = torch.randn(H, 3, generator=g, device=dev) * 0.05
    k2 = rollout_cuda.make_primal(env, H)
    x0 = pack_state(st)
    torch.testing.assert_close(k2(x0, a_seq, dist, p), k2.plain(x0, a_seq, dist, p),
                               atol=1e-5, rtol=0)


def _rel(got, ref) -> float:
    return float(torch.linalg.norm((got - ref).double())
                 / torch.linalg.norm(ref.double()))


@pytest.mark.parametrize("sd", [13, 16])
def test_sens_chain_matches_plain(dev, sd):
    g = torch.Generator(dev).manual_seed(3)
    J = torch.randn(H, sd, sd + 4, generator=g, device=dev) * 0.5
    M = torch.randn(H, sd + 4, sd + 4, generator=g, device=dev)
    M = (M + M.transpose(1, 2)) / 2
    T_k = hessian_cuda.sens_chain(J, 4)
    T_p = hessian_cuda.sens_chain_plain(J, 4)
    assert _rel(T_k, T_p) < 1e-5
    assert _rel(hessian_cuda.pullback(T_k, M), hessian_cuda.pullback(T_p, M)) < 1e-5


@pytest.mark.parametrize("second_order", [False, True], ids=["gn", "adjoint"])
def test_hessian_through_kernels_matches_plain(dev, second_order):
    """The whole Hessian with K2 and K3 against the plain primal and chain,
    on the same CUDA inputs."""
    env, p, st = _env_state(dev)
    a = torch.randn(H * 4, generator=torch.Generator(dev).manual_seed(4),
                    device=dev) * 0.3
    args = (a, pack_state(st), st.time, st.pos_traj, st.vel_traj, p)
    got = make_hessian_adjoint(env, H, primal="cuda", tail="cuda",
                               second_order=second_order)(*args)
    ref = make_hessian_adjoint(env, H, primal="torch", tail="torch",
                               second_order=second_order)(*args)
    assert _rel(got, ref) < 1e-5
