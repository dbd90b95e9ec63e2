"""covo_mpc_tpu_torch.ops against the JAX package, one module per test.

On the CPU the kernel wrappers take their plain versions; each is held
against the JAX function that reaches the Pallas kernel, run the way the
JAX package's own tests run it here (interpret mode). Tolerances are the
JAX kernel tests' own. A CUDA kernel has no CPU mode:
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold each one against
its plain version on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covo_mpc_tpu.models import dynamics as jdyn
from covo_mpc_tpu.models import pack_state as jpack
from covo_mpc_tpu.ops import covariance as jcov
from covo_mpc_tpu.ops import reductions as jred
from covo_mpc_tpu.ops.hessian import make_hessian_adjoint as j_hessian_adjoint
from covo_mpc_tpu.ops.hessian_pallas import make_tail_pullback as j_tail_pullback
from covo_mpc_tpu.ops.rollout import make_rollout as j_make_rollout
from covo_mpc_tpu.ops.rollout_pallas import SUB
from covo_mpc_tpu.ops.rollout_pallas import make_pallas_primal as j_primal
from covo_mpc_tpu.ops.rollout_pallas import (
    make_pallas_rollout_joint_sampling as j_joint_sampling,
)
from covo_mpc_tpu_torch.models import pack_state
from covo_mpc_tpu_torch.ops import covariance, hessian_cuda, reductions, rollout_cuda
from covo_mpc_tpu_torch.ops.hessian import make_hessian_adjoint
from covo_mpc_tpu_torch.ops.rollout import make_rollout
from tests.test_torch_models import make_envs, t, to_torch_params, to_torch_state

N, H = 1024, 8
D = 4 * H


def _reset(seed=0, **env_kw):
    """JAX env + reset noisy state, and the port's copies of both."""
    jenv, env = make_envs(**env_kw)
    jp = jenv.default_params
    _, info, _ = jenv.reset_env(jax.random.PRNGKey(seed), jp)
    noisy = info["noisy_state"]
    return jenv, env, jp, noisy, to_torch_params(jp), to_torch_state(noisy)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# --- the plain rollout (engine="torch"; the oracle of K1) -----------------


@pytest.mark.parametrize("env_kw,scale,deterministic", [
    (dict(), 0.4, True),
    (dict(), 0.4, False),  # the shared gaussian draw, injected from JAX
    (dict(disturb_type="none"), 0.4, False),
    (dict(disable_rollover_terminate=False), 0.4, True),
    (dict(), 3.0, True),  # large actions: samples leave |pos| < 3 and freeze
])
def test_plain_rollout_matches_jnp_engine(env_kw, scale, deterministic):
    jenv, env, jp, noisy, p, st = _reset(**env_kw)
    rng = np.random.default_rng(1)
    actions = (rng.normal(size=(256, H, 4)) * scale).astype(np.float32)
    step_key = jax.random.PRNGKey(3)
    ref, _ = j_make_rollout(jenv)(
        jpack(noisy), noisy.time, noisy.pos_traj, noisy.vel_traj, actions, jp,
        step_key, deterministic=deterministic, discount=0.98,
    )
    # the normals JAX's gaussian disturbance draws from the step key
    draw = t(jax.random.normal(jdyn.derive_dynamics_keys(step_key), (3,)))
    got = make_rollout(env)(pack_state(st), st.time, st.pos_traj, st.vel_traj,
                            t(actions), p, draw, deterministic=deterministic,
                            discount=0.98)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-5)


# --- K1: joint sample + rollout ---------------------------------------------


def _joint_inputs(seed=7):
    rng = np.random.default_rng(seed)
    a_mean = (rng.normal(size=(H, 4)) * 0.2).astype(np.float32)
    factor = (rng.normal(size=(D, D)) * 0.1).astype(np.float32)
    return a_mean, factor


def test_joint_sample_rollout_plain_matches_pallas():
    """K1's plain version == the Pallas kernel in interpret mode, fed the
    same normals (z rebuilt from act_key as the JAX kernel test does)."""
    jenv, env, jp, noisy, p, st = _reset()
    a_mean, factor = _joint_inputs()
    step_key, act_key = jax.random.PRNGKey(3), jax.random.PRNGKey(4)
    costs_r, a_r = j_joint_sampling(jenv, interpret=True)(
        jpack(noisy), noisy.time, noisy.pos_traj, noisy.vel_traj, a_mean,
        factor, jp, step_key, act_key, N, deterministic=True, discount=0.98,
    )
    z = jax.random.normal(act_key, (D, SUB, N // SUB)).reshape(D, N)
    launches = rollout_cuda.JOINT_KERNEL.launches
    costs, a_t = rollout_cuda.make_rollout_joint_sampling(env)(
        pack_state(st), st.time, st.pos_traj, st.vel_traj, t(a_mean),
        t(factor), p, seed=0, N=N, deterministic=True, discount=0.98, z=t(z),
    )
    assert rollout_cuda.JOINT_KERNEL.launches == launches  # CPU: plain version
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_r), atol=1e-5)
    np.testing.assert_allclose(costs.numpy(), np.asarray(costs_r),
                               atol=2e-4, rtol=1e-5)


def test_joint_sample_rollout_plain_draws_from_seed():
    _, env, _, _, p, st = _reset()
    a_mean, factor = _joint_inputs()
    k1 = rollout_cuda.make_rollout_joint_sampling(env)
    args = (pack_state(st), st.time, st.pos_traj, st.vel_traj, t(a_mean),
            t(factor), p)
    c1, a1 = k1(*args, seed=5, N=256, deterministic=True)
    c2, a2 = k1(*args, seed=5, N=256, deterministic=True)
    c3, _ = k1(*args, seed=6, N=256, deterministic=True)
    assert torch.equal(c1, c2) and torch.equal(a1, a2)
    assert not torch.equal(c1, c3)
    assert float(a1.abs().max()) <= 1.0


def test_pack_kernel_inputs_layout():
    jenv, env, jp, noisy, p, st = _reset()
    ptar, vtar, scal, ints = rollout_cuda._pack_kernel_inputs(
        env, pack_state(st), st.time, st.pos_traj, st.vel_traj, p, None,
        True, 0.98, H,
    )
    from covo_mpc_tpu.ops.rollout_pallas import _pack_kernel_inputs as j_pack

    jptar, jvtar, _, jscal, jints = j_pack(
        jenv, jpack(noisy), noisy.time, noisy.pos_traj, noisy.vel_traj, jp,
        jax.random.PRNGKey(0), True, 0.98, H,
    )
    np.testing.assert_allclose(ptar.numpy(), np.asarray(jptar), atol=0)
    np.testing.assert_allclose(vtar.numpy(), np.asarray(jvtar), atol=0)
    np.testing.assert_allclose(scal.numpy(), np.asarray(jscal), rtol=1e-7)
    np.testing.assert_array_equal(ints.numpy(), np.asarray(jints))


# --- K2: primal ---------------------------------------------------------------


def test_primal_plain_matches_pallas():
    jenv, env, jp, noisy, p, st = _reset()
    rng = np.random.default_rng(2)
    a_seq = rng.uniform(-1.3, 1.3, size=(H, 4)).astype(np.float32)  # raw
    dist = (rng.normal(size=(H, 3)) * 0.05).astype(np.float32)
    ref = j_primal(jenv, H, interpret=True)(jpack(noisy), a_seq, dist, jp)
    launches = rollout_cuda.PRIMAL_KERNEL.launches
    got = rollout_cuda.make_primal(env, H)(pack_state(st), t(a_seq), t(dist), p)
    assert rollout_cuda.PRIMAL_KERNEL.launches == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    # z_h keeps the raw, unclipped actions
    np.testing.assert_array_equal(got[:, 13:].numpy(), a_seq)


# --- K3: sensitivity chain + pullback -----------------------------------------


@pytest.mark.parametrize("sd", [13, 16])
def test_tail_pullback_plain_matches_pallas(sd):
    Hh, dA = 4, 4
    rng = np.random.default_rng(3)
    J = (rng.normal(size=(Hh, sd, sd + dA)) * 0.5).astype(np.float32)
    A = rng.normal(size=(Hh, sd + dA, sd + dA)).astype(np.float32)
    M = (A + A.transpose(0, 2, 1)) / 2
    ref = j_tail_pullback(Hh, dA, sd=sd, interpret=True)(J, M)
    launches = hessian_cuda.CHAIN_KERNEL.launches
    got = hessian_cuda.make_tail_pullback(Hh, dA, sd)(t(J), t(M))
    assert hessian_cuda.CHAIN_KERNEL.launches == launches
    assert _rel(got.numpy(), ref) < 1e-6


# --- the Hessian: Gauss–Newton (the main path) and the exact adjoint -----------


@pytest.mark.parametrize("second_order", [False, True], ids=["gn", "adjoint"])
@pytest.mark.parametrize("part", ["torch", "cuda"])
def test_hessian_adjoint_matches_jax(part, second_order):
    jenv, env, jp, noisy, p, st = _reset(seed=11)
    a = (np.random.default_rng(7).normal(size=(H, 4)) * 0.3).astype(np.float32)
    ref = j_hessian_adjoint(jenv, H, second_order=second_order)(
        a.reshape(-1), jpack(noisy), noisy.time, noisy.pos_traj,
        noisy.vel_traj, jp, jax.random.PRNGKey(9),
    )
    got = make_hessian_adjoint(env, H, primal=part, tail=part,
                               second_order=second_order)(
        t(a).reshape(-1), pack_state(st), st.time, st.pos_traj, st.vel_traj, p,
    )
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) < 1e-5


# --- the Newton–Schulz Sigma-designer ----------------------------------------


@pytest.mark.parametrize("horizon", [8, 32])
def test_optimize_sigma_ns_matches_jax(horizon):
    """Both designers on one real rollout Hessian (the port's gn Hessian at
    a reset state, hover-ish nominal)."""
    _, env, _, _, p, st = _reset(seed=11)
    a = (np.random.default_rng(7).normal(size=(horizon, 4)) * 0.3).astype(np.float32)
    R = make_hessian_adjoint(env, horizon, second_order=False)(
        t(a).reshape(-1), pack_state(st), st.time, st.pos_traj, st.vel_traj, p,
    )
    Dh = 4 * horizon
    c_ref, f_ref = jcov.optimize_sigma_ns(jnp.asarray(R.numpy()), 0.5, Dh)
    c, f = covariance.optimize_sigma_ns(R, 0.5, Dh)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=2e-4)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), atol=2e-4)
    assert bool(torch.isfinite(c).all())


def test_optimize_sigma_eigh_matches_jax():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(32, 32)).astype(np.float32)
    R = A @ A.T - 2.0 * np.eye(32, dtype=np.float32)
    c_ref, _ = jcov.optimize_sigma(R, 0.5, 32)
    c, f = covariance.optimize_sigma(t(R), 0.5, 32)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=2e-4)
    np.testing.assert_allclose((f @ f.T).numpy(), c.numpy(), atol=1e-5)


# --- reductions -----------------------------------------------------------------


def test_weights_and_mean_update_match():
    rng = np.random.default_rng(5)
    costs = rng.normal(size=N).astype(np.float32) * 3
    a_t = rng.normal(size=(H, 4, N)).astype(np.float32)
    a_mean = rng.normal(size=(H, 4)).astype(np.float32)
    w_ref = jred.mppi_weights(costs, 0.01)
    w = reductions.mppi_weights(t(costs), 0.01)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), atol=1e-6)
    ref = jred.mean_update_t(w_ref, a_t, a_mean, 0.7)
    got = reductions.mean_update_t(w, t(a_t), t(a_mean), 0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
