"""covo_mpc_tpu_torch.ops against the JAX package, one module per test.

On the CPU the kernel wrappers take their plain versions; each is held
against the JAX function that reaches the Pallas kernel, run the way the
JAX package's own tests run it here (interpret mode). Tolerances are the
JAX kernel tests' own. A CUDA kernel has no CPU mode:
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold each one against
its plain version on the card.
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
import numpy as np
import pytest
import torch

from covo_mpc_tpu.models import dynamics as jdyn
from covo_mpc_tpu.models import pack_state as jpack
from covo_mpc_tpu.ops import covariance as jcov
from covo_mpc_tpu.ops import reductions as jred
from covo_mpc_tpu.ops.hessian import make_hessian_adjoint as j_hessian_adjoint
from covo_mpc_tpu.ops import hessian_pallas as jhp
from covo_mpc_tpu.ops.hessian_pallas import make_tail_pullback as j_tail_pullback
from covo_mpc_tpu.ops.rollout import make_rollout as j_make_rollout
from covo_mpc_tpu.ops.rollout_pallas import SUB
from covo_mpc_tpu.solvers.factory import hover_sequence as j_hover
from covo_mpc_tpu.ops import sampling as jsamp
from covo_mpc_tpu.ops.rollout_pallas import make_pallas_primal as j_primal
from covo_mpc_tpu.ops.rollout_pallas import make_pallas_rollout as j_pallas_rollout
from covo_mpc_tpu.ops.rollout_pallas import (
    make_pallas_rollout_joint_sampling as j_joint_sampling,
)
from covo_mpc_tpu.ops.rollout_pallas import (
    make_pallas_rollout_sampling as j_rollout_sampling,
)
from covo_mpc_tpu_torch.models import pack_state
from covo_mpc_tpu_torch.ops import covariance, hessian_cuda, reductions, rollout_cuda, sampling
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


def _joint_inputs(seed=7, Hs=H):
    rng = np.random.default_rng(seed)
    a_mean = (rng.normal(size=(Hs, 4)) * 0.2).astype(np.float32)
    factor = (rng.normal(size=(4 * Hs, 4 * Hs)) * 0.1).astype(np.float32)
    return a_mean, factor


@pytest.mark.parametrize("Hs", [H, 32])
def test_joint_sample_rollout_plain_matches_pallas(Hs):
    """K1's plain version == the Pallas kernel in interpret mode, fed the
    same normals (z rebuilt from act_key as the JAX kernel test does), at
    H=8 and at the main path's width (H=32, D=128): the yardstick the card
    holds K1 against, anchored to JAX."""
    jenv, env, jp, noisy, p, st = _reset()
    a_mean, factor = _joint_inputs(Hs=Hs)
    step_key, act_key = jax.random.PRNGKey(3), jax.random.PRNGKey(4)
    costs_r, a_r = j_joint_sampling(jenv, interpret=True)(
        jpack(noisy), noisy.time, noisy.pos_traj, noisy.vel_traj, a_mean,
        factor, jp, step_key, act_key, N, deterministic=True, discount=0.98,
    )
    z = jax.random.normal(act_key, (4 * Hs, SUB, N // SUB)).reshape(4 * Hs, N)
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
    ptar, vtar, dist, scal, ints = rollout_cuda._pack_kernel_inputs(
        env, pack_state(st), st.time, st.pos_traj, st.vel_traj, p, None,
        True, 0.98, H,
    )
    from covo_mpc_tpu.ops.rollout_pallas import _pack_kernel_inputs as j_pack

    jptar, jvtar, jdist, jscal, jints = j_pack(
        jenv, jpack(noisy), noisy.time, noisy.pos_traj, noisy.vel_traj, jp,
        jax.random.PRNGKey(0), True, 0.98, H,
    )
    np.testing.assert_allclose(ptar.numpy(), np.asarray(jptar), atol=0)
    np.testing.assert_allclose(vtar.numpy(), np.asarray(jvtar), atol=0)
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jdist))
    np.testing.assert_allclose(scal.numpy(), np.asarray(jscal), rtol=1e-7)
    np.testing.assert_array_equal(ints.numpy(), np.asarray(jints))


# --- K4: rollout costs of given actions ---------------------------------------


@pytest.mark.parametrize("Hs", [H, 32])
@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("layout", ["nhd", "hdn"])
def test_rollout_costs_plain_matches_pallas(layout, deterministic, Hs):
    """K4's plain route == the Pallas kernel in interpret mode, fed the same
    actions and the normals of JAX's shared draw (fast keys: the draw hashes
    the step key itself), at H=8 and at the main path's H=32."""
    jenv, env, jp, noisy, p, st = _reset()
    rng = np.random.default_rng(8)
    actions = (rng.normal(size=(N, Hs, 4)) * 0.5).astype(np.float32)
    if layout == "hdn":
        actions = np.ascontiguousarray(actions.transpose(1, 2, 0))
    step_key = jax.random.PRNGKey(3)
    ref, _ = j_pallas_rollout(jenv, interpret=True, fast_keys=True)(
        jpack(noisy), noisy.time, noisy.pos_traj, noisy.vel_traj, actions, jp,
        step_key, deterministic=deterministic, discount=0.98, layout=layout,
    )
    draw = t(jax.random.normal(jdyn.derive_dynamics_keys(step_key, fast=True), (3,)))
    launches = rollout_cuda.ROLLOUT_KERNEL.launches
    got = rollout_cuda.make_rollout_costs(env)(
        pack_state(st), st.time, st.pos_traj, st.vel_traj, t(actions), p, draw,
        deterministic=deterministic, discount=0.98, layout=layout,
    )
    assert rollout_cuda.ROLLOUT_KERNEL.launches == launches  # CPU: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-5)


def _two_pass_costs(env, x0, t0, pos_traj, vel_traj, actions, params, draw,
                    deterministic, discount):
    """K4's costs the way the split kernel computes them: the H + 1 states
    alone first (the force carried from each pre-step velocity), then the
    rewards, the freeze and the discounted cost from those states; built
    from the functions ``make_rollout`` uses. ``actions`` (N, H, 4). Returns
    the costs and each sample's first terminated step (H: none)."""
    from covo_mpc_tpu_torch.models import dynamics
    from covo_mpc_tpu_torch.models.structs import FDIST, VEL
    from covo_mpc_tpu_torch.ops import rollout as rollout_ops

    reward, done_fn = rollout_ops.make_reward(env), rollout_ops._make_done(env)
    acts = actions.permute(1, 0, 2)
    Hs, n, _ = acts.shape
    ptar, vtar = rollout_ops.target_window(t0, pos_traj, vel_traj, Hs)
    if deterministic:
        params = params.replace(dyn_noise_scale=params.dyn_noise_scale * 0.0)
    draw = x0.new_zeros(3) if draw is None else draw
    xs = [x0[:16].expand(n, 16)]
    for h in range(Hs):  # pass 1: the state chain
        x = xs[-1]
        s_new = dynamics.core_step(x[:, :13], acts[h], x[:, 13:16], params, env._dt)
        f_new = env.disturb_fn(params, draw, t0 + h, x[..., VEL], x[..., FDIST])
        xs.append(torch.cat([s_new, f_new.expand(n, 3)], dim=-1))
    r_prev = torch.zeros(n)
    d_prev = torch.zeros(n, dtype=torch.bool)
    first = torch.full((n,), Hs)
    rews = []
    for h in range(Hs):  # pass 2: rewards, freeze, cost
        r = torch.where(d_prev, r_prev, reward(xs[h], ptar[h], vtar[h]))
        d = done_fn(xs[h], t0 + h, params.max_steps_in_episode) | d_prev
        first = torch.where(d & ~d_prev, torch.full_like(first, h), first)
        r_prev, d_prev = r, d
        rews.append(r)
    disc = torch.pow(discount, torch.arange(Hs, dtype=torch.float32))
    return -torch.einsum("h,hn->n", disc, torch.stack(rews)), first


@pytest.mark.parametrize("kind", ["gaussian", "drag"])
def test_rollout_costs_from_states_then_rewards(kind):
    """The decomposition K4's split kernel relies on: the states rolled out
    alone, then the rewards, freeze and cost from them, give the one-pass
    plain rollout's costs bit for bit, and the Pallas kernel's (interpret
    mode) within its tolerance; in the shared (gaussian) and drag modes,
    rollover termination on, with samples that terminate mid-horizon."""
    jenv, env = make_envs(disturb_type=kind, disable_rollover_terminate=False)
    jp = jenv.default_params
    if kind == "drag":  # a wind, and a start force the drag carries
        jp = jp.replace(disturb_params=jnp.asarray(
            np.random.default_rng(0).uniform(-1.0, 1.0, 6).astype(np.float32)))
    _, info, _ = jenv.reset_env(jax.random.PRNGKey(0), jp)
    noisy = info["noisy_state"].replace(f_disturb=jnp.asarray([0.02, -0.01, 0.015]))
    p, st = to_torch_params(jp), to_torch_state(noisy)
    actions = (np.random.default_rng(8).normal(size=(256, 32, 4)) * 3.0).astype(np.float32)
    step_key = jax.random.PRNGKey(3)
    ref, _ = j_pallas_rollout(jenv, interpret=True, fast_keys=True)(
        jpack(noisy), noisy.time, noisy.pos_traj, noisy.vel_traj, actions, jp, step_key,
        deterministic=False, discount=0.98)
    draw = (t(jax.random.normal(jdyn.derive_dynamics_keys(step_key, fast=True), (3,)))
            if kind == "gaussian" else None)
    roll = (pack_state(st), st.time, st.pos_traj, st.vel_traj, t(actions), p, draw)
    got, first = _two_pass_costs(env, *roll, deterministic=False, discount=0.98)
    one_pass = make_rollout(env)(*roll, deterministic=False, discount=0.98)
    assert 0 < int((first < 32).sum()) < 256 and int(first[first < 32].min()) > 0
    assert torch.equal(got, one_pass)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-5)


# --- K5: per-step sample + rollout ------------------------------------------------


def _per_step_inputs(seed=9, Hs=H):
    """A mean and per-step lower Cholesky factors of SPD covariances."""
    rng = np.random.default_rng(seed)
    a_mean = (rng.normal(size=(Hs, 4)) * 0.2).astype(np.float32)
    A = rng.normal(size=(Hs, 4, 4)) * 0.2
    cov = A @ A.transpose(0, 2, 1) + 0.05 * np.eye(4)
    return a_mean, np.linalg.cholesky(cov).astype(np.float32), cov.astype(np.float32)


@pytest.mark.parametrize("Hs", [H, 32])
@pytest.mark.parametrize("deterministic", [True, False])
def test_sample_rollout_plain_matches_pallas(deterministic, Hs):
    """K5's plain route == the Pallas kernel in interpret mode, fed the
    normals its interpret path draws from act_key and the shared draw from
    step_key, at H=8 and at the main path's H=32."""
    jenv, env, jp, noisy, p, st = _reset()
    a_mean, chol, _ = _per_step_inputs(Hs=Hs)
    step_key, act_key = jax.random.PRNGKey(3), jax.random.PRNGKey(4)
    costs_r, a_r = j_rollout_sampling(jenv, interpret=True, fast_keys=True)(
        jpack(noisy), noisy.time, noisy.pos_traj, noisy.vel_traj, a_mean, chol,
        jp, step_key, act_key, N, deterministic=deterministic, discount=0.98,
    )
    z = jax.random.normal(act_key, (Hs, 4, SUB, N // SUB)).reshape(Hs, 4, N)
    draw = t(jax.random.normal(jdyn.derive_dynamics_keys(step_key, fast=True), (3,)))
    launches = rollout_cuda.SAMPLE_KERNEL.launches
    costs, a_t = rollout_cuda.make_rollout_sampling(env)(
        pack_state(st), st.time, st.pos_traj, st.vel_traj, t(a_mean), t(chol),
        p, seed=0, N=N, deterministic=deterministic, discount=0.98, draw=draw,
        z=t(z),
    )
    assert rollout_cuda.SAMPLE_KERNEL.launches == launches  # CPU: plain version
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_r), atol=1e-5)
    np.testing.assert_allclose(costs.numpy(), np.asarray(costs_r),
                               atol=2e-4, rtol=1e-5)


def test_sample_rollout_plain_draws_from_seeds():
    """The plain route's own draws: the actions from ``seed``, the shared
    disturbance (when no draw is given) from ``disturb_seed``, written to
    ``draw_out``; feeding that draw back gives the same costs."""
    _, env, _, _, p, st = _reset()
    a_mean, chol, _ = _per_step_inputs()
    k5 = rollout_cuda.make_rollout_sampling(env)
    args = (pack_state(st), st.time, st.pos_traj, st.vel_traj, t(a_mean),
            t(chol), p)
    draw_out = torch.zeros(3)
    c1, a1 = k5(*args, seed=5, N=256, disturb_seed=8, draw_out=draw_out)
    c2, a2 = k5(*args, seed=5, N=256, draw=draw_out.clone())
    c3, a3 = k5(*args, seed=6, N=256, disturb_seed=8)
    assert torch.equal(c1, c2) and torch.equal(a1, a2)
    assert not torch.equal(a1, a3)
    assert float(draw_out.abs().sum()) > 0.0
    assert float(a1.abs().max()) <= 1.0
    with pytest.raises(ValueError):
        k5(*args, seed=5, N=256)  # stochastic gaussian: a draw or a seed


@pytest.mark.parametrize("env_kw,deterministic,expect", [
    (dict(), False, [0.05, 0.0, 0.0]),  # "krng": the scale, the kernel draws
    (dict(), True, [0.0, 0.0, 0.0]),
    (dict(disturb_type="none"), False, [0.0, 0.0, 0.0]),
])
def test_build_kernel_disturb_modes(env_kw, deterministic, expect):
    _, env, _, _, p, st = _reset(**env_kw)
    krng = rollout_cuda._kernel_draws(env, None, deterministic)
    assert krng == (expect[0] > 0)
    dist, got = rollout_cuda.build_kernel_disturb(
        env, pack_state(st), st.time, p, None, deterministic, H, kernel_draw=krng)
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-7)
    np.testing.assert_array_equal(dist.numpy(), np.zeros(3 * H, np.float32))


# --- K2: primal ---------------------------------------------------------------


@pytest.mark.parametrize("Hs", [8, 32])
def test_primal_plain_matches_pallas(Hs):
    jenv, env, jp, noisy, p, st = _reset()
    rng = np.random.default_rng(2)
    a_seq = rng.uniform(-1.3, 1.3, size=(Hs, 4)).astype(np.float32)  # raw
    dist = (rng.normal(size=(Hs, 3)) * 0.05).astype(np.float32)
    ref = j_primal(jenv, Hs, interpret=True)(jpack(noisy), a_seq, dist, jp)
    launches = rollout_cuda.PRIMAL_KERNEL.launches
    got = rollout_cuda.make_primal(env, Hs)(pack_state(st), t(a_seq), t(dist), p)
    assert rollout_cuda.PRIMAL_KERNEL.launches == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    # z_h keeps the raw, unclipped actions
    np.testing.assert_array_equal(got[:, 13:].numpy(), a_seq)


# --- K3: sensitivity chain + pullback -----------------------------------------


@pytest.mark.parametrize("Hh", [4, 13])
@pytest.mark.parametrize("sd", [13, 16])
def test_tail_pullback_plain_matches_pallas(sd, Hh):
    dA = 4
    rng = np.random.default_rng(3)
    J = (rng.normal(size=(Hh, sd, sd + dA)) * 0.5).astype(np.float32)
    A = rng.normal(size=(Hh, sd + dA, sd + dA)).astype(np.float32)
    M = (A + A.transpose(0, 2, 1)) / 2
    ref = j_tail_pullback(Hh, dA, sd=sd, interpret=True)(J, M)
    launches = hessian_cuda.CHAIN_KERNEL.launches
    got = hessian_cuda.make_tail_pullback(Hh, dA, sd)(t(J), t(M))
    assert hessian_cuda.CHAIN_KERNEL.launches == launches
    assert _rel(got.numpy(), ref) < 1e-6


def _pallas_chain_T(J, H, dA, sd):
    """T (H, sd + dA, D) from JAX's chain kernel in interpret mode, un-banked
    as ``make_tail_pullback`` does before its pullback."""
    D, L = H * dA, -(-H * dA // 128) * 128
    J_bank = jnp.pad(jhp._to_bank_cols(jnp.asarray(J), sd), [(0, 0), (0, jhp._AB - sd), (0, 0)])
    T_bank = pl.pallas_call(
        functools.partial(jhp._chain_kernel, H=H, dA=dA),
        out_shape=jax.ShapeDtypeStruct((H * jhp._ZB, L), jnp.float32), interpret=True,
    )(J_bank.reshape(H * jhp._AB, jhp._ZB).astype(jnp.float32)).reshape(H, jhp._ZB, L)
    return np.asarray(jnp.concatenate(
        [T_bank[:, :sd, :D], T_bank[:, jhp._AB:jhp._AB + dA, :D]], axis=1))


@pytest.mark.parametrize("sd", [13, 16])
def test_sens_chain_zero_prefix_matches_pallas(sd):
    """Column x of T is exactly zero in its S1 rows at h <= x // dA (the
    action of step x // dA moves no state before step x // dA + 1), in the
    plain chain and in JAX's kernel alike: the steps K3 does not run."""
    Hh, dA = 13, 4
    rng = np.random.default_rng(5)
    J = (rng.normal(size=(Hh, sd, sd + dA)) * 0.5).astype(np.float32)
    got = hessian_cuda.sens_chain_plain(t(J), dA).numpy()
    ref = _pallas_chain_T(J, Hh, dA, sd)
    prefix = np.arange(Hh)[:, None] <= np.arange(Hh * dA)[None, :] // dA  # (H, D)
    for T in (got, ref):
        s1 = np.abs(T[:, :sd, :]).max(axis=1)
        assert (s1[prefix] == 0).all() and (s1[~prefix] > 0).all()
        assert (T[:, sd:, :] == np.eye(Hh * dA).reshape(Hh, dA, Hh * dA)).all()
    assert _rel(got, ref) < 1e-6


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


@pytest.mark.parametrize("second_order", [False, True], ids=["gn", "adjoint"])
def test_hessian_at_zero_yaw_matches_jax(second_order):
    """At the exact reset state (identity attitude, zero body rates) the
    hover nominal keeps the yaw at exactly 0 over the horizon, where |yaw|
    is not differentiable: JAX's derivative of abs at 0 is +1, so its
    Hessian keeps the yaw penalty's curvature. The port's did not (torch.abs
    has 0 there: 100% relative error) until the reward took JAX's
    convention."""
    jenv, env = make_envs()
    jp = jenv.default_params
    _, _, state = jenv.reset_env(jax.random.PRNGKey(0), jp)
    a = np.tile(np.asarray(j_hover(jenv, 1)), (H, 1)).astype(np.float32)
    ref = j_hessian_adjoint(jenv, H, second_order=second_order)(
        a.reshape(-1), jpack(state), state.time, state.pos_traj, state.vel_traj,
        jp, jax.random.PRNGKey(9),
    )
    st = to_torch_state(state)
    got = make_hessian_adjoint(env, H, second_order=second_order)(
        t(a).reshape(-1), pack_state(st), st.time, st.pos_traj, st.vel_traj,
        to_torch_params(jp),
    )
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


def test_sample_per_step_t_matches_jax():
    a_mean, chol, cov = _per_step_inputs()
    z = jax.random.normal(jax.random.PRNGKey(2), (N, H, 4))
    ref = jsamp.sample_per_step_t(jax.random.PRNGKey(2), a_mean, cov, N, mode="fast")
    got = sampling.sample_per_step_t(None, t(a_mean), t(chol), N, z=t(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    drawn = sampling.sample_per_step_t(torch.Generator().manual_seed(0),
                                       t(a_mean), t(chol), N)
    assert drawn.shape == (H, 4, N)


@pytest.mark.parametrize("gamma_sigma", [0.0, 0.5])
def test_cov_updates_match_jax(gamma_sigma):
    rng = np.random.default_rng(6)
    costs = rng.normal(size=N).astype(np.float32) * 0.05
    a_t = rng.normal(size=(H, 4, N)).astype(np.float32) * 0.5
    a_mean, chol, cov = _per_step_inputs()
    w = jred.mppi_weights(costs, 0.01)
    new_mean = jred.mean_update_t(w, a_t, a_mean, 1.0)
    ref = jred.cov_update_t(w, a_t, new_mean, cov, gamma_sigma)
    ref_c, ref_l = jred.cov_factor_update_t(w, a_t, new_mean, cov, chol, gamma_sigma)
    tw, tm, tcov, tchol = t(w), t(new_mean), t(cov), t(chol)
    got = reductions.cov_update_t(tw, t(a_t), tm, tcov, gamma_sigma)
    got_c, got_l = reductions.cov_factor_update_t(tw, t(a_t), tm, tcov, tchol,
                                                  gamma_sigma)
    for g, r in ((got, ref), (got_c, ref_c), (got_l, ref_l)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)
    assert got_l.is_contiguous()
    if gamma_sigma == 0.0:  # the carried tensors, untouched
        assert got is tcov and got_c is tcov and got_l is tchol
