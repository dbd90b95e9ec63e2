"""The port's tasks against the JAX package: the Lissajous
(``tracking``), slow Lissajous (``tracking_slow``) and fixed
(``hovering``) trajectories, the env on each task, the realworld reward of
``tracking_slow`` through the plain rollouts (the kernels' plain versions),
the 13- and 16-dim Hessians and the solves, and the rest of the rotation
and reward helpers.

Every random number enters the port as a tensor, so these tests hand it
the numbers JAX drew from its keys (the trajectory's uniforms from the reset
key's split, the samplers' normals, the shared gaussian draw). JAX's Pallas
rollouts run in interpret mode, as the JAX package's own tests run them on
the CPU. Small sizes: N=256, H=8, the state moved to t0 = 47 with a start
force of (0.02, -0.01, 0.015) and, under drag, a non-zero wind.
Tolerances: tables, env states and the helpers atol 1e-5 (fp32 in another
order); rollout costs atol 2e-4, rtol 1e-5 (the JAX kernel tests'); the
Hessians relative Frobenius 1e-5; one solve 2e-4 (BASELINE.md's per-solve
contract).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covo_mpc_tpu.models import dynamics as jdyn
from covo_mpc_tpu.models import pack_state as jpack
from covo_mpc_tpu.models import rewards as jrew
from covo_mpc_tpu.models import rotation as jrot
from covo_mpc_tpu.models import trajectory as jtraj
from covo_mpc_tpu.ops import covariance as jcov
from covo_mpc_tpu.ops import reductions as jred
from covo_mpc_tpu.ops.hessian import make_hessian_adjoint as j_hessian_adjoint
from covo_mpc_tpu.ops.rollout import make_rollout as j_make_rollout
from covo_mpc_tpu.ops.rollout_pallas import make_pallas_rollout as j_pallas_rollout
from covo_mpc_tpu.ops.rollout_pallas import make_pallas_rollout_batched as j_rollout_batched
from covo_mpc_tpu.solvers import get_solver as j_get_solver
from covo_mpc_tpu.solvers import hover_sequence as j_hover
from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv, pack_state, rewards, rotation
from covo_mpc_tpu_torch.models.quad_env import ResetDraws
from covo_mpc_tpu_torch.models.trajectory import FixedDraws, LissajousDraws, get_generator
from covo_mpc_tpu_torch.ops import rollout_cuda
from covo_mpc_tpu_torch.ops.hessian import make_hessian_adjoint
from covo_mpc_tpu_torch.ops.rollout import make_rollout
from covo_mpc_tpu_torch.parallel import make_batched_covo_solve
from covo_mpc_tpu_torch.solvers import covo_params_from_numpy, get_solver, mppi_params_from_numpy
from tests.test_torch_models import (
    assert_states_close,
    leaves,
    make_envs,
    obs_noise_from_key,
    step_draws_from_key,
    t,
    to_torch_params,
    to_torch_state,
    zigzag_draws_from_key,
)

N, H = 256, 8
D = 4 * H
T0 = 47
F0 = np.array([0.02, -0.01, 0.015], np.float32)
PSTR = f"N{N}_H{H}_lam0.01"
TASKS = ["tracking", "tracking_slow", "hovering"]
JAX_TRAJ = {"tracking": jtraj.generate_lissa_traj,
            "tracking_slow": jtraj.generate_lissa_traj_slow,
            "hovering": jtraj.generate_fixed_traj}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def traj_draws_from_key(task, key, max_steps):
    """The draws JAX's generator of ``task`` makes from ``key``, in the
    port's form: the Lissajous amplitudes and phases from split(key, 2),
    the zigzag's uniforms, nothing for the fixed target."""
    if task == "hovering":
        return FixedDraws(device=torch.device("cpu"))
    if task == "tracking_zigzag":
        return zigzag_draws_from_key(key, max_steps)
    key_amp, key_phase = jax.random.split(key, 2)
    return LissajousDraws(
        amp=t(jax.random.uniform(key_amp, (3, 2), minval=-1.0, maxval=1.0)),
        phase=t(jax.random.uniform(key_phase, (3, 2), minval=-jnp.pi, maxval=jnp.pi)))


def reset_draws_from_key(task, jenv, key, params) -> ResetDraws:
    """The draws JAX's reset_env(key) makes on ``task``, in the port's form
    (tests/test_torch_models.reset_draws_from_key for any generator)."""
    traj_key, disturb_key, _ = jax.random.split(key, 3)
    scale = float(params.disturb_scale)
    f = jax.random.uniform(disturb_key, (3,), minval=-scale, maxval=scale)
    return ResetDraws(traj=traj_draws_from_key(task, traj_key, jenv._max_steps),
                      f_disturb=t(np.asarray(f) / scale),
                      obs_noise=obs_noise_from_key(jax.random.split(key)[0]))


# --- trajectories and the env ------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("task", TASKS)
def test_trajectory_tables_match_jax(task, seed):
    """Each generator's three tables from JAX's draws, at JAX's lengths
    (max_steps + 50 for the Lissajous ones, max_steps for the fixed one)."""
    key = jax.random.PRNGKey(seed)
    ref = JAX_TRAJ[task](300, 0.02, key)
    _, pure = get_generator(task)
    got = pure(300, 0.02, traj_draws_from_key(task, key, 300))
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


@pytest.mark.parametrize("task", TASKS)
def test_env_reset_and_steps_match_jax(task):
    """reset_env, then five step_env calls fed the draws JAX made; the port
    starts every step from the JAX state. The step reward is the task's
    (realworld on tracking_slow)."""
    jenv, env = make_envs(task=task)
    jp, p = jenv.default_params, env.default_params
    key = jax.random.PRNGKey(11)
    obs_r, info_r, jstate = jenv.reset_env(key, jp)
    obs, info, state = env.reset_from_draws(reset_draws_from_key(task, jenv, key, jp), p)
    assert_states_close(state, jstate, msg="reset")
    np.testing.assert_allclose(state.acc_traj.numpy(), np.asarray(jstate.acc_traj), atol=1e-5)
    assert_states_close(info["noisy_state"], info_r["noisy_state"], msg="noisy")
    np.testing.assert_allclose(obs.numpy(), np.asarray(obs_r), atol=1e-5)
    rng = np.random.default_rng(4)
    key = jax.random.PRNGKey(9)
    for i in range(5):
        key, k = jax.random.split(key)
        action = rng.uniform(-1.1, 1.1, size=4).astype(np.float32)
        obs_r, next_r, rew_r, done_r, info_r = jenv.step_env(k, jstate, action, jp)
        obs, nxt, rew, done, info = env.step_from_draws(
            step_draws_from_key(k), to_torch_state(jstate), t(action), p)
        assert_states_close(nxt, next_r, msg=f"step {i}")
        np.testing.assert_allclose(obs.numpy(), np.asarray(obs_r), atol=1e-5)
        np.testing.assert_allclose(float(rew), float(rew_r), atol=1e-5)
        assert bool(done) == bool(done_r)
        jstate = next_r


@pytest.mark.parametrize("task", ["tracking", "tracking_slow", "tracking_zigzag", "hovering"])
def test_every_task_builds_resets_and_steps(task):
    """QuadEnv builds for every task of JAX's get_generator with the JAX
    defaults (DR, periodic disturbance), resets and auto-steps; the rollout
    kernels' wrappers take the task's reward as their launch argument."""
    env = QuadEnv(EnvConfig(task=task), device="cpu")
    gen = torch.Generator().manual_seed(0)
    obs, _, state = env.reset(gen, env.sample_params(gen))
    for _ in range(3):
        obs, state, reward, done, _ = env.step(gen, state, torch.zeros(4))
    assert obs.shape == (env.obs_dim,) and bool(torch.isfinite(reward))
    assert env.reward_name == ("realworld" if task == "tracking_slow" else "penyaw")
    assert rollout_cuda.make_rollout_costs(env).reward == rollout_cuda.REWARDS[env.reward_name]
    with pytest.raises(ValueError):
        get_generator("tracking_fast")


# --- the rest of rotation.py and rewards.py ----------------------------------


@pytest.mark.parametrize("name", ["quat_to_rpy", "rp_to_quat", "quat_to_rp"])
def test_rotation_helpers_match_jax(name):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q[:, 3] = np.abs(q[:, 3]) + 0.5  # away from the rp singularity at q_w = 0
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    x = rng.normal(size=(64, 3)).astype(np.float32) if name == "rp_to_quat" else q
    ref = getattr(jrot, name)(x)
    got = getattr(rotation, name)(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("name", ["hovering_reward", "tracking_reward",
                                  "hovering_reward_fn", "tracking_reward_fn"])
def test_reward_helpers_match_jax(name):
    """The array forms on 64 random rows; the state wrappers on a stepped
    JAX state."""
    if name.endswith("_fn"):
        jenv = make_envs(task="tracking")[0]
        _, _, jstate = jenv.reset_env(jax.random.PRNGKey(1), jenv.default_params)
        jstate = jenv.step_env(jax.random.PRNGKey(2), jstate, jnp.full(4, 0.3),
                               jenv.default_params)[1]
        ref = getattr(jrew, name)(jstate)
        got = getattr(rewards, name)(to_torch_state(jstate))
    else:
        rng = np.random.default_rng(3)
        args = [rng.normal(size=(64, 3)).astype(np.float32) for _ in range(4)]
        ref = getattr(jrew, name)(*args)
        got = getattr(rewards, name)(*map(t, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


# --- tracking_slow: the realworld reward through the plain rollouts ----------


@functools.lru_cache(maxsize=None)
def _setup(kind):
    """JAX env on tracking_slow under ``kind`` (gaussian or drag, with the
    wind), a noisy reset state at T0 with the start force F0, and the
    port's copies."""
    jenv, env = make_envs(task="tracking_slow", disturb_type=kind)
    jp = jenv.default_params
    if kind == "drag":
        jp = jp.replace(disturb_params=jnp.asarray(
            np.random.default_rng(0).uniform(-1.0, 1.0, 6).astype(np.float32)))
    _, info, _ = jenv.reset_env(jax.random.PRNGKey(0), jp)
    noisy = info["noisy_state"].replace(time=jnp.int32(T0), f_disturb=jnp.asarray(F0))
    return jenv, env, jp, noisy, to_torch_params(jp), to_torch_state(noisy)


def _gauss_draw(kind, key, fast=False):
    """The shared gaussian normals a JAX rollout draws from its step key
    (drag reads none)."""
    if kind != "gaussian":
        return None
    return t(jax.random.normal(jdyn.derive_dynamics_keys(key, fast=fast), (3,)))


@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("kind", ["gaussian", "drag"])
def test_plain_rollout_matches_pallas_and_jnp(kind, deterministic):
    """The plain rollout (engine="torch" and the K4 wrapper's CPU route)
    against JAX's jnp rollout and its Pallas rollout in interpret mode, both
    on the realworld reward."""
    jenv, env, jp, noisy, p, st = _setup(kind)
    actions = (np.random.default_rng(1).normal(size=(N, H, 4)) * 0.4).astype(np.float32)
    key = jax.random.PRNGKey(3)
    args = (jpack(noisy), T0, noisy.pos_traj, noisy.vel_traj, actions, jp, key)
    kw = dict(deterministic=deterministic, discount=0.99)
    ref_jnp, _ = j_make_rollout(jenv)(*args, **kw)
    ref_pl, _ = j_pallas_rollout(jenv, interpret=True)(*args, **kw)
    roll = (pack_state(st), st.time, st.pos_traj, st.vel_traj, t(actions), p,
            _gauss_draw(kind, key))
    got = make_rollout(env)(*roll, **kw)
    for ref in (ref_jnp, ref_pl):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-5)
    launches = rollout_cuda.ROLLOUT_KERNEL.launches
    got4 = rollout_cuda.make_rollout_costs(env)(*roll, **kw)
    assert rollout_cuda.ROLLOUT_KERNEL.launches == launches  # CPU: plain version
    np.testing.assert_array_equal(got4.numpy(), got.numpy())
    # the realworld reward, not penyaw: the zigzag task's rollout differs
    penyaw = make_envs(task="tracking_zigzag", disturb_type=kind)[1]
    assert not torch.allclose(make_rollout(penyaw)(*roll, **kw), got)


@pytest.mark.parametrize("kind", ["gaussian", "drag"])
def test_batched_plain_rollout_matches_pallas(kind):
    """B=2 scenarios (t0 = 47 and 49, masses apart): K6's plain route against
    JAX's batched Pallas rollout in interpret mode (fast keys), each scenario
    under its own shared draw."""
    jenv, env, jp, _, _, _ = _setup(kind)
    jp_b = jax.tree.map(lambda x: jnp.stack([jnp.asarray(x)] * 2), jp)
    jp_b = jp_b.replace(m=jnp.array([0.027, 0.031]))
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    sts = [jenv.reset_env(k, jp)[1]["noisy_state"] for k in keys]
    x0s = jnp.stack([jpack(s) for s in sts]).at[:, 13:16].set(jnp.asarray(F0))
    t0s = jnp.array([47, 49], jnp.int32)
    pos = jnp.stack([s.pos_traj for s in sts])
    vel = jnp.stack([s.vel_traj for s in sts])
    actions = (np.random.default_rng(6).normal(size=(2, N, H, 4)) * 0.4).astype(np.float32)
    step_keys = jax.random.split(jax.random.PRNGKey(7), 2)
    ref = j_rollout_batched(jenv, interpret=True, fast_keys=True)(
        x0s, t0s, pos, vel, actions, jp_b, step_keys, False, 0.99)
    draws = (None if kind == "drag" else
             torch.stack([_gauss_draw(kind, k, fast=True) for k in step_keys]))
    got = rollout_cuda.make_rollout_batched_costs(env)(
        t(x0s), torch.from_numpy(np.array(t0s)), t(pos), t(vel), t(actions),
        to_torch_params(jp_b), draws, False, 0.99, layout="nhd")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-5)


# --- tracking_slow: the Hessians -----------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_hessian(kind, second_order):
    jenv, _, jp, noisy, _, _ = _setup(kind)
    a = (np.random.default_rng(7).normal(size=(H, 4)) * 0.3).astype(np.float32)
    ref = jax.jit(j_hessian_adjoint(jenv, H, second_order=second_order))(
        a.reshape(-1), jpack(noisy), noisy.time, noisy.pos_traj, noisy.vel_traj, jp,
        jax.random.PRNGKey(9))
    return a, np.asarray(ref)


@pytest.mark.parametrize("part", ["torch", "cuda"])
@pytest.mark.parametrize("second_order", [False, True], ids=["gn", "adjoint"])
@pytest.mark.parametrize("kind", ["gaussian", "drag"], ids=["sd13", "sd16"])
def test_hessian_matches_jax(kind, second_order, part):
    """The gn and exact-adjoint Hessians of the realworld cost against JAX's
    make_hessian_adjoint: the 13-dim state (gaussian; K2 and K3 for
    part="cuda") and the 16-dim one (drag; K3 at sd=16). The realworld cost
    is convex in q_w, so R may be indefinite: held to JAX's as it is."""
    _, env, _, _, p, st = _setup(kind)
    a, ref = _jax_hessian(kind, second_order)
    got = make_hessian_adjoint(env, H, primal=part, tail=part, second_order=second_order)(
        t(a).reshape(-1), pack_state(st), st.time, st.pos_traj, st.vel_traj, p)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) < 1e-5


# --- tracking_slow: the solves ---------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reset_pair():
    """JAX's and the port's env, params, reset state and info on
    tracking_slow."""
    jenv, env = make_envs(task="tracking_slow")
    jp = jenv.default_params
    obs, info, state = jenv.reset_env(jax.random.PRNGKey(0), jp)
    return (jenv, env, jp, obs, info, state, to_torch_params(jp), to_torch_state(state),
            {"noisy_state": to_torch_state(info["noisy_state"])})


SOLVE_KEYS = (jax.random.PRNGKey(5), jax.random.PRNGKey(6))


@functools.lru_cache(maxsize=None)
def _j_solves(name, hessian_mode="gn"):
    """JAX's jnp-engine solver ``name`` chained over SOLVE_KEYS from its
    initial params: [(params before, action, params after)] per key."""
    jenv, _, jp, obs, info, state = _reset_pair()[:6]
    kw = dict(hessian_mode=hessian_mode, sigma_mode="ns") if name != "mppi" else {}
    jsolver, jcp = j_get_solver(jenv, name, PSTR, rng_mode="fast", engine="jnp",
                                collect_debug=False, **kw)
    out = []
    for key in SOLVE_KEYS:
        a_r, jcp_next, _ = jsolver(obs, state, jp, key, jcp, info)
        out.append((jcp, a_r, jcp_next))
        jcp = jcp_next
    return out


@pytest.mark.parametrize("engine,rng_mode,hessian_mode", [
    ("torch", "fast", "gn"), ("cuda", "kernel", "gn"), ("cuda", "fast", "adjoint"),
])
def test_covo_solve_matches_jax(engine, rng_mode, hessian_mode):
    """Two chained CoVO-online solves against JAX's jnp engine on the same
    normals (act_key = split(rng)[1]); deterministic rollouts. Each solve
    starts from JAX's params, so errors do not compound."""
    env, p, st, tinfo = (_reset_pair()[i] for i in (1, 6, 7, 8))
    solver, _ = get_solver(env, "covo_online", PSTR, rng_mode=rng_mode,
                           hessian_mode=hessian_mode,
                           sigma_mode="ns", engine=engine, collect_debug=False)
    for key, (jcp, a_r, jcp_r) in zip(SOLVE_KEYS, _j_solves("covo_online", hessian_mode)):
        z = torch.from_numpy(np.array(jax.random.normal(jax.random.split(key)[1], (N, D))))
        a, cp, _ = solver(None, st, p, covo_params_from_numpy(leaves(jcp), device="cpu"),
                          tinfo, z=z)
        np.testing.assert_allclose(a.numpy(), np.asarray(a_r), atol=2e-4)
        np.testing.assert_allclose(cp.a_mean.numpy(), np.asarray(jcp_r.a_mean), atol=2e-4)
        np.testing.assert_allclose(cp.a_cov.numpy(), np.asarray(jcp_r.a_cov), atol=2e-4)


def test_speculative_prepare_matches_jax():
    """The speculative mode's reset, act() and prepare() on tracking_slow:
    prepare's deterministic model step and the design around the shifted
    nominal give JAX's a_cov and a_factor within 2e-4."""
    jenv, env, jp, obs, info, state, p, st, tinfo = _reset_pair()
    kw = dict(rng_mode="fast", hessian_mode="gn", sigma_mode="ns", collect_debug=False)
    jsolver, jcp = j_get_solver(jenv, "covo_speculative", PSTR, engine="jnp", **kw)
    solver, _ = get_solver(env, "covo_speculative", PSTR, engine="torch", **kw)
    jcp1 = jsolver.reset(state, jp, jcp, jax.random.PRNGKey(1))
    cp1 = solver.reset(st, p, covo_params_from_numpy(leaves(jcp), device="cpu"))
    np.testing.assert_allclose(cp1.a_cov.numpy(), np.asarray(jcp1.a_cov), atol=2e-4)
    key = jax.random.PRNGKey(5)
    a_r, jcp2, _ = jsolver.act(None, state, jp, key, jcp1, info)
    z = torch.from_numpy(np.array(jax.random.normal(jax.random.split(key)[1], (N, D))))
    a, _, _ = solver.act(None, st, p, covo_params_from_numpy(leaves(jcp1), device="cpu"),
                         tinfo, z=z)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_r), atol=2e-4)
    jcp3 = jsolver.prepare(state, jp, jcp2, jax.random.PRNGKey(6), info)
    cp3 = solver.prepare(st, p, covo_params_from_numpy(leaves(jcp2), device="cpu"), tinfo)
    np.testing.assert_allclose(cp3.a_cov.numpy(), np.asarray(jcp3.a_cov), atol=2e-4)
    np.testing.assert_allclose(cp3.a_factor.numpy(), np.asarray(jcp3.a_factor), atol=2e-4)


@pytest.mark.parametrize("engine,rng_mode", [("torch", "fast"), ("cuda", "kernel")])
def test_mppi_solve_matches_jax(engine, rng_mode):
    """Two chained MPPI solves against JAX's jnp engine, each fed the normals
    and the shared gaussian draw JAX drew (fast keys)."""
    env, p, st, tinfo = (_reset_pair()[i] for i in (1, 6, 7, 8))
    solver, _ = get_solver(env, "mppi", PSTR, rng_mode=rng_mode, engine=engine, collect_debug=False)
    for key, (jcp, a_r, jcp_r) in zip(SOLVE_KEYS, _j_solves("mppi")):
        rest, act_key = jax.random.split(key)
        z = torch.from_numpy(np.array(jax.random.normal(act_key, (N, H, 4))))
        draw = torch.from_numpy(np.array(jax.random.normal(jax.random.split(rest)[1], (3,))))
        a, cp, _ = solver(None, st, p, mppi_params_from_numpy(leaves(jcp), device="cpu"),
                          tinfo, z=z, draw=draw)
        np.testing.assert_allclose(a.numpy(), np.asarray(a_r), atol=2e-4)
        for name in ("a_mean", "a_cov", "a_cov_chol"):
            np.testing.assert_allclose(getattr(cp, name).numpy(),
                                       np.asarray(getattr(jcp_r, name)), atol=2e-4)


@functools.lru_cache(maxsize=None)
def _j_batched_reference():
    """B=2 tracking_slow scenarios (masses apart, each reset from its own
    key), hover means and numpy normals; JAX's per-scenario CoVO math on
    them (the adjoint Hessian with the scan primal, the NS designer, the
    deterministic jnp rollout, the MPPI-weighted mean); and the port's
    copies of the inputs."""
    jenv, env = make_envs(task="tracking_slow")
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    jp_b = jax.tree.map(lambda x: jnp.stack([jnp.asarray(x)] * 2), jenv.default_params)
    jp_b = jp_b.replace(m=jnp.array([0.027, 0.031]))
    sts = jax.vmap(lambda k, q: jenv.reset_env(k, q)[1]["noisy_state"])(keys, jp_b)
    x0s = jax.vmap(jpack)(sts)
    a_means = np.tile(np.asarray(j_hover(jenv, H))[None], (2, 1, 1))
    z = np.random.default_rng(3).standard_normal((2, N, D)).astype(np.float32)
    hess = j_hessian_adjoint(jenv, H, primal="scan")
    rollout = j_make_rollout(jenv, fast_keys=True)

    def one(am, x0, t0, pos, vel, params, key, zb):
        am = jnp.concatenate([am[1:], am[-1:]])
        R = hess(am.flatten(), x0, t0, pos, vel, params, jax.random.PRNGKey(0))
        _, F = jcov.optimize_sigma_ns(R, 0.5, D)
        a_s = jnp.clip((am.flatten()[None] + zb @ F.T).reshape(N, H, 4), -1.0, 1.0)
        costs, _ = rollout(x0, t0, pos, vel, a_s, params, key, deterministic=True,
                           collect_poses=False)
        return jred.mean_update(jred.mppi_weights(costs, 0.01), a_s, am, 1.0), jnp.min(costs)

    expect, min_ref = jax.jit(jax.vmap(one))(a_means, x0s, sts.time, sts.pos_traj,
                                             sts.vel_traj, jp_b, keys, z)
    args = (t(x0s), torch.from_numpy(np.array(sts.time)), t(sts.pos_traj), t(sts.vel_traj))
    return (dict(a_means=a_means, z=z, expect=expect, min_ref=min_ref),
            dict(env=env, args=args, params=to_torch_params(jp_b)))


@pytest.mark.parametrize("engine,rng_mode", [("torch", "fast"), ("cuda", "kernel")])
def test_batched_covo_solve_matches_jax(engine, rng_mode):
    """The batched CoVO solve at B=2 (masses apart, each scenario reset from
    its own key) against JAX's per-scenario math on the same normals: the
    adjoint Hessian (scan primal), the NS designer, the deterministic jnp
    rollout, the MPPI-weighted mean."""
    j, pb = _j_batched_reference()
    solve = make_batched_covo_solve(pb["env"], N, H, 0.01, rng=rng_mode, engine=engine)
    a_new, min_costs = solve(*pb["args"], t(j["a_means"]), pb["params"], z=t(j["z"]))
    np.testing.assert_allclose(a_new.numpy(), np.asarray(j["expect"]), atol=2e-4)
    np.testing.assert_allclose(min_costs.numpy(), np.asarray(j["min_ref"]), atol=2e-4, rtol=0)
