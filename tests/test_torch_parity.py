"""The port's key-drawing paths against the JAX package on the same keys.

JAX's key tree (``utils/prng.py``) drives every draw here on both sides:
the env's reset, step and params draws, the parity and invariant samplers,
the disturbance chain, and whole parity solves (CoVO online, offline and
speculative, MPPI) with the reference's generic Hessian estimators and
the sensitivity propagation. Tolerances: draws bit for bit where the
arithmetic is the same, 1e-6 on the env's states, the JAX tests' own on
the Hessians (tests/test_covo.py), BASELINE.md's 2e-4 on actions and Σ,
1e-4 on the debug poses' mean and std.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covo_mpc_tpu.models import dynamics as jdyn
from covo_mpc_tpu.models.structs import pack_state as jpack
from covo_mpc_tpu.ops import covariance as jcov
from covo_mpc_tpu.ops import sampling as jsampling
from covo_mpc_tpu.ops.hessian import build_hessian_aux_table as j_aux_table
from covo_mpc_tpu.ops.hessian import make_hessian_sensitivity as j_sensitivity
from covo_mpc_tpu.ops.rollout import make_hessian_cost as j_hessian_cost
from covo_mpc_tpu.solvers import get_solver as j_get_solver
from covo_mpc_tpu_torch.models import dynamics
from covo_mpc_tpu_torch.models.structs import pack_state
from covo_mpc_tpu_torch.ops import covariance, sampling
from covo_mpc_tpu_torch.ops.hessian import make_hessian_sensitivity
from covo_mpc_tpu_torch.ops.rollout import hessian_draws_from_key, make_hessian_cost
from covo_mpc_tpu_torch.solvers import (
    covo_params_from_numpy,
    get_solver,
    mppi_params_from_numpy,
)
from covo_mpc_tpu_torch.utils import prng
from tests.test_torch_models import (
    STATE_FIELDS,
    leaves,
    make_envs,
    obs_noise_from_key,
    t,
    to_torch_state,
)
from tests.test_torch_tasks import reset_draws_from_key

PSTR = "N64_H8_lam0.01"
H = 8
SOLVE_ATOL = 2e-4  # BASELINE.md's per-solve contract, actions and Σ
POSE_ATOL = 1e-4


# the trajectory tables come from the pure generators, built in fp32 in
# another order than JAX's and held at 1e-5 by tests/test_torch_models.py
TABLES = ("pos_traj", "vel_traj", "pos_tar", "vel_tar")


def assert_states_close(ours, ref, msg=""):
    """Every state field to 1e-6, the trajectory tables to 1e-5."""
    for f in STATE_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(ours, f)), np.asarray(getattr(ref, f)),
                                   atol=1e-5 if f in TABLES else 1e-6, err_msg=f"{msg}:{f}")


def words(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


# --- the env's draws -----------------------------------------------------------


@pytest.mark.parametrize("task", ["tracking_zigzag", "tracking", "hovering"])
@pytest.mark.parametrize("disturb", ["gaussian", "periodic"])
def test_env_reset_draws_from_a_key_are_jaxs(task, disturb):
    """draw_reset(key): the trajectory's draws and the reset force bit for
    bit, the obs noise within 2 ulp; the reset state to 1e-6 (the zigzag's
    tables are built in fp32 in another order)."""
    jenv, env = make_envs(task=task, disturb_type=disturb)
    key = jax.random.PRNGKey(17)
    ref = reset_draws_from_key(task, jenv, key, jenv.default_params)
    ours = env.draw_reset(words(key))
    for name in ("amp", "phase", "start", "segs"):
        if hasattr(ref.traj, name):
            assert np.array_equal(bits(getattr(ours.traj, name)),
                                  bits(getattr(ref.traj, name))), name
    scale = env.default_params.disturb_scale
    assert np.array_equal(bits(ours.f_disturb * scale), bits(ref.f_disturb * scale))
    np.testing.assert_allclose(ours.obs_noise, ref.obs_noise, atol=1e-6)
    _, jinfo, jstate = jenv.reset(key, jenv.default_params)
    _, info, state = env.reset(words(key))
    if task == "tracking_zigzag":
        assert_states_close(state, jstate)
        assert_states_close(info["noisy_state"], jinfo["noisy_state"])
    assert np.array_equal(bits(state.f_disturb), bits(jstate.f_disturb))


@pytest.mark.parametrize("disturb", ["gaussian", "mixed"])
def test_env_step_draws_and_auto_reset_from_a_key_are_jaxs(disturb):
    """step(key): ``key, key_reset = split(key)``, the disturbance through
    the reference's chain, the obs noise from ``split(key)[0]``: next state
    and noisy state to 1e-6, over a step and an auto-reset."""
    jenv, env = make_envs(disturb_type=disturb)
    jp, p = jenv.default_params, env.default_params
    _, _, jstate = jenv.reset(jax.random.PRNGKey(2), jp)
    _, _, state = env.reset(prng.PRNGKey(2))
    action = jnp.array([0.2, -0.1, 0.3, 0.05])
    taction = torch.tensor([0.2, -0.1, 0.3, 0.05])
    for k in (5, 6):
        jobs, jstate, _, jdone, jinfo = jenv.step(jax.random.PRNGKey(k), jstate, action, jp)
        obs, state, _, done, info = env.step(prng.PRNGKey(k), state, taction, p)
        assert_states_close(state, jstate, msg=f"step {k}")
        assert_states_close(info["noisy_state"], jinfo["noisy_state"])
        np.testing.assert_allclose(obs, jobs, atol=1e-6)
    # an auto-reset: a state past the episode's end takes the reset branch
    late = jstate.replace(time=jnp.int32(300))
    _, jnew, _, jdone, _ = jenv.step(jax.random.PRNGKey(9), late, action, jp)
    past = state.replace(time=torch.tensor(300, dtype=torch.int32))
    _, new, _, done, _ = env.step(prng.PRNGKey(9), past, taction, p)
    assert bool(done) and bool(jdone)
    assert_states_close(new, jnew, msg="auto-reset")


@pytest.mark.parametrize("randomize", [False, True])
def test_sample_params_from_a_key_are_jaxs(randomize):
    jenv, env = make_envs(enable_randomizer=randomize)
    key = jax.random.PRNGKey(23)
    ref, ours = jenv.sample_params(key), env.sample_params(words(key))
    for name in ("m", "I_diag", "action_scale", "alpha_bodyrate", "disturb_params"):
        np.testing.assert_allclose(getattr(ours, name), getattr(ref, name), atol=1e-6,
                                   err_msg=name)
    assert np.array_equal(bits(env.draw_params(words(key))),
                          bits(jax.random.uniform(jax.random.split(key)[0] if randomize
                                                  else key, (17 if randomize else 6,),
                                                  minval=-1.0, maxval=1.0)))


def test_obs_noise_from_an_info_key_is_jaxs():
    _, env = make_envs()
    key = jax.random.PRNGKey(31)
    np.testing.assert_allclose(env._draw_obs_noise(words(key)), obs_noise_from_key(key),
                               atol=1e-6)


# --- the disturbance chain -----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_dynamics_key_chain_and_draws_are_jaxs(seed):
    """derive_dynamics_keys bit for bit (both chains), and each model's draw
    from the disturb key."""
    key = jax.random.PRNGKey(seed)
    for fast in (False, True):
        assert torch.equal(dynamics.derive_dynamics_keys(words(key), fast),
                           words(jdyn.derive_dynamics_keys(key, fast)))
    dk = jdyn.derive_dynamics_keys(key)
    scale = jnp.float32(0.2)
    u = dynamics.disturb_draw_from_key("periodic", words(dk), torch.tensor(0.2))
    assert np.array_equal(bits(u), bits(jax.random.uniform(dk, (3,), minval=-scale,
                                                           maxval=scale)))
    n = dynamics.disturb_draw_from_key("gaussian", words(dk), torch.tensor(0.2))
    np.testing.assert_allclose(n, jax.random.normal(dk, (3,)), atol=1e-6)
    assert dynamics.disturb_draw_from_key("gaussian", words(dk), 0.2,
                                          deterministic=True) is None
    assert dynamics.disturb_draw_from_key("sin", words(dk), 0.2) is None


@pytest.mark.parametrize("disturb", ["periodic", "mixed"])
def test_hessian_draws_follow_jaxs_per_step_split(disturb):
    """The Hessian rollout's per-step draws: JAX's aux table holds them
    (columns 3:6), one key split per step."""
    jenv, env = make_envs(disturb_type=disturb)
    key = jax.random.PRNGKey(9)
    x0 = jnp.zeros(16)
    ref = np.asarray(j_aux_table(jenv, x0, jnp.int32(0), jenv.default_params, key, H))[:, 3:6]
    ours = hessian_draws_from_key(env, words(key), H)
    assert np.array_equal(bits(ours), bits(ref))
    # a stack of keys gives each its chain
    keys = jax.random.split(key, 3)
    stack = hessian_draws_from_key(env, words(keys), H)
    assert np.array_equal(bits(stack[1]), bits(hessian_draws_from_key(env, words(keys[1]), H)))
    _, genv = make_envs(disturb_type="gaussian")
    assert hessian_draws_from_key(genv, words(key), H) is None


# --- the samplers -----------------------------------------------------------------


def _chol(D, seed):
    A = np.random.default_rng(seed).normal(size=(D, D)).astype(np.float32) * 0.1
    return np.linalg.cholesky(A @ A.T + np.eye(D, dtype=np.float32) * 0.05).astype(np.float32)


@pytest.mark.parametrize("mode", ["parity", "invariant"])
def test_joint_sampler_is_jaxs(mode):
    N, D = 33, 4 * H
    rng = np.random.default_rng(1)
    mean = rng.normal(size=D).astype(np.float32) * 0.2
    L = _chol(D, 2)
    key = jax.random.PRNGKey(5)
    ref = jsampling.sample_joint(key, jnp.asarray(mean), jnp.asarray(L), N, mode=mode)
    ours = sampling.sample_joint(words(key), t(mean), t(L), N, mode)
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    if mode == "invariant":
        ref_t = jsampling.sample_joint_t(key, jnp.asarray(mean), jnp.asarray(L), N, mode=mode)
        ours_t = sampling.sample_joint_t(words(key), t(mean), t(L), N, mode=mode)
        np.testing.assert_allclose(ours_t, ref_t, atol=1e-5)
        ids = jnp.arange(5, 5 + N)
        ref_ids = jsampling.sample_joint(key, jnp.asarray(mean), jnp.asarray(L), N,
                                         mode=mode, sample_ids=ids)
        ours_ids = sampling.sample_joint(words(key), t(mean), t(L), N, mode,
                                         sample_ids=torch.arange(5, 5 + N))
        np.testing.assert_allclose(ours_ids, ref_ids, atol=1e-5)
    else:
        with pytest.raises(ValueError, match="transposed"):
            sampling.sample_joint_t(words(key), t(mean), t(L), N, mode=mode)


@pytest.mark.parametrize("mode", ["parity", "invariant"])
def test_per_step_sampler_is_jaxs(mode):
    N = 17
    rng = np.random.default_rng(3)
    mean = rng.normal(size=(H, 4)).astype(np.float32) * 0.2
    chol = np.stack([_chol(4, 10 + h) for h in range(H)])
    cov = chol @ np.swapaxes(chol, -1, -2)
    key = jax.random.PRNGKey(8)
    ref = jsampling.sample_per_step(key, jnp.asarray(mean), jnp.asarray(cov), N, mode=mode,
                                    chol=jnp.asarray(chol))
    ours = sampling.sample_per_step(words(key), t(mean), t(chol), N, mode)
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    if mode == "invariant":
        ref_t = jsampling.sample_per_step_t(key, jnp.asarray(mean), jnp.asarray(cov), N,
                                            mode=mode, chol=jnp.asarray(chol))
        ours_t = sampling.sample_per_step_t(words(key), t(mean), t(chol), N, mode=mode)
        np.testing.assert_allclose(ours_t, ref_t, atol=1e-5)
    else:
        with pytest.raises(ValueError, match="transposed"):
            sampling.sample_per_step_t(words(key), t(mean), t(chol), N, mode=mode)


# --- the reference Hessians ---------------------------------------------------------


@pytest.mark.parametrize("disturb", ["gaussian", "mixed"])
def test_reference_hessians_match_jax(disturb):
    """fwd_fwd and fwd_rev of make_hessian_cost at tests/test_covo.py:214's
    tolerance, the sensitivity propagation at :338's, on a noisy reset
    state, a random nominal and the Hessian's key chain."""
    jenv, env = make_envs(disturb_type=disturb)
    _, info, _ = jenv.reset_env(jax.random.PRNGKey(11), jenv.default_params)
    noisy = info["noisy_state"]
    a = jax.random.normal(jax.random.PRNGKey(7), (H, 4)) * 0.3
    key = jax.random.PRNGKey(9)
    jargs = (jpack(noisy), noisy.time, noisy.pos_traj, noisy.vel_traj,
             jenv.default_params, key)
    st = to_torch_state(noisy)
    targs = (pack_state(st), st.time, st.pos_traj, st.vel_traj, env.default_params,
             hessian_draws_from_key(env, words(key), H))
    af = t(np.asarray(a).reshape(-1))
    R_ref = np.asarray(jcov.make_hessian(j_hessian_cost(jenv, H), jcov.FWD_FWD)(
        a.flatten(), *jargs))
    for mode in (covariance.FWD_FWD, covariance.FWD_REV):
        R = covariance.make_hessian(make_hessian_cost(env, H), mode)(af, *targs)
        assert R.dtype == torch.float32
        np.testing.assert_allclose(R, R_ref, atol=2e-3, rtol=1e-3, err_msg=mode)
    R_sens = np.asarray(j_sensitivity(jenv, H)(a.flatten(), *jargs))
    np.testing.assert_allclose(make_hessian_sensitivity(env, H)(af, *targs), R_sens,
                               atol=5e-4, rtol=1e-3)


# --- whole solves ---------------------------------------------------------------------


def _setup(name, rng_mode, hessian_mode, sigma_mode, disturb):
    jenv, env = make_envs(disturb_type=disturb)
    kw = dict(rng_mode=rng_mode, hessian_mode=hessian_mode, sigma_mode=sigma_mode,
              collect_debug=True)
    jsolver, jcp = j_get_solver(jenv, name, PSTR, engine="jnp", **kw)
    solver, _ = get_solver(env, name, PSTR, engine="torch", **kw)
    to_params = mppi_params_from_numpy if name == "mppi" else covo_params_from_numpy
    obs, info, state = jenv.reset_env(jax.random.PRNGKey(42), jenv.default_params)
    port = (to_torch_state(state), {"noisy_state": to_torch_state(info["noisy_state"])},
            to_params(leaves(jcp), device="cpu"))
    return jenv, env, jsolver, solver, (obs, info, state, jcp), port


def _chained_solves(jenv, env, jsolver, solver, jax_side, port, solves):
    """``solves`` chained solves of both from the same keys: the per-solve
    max differences of the action, Σ, pos_mean and pos_std."""
    obs, info, state, jcp = jax_side
    st, tinfo, cp = port
    diffs = []
    for i in range(solves):
        ja, jcp, jout = jsolver(obs, state, jenv.default_params, jax.random.PRNGKey(3 + i),
                                jcp, info)
        a, cp, out = solver(None, st, env.default_params, cp, tinfo,
                            key=prng.PRNGKey(3 + i))
        diffs.append([float(np.abs(np.asarray(x) - y.numpy()).max()) for x, y in (
            (ja, a), (jcp.a_cov, cp.a_cov), (jout["pos_mean"], out["pos_mean"]),
            (jout["pos_std"], out["pos_std"]))])
    return np.array(diffs)


def _solve_pair(name, rng_mode="parity", hessian_mode="fwd_fwd", sigma_mode="eigh",
                disturb="gaussian", solves=2):
    """JAX's and the port's solver on one reset, reset from one key (the
    speculative cold start), then ``solves`` chained solves from the same
    keys (:func:`_chained_solves`)."""
    jenv, env, jsolver, solver, jax_side, port = _setup(name, rng_mode, hessian_mode,
                                                         sigma_mode, disturb)
    obs, info, state, jcp = jax_side
    st, tinfo, cp = port
    jcp = jsolver.reset(state, jenv.default_params, jcp, jax.random.PRNGKey(5))
    cp = solver.reset(st, env.default_params, cp, key=prng.PRNGKey(5))
    return _chained_solves(jenv, env, jsolver, solver, (obs, info, state, jcp),
                           (st, tinfo, cp), solves)


def _offline_pair(rng_mode, hessian_mode, sigma_mode, first=3):
    """The offline schedule piece by piece (JAX's whole 300-state reset
    compiles and runs for minutes on the CPU): the expansion episode's keys
    and states from the reset key, the Σ schedule at its ``first`` states,
    then two solves at time 0 on the two schedules."""
    jenv, env, jsolver, solver, jax_side, port = _setup(
        "covo_offline", rng_mode, hessian_mode, sigma_mode, "gaussian")
    obs, info, state, jcp = jax_side
    st, tinfo, cp = port
    jp, p = jenv.default_params, env.default_params
    jstates, jkeys = jax.jit(jsolver.offline_schedule_inputs)(state, jp,
                                                             jax.random.PRNGKey(5))
    keys, disturb = solver.offline_schedule_keys(prng.PRNGKey(5))
    assert torch.equal(keys, words(jkeys))
    states = solver.offline_schedule_inputs(st, p, disturb)
    np.testing.assert_allclose(states.pos, jstates.pos, atol=1e-5)
    np.testing.assert_allclose(states.quat, jstates.quat, atol=1e-5)
    sub = jax.tree.map(lambda x: x[:first], jstates)
    j_cov, j_fac = jax.jit(jax.vmap(lambda s, k: jsolver.offline_sigma_at(
        s, k, jp, jcp.sample_sigma)))(sub, jkeys[:first])
    a_cov, factor = solver.offline_sigma_at(
        jax_to_states(sub, st), p, cp.sample_sigma, keys[:first])
    np.testing.assert_allclose(a_cov, j_cov, atol=SOLVE_ATOL)
    jcp = jcp.replace(a_cov_offline=j_cov, a_factor_offline=j_fac)
    cp = cp.replace(a_cov_offline=a_cov, a_factor_offline=factor)
    return _chained_solves(jenv, env, jsolver, solver, (obs, info, state, jcp),
                           (st, tinfo, cp), 2)


def jax_to_states(jstates, like):
    """JAX's stacked schedule states as the port's stacked EnvState3D."""
    from covo_mpc_tpu_torch.models.structs import state_from_numpy

    return state_from_numpy({**leaves(jstates), "control_params": like.control_params},
                            device="cpu")


def _assert_within(diffs, name):
    assert np.isfinite(diffs).all(), name
    assert diffs[:, :2].max() <= SOLVE_ATOL, f"{name}: action / Σ {diffs[:, :2]}"
    assert diffs[:, 2:].max() <= POSE_ATOL, f"{name}: pos_mean / pos_std {diffs[:, 2:]}"


@pytest.mark.parametrize("name", ["covo_online", "covo_speculative", "mppi"])
def test_parity_solve_matches_jax(name):
    """JAX's default configuration (parity, fwd_fwd, eigh, debug poses):
    two chained solves, 2e-4 on the action and Σ, 1e-4 on the poses."""
    _assert_within(_solve_pair(name), name)


@pytest.mark.parametrize("rng_mode,hessian_mode,sigma_mode", [
    ("parity", "fwd_fwd", "eigh"), ("invariant", "adjoint", "ns")])
def test_offline_schedule_and_solve_match_jax(rng_mode, hessian_mode, sigma_mode):
    """Offline: the schedule's key chain bit for bit, its states, its Σ at
    the first states, and two solves on it (parity's per-solve Cholesky,
    invariant's stored factor)."""
    _assert_within(_offline_pair(rng_mode, hessian_mode, sigma_mode), "covo_offline")


@pytest.mark.parametrize("name,hessian_mode,sigma_mode", [
    ("covo_online", "gn", "ns"), ("mppi", "gn", "ns")])
def test_invariant_solve_matches_jax(name, hessian_mode, sigma_mode):
    _assert_within(_solve_pair(name, "invariant", hessian_mode, sigma_mode), name)


@pytest.mark.parametrize("name,hessian_mode", [("covo_online", "sensitivity")])
def test_parity_solve_under_periodic_matches_jax(name, hessian_mode):
    """The disturbance's uniform draws through the key chains: the
    rollout's (step key), the Hessian's (a split a step)."""
    _assert_within(_solve_pair(name, hessian_mode=hessian_mode, disturb="periodic",
                               solves=1), name)


def test_random_solver_draws_jaxs_normals():
    jenv, env = make_envs()
    jsolver, _ = j_get_solver(jenv, "random")
    solver, _ = get_solver(env, "random")
    key = jax.random.PRNGKey(4)
    ja, _, _ = jsolver(None, None, None, key, None)
    a, _, _ = solver(None, None, None, None, key=words(key))
    np.testing.assert_allclose(a, ja, atol=1e-6)


def test_key_drawing_solvers_refuse_to_run_without_a_key():
    """Nothing falls back to the generators: a parity or invariant solve
    without a key raises, and so does a parity runner given a generator."""
    from covo_mpc_tpu_torch.runtime.episode import make_episode_runner

    _, env = make_envs()
    _, _, state = env.reset(prng.PRNGKey(0))
    for name, mode in (("covo_online", "parity"), ("mppi", "invariant"),
                       ("random", "parity")):
        solver, cp = get_solver(env, name, "N8_H2_lam0.01", rng_mode=mode,
                                hessian_mode="gn", sigma_mode="eigh" if mode == "parity"
                                else "ns")
        assert solver.draws_from_keys
        with pytest.raises(ValueError, match="key"):
            solver(None, state, env.default_params, cp, None)
        with pytest.raises(ValueError, match="key"):
            make_episode_runner(env, solver, steps=2)(torch.Generator(), torch.Generator())


def test_get_solver_takes_jaxs_defaults():
    """JAX's get_solver defaults: parity, fwd_fwd, eigh, debug poses, on the
    plain engine (which "auto" picks under collect_debug)."""
    _, env = make_envs()
    covo, _ = get_solver(env, "covo_online", "N8_H2_lam0.01")
    assert (covo.rng_mode, covo.hessian_mode, covo.sigma_mode, covo.collect_debug,
            covo.engine) == ("parity", "fwd_fwd", "eigh", True, "torch")
    assert covo.draws_from_keys and not covo.capturable
    mppi, _ = get_solver(env, "mppi", "N8_H2_lam0.01")
    assert (mppi.rng_mode, mppi.collect_debug, mppi.engine) == ("parity", True, "torch")
    fast, _ = get_solver(env, "covo_online", "N8_H2_lam0.01", engine="cuda",
                         rng_mode="kernel", hessian_mode="gn", sigma_mode="ns",
                         collect_debug=False)
    assert not fast.draws_from_keys and fast.capturable
