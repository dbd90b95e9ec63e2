"""The port's speculative and offline CoVO modes, ``sigma_mode="ns_pallas"``
on the CPU, the closed loops of the new solvers, and the card defaults,
against the JAX package where it has a counterpart.

Speculative and offline solves are held against JAX's ``CoVOSolver(
engine="jnp", rng_mode="fast", hessian_mode="gn", sigma_mode="ns")`` on
the same state, params and normals (the port is handed the z JAX's fast
sampler draws: act_key = split(rng_act)[1]); the offline schedule against
JAX's with JAX's step draws injected. Per-solve contract (BASELINE.md):
2e-4 on actions, means and covariances.
"""

import jax
import numpy as np
import pytest
import torch

from covo_mpc_tpu.models import dynamics as jdyn
from covo_mpc_tpu.solvers import get_solver as j_get_solver
from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv
from covo_mpc_tpu_torch.models.quad_env import StepDraws
from covo_mpc_tpu_torch.models.structs import EnvParams3D, state_from_numpy
from covo_mpc_tpu_torch.ops import covariance, covariance_cuda, rollout_cuda
from covo_mpc_tpu_torch.parallel import make_batched_covo_solve, make_batched_mppi_solve
from covo_mpc_tpu_torch.runtime import evaluate
from covo_mpc_tpu_torch.solvers import (
    FAST_PATH,
    covo_params_from_numpy,
    get_solver,
    resolve_engine,
)
from tests.test_torch_models import (
    STATE_FIELDS,
    leaves,
    make_envs,
    t,
    to_torch_params,
    to_torch_state,
)

N, H = 1024, 8
D = 4 * H
PSTR = f"N{N}_H{H}_lam0.01"
JKW = dict(rng_mode="fast", hessian_mode="gn", sigma_mode="ns", engine="jnp",
           collect_debug=False)
KW = dict(rng_mode="fast", hessian_mode="gn", sigma_mode="ns", engine="torch",
          collect_debug=False)
TOL = 2e-4


def _z(key, n=N, d=D):
    """The normals JAX's fast sampler draws from ``rng_act``."""
    return torch.from_numpy(np.array(jax.random.normal(jax.random.split(key)[1], (n, d))))


def _close(got, ref, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, err_msg=msg)


def _cp(jcp):
    return covo_params_from_numpy(leaves(jcp), device="cpu")


@pytest.fixture(scope="module")
def spec():
    """JAX's and the port's speculative solvers, JAX's reset state, and
    JAX's cold-start params at it."""
    jenv, env = make_envs()
    jsolver, jcp = j_get_solver(jenv, "covo_speculative", PSTR, **JKW)
    solver, _ = get_solver(env, "covo_speculative", PSTR, **KW)
    jp = jenv.default_params
    obs, info, state = jenv.reset_env(jax.random.PRNGKey(0), jp)
    jcp1 = jsolver.reset(state, jp, jcp, jax.random.PRNGKey(1))
    return dict(jsolver=jsolver, solver=solver, jcp=jcp, jcp1=jcp1, jp=jp,
                p=to_torch_params(jp), state=state, info=info,
                tinfo={"noisy_state": to_torch_state(info["noisy_state"])})


def test_speculative_reset_matches_jax(spec):
    """The cold start designs step 0's Sigma at the reset state around the
    shifted initial nominal."""
    cp = spec["solver"].reset(to_torch_state(spec["state"]), spec["p"], _cp(spec["jcp"]))
    _close(cp.a_cov, spec["jcp1"].a_cov, "a_cov")
    _close(cp.a_factor, spec["jcp1"].a_factor, "a_factor")
    torch.testing.assert_close(cp.a_factor @ cp.a_factor.T, cp.a_cov, atol=2e-6, rtol=0)


def test_speculative_act_matches_jax(spec):
    """act() samples with the stored factor: action and a_mean within 2e-4
    on JAX's normals; Sigma is left as it was."""
    key = jax.random.PRNGKey(5)
    a_ref, jcp2, _ = spec["jsolver"].act(None, spec["state"], spec["jp"], key,
                                         spec["jcp1"], spec["info"])
    cp1 = _cp(spec["jcp1"])
    a, cp2, _ = spec["solver"].act(None, to_torch_state(spec["state"]), spec["p"],
                                   cp1, spec["tinfo"], z=_z(key))
    _close(a, a_ref, "action")
    _close(cp2.a_mean, jcp2.a_mean, "a_mean")
    assert cp2.a_cov is cp1.a_cov and cp2.a_factor is cp1.a_factor


def test_speculative_prepare_matches_jax(spec):
    """prepare() after an act: one deterministic model step with the new
    a_mean[0] from the noisy state, then the design around the shifted
    nominal; a_cov and a_factor within 2e-4."""
    key = jax.random.PRNGKey(5)
    _, jcp2, _ = spec["jsolver"].act(None, spec["state"], spec["jp"], key,
                                     spec["jcp1"], spec["info"])
    jcp3 = spec["jsolver"].prepare(spec["state"], spec["jp"], jcp2,
                                   jax.random.PRNGKey(6), spec["info"])
    cp3 = spec["solver"].prepare(to_torch_state(spec["state"]), spec["p"], _cp(jcp2),
                                 spec["tinfo"])
    _close(cp3.a_cov, jcp3.a_cov, "a_cov")
    _close(cp3.a_factor, jcp3.a_factor, "a_factor")


@pytest.mark.parametrize("engine,rng_mode", [("torch", "fast"), ("cuda", "kernel")])
def test_speculative_call_is_act_plus_prepare(engine, rng_mode):
    """__call__ is exactly act() then prepare(), the same draws consumed."""
    _, env = make_envs()
    kw = dict(rng_mode=rng_mode, engine=engine, sigma_mode="ns_pallas", seed=4,
              hessian_mode="gn", collect_debug=False)
    s1, cp = get_solver(env, "covo_speculative", "N64_H4_lam0.01", **kw)
    s2, _ = get_solver(env, "covo_speculative", "N64_H4_lam0.01", **kw)
    _, info, st = env.reset(torch.Generator().manual_seed(2))
    cp = s1.reset(st, env.default_params, cp)
    a1, cp1, _ = s1(None, st, env.default_params, cp, info)
    a2, cp2, _ = s2.act(None, st, env.default_params, cp, info)
    cp2 = s2.prepare(st, env.default_params, cp2, info)
    assert torch.equal(a1, a2)
    for name in ("a_mean", "a_cov", "a_factor"):
        assert torch.equal(getattr(cp1, name), getattr(cp2, name)), name
    assert float((cp1.a_cov - cp.a_cov).abs().max()) > 1e-8  # a new Sigma


def test_speculative_mode_guards_and_factory():
    """"spec" / "latency" select the speculative mode with the isotropic
    cold-start factor; act() and prepare() raise outside it."""
    _, env = make_envs()
    for name in ("covo_speculative", "covo_latency"):
        solver, cp = get_solver(env, name, "N64_H4_lam0.01", **FAST_PATH)
        assert solver.mode == "speculative"
        torch.testing.assert_close(cp.a_factor @ cp.a_factor.T, cp.a_cov, atol=1e-7,
                                   rtol=0)
        assert solver.reset() is cp and solver.reset(None, None, cp) is cp
    onl, cp = get_solver(env, "covo_online", "N64_H4_lam0.01", **FAST_PATH)
    _, info, st = env.reset(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="speculative"):
        onl.act(None, st, env.default_params, cp, info)
    with pytest.raises(ValueError, match="speculative"):
        onl.prepare(st, env.default_params, cp)
    offline = get_solver(env, "covo_offline_latency", "N64_H4_lam0.01", **FAST_PATH)[0]
    assert offline.mode == "offline"


def test_speculative_matches_online_when_prediction_exact():
    """With no disturbance and no observation noise the model prediction is
    exact, so the speculative solver designs the Sigma the online solver
    designs one step later and, with the same draws, acts the same."""
    env = QuadEnv(EnvConfig(task="tracking_zigzag", enable_randomizer=False,
                            disturb_type="none", disable_rollover_terminate=True,
                            generate_noisy_state=False), device="cpu")
    spec_s, cp_s = get_solver(env, "covo_speculative", "N64_H4_lam0.01", **KW)
    onl, cp_o = get_solver(env, "covo_online", "N64_H4_lam0.01", **KW)
    p = env.default_params
    _, _, state = env.reset(torch.Generator().manual_seed(0), p)
    cp_s, cp_o = spec_s.reset(state, p, cp_s), onl.reset(state, p, cp_o)
    so = oo = state
    for step in range(4):
        a_s, cp_s, _ = spec_s(None, so, p, cp_s, None)
        a_o, cp_o, _ = onl(None, oo, p, cp_o, None)
        np.testing.assert_allclose(a_s.numpy(), a_o.numpy(), atol=1e-5,
                                   err_msg=f"step {step}")
        draws = StepDraws(disturb=torch.zeros(3), obs_noise=None)
        so = env.step_from_draws(draws, so, a_s, p, deterministic=True)[1]
        oo = env.step_from_draws(draws, oo, a_o, p, deterministic=True)[1]


# --- offline ---------------------------------------------------------------


def _schedule_draws(key, steps):
    """The disturbance normals JAX's offline_schedule_inputs draws: per
    step, the PID split, then the step key's dynamics draw."""
    def body(k, _):
        _, k = jax.random.split(k)
        rng_step, k = jax.random.split(k)
        return k, jax.random.normal(jdyn.derive_dynamics_keys(rng_step), (3,))

    return np.asarray(jax.lax.scan(body, key, None, length=steps)[1])


@pytest.fixture(scope="module")
def offline():
    """JAX's and the port's offline solvers, JAX's reset state and its
    schedule inputs."""
    jenv, env = make_envs()
    jsolver, jcp = j_get_solver(jenv, "covo_offline", PSTR, **JKW)
    solver, _ = get_solver(env, "covo_offline", PSTR, **KW)
    jp = jenv.default_params
    obs, info, state = jenv.reset_env(jax.random.PRNGKey(0), jp)
    key = jax.random.PRNGKey(7)
    states, keys = jsolver.offline_schedule_inputs(state, jp, key)
    return dict(jsolver=jsolver, solver=solver, jcp=jcp, jp=jp, p=to_torch_params(jp),
                state=state, info=info, key=key, states=states, keys=keys)


def test_offline_schedule_inputs_match_jax(offline):
    """The 300-step PID expansion episode (stochastic steps, JAX's draws
    injected): every schedule state within 1e-4 (a closed loop of 300 fp32
    steps; each step alone agrees to 1e-5, test_torch_models)."""
    steps = offline["jsolver"].env.default_params.max_steps_in_episode
    disturb = t(_schedule_draws(offline["key"], steps))
    got = offline["solver"].offline_schedule_inputs(
        to_torch_state(offline["state"]), offline["p"], disturb=disturb)
    ref = offline["states"]
    assert got.time.shape == (steps,)
    for f in STATE_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   atol=1e-4, err_msg=f)


def _jax_sigma_at(offline, n):
    jsolver, jp = offline["jsolver"], offline["jp"]
    head = jax.tree_util.tree_map(lambda x: x[:n], (offline["states"], offline["keys"]))
    return jax.vmap(lambda s, k: jsolver.offline_sigma_at(s, k, jp, 0.5))(*head)


def test_offline_sigma_at_matches_jax(offline):
    """The schedule's Sigma at JAX's first 10 schedule states, batched (no
    loop over the states), against JAX's vmapped offline_sigma_at."""
    c_ref, f_ref = _jax_sigma_at(offline, 10)
    states = state_from_numpy(
        {k: v[:10] for k, v in leaves(offline["states"]).items()}, device="cpu")
    c, f = offline["solver"].offline_sigma_at(states, offline["p"], 0.5)
    assert c.shape == (10, D, D)
    _close(c, c_ref, "a_cov_offline")
    _close(f, f_ref, "a_factor_offline")


def test_offline_solve_matches_jax(offline):
    """One offline solve at the reset state (time 0) reads step 0 of the
    schedule: action, a_mean and a_cov within 2e-4 on JAX's normals."""
    c_ref, f_ref = _jax_sigma_at(offline, 2)
    jcp = offline["jcp"].replace(a_cov_offline=c_ref, a_factor_offline=f_ref)
    key = jax.random.PRNGKey(9)
    a_ref, jcp1, _ = offline["jsolver"](None, offline["state"], offline["jp"], key,
                                        jcp, offline["info"])
    tinfo = {"noisy_state": to_torch_state(offline["info"]["noisy_state"])}
    a, cp1, _ = offline["solver"](None, to_torch_state(offline["state"]),
                                  offline["p"], _cp(jcp), tinfo, z=_z(key))
    _close(a, a_ref, "action")
    _close(cp1.a_mean, jcp1.a_mean, "a_mean")
    _close(cp1.a_cov, jcp1.a_cov, "a_cov")
    with pytest.raises(ValueError, match="reset"):
        offline["solver"](None, to_torch_state(offline["state"]), offline["p"],
                          _cp(offline["jcp"]), tinfo)


# --- sigma_mode="ns_pallas" on the CPU -----------------------------------------


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_ns_pallas_on_cpu_is_the_plain_designer(engine):
    """On CPU tensors "ns_pallas" runs the plain designer: an online solve
    equals the "ns" solve bit for bit; on engine="cuda" the solver holds
    the K8 wrapper, on "torch" and in offline mode the plain designer."""
    _, env = make_envs()
    kw = dict(rng_mode="fast", engine=engine, seed=1, hessian_mode="gn",
              collect_debug=False)
    s_k, cp = get_solver(env, "covo_online", "N64_H4_lam0.01", sigma_mode="ns_pallas", **kw)
    s_p, _ = get_solver(env, "covo_online", "N64_H4_lam0.01", sigma_mode="ns", **kw)
    expected = (covariance_cuda.optimize_sigma_ns_cuda if engine == "cuda"
                else covariance.optimize_sigma_ns)
    assert s_k._optimize_sigma is expected
    off, _ = get_solver(env, "covo_offline", "N64_H4_lam0.01", sigma_mode="ns_pallas", **kw)
    assert off._optimize_sigma is covariance.optimize_sigma_ns
    obs, info, st = env.reset(torch.Generator().manual_seed(3))
    out_k = s_k(obs, st, env.default_params, cp, info)
    out_p = s_p(obs, st, env.default_params, cp, info)
    assert torch.equal(out_k[0], out_p[0])
    assert torch.equal(out_k[1].a_mean, out_p[1].a_mean)
    assert torch.equal(out_k[1].a_cov, out_p[1].a_cov)


# --- closed loops ----------------------------------------------------------------


def test_closed_loops_of_the_new_solvers():
    """One 300-step episode each on the CPU (N=64, H=4): speculative,
    offline, PID and random give a finite err_pos; PID and the CoVO modes
    track better than random actions."""
    _, env = make_envs()
    err = {}
    for name in ("covo_speculative", "covo_offline", "pid", "random"):
        solver, _ = get_solver(env, name, "N64_H4_lam0.01", sigma_mode="ns_pallas",
                               rng_mode="fast", hessian_mode="gn", collect_debug=False)
        result = evaluate(env, solver, total_steps=300, seed=1)
        assert result.err_pos_ep.shape == (1,) and np.isfinite(result.mean), name
        err[name] = result.mean
    assert all(err[k] < err["random"] for k in ("covo_speculative", "covo_offline", "pid")), err


# --- the card defaults -----------------------------------------------------------


def test_entry_points_default_to_the_card():
    """Without a CUDA device, the env and its params refuse the default (the
    card) instead of running on the CPU; on a CPU env, engine="auto"
    resolves to the plain path in every factory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QuadEnv(EnvConfig(task="tracking_zigzag"))
    with pytest.raises((RuntimeError, AssertionError)):
        EnvParams3D.default()
    _, env = make_envs()
    assert resolve_engine(env, "auto") == "torch"
    assert resolve_engine(type("Env", (), {"device": torch.device("cuda")}), "auto") == "cuda"
    covo, _ = get_solver(env, "covo_online", "N64_H4_lam0.01", **FAST_PATH)
    assert covo.engine == "torch"
    mppi, _ = get_solver(env, "mppi", "N64_H4_lam0.01", rng_mode="fast", collect_debug=False)
    assert not isinstance(mppi.rollout, rollout_cuda.RolloutCosts)
    assert make_batched_covo_solve(env, 64, 4, 0.01).engine == "torch"
    assert make_batched_mppi_solve(env, 64, 4, 0.01).engine == "torch"
