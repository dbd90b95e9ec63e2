"""Every controller in the port's batched protocol: JAX's key schedule and
the twins of CoVO speculative, offline and ``eigh``, against the JAX
package and against the port's single solvers.

At a small size (B = 1-3 episodes, N=16, H=4, 12-step episodes) on the
CPU, where every kernel wrapper takes its plain version. Tolerances:

- the protocol's reset and run keys equal JAX's ``evaluate_batched`` keys
  bit for bit, so do each episode's reset uniforms (its obs-noise normals
  within 2 ulp, ``utils/prng.normal``'s contract), and its reset state is
  JAX's within tests/test_torch_models.py's ATOL, 1e-5 (the trajectory
  generators' float32 trig, XLA against PyTorch: 3e-6 on this input);
- Random parity's per-episode means within 1e-4 of JAX's
  ``evaluate_batched`` (its actions do not feed back, so whole episodes
  compare);
- the feedback controllers' per-episode err_pos within 1e-3 of JAX's
  ``jax.vmap`` of its episode runner over the same keys for 12 steps, as
  tests/test_torch_parity_episode.py holds the single loop (past that,
  chaos amplifies ulps). CoVO offline runs ``hessian_mode="gn"``: JAX's
  fwd_fwd offline schedule takes minutes to compile on the CPU;
- JAX's fast modes draw from streams the port does not share, so the fast
  twins are held against the port's single solver at B=1 within 2e-4
  (BASELINE.md's per-solve contract) on the same normals and draws, and
  their episodes in a batch against the same episodes run one by one bit
  for bit (each episode draws from its own generators).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from covo_mpc_tpu.runtime.episode import make_episode_runner as j_make_episode_runner
from covo_mpc_tpu.runtime.eval import evaluate_batched as j_evaluate_batched
from covo_mpc_tpu.solvers import get_solver as j_get_solver
from covo_mpc_tpu_torch.models.batched import BatchedEnv
from covo_mpc_tpu_torch.models.structs import (
    expand_params,
    index,
    pack_state,
    stack,
    tree_flatten,
)
from covo_mpc_tpu_torch.parallel import batched_controller, make_batched_covo_solve
from covo_mpc_tpu_torch.runtime import evaluate_batched, make_batched_episode_runner
from covo_mpc_tpu_torch.runtime.episode import batched_keys
from covo_mpc_tpu_torch.solvers import get_solver
from tests.test_torch_models import ATOL, STATE_FIELDS, make_envs, reset_draws_from_key

PSTR = "N16_H4_lam0.01"
N, H = 16, 4
STEPS = 12
FAST = dict(rng_mode="fast", hessian_mode="gn", sigma_mode="ns", collect_debug=False,
            engine="torch")


def words(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


@functools.lru_cache(maxsize=None)
def _envs():
    return make_envs()


def _jax_batched_keys(seed: int, num_eps: int):
    base = jax.random.PRNGKey(seed)
    return (jax.random.split(jax.random.fold_in(base, 0), num_eps),
            jax.random.split(jax.random.fold_in(base, 1), num_eps))


# --- JAX's key schedule in the batched protocol ----------------------------------


def test_batched_keys_and_reset_states_equal_jaxs():
    """The reset and run keys of episodes [lo, hi) are JAX's
    ``split(fold_in(PRNGKey(seed), 0 | 1), num_eps)[lo:hi]`` bit for bit,
    whatever the chunk; the batched env's reset uniforms on them are JAX's
    bit for bit (the obs noise's normals within 2 ulp), and its reset
    states JAX's (ATOL)."""
    jenv, env = _envs()
    jr, jk = _jax_batched_keys(7, 5)
    reset, run = batched_keys(7, 0, 5, "cpu")
    assert torch.equal(reset, words(jr)) and torch.equal(run, words(jk))
    reset_c, run_c = batched_keys(7, 2, 5, "cpu")
    assert torch.equal(reset_c, reset[2:]) and torch.equal(run_c, run[2:])
    benv = BatchedEnv(env)
    draws = tree_flatten(benv.draw_reset(reset))[0]
    ref = tree_flatten(stack([reset_draws_from_key(jenv, k, jenv.default_params)
                              for k in jr]))[0]
    assert len(draws) == len(ref) == 4  # trajectory (2), force, obs noise
    assert all(torch.equal(a, b) for a, b in zip(draws[:3], ref[:3]))
    assert float((draws[3] - ref[3]).abs().max()) <= 2 * 2.0**-23
    _, _, jstates = jax.vmap(lambda k: jenv.reset(k, jenv.default_params))(jr)
    _, _, states = benv.reset(reset, env.default_params)
    for f in STATE_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(states, f)),
                                   np.asarray(getattr(jstates, f)), atol=ATOL,
                                   err_msg=f)


def test_random_parity_evaluate_batched_matches_jax():
    """Random under parity: evaluate_batched's per-episode means within 1e-4
    of JAX's evaluate_batched (num_eps=2, seed=2: the full 300 steps, the
    auto-reset's keys included)."""
    jenv, env = _envs()
    ref = j_evaluate_batched(jenv, j_get_solver(jenv, "random")[0], num_eps=2, seed=2)
    ours = evaluate_batched(env, get_solver(env, "random")[0], num_eps=2, seed=2)
    np.testing.assert_allclose(ours.err_pos_ep.numpy(), np.asarray(ref.err_pos_ep),
                               atol=1e-4)


@pytest.mark.parametrize("name, kw", [
    ("mppi", {}),
    ("covo_online", {}),
    ("covo_speculative", dict(hessian_mode="gn")),
    ("covo_offline", dict(rng_mode="invariant", hessian_mode="gn", sigma_mode="ns")),
], ids=["mppi-parity", "covo_online-parity-fwd_fwd-eigh", "covo_speculative-parity-gn",
        "covo_offline-invariant-gn"])
def test_keyed_batched_episodes_follow_jax(name, kw):
    """B=2 episodes of the batched runner on JAX's keys against JAX's vmap
    of its episode runner over the same keys (evaluate_batched's program,
    12 steps): per-episode err_pos within 1e-3, the dones equal. JAX's
    defaults are the parity path (fwd_fwd, eigh); the others name theirs."""
    jenv, env = _envs()
    jsolver, _ = j_get_solver(jenv, name, PSTR, **kw)
    solver, _ = get_solver(env, name, PSTR, **kw)
    jrun = j_make_episode_runner(jenv, jsolver, steps=STEPS)
    jr, jk = _jax_batched_keys(1, 2)
    _, jerr, jdone, _ = jax.jit(jax.vmap(lambda a, b: jrun(a, b, None)))(jr, jk)
    err, done = make_batched_episode_runner(env, solver, steps=STEPS)(1, 0, 2)
    assert np.isfinite(err.numpy()).all()
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), atol=1e-3)
    assert np.array_equal(done.numpy(), np.asarray(jdone))


# --- the fast twins against the single solvers (B=1) ------------------------------


def _b1(env, seed=3):
    """One episode's batched reset (B=1) and its unbatched state."""
    gen = torch.Generator().manual_seed(seed)
    obs, info, state = BatchedEnv(env).reset([gen], env.default_params)
    return info, state, index(info, 0), index(state, 0)


def _close(a, b, what):
    assert float((a - b).abs().max()) <= 2e-4, f"{what}: {float((a - b).abs().max())}"


def test_speculative_twin_at_b1_matches_the_single_solver():
    """The speculative twin's reset (step 0's Sigma) and two steps (act, then
    prepare at the model-predicted state) at B=1 against the single solver's
    reset and __call__ on the same normals: actions, means, Sigma and factor
    within 2e-4."""
    _, env = _envs()
    p = env.default_params
    solver, cp = get_solver(env, "covo_speculative", PSTR, **FAST)
    twin = batched_controller(solver)
    info_b, state_b, info, state = _b1(env)
    carry = twin.reset(1, state_b, p, [torch.Generator().manual_seed(0)])
    cp = solver.reset(state, p, cp)
    _close(carry[1][0], cp.a_cov, "reset a_cov")
    _close(carry[2][0], cp.a_factor, "reset a_factor")
    for step in range(2):
        gen = torch.Generator().manual_seed(10 + step)
        z = torch.randn(N, H * 4, generator=torch.Generator().manual_seed(10 + step))
        a_b, carry = twin(state_b, info_b, p, carry, [gen])
        a, cp, _ = solver(None, state, p, cp, info, z=z)
        _close(a_b[0], a, f"step {step} action")
        for got, ref, what in zip(carry, (cp.a_mean, cp.a_cov, cp.a_factor),
                                  ("a_mean", "a_cov", "a_factor")):
            _close(got[0], ref, f"step {step} {what}")


def test_offline_twin_at_b1_matches_the_single_solver():
    """The offline twin's reset (the episode's 300-step Sigma schedule from
    its generator's expansion draws) and one step at B=1 against the single
    solver's reset on the same draws and solve on the same normals."""
    _, env = _envs()
    p = env.default_params
    solver, cp = get_solver(env, "covo_offline", PSTR, **FAST)
    twin = batched_controller(solver)
    info_b, state_b, info, state = _b1(env)
    carry = twin.reset(1, state_b, p, [torch.Generator().manual_seed(5)])
    solver.device_generator.manual_seed(5)  # the expansion episode's draws
    cp = solver.reset(state, p, cp)
    _close(carry[1][0], cp.a_cov_offline, "a_cov_offline")
    _close(carry[2][0], cp.a_factor_offline, "a_factor_offline")
    z = torch.randn(N, H * 4, generator=torch.Generator().manual_seed(8))
    a_b, carry = twin(state_b, info_b, p, carry, [torch.Generator().manual_seed(8)])
    a, cp, _ = solver(None, state, p, cp, info, z=z)
    _close(a_b[0], a, "action")
    _close(carry[0][0], cp.a_mean, "a_mean")


def test_batched_eigh_solve_at_b1_matches_the_single_solver():
    """The batched solve with the eigh designer (B=1, invariant keys, the
    sensitivity Hessian) against the single online solver on the same key:
    the action and the new mean within 2e-4; the solve is not capturable
    (eigh reads the host)."""
    _, env = _envs()
    p = env.default_params
    solver, cp = get_solver(env, "covo_online", PSTR, rng_mode="invariant",
                            hessian_mode="sensitivity", sigma_mode="eigh",
                            collect_debug=False, engine="torch")
    solve = make_batched_covo_solve(env, N, H, 0.01, rng="invariant",
                                    hessian_mode="sensitivity", engine="torch",
                                    sigma_mode="eigh")
    assert not solve.capturable and not solver.capturable
    info_b, state_b, info, state = _b1(env)
    key = words(jax.random.PRNGKey(9))
    a, cp_new, _ = solver(None, state, p, cp, info, key=key)
    noisy = info_b["noisy_state"]
    means, _ = solve(pack_state(noisy), noisy.time, noisy.pos_traj, noisy.vel_traj,
                     cp.a_mean[None], expand_params(p, 1), key=key[None])
    _close(means[0], cp_new.a_mean, "a_mean")
    _close(means[0, 0], a, "action")


@pytest.mark.parametrize("name", ["covo_speculative", "covo_offline"])
def test_fast_twin_episodes_equal_the_episodes_one_by_one(name):
    """evaluate_batched's runner (fast rng, 2 episodes, 6 steps) equals the
    same episodes run one at a time (B=1) bit for bit: each episode draws
    from its own generators, so nothing depends on its batch."""
    _, env = _envs()
    solver, _ = get_solver(env, name, PSTR, **FAST)
    run = make_batched_episode_runner(env, solver, steps=6)
    err, _ = run(4, 0, 2)
    one = torch.cat([run(4, e, e + 1)[0] for e in range(2)])
    assert np.isfinite(err.numpy()).all()
    assert torch.equal(err, one)


def test_batched_ns_pallas_still_raises():
    """K8 does not batch (JAX cannot vmap its pallas_call on hardware
    either): online and speculative twins with ns_pallas raise, naming the
    item; offline designs with the plain designer, as its single solver."""
    _, env = _envs()
    for name in ("covo_online", "covo_speculative"):
        solver, _ = get_solver(env, name, PSTR, **{**FAST, "sigma_mode": "ns_pallas"})
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            batched_controller(solver)
    solver, _ = get_solver(env, "covo_offline", PSTR, **{**FAST, "sigma_mode": "ns_pallas"})
    assert batched_controller(solver).solve.sigma_mode == "ns"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_batched_covo_solve(env, N, H, 0.01, engine="torch", sigma_mode="ns_pallas")
