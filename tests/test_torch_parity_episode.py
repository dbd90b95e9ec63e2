"""The port's closed loop against the JAX package's on one key chain.

BASELINE.md's closed-loop contract (tests/test_parity_episode.py), at its
configuration: tracking_zigzag, N=32, H=8, the parity path (JAX's
defaults), the episode's key chain from PRNGKey(1) and the reset from
PRNGKey(100), stepped as JAX's episode runner steps it
(runtime/episode.py: ``rng, rng_act, rng_step, _ = split(rng, 4)``, then
``rng = split(rng)[0]``). Both loops run closed, each on its own state:

1. the first 3 solves' actions agree within 1e-4;
2. the actions agree within 1e-3 for 12 steps (past that, chaos amplifies
   ulps, as BASELINE.md measures).

Then the runners themselves: the port's ``make_episode_runner`` and
``evaluate`` on keys give JAX's per-step errors and per-episode means.
"""

import jax
import numpy as np
import pytest
import torch

from covo_mpc_tpu.runtime.episode import make_episode_runner as j_make_episode_runner
from covo_mpc_tpu.runtime.eval import evaluate as j_evaluate
from covo_mpc_tpu.solvers import get_solver as j_get_solver
from covo_mpc_tpu_torch.runtime.episode import make_episode_runner
from covo_mpc_tpu_torch.runtime.eval import evaluate, key_protocol
from covo_mpc_tpu_torch.solvers import get_solver
from covo_mpc_tpu_torch.utils import prng
from tests.test_torch_models import leaves, make_envs

N, H, LAM = 32, 8, 0.01
PSTR = f"N{N}_H{H}_lam{LAM}"
FLOOR = 12  # steps of 1e-3 closed-loop parity (BASELINE.md)


def words(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def _closed_loops(name, steps):
    """JAX's and the port's parity loops from one key chain: (actions,
    actions_ref, pos, pos_ref), each (steps, ...)."""
    jenv, env = make_envs()
    jsolver, _ = j_get_solver(jenv, name, PSTR)  # JAX's defaults: the parity path
    solver, _ = get_solver(env, name, PSTR)  # the port's, the same defaults
    jp, p = jenv.default_params, env.default_params
    jobs, jinfo, jstate = jenv.reset(jax.random.PRNGKey(100), jp)
    obs, info, state = env.reset(prng.PRNGKey(100), p)
    jrng, rng = jax.random.PRNGKey(1), prng.PRNGKey(1)
    j_control, jrng = jax.random.split(jrng)
    t_control, rng = prng.split(rng)
    jcp = jsolver.reset(jstate, jp, jsolver.init_control_params, j_control)
    cp = solver.reset(state, p, solver.init_control_params, key=t_control)
    jstep = jax.jit(jenv.step)
    out = []
    for _ in range(steps):
        jrng, j_act, j_step, _ = jax.random.split(jrng, 4)
        rng, t_act, t_step, _ = prng.split(rng, 4)
        ja, jcp, _ = jsolver(jobs, jstate, jp, j_act, jcp, jinfo)
        a, cp, _ = solver(obs, state, p, cp, info, key=t_act)
        jobs, jstate, _, _, jinfo = jstep(j_step, jstate, ja, jp)
        obs, state, _, _, info = env.step(t_step, state, a, p)
        jrng, rng = jax.random.split(jrng)[0], prng.split(rng)[0]
        assert torch.equal(rng, words(jrng))
        out.append((a.numpy(), np.asarray(ja), state.pos.numpy(), np.asarray(jstate.pos)))
    return [np.stack(x) for x in zip(*out)]


@pytest.mark.parametrize("name", ["covo_online", "mppi"])
def test_closed_loop_on_one_key_chain_matches_jax(name):
    actions, actions_ref, pos, pos_ref = _closed_loops(name, FLOOR)
    diffs = np.abs(actions - actions_ref).max(axis=1)
    assert np.isfinite(actions).all()
    assert diffs[:3].max() < 1e-4, f"{name}: first solves {diffs[:3]}"
    assert diffs.max() <= 1e-3, f"{name}: closed loop {diffs}"
    assert np.abs(pos - pos_ref).max() <= 1e-3


def test_episode_runner_follows_jaxs_key_schedule():
    """make_episode_runner on keys: JAX's per-step err_pos for 12 steps of
    the MPPI parity loop, and the episode's last key written back into the
    caller's key."""
    jenv, env = make_envs()
    jsolver, _ = j_get_solver(jenv, "mppi", PSTR)
    solver, _ = get_solver(env, "mppi", PSTR)
    jrng, jerr, jdone, _ = j_make_episode_runner(jenv, jsolver, steps=FLOOR)(
        jax.random.PRNGKey(100), jax.random.PRNGKey(1))
    rng = prng.PRNGKey(1)
    err, done, _ = make_episode_runner(env, solver, steps=FLOOR)(prng.PRNGKey(100), rng)
    np.testing.assert_allclose(err, jerr, atol=1e-4)
    assert np.array_equal(done.numpy(), np.asarray(jdone))
    assert torch.equal(rng, words(jrng))


def test_evaluate_runs_jaxs_protocol_on_keys():
    """evaluate with a key-drawing solver (Random under parity: its actions
    do not feed back, so whole episodes stay comparable) gives JAX's
    per-episode means: the reset keys, the episodes' key chain through
    auto-resets and episodes."""
    jenv, env = make_envs()
    jsolver, _ = j_get_solver(jenv, "random")
    solver, _ = get_solver(env, "random")
    ref = j_evaluate(jenv, jsolver, total_steps=600, num_trajs=2, seed=3)
    ours = evaluate(env, solver, total_steps=600, num_trajs=2, seed=3)
    np.testing.assert_allclose(ours.err_pos_ep, ref.err_pos_ep, rtol=1e-4)
    num_eps, reps, reset_keys, rng = key_protocol(env, 1200, 4, 7)
    j_rng, j_meta = jax.random.split(jax.random.PRNGKey(7))
    assert (num_eps, reps) == (4, 1)
    assert torch.equal(reset_keys, words(jax.random.split(j_meta, 4)))
    assert torch.equal(rng, words(j_rng))


def test_parity_defaults_and_leaves_match_jaxs_solver_params():
    """get_solver's defaults build JAX's default solver: the same initial
    params, leaf for leaf."""
    jenv, env = make_envs()
    for name in ("covo_online", "mppi"):
        _, jcp = j_get_solver(jenv, name, PSTR)
        solver, cp = get_solver(env, name, PSTR)
        for k, v in leaves(jcp).items():
            if getattr(cp, k, None) is not None and v.ndim:
                np.testing.assert_allclose(getattr(cp, k), v, atol=1e-7, err_msg=k)
