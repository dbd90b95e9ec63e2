"""The randomized-config net against the JAX package on the CPU: the env
of every case and the MPPI solves here, the CoVO online solves in
``test_torch_random_configs_covo.py``, the offline ones in
``test_torch_random_configs_offline.py`` (three files, so that three
workers share the net).

JAX's net (``tests/test_random_configs.py``: 20 seeded draws of task x obs
x disturbance x domain randomization x controller x N x H x rng x Hessian
x designer, seed 20240820, the same ids) through the port. Each case:

* the env: JAX's and the port's env from one ``EnvConfig``, reset from
  ``PRNGKey(0)``, then one step under the action 0.1 from ``PRNGKey(1)``:
  obs, reward, done, every state leaf and every info entry within 1e-5 and
  finite (:func:`test_env_reset_and_step_match_jax`, every case);
* the solve (not the four kernel-rng cases, whose draws exist only in the
  CUDA kernels: ``chip_smoke.py`` phase 15 runs them on the card): the
  port's ``engine="torch"`` solver against JAX's ``engine="jnp"`` one, the
  case's settings, reset from ``PRNGKey(7)`` and called with ``PRNGKey(3)``
  as JAX's net does. Parity and invariant draw from JAX's keys; fast takes
  JAX's normals and disturbance draws through the solver's ``z=``,
  ``draw=`` and ``hess_draws=``. BASELINE.md's contract: the action, the
  new mean and (CoVO) Σ within 2e-4; and every sample's cost, the port's
  against JAX's rollout on the same actions and key, within atol 2e-4,
  rtol 1e-5 (the JAX kernel tests'). Offline (JAX's 300-state schedule
  under fwd_fwd runs for minutes here) is held piece by piece, as
  ``tests/test_torch_parity.py``'s offline pair: the schedule's keys bit for
  bit, its states within 1e-4, Σ and its factor at its first two states
  within 2e-4, then one solve at time 0 on JAX's Σ.

The eigh designer's sampling factor is the eigen square root U diag(s),
whose columns' signs (and basis inside a cluster of near-equal
eigenvalues) are the LAPACK routine's choice: JAX's and torch's differ.
Where a solve samples with it (eigh under fast or invariant rng), the
port's factor is held to JAX's up to an orthogonal Q (Qᵀ Q = I within
1e-3, and F Fᵀ = Σ within 2e-4), and the solve samples with it taken into
JAX's basis (F Qᵀ), so that both draw the same actions from the same
normals (:func:`eigh_basis`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covo_mpc_tpu.models import EnvConfig as JEnvConfig
from covo_mpc_tpu.models import QuadEnv as JQuadEnv
from covo_mpc_tpu.solvers import get_solver as j_get_solver
from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv
from covo_mpc_tpu_torch.ops.rollout import hessian_draws_from_key
from covo_mpc_tpu_torch.solvers import get_solver
from tests.test_random_configs import CASES, IDS
from tests.test_torch_models import leaves, t, to_torch_params, to_torch_state
from tests.test_torch_parity import words

ENV_ATOL = 1e-5
SOLVE_ATOL = 2e-4  # BASELINE.md's per-solve contract: action, mean, Σ
COST_ATOL, COST_RTOL = 2e-4, 1e-5
BASIS_ATOL = 1e-3  # Qᵀ Q = I: the eigen square roots' bases
RESET_KEY, SOLVE_KEY = 7, 3  # JAX's net's keys


def case_params(pred=lambda c: True):
    """``pytest.param`` of each of JAX's cases that ``pred`` keeps, under
    JAX's id."""
    return [pytest.param(c, id=i) for c, i in zip(CASES, IDS) if pred(c)]


def make_envs(c):
    kw = dict(task=c["task"], obs_type=c["obs_type"], enable_randomizer=c["randomizer"],
              disturb_type=c["disturb"], disable_rollover_terminate=True,
              generate_noisy_state=True)
    return JQuadEnv(JEnvConfig(**kw)), QuadEnv(EnvConfig(**kw), device="cpu")


def assert_tree_close(ours, ref, atol, msg):
    """Every field of the port's state (or info entry) against JAX's."""
    if dataclasses.is_dataclass(ours):
        for f in dataclasses.fields(ours):
            if f.name != "control_params":
                assert_tree_close(getattr(ours, f.name), getattr(ref, f.name), atol,
                                  f"{msg}.{f.name}")
        return
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, msg
    assert np.isfinite(ours).all(), msg
    np.testing.assert_allclose(ours, ref, atol=atol, err_msg=msg)


def test_the_cases_are_jaxs_and_the_cards():
    """JAX's 20 cases and ids, four under the kernel rng; chip_smoke.py's
    copy of the draw (phase 15) gives the same."""
    import chip_smoke

    assert len(CASES) == 20 and sum(c["rng_mode"] == "kernel" for c in CASES) == 4
    assert chip_smoke.random_config_cases() == (CASES, IDS)


@pytest.mark.parametrize("c", case_params())
def test_env_reset_and_step_match_jax(c):
    jenv, env = make_envs(c)
    jp, p = jenv.default_params, env.default_params
    for name, ref in leaves(jp).items():
        np.testing.assert_allclose(np.asarray(getattr(p, name)), ref, atol=0, err_msg=name)
    jobs, jinfo, jstate = jenv.reset_env(jax.random.PRNGKey(0), jp)
    obs, info, state = env.reset_env(words(jax.random.PRNGKey(0)), p)
    assert obs.shape == (env.obs_dim,) == jobs.shape
    assert_tree_close(obs, jobs, ENV_ATOL, "reset obs")
    assert_tree_close(state, jstate, ENV_ATOL, "reset state")
    for k in jinfo:
        assert_tree_close(info[k], jinfo[k], ENV_ATOL, f"reset info[{k}]")

    a0 = 0.1
    jout = jenv.step(jax.random.PRNGKey(1), jstate, jnp.full((jenv.action_dim,), a0), jp)
    out = env.step(words(jax.random.PRNGKey(1)), state, torch.full((env.action_dim,), a0), p)
    for name, ours, ref in zip(("obs", "state", "reward", "done"), out[:4], jout[:4]):
        assert_tree_close(ours, ref, ENV_ATOL, f"step {name}")
    for k in jout[4]:
        assert_tree_close(out[4][k], jout[4][k], ENV_ATOL, f"step info[{k}]")


# --- the solves ---------------------------------------------------------------------


def solver_pair(c, jenv, env):
    """JAX's jnp solver and the port's torch solver at the case's settings
    (JAX's net's: the Hessian is CoVO's only)."""
    kw = dict(rng_mode=c["rng_mode"], sigma_mode=c["sigma"], collect_debug=False,
              hessian_mode=c["hessian"] if "covo" in c["controller"] else "fwd_fwd")
    pstr = f"N{c['n']}_H{c['h']}_lam0.01"
    jsolver, jcp = j_get_solver(jenv, c["controller"], pstr, engine="jnp", **kw)
    solver, cp = get_solver(env, c["controller"], pstr, engine="torch", **kw)
    return jsolver, jcp, solver, cp


def recording(solver) -> dict:
    """Wrap ``solver.rollout`` to keep the actions it was handed (as (N, H,
    dA)) and the costs it returned."""
    rec, inner = {}, solver.rollout

    def rollout(x0, t0, pos_traj, vel_traj, actions, params, draw, layout="nhd", **kw):
        costs = inner(x0, t0, pos_traj, vel_traj, actions, params, draw, layout=layout,
                      **kw)
        if layout == "hdn":
            actions = actions.reshape(solver.H, solver.action_dim, -1).permute(2, 0, 1)
        rec.update(actions=actions.clone(), costs=costs.clone(),
                   deterministic=kw["deterministic"])
        return costs

    solver.rollout = rollout
    return rec


def solve_keys(rng_act):
    """JAX's chain in a solve: ``rng, act_key = split(rng_act)``, ``rng,
    step_key = split(rng)``."""
    rest, act_key = jax.random.split(rng_act)
    return act_key, jax.random.split(rest)[1]


def fast_inputs(c, env, rng_act):
    """What JAX's fast sampler draws from ``rng_act`` in the port's hooks:
    the normals (MPPI (N, H, dA), CoVO (N, D)) from the act key, the
    rollout's disturbance draw from the step key by the fast chain, and
    (CoVO online) the Hessian's per-step draws from ``rng_act``."""
    act_key, step_key = solve_keys(rng_act)
    N, H = c["n"], c["h"]
    if c["controller"] == "mppi":
        return dict(z=t(jax.random.normal(act_key, (N, H, 4))),
                    draw=env.disturb_from_key(words(step_key), fast=True))
    kw = dict(z=t(jax.random.normal(act_key, (N, 4 * H))),
              draw=env.disturb_from_key(words(step_key), deterministic=True, fast=True))
    if c["controller"] == "covo_online":
        kw["hess_draws"] = hessian_draws_from_key(env, words(rng_act), H)
    return kw


def ess(costs: torch.Tensor, lam: float = 0.01) -> float:
    w = torch.softmax(-costs.double() / lam, dim=0)
    return float(1.0 / (w * w).sum())


def eigh_basis(factor: torch.Tensor, j_factor, a_cov: torch.Tensor) -> np.ndarray:
    """Q with ``factor = j_factor Q``, the port's eigen square root against
    JAX's (the module docstring): checks that Q is orthogonal (1e-3) and
    that ``factor factorᵀ = a_cov`` (2e-4); returns Q (float64)."""
    F, J = factor.double().numpy(), np.asarray(j_factor, np.float64)
    Q = np.linalg.solve(J, F)
    assert np.abs(Q.T @ Q - np.eye(len(Q))).max() <= BASIS_ATOL, "not one eigenbasis"
    np.testing.assert_allclose(F @ F.T, a_cov.double().numpy(), atol=SOLVE_ATOL)
    return Q


def in_jax_basis(solver, j_factor):
    """Have the solver's designer return its factor taken into JAX's basis
    (``F Qᵀ``, :func:`eigh_basis`); returns the number of columns whose
    sign that flips."""
    design, flips = solver._optimize_sigma, []

    def aligned(R, sample_sigma, D):
        a_cov, F = design(R, sample_sigma, D)
        Q = eigh_basis(F, j_factor, a_cov)
        flips.append(int((np.diag(Q) < 0).sum()))
        return a_cov, (F.double() @ torch.from_numpy(Q.T)).float().contiguous()

    solver._optimize_sigma = aligned
    return flips


def samples_with_eigh(c) -> bool:
    return c["sigma"] == "eigh" and c["rng_mode"] != "parity"


def solve_and_compare(c, jenv, env, jsolver, solver, jcp, cp, jstate, jinfo):
    """One solve of each from ``PRNGKey(SOLVE_KEY)`` on JAX's state: the
    action, the new mean and (CoVO) Σ within 2e-4, every sample's cost (the
    port's, against JAX's rollout on the same actions and key) within the
    cost contract. An online solve with the eigh factor samples in JAX's
    basis (:func:`in_jax_basis`). Returns the diffs and the solve's ESS."""
    jp, p = jenv.default_params, to_torch_params(jenv.default_params)
    st = to_torch_state(jstate)
    noisy = jinfo["noisy_state"]
    tinfo = {"noisy_state": to_torch_state(noisy)}
    rng_act = jax.random.PRNGKey(SOLVE_KEY)
    ja, jcp1, _ = jsolver(None, jstate, jp, rng_act, jcp, jinfo)
    flips = None
    if c["controller"] == "covo_online" and samples_with_eigh(c):
        shifted = jcp.replace(a_mean=jnp.concatenate([jcp.a_mean[1:], jcp.a_mean[-1:]]))
        _, j_factor = jax.jit(jsolver._sigma_online)(shifted, noisy, jp, rng_act)
        flips = in_jax_basis(solver, j_factor)
    rec = recording(solver)
    hooks = (fast_inputs(c, env, rng_act) if c["rng_mode"] == "fast"
             else dict(key=words(rng_act)))
    a, cp1, _ = solver(None, st, p, cp, tinfo, **hooks)
    if flips is not None:
        assert len(flips) == 1
        print(f"eigh factor: {flips[0]} of {solver.D} columns' signs flip into JAX's basis")

    # JAX's rollout on the port's actions, from JAX's step key
    from covo_mpc_tpu.models.structs import pack_state as jpack

    j_costs, _ = jax.jit(jsolver.rollout, static_argnames=("deterministic",))(
        jpack(noisy), noisy.time, noisy.pos_traj, noisy.vel_traj,
        jnp.asarray(rec["actions"].numpy()), jp, solve_keys(rng_act)[1],
        deterministic=rec["deterministic"], discount=1.0)
    j_costs = torch.from_numpy(np.array(j_costs))
    diffs = {"action": float((a - t(ja)).abs().max()),
             "a_mean": float((cp1.a_mean - t(jcp1.a_mean)).abs().max())}
    if "covo" in c["controller"]:
        diffs["a_cov"] = float((cp1.a_cov - t(jcp1.a_cov)).abs().max())
    for x in (a, cp1.a_mean, rec["costs"]):
        assert torch.isfinite(x).all()
    assert float(a.abs().max()) <= 1.0 + 1e-6
    cost_excess = float(((rec["costs"] - j_costs).abs()
                         - (COST_ATOL + COST_RTOL * j_costs.abs())).max())
    assert cost_excess <= 0.0, (
        f"costs: max |port - JAX| {float((rec['costs'] - j_costs).abs().max()):.3e} "
        "outside atol 2e-4, rtol 1e-5")
    return diffs, ess(rec["costs"])


def assert_solve_within(diffs, solve_ess):
    print(f"max |port - JAX| {diffs}, ESS {solve_ess:.2f}")  # shown by pytest -rP
    assert all(v <= SOLVE_ATOL for v in diffs.values()), (
        f"{diffs} against {SOLVE_ATOL} (ESS {solve_ess:.2f})")


def reset_pair(c):
    jenv, env = make_envs(c)
    jp = jenv.default_params
    _, jinfo, jstate = jenv.reset_env(jax.random.PRNGKey(0), jp)
    return jenv, env, jstate, jinfo


def online_solve_matches_jax(c):
    """MPPI and CoVO online: one solve of each after the reset."""
    jenv, env, jstate, jinfo = reset_pair(c)
    jsolver, jcp, solver, cp = solver_pair(c, jenv, env)
    jcp = jsolver.reset(jstate, jenv.default_params, jcp, jax.random.PRNGKey(RESET_KEY))
    cp = solver.reset(to_torch_state(jstate), env.default_params, cp,
                      key=words(jax.random.PRNGKey(RESET_KEY)))
    assert_solve_within(*solve_and_compare(c, jenv, env, jsolver, solver, jcp, cp,
                                           jstate, jinfo))


def solved_on_the_cpu(controller):
    """The cases of ``controller`` whose solve runs here (not kernel rng)."""
    return case_params(pred=lambda c: c["rng_mode"] != "kernel"
                       and c["controller"] == controller)


@pytest.mark.parametrize("c", solved_on_the_cpu("mppi"))
def test_mppi_solve_matches_jax(c):
    online_solve_matches_jax(c)
