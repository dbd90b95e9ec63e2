"""JAX's randomized-config net, its CoVO offline cases on the CPU: JAX's
300-state schedule under fwd_fwd runs for minutes here, so the reset is
held piece by piece, as ``tests/test_torch_parity.py``'s offline pair
holds it: the schedule's keys bit for bit, its states within 1e-4, Σ and
its factor at the first :data:`OFFLINE_FIRST` states within 2e-4 (the
factor up to its eigenbasis under eigh), then one solve at time 0 on
JAX's Σ (``tests/test_torch_random_configs.py`` holds the contract and the
env of every case)."""

import jax
import numpy as np
import pytest
import torch

from covo_mpc_tpu_torch.ops.rollout import hessian_draws_from_key
from covo_mpc_tpu_torch.solvers import covo_params_from_numpy
from tests.test_torch_models import leaves, to_torch_params, to_torch_state
from tests.test_torch_parity import jax_to_states, words
from tests.test_torch_random_configs import (
    RESET_KEY,
    SOLVE_ATOL,
    assert_solve_within,
    assert_tree_close,
    eigh_basis,
    reset_pair,
    solve_and_compare,
    solved_on_the_cpu,
    solver_pair,
)

SCHEDULE_ATOL = 1e-4  # 300 closed-loop fp32 steps (test_torch_modes)
OFFLINE_FIRST = 2


@pytest.mark.parametrize("c", solved_on_the_cpu("covo_offline"))
def test_offline_schedule_and_solve_match_jax(c):
    jenv, env, jstate, jinfo = reset_pair(c)
    jsolver, jcp, solver, cp = solver_pair(c, jenv, env)
    jp, p = jenv.default_params, to_torch_params(jenv.default_params)
    reset_key = jax.random.PRNGKey(RESET_KEY)
    jstates, jkeys = jax.jit(jsolver.offline_schedule_inputs)(jstate, jp, reset_key)
    keys, disturb = solver.offline_schedule_keys(words(reset_key))
    assert torch.equal(keys, words(jkeys))
    states = solver.offline_schedule_inputs(to_torch_state(jstate), p, disturb)
    assert_tree_close(states, jstates, SCHEDULE_ATOL, "schedule")

    sub = jax.tree.map(lambda x: x[:OFFLINE_FIRST], jstates)
    j_cov, j_fac = jax.jit(jax.vmap(lambda s, k: jsolver.offline_sigma_at(
        s, k, jp, jcp.sample_sigma)))(sub, jkeys[:OFFLINE_FIRST])
    first = keys[:OFFLINE_FIRST]
    kw = {} if solver.draws_from_keys else dict(
        step_draws=solver._nominal_draws_from_keys(first),
        hess_draws=hessian_draws_from_key(env, first, solver.H))
    a_cov, factor = solver.offline_sigma_at(jax_to_states(sub, to_torch_state(jstate)), p,
                                            cp.sample_sigma, first, **kw)
    np.testing.assert_allclose(a_cov.numpy(), np.asarray(j_cov), atol=SOLVE_ATOL)
    for b in range(OFFLINE_FIRST):
        if c["sigma"] == "eigh":
            Q = eigh_basis(factor[b], j_fac[b], a_cov[b])
            print(f"state {b}: {int((np.diag(Q) < 0).sum())} of {len(Q)} eigh factor "
                  "columns' signs differ from JAX's")
        else:
            np.testing.assert_allclose(factor[b].numpy(), np.asarray(j_fac[b]),
                                       atol=SOLVE_ATOL)

    jcp = jcp.replace(a_cov_offline=j_cov, a_factor_offline=j_fac)
    cp = covo_params_from_numpy(leaves(jcp), device="cpu")
    assert_solve_within(*solve_and_compare(c, jenv, env, jsolver, solver, jcp, cp,
                                           jstate, jinfo))
