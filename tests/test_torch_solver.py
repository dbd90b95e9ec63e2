"""The port's CoVO-online solve and its closed loop, against the JAX solver.

One whole solve is held against ``CoVOSolver(engine="jnp",
rng_mode="fast", hessian_mode="gn", sigma_mode="ns")`` on the same state,
params and normals: the port is handed the z that JAX draws from its key
chain (solvers/covo.py:453, ops/sampling.py:40). Per-solve contract
(BASELINE.md): action, a_mean and a_cov within 2e-4.
"""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from covo_mpc_tpu.solvers import get_solver as j_get_solver
from covo_mpc_tpu_torch.runtime import evaluate, make_episode_runner
from covo_mpc_tpu_torch.solvers import covo_params_from_numpy, get_solver
from tests.test_torch_models import leaves, make_envs, to_torch_params, to_torch_state

REPO = Path(__file__).resolve().parents[1]
N, H = 1024, 8
PSTR = f"N{N}_H{H}_lam0.01"


@pytest.mark.parametrize("engine,rng_mode,hessian_mode", [
    ("torch", "fast", "gn"), ("cuda", "kernel", "gn"), ("torch", "fast", "adjoint"),
])
def test_solve_matches_jax(engine, rng_mode, hessian_mode):
    jenv, env = make_envs()
    jsolver, jcp = j_get_solver(
        jenv, "covo_online", PSTR, rng_mode="fast", hessian_mode=hessian_mode,
        sigma_mode="ns", engine="jnp", collect_debug=False,
    )
    jp = jenv.default_params
    obs, info, state = jenv.reset_env(jax.random.PRNGKey(0), jp)
    rng = jax.random.PRNGKey(5)
    # two solves, so the second starts from a shifted, non-hover mean
    a_r, jcp1, _ = jsolver(obs, state, jp, rng, jcp, info)
    rng2 = jax.random.PRNGKey(6)
    a_r2, jcp2, _ = jsolver(obs, state, jp, rng2, jcp1, info)

    solver, _ = get_solver(env, "covo_online", PSTR, rng_mode=rng_mode,
                           hessian_mode=hessian_mode, sigma_mode="ns",
                           engine=engine)
    p = to_torch_params(jp)
    st = to_torch_state(state)
    tinfo = {"noisy_state": to_torch_state(info["noisy_state"])}
    cp = covo_params_from_numpy(leaves(jcp))
    for key, a_ref, jcp_ref in ((rng, a_r, jcp1), (rng2, a_r2, jcp2)):
        # the normals JAX's fast sampler drew: act_key = split(rng_act)[1]
        z = jax.random.normal(jax.random.split(key)[1], (N, 4 * H))
        a, cp, _ = solver(None, st, p, cp, tinfo,
                          z=torch.from_numpy(np.array(z)))
        np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), atol=2e-4)
        np.testing.assert_allclose(cp.a_mean.numpy(), np.asarray(jcp_ref.a_mean),
                                   atol=2e-4)
        np.testing.assert_allclose(cp.a_cov.numpy(), np.asarray(jcp_ref.a_cov),
                                   atol=2e-4)
        # continue from the reference's params so errors do not compound
        cp = covo_params_from_numpy(leaves(jcp_ref))


def test_solver_modes_that_are_not_ported_raise():
    _, env = make_envs()
    with pytest.raises(ValueError):
        get_solver(env, "covo_online", PSTR, rng_mode="kernel", engine="torch")
    with pytest.raises(NotImplementedError):
        get_solver(env, "covo_online", PSTR, rng_mode="fast", engine="cuda")
    with pytest.raises(NotImplementedError):
        get_solver(env, "covo_offline", PSTR)
    with pytest.raises(NotImplementedError):
        get_solver(env, "covo_online", PSTR, hessian_mode="sensitivity")


def test_episode_runner_and_evaluate():
    """The closed loop on the CPU at a tiny size: a short episode through
    the runner for both engines, then one protocol episode; tracking stays
    finite."""
    _, env = make_envs()
    for engine, rng_mode in (("torch", "fast"), ("cuda", "kernel")):
        solver, _ = get_solver(env, "covo_online", "N64_H4_lam0.01",
                               rng_mode=rng_mode, engine=engine)
        run = make_episode_runner(env, solver, steps=20)
        err, dones = run(torch.Generator().manual_seed(0),
                         torch.Generator().manual_seed(1))
        assert err.shape == (20,) and dones.shape == (20,)
        assert bool(torch.isfinite(err).all())
    result = evaluate(env, solver, total_steps=300, seed=1)
    assert np.isfinite(result.mean) and result.err_pos_ep.shape == (1,)
    assert result.summary().endswith("cm")


def test_package_never_imports_jax():
    code = ("import sys, covo_mpc_tpu_torch, covo_mpc_tpu_torch.ops.hessian; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
