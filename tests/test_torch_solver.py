"""The port's CoVO-online and MPPI solves and their closed loop, against
the JAX solvers.

Whole solves are held against ``CoVOSolver(engine="jnp", rng_mode="fast",
hessian_mode="gn", sigma_mode="ns")`` and ``MPPISolver(engine="jnp",
rng_mode="fast")`` on the same state, params and normals: the port is
handed the z (and, for MPPI's stochastic rollouts, the disturbance draw)
that JAX draws from its key chain (solvers/covo.py:453,
solvers/mppi.py:137-138, ops/sampling.py:40). Per-solve contract
(BASELINE.md): action, a_mean and the covariance within 2e-4.
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
from covo_mpc_tpu_torch.solvers import covo_params_from_numpy, get_solver, mppi_params_from_numpy
from tests.test_torch_models import leaves, make_envs, to_torch_params, to_torch_state

REPO = Path(__file__).resolve().parents[1]
N, H = 1024, 8
PSTR = f"N{N}_H{H}_lam0.01"


@pytest.mark.parametrize("engine,rng_mode,hessian_mode", [
    ("torch", "fast", "gn"), ("cuda", "kernel", "gn"), ("torch", "fast", "adjoint"),
    ("cuda", "fast", "gn"),
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
                           engine=engine, collect_debug=False)
    p = to_torch_params(jp)
    st = to_torch_state(state)
    tinfo = {"noisy_state": to_torch_state(info["noisy_state"])}
    cp = covo_params_from_numpy(leaves(jcp), device="cpu")
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
        cp = covo_params_from_numpy(leaves(jcp_ref), device="cpu")


@pytest.mark.parametrize("engine,rng_mode", [
    ("torch", "fast"), ("cuda", "fast"), ("cuda", "kernel"),
])
def test_mppi_solve_matches_jax(engine, rng_mode):
    """Two chained MPPI solves, each fed the normals JAX's fast sampler drew
    (act_key = split(rng)[1]) and its shared disturbance draw (step_key =
    split(split(rng)[0])[1], hashed as it is under fast keys)."""
    jenv, env = make_envs()
    jsolver, jcp = j_get_solver(jenv, "mppi", PSTR, rng_mode="fast",
                                engine="jnp", collect_debug=False)
    jp = jenv.default_params
    obs, info, state = jenv.reset_env(jax.random.PRNGKey(0), jp)
    solver, _ = get_solver(env, "mppi", PSTR, rng_mode=rng_mode, engine=engine, collect_debug=False)
    p = to_torch_params(jp)
    st = to_torch_state(state)
    tinfo = {"noisy_state": to_torch_state(info["noisy_state"])}
    cp = mppi_params_from_numpy(leaves(jcp), device="cpu")
    for key in (jax.random.PRNGKey(5), jax.random.PRNGKey(6)):
        a_r, jcp, _ = jsolver(obs, state, jp, key, jcp, info)
        rest, act_key = jax.random.split(key)
        z = jax.random.normal(act_key, (N, H, 4))
        draw = jax.random.normal(jax.random.split(rest)[1], (3,))
        a, cp, _ = solver(None, st, p, cp, tinfo, z=torch.from_numpy(np.array(z)),
                          draw=torch.from_numpy(np.array(draw)))
        np.testing.assert_allclose(a.numpy(), np.asarray(a_r), atol=2e-4)
        for name in ("a_mean", "a_cov", "a_cov_chol"):
            np.testing.assert_allclose(getattr(cp, name).numpy(),
                                       np.asarray(getattr(jcp, name)), atol=2e-4)
        # continue from the reference's params so errors do not compound
        cp = mppi_params_from_numpy(leaves(jcp), device="cpu")


def test_solver_modes_that_are_not_ported_raise():
    _, env = make_envs()
    with pytest.raises(ValueError):
        get_solver(env, "covo_online", PSTR, rng_mode="kernel", engine="torch",
                   hessian_mode="gn", sigma_mode="ns", collect_debug=False)
    with pytest.raises(NotImplementedError):
        get_solver(env, "lqr")
    with pytest.raises(ValueError):
        get_solver(env, "covo_online", PSTR, sigma_mode="ns_triton",
                   rng_mode="fast", hessian_mode="gn", collect_debug=False)
    with pytest.raises(ValueError, match="parity"):
        get_solver(env, "covo_online", PSTR, rng_mode="parity", sigma_mode="ns_pallas",
                   hessian_mode="gn", collect_debug=False)
    with pytest.raises(ValueError):
        get_solver(env, "mppi", PSTR, rng_mode="kernel", engine="torch", collect_debug=False)
    # every Hessian estimator is ported: an unknown one raises
    with pytest.raises(ValueError, match="hessian_mode"):
        get_solver(env, "covo_offline", PSTR, hessian_mode="fwd_bwd",
                   rng_mode="fast", sigma_mode="ns", collect_debug=False)
    # the kernels compute costs only: no debug poses on the cuda engine
    for name in ("covo_online", "mppi"):
        with pytest.raises(ValueError, match="collect_debug"):
            get_solver(env, name, PSTR, engine="cuda", collect_debug=True)


def test_episode_runner_and_evaluate():
    """The closed loop on the CPU at a tiny size: a short episode through
    the runner for both engines, then one protocol episode; tracking stays
    finite."""
    _, env = make_envs()
    for engine, rng_mode in (("torch", "fast"), ("cuda", "kernel")):
        solver, _ = get_solver(env, "covo_online", "N64_H4_lam0.01",
                               rng_mode=rng_mode, engine=engine,
                               hessian_mode="gn", sigma_mode="ns", collect_debug=False)
        run = make_episode_runner(env, solver, steps=20)
        err, dones, metrics = run(torch.Generator().manual_seed(0),
                                  torch.Generator().manual_seed(1))
        assert metrics == {}
        assert err.shape == (20,) and dones.shape == (20,)
        assert bool(torch.isfinite(err).all())
    result = evaluate(env, solver, total_steps=300, seed=1)
    assert np.isfinite(result.mean) and result.err_pos_ep.shape == (1,)
    assert result.summary().endswith("cm")


def test_mppi_episode_runner_and_evaluate():
    """MPPI's closed loop on the CPU at a tiny size, for each engine and
    sampler: a short episode through the runner, then one protocol episode."""
    _, env = make_envs()
    for engine, rng_mode in (("torch", "fast"), ("cuda", "fast"), ("cuda", "kernel")):
        solver, _ = get_solver(env, "mppi", "N64_H4_lam0.01", rng_mode=rng_mode,
                               engine=engine, collect_debug=False)
        run = make_episode_runner(env, solver, steps=20)
        err, dones, metrics = run(torch.Generator().manual_seed(0),
                                  torch.Generator().manual_seed(1))
        assert metrics == {}
        assert err.shape == (20,) and dones.shape == (20,)
        assert bool(torch.isfinite(err).all())
    result = evaluate(env, solver, total_steps=300, seed=1)
    assert np.isfinite(result.mean) and result.err_pos_ep.shape == (1,)


def test_package_never_imports_jax():
    code = ("import sys, covo_mpc_tpu_torch, covo_mpc_tpu_torch.ops.hessian, "
            "covo_mpc_tpu_torch.solvers.mppi, covo_mpc_tpu_torch.cli, "
            "covo_mpc_tpu_torch.utils.plotting, covo_mpc_tpu_torch.models.misc, "
            "covo_mpc_tpu_torch.models.wrappers, covo_mpc_tpu_torch.utils.stats, "
            "covo_mpc_tpu_torch.viz.meshcat_vis, covo_mpc_tpu_torch.parallel.scenarios, "
            "covo_mpc_tpu_torch.runtime.render, covo_mpc_tpu_torch.runtime.supervisor, "
            "covo_mpc_tpu_torch.models.batched, covo_mpc_tpu_torch.tools.clock_probe, "
            "covo_mpc_tpu_torch.parallel.mesh, covo_mpc_tpu_torch.parallel.distributed, "
            "covo_mpc_tpu_torch.parallel.sharded, covo_mpc_tpu_torch.parallel.offline, "
            "covo_mpc_tpu_torch.parallel.pipeline, covo_mpc_tpu_torch.scripts.bench_mesh, "
            "covo_mpc_tpu_torch.scripts.pod_scale; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'covo_mpc_tpu' not in sys.modules, 'the JAX package imported'")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
