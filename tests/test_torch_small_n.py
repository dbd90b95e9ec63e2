"""The N-ablation's small sample counts on the CPU: the port's MPPI and CoVO
online solves against the JAX package's at H=32 and N = 16 and 64
(``scripts/n_ablation.py``'s cells: fast rng, the adjoint Hessian and the
ns designer for CoVO), on the normals and the disturbance draw JAX's fast
sampler drew, two chained solves, within the per-solve contract (2e-4).
The second CoVO solve designs Σ around a shifted mean with actions exactly
on the clip bounds (±1), where the derivative of the clip must be JAX's
(1/2): the step's Jacobian there is held against JAX's too. The kernels at
these N are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``small_n``).
"""

import jax
import numpy as np
import pytest
import torch

from covo_mpc_tpu.ops.hessian import _step13
from covo_mpc_tpu.solvers import get_solver as j_get_solver
from covo_mpc_tpu_torch.models import dynamics
from covo_mpc_tpu_torch.solvers import covo_params_from_numpy, get_solver, mppi_params_from_numpy
from tests.test_torch_models import leaves, make_envs, to_torch_params, to_torch_state

H = 32


def _reset(jenv):
    jp = jenv.default_params
    obs, info, state = jenv.reset_env(jax.random.PRNGKey(0), jp)
    return jp, obs, info, state, {"noisy_state": to_torch_state(info["noisy_state"])}


@pytest.mark.parametrize("n", [16, 64])
def test_mppi_solve_at_small_n_matches_jax(n):
    """MPPI at the N-ablation's width: each solve fed JAX's normals
    (act_key = split(rng)[1]) and shared disturbance draw."""
    jenv, env = make_envs()
    pstr = f"N{n}_H{H}_lam0.01"
    jsolver, jcp = j_get_solver(jenv, "mppi", pstr, rng_mode="fast", engine="jnp",
                                collect_debug=False)
    jp, obs, info, state, tinfo = _reset(jenv)
    solver, _ = get_solver(env, "mppi", pstr, rng_mode="fast", engine="torch", collect_debug=False)
    p, st = to_torch_params(jp), to_torch_state(state)
    cp = mppi_params_from_numpy(leaves(jcp), device="cpu")
    for key in (jax.random.PRNGKey(5), jax.random.PRNGKey(6)):
        a_r, jcp, _ = jsolver(obs, state, jp, key, jcp, info)
        rest, act_key = jax.random.split(key)
        z = jax.random.normal(act_key, (n, H, 4))
        draw = jax.random.normal(jax.random.split(rest)[1], (3,))
        a, cp, _ = solver(None, st, p, cp, tinfo, z=torch.from_numpy(np.array(z)),
                          draw=torch.from_numpy(np.array(draw)))
        np.testing.assert_allclose(a.numpy(), np.asarray(a_r), atol=2e-4)
        for name in ("a_mean", "a_cov", "a_cov_chol"):
            np.testing.assert_allclose(getattr(cp, name).numpy(),
                                       np.asarray(getattr(jcp, name)), atol=2e-4)
        # continue from the reference's params so errors do not compound
        cp = mppi_params_from_numpy(leaves(jcp), device="cpu")


@pytest.mark.parametrize("n", [16, 64])
def test_covo_solve_at_small_n_matches_jax(n):
    """CoVO online with n_ablation's settings (adjoint Hessian, ns designer,
    fast rng) on JAX's normals."""
    jenv, env = make_envs()
    pstr = f"N{n}_H{H}_lam0.01"
    jsolver, jcp = j_get_solver(jenv, "covo_online", pstr, rng_mode="fast",
                                hessian_mode="adjoint", sigma_mode="ns", engine="jnp",
                                collect_debug=False)
    jp, obs, info, state, tinfo = _reset(jenv)
    solver, _ = get_solver(env, "covo_online", pstr, rng_mode="fast",
                           hessian_mode="adjoint",
                           sigma_mode="ns", engine="torch", collect_debug=False)
    p, st = to_torch_params(jp), to_torch_state(state)
    cp = covo_params_from_numpy(leaves(jcp), device="cpu")
    for key in (jax.random.PRNGKey(5), jax.random.PRNGKey(6)):
        a_r, jcp, _ = jsolver(obs, state, jp, key, jcp, info)
        z = jax.random.normal(jax.random.split(key)[1], (n, 4 * H))
        a, cp, _ = solver(None, st, p, cp, tinfo, z=torch.from_numpy(np.array(z)))
        np.testing.assert_allclose(a.numpy(), np.asarray(a_r), atol=2e-4)
        for name in ("a_mean", "a_cov"):
            np.testing.assert_allclose(getattr(cp, name).numpy(),
                                       np.asarray(getattr(jcp, name)), atol=2e-4)
        cp = covo_params_from_numpy(leaves(jcp), device="cpu")


def test_action_clip_derivative_at_the_bounds_matches_jax():
    """The step's Jacobian with respect to an action with components exactly
    on the bounds (-1, 1), just inside and outside them: JAX's jnp.clip has
    derivative 1/2 at a bound (a min of a max, split at the tie) where
    torch.clamp has 1; dynamics.clip_action keeps JAX's, and the clip's
    values."""
    jenv, env = make_envs()
    jp, _, info, _, tinfo = _reset(jenv)
    s13 = np.asarray(jax.numpy.concatenate([info["noisy_state"].pos, info["noisy_state"].quat,
                                            info["noisy_state"].vel,
                                            info["noisy_state"].omega]))
    fd = np.zeros(3, np.float32)
    p = to_torch_params(jp)
    for a in ([1.0, -1.0, 0.5, 1.0], [-1.0, 1.0, -1.0, 0.999], [1.25, -1.0, 1.0, -1.5]):
        a = np.asarray(a, np.float32)
        ref = jax.jacfwd(lambda x: _step13(s13, x, fd, jp, jenv._dt))(a)
        got = torch.func.jacfwd(lambda x: dynamics.core_step(
            torch.from_numpy(s13), x, torch.from_numpy(fd), p, env._dt))(torch.from_numpy(a))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
        x = torch.tensor([-1.5, -1.0, -0.25, 1.0, 2.0])
        assert torch.equal(dynamics.clip_action(x), torch.clamp(x, -1.0, 1.0))
