"""The port's scenario-batched path against the JAX package: domain
randomization, the batched packing, K6's and K7's plain versions, the
batched Hessian and Σ-designer, and the batched CoVO and MPPI solves.

B=3 domain-randomized scenarios (JAX's ``vmap(env.sample_params)``, with
the masses and body-rate gains set apart by hand, as the JAX kernel tests
do, so that the scenario-strided tables are exercised), N ≤ 1024, H=4.
Normals come from a numpy seed or from JAX's keys and are handed to both
packages. Tolerances: rollout costs atol 2e-4, rtol 1e-5 and actions 1e-5
(the JAX kernel tests'), one solve 2e-4 (BASELINE.md's per-solve
contract), the batched forms against a loop of the port's single-scenario
forms 1e-5 relative. On the CPU every kernel wrapper takes its plain
version; the kernels themselves are held against those on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covo_mpc_tpu.models import dynamics as jdyn
from covo_mpc_tpu.models import pack_state as jpack
from covo_mpc_tpu.ops import covariance as jcov
from covo_mpc_tpu.ops import reductions as jred
from covo_mpc_tpu.ops.hessian import make_hessian_adjoint as j_hessian_adjoint
from covo_mpc_tpu.ops.rollout import make_rollout as j_make_rollout
from covo_mpc_tpu.ops.rollout_pallas import make_pallas_rollout_batched as j_rollout_batched
from covo_mpc_tpu.solvers import hover_sequence as j_hover
from covo_mpc_tpu_torch.models.structs import EnvParams3D, index_params, stack_params
from covo_mpc_tpu_torch.ops import covariance, rollout_cuda
from covo_mpc_tpu_torch.ops.hessian import make_hessian_adjoint, make_hessian_batched
from covo_mpc_tpu_torch.parallel import make_batched_covo_solve, make_batched_mppi_solve
from covo_mpc_tpu_torch.solvers import get_solver
from covo_mpc_tpu_torch.solvers.covo import CoVOParams
from covo_mpc_tpu_torch.solvers.mppi import MPPIParams
from tests.test_torch_models import leaves, make_envs, t, to_torch_params, to_torch_state

B, N, H = 3, 1024, 4
D = 4 * H
LAM = 0.01


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@functools.lru_cache(maxsize=None)
def _scenarios(dr: bool = True):
    """B scenarios as the JAX tests build them: per-scenario params from
    ``vmap(sample_params)`` (masses and body-rate gains set apart), each
    reset from its own key. Returns the JAX pieces and the port's copies
    (built once per process; the tests only read them)."""
    jenv, env = make_envs(enable_randomizer=dr)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jp_b = jax.vmap(jenv.sample_params)(keys).replace(
        m=jnp.array([0.027, 0.031, 0.024]),
        alpha_bodyrate=jnp.array([0.5, 0.4, 0.6]),
    )
    resets = jax.vmap(lambda k, p: jenv.reset_env(k, p)[1]["noisy_state"])(keys, jp_b)
    x0s = jax.vmap(jpack)(resets)
    j = dict(env=jenv, keys=keys, params=jp_b, x0s=x0s, t0s=resets.time,
             pos=resets.pos_traj, vel=resets.vel_traj)
    p = dict(env=env, params=to_torch_params(jp_b), x0s=t(x0s),
             t0s=torch.from_numpy(np.array(resets.time)), pos=t(resets.pos_traj),
             vel=t(resets.vel_traj))
    return j, p


def _jparams(j, b):
    return jax.tree.map(lambda x: x[b], j["params"])


def _args(p):
    return p["x0s"], p["t0s"], p["pos"], p["vel"]


# --- domain randomization -------------------------------------------------


@pytest.mark.parametrize("dr", [True, False], ids=["DR", "noDR"])
def test_sample_params_matches_jax(dr):
    """``params_from_draws`` on the uniforms JAX's ``sample_params`` draws:
    17 from split(key)[0] under DR, 6 unscaled from the key without."""
    jenv, env = make_envs(enable_randomizer=dr)
    key = jax.random.PRNGKey(5)
    ref = jenv.sample_params(key)
    if dr:
        u = jax.random.uniform(jax.random.split(key)[0], (17,), minval=-1.0, maxval=1.0)
    else:
        u = jax.random.uniform(key, (6,), minval=-1.0, maxval=1.0)
    got = env.params_from_draws(t(u))
    for name, v in leaves(ref).items():
        np.testing.assert_allclose(np.asarray(getattr(got, name)), v, rtol=1e-7,
                                   atol=1e-12, err_msg=name)
    drawn = env.sample_params(torch.Generator().manual_seed(0))
    u = env.draw_params(torch.Generator().manual_seed(0))
    assert u.shape == ((17,) if dr else (6,)) and float(u.abs().max()) <= 1.0
    assert torch.equal(drawn.disturb_params, env.params_from_draws(u).disturb_params)
    if dr:
        assert float(drawn.m) != float(env.default_params.m)


def test_batched_params_stack_and_index():
    """JAX's batched params carried over with their leading axis: each
    scenario equals the one carried over alone, and stack_params inverts
    index_params."""
    j, p = _scenarios()
    pb = p["params"]
    assert pb.m.shape == (B,) and pb.max_omega.shape == (B, 3)
    assert isinstance(pb.max_steps_in_episode, int)
    for b in range(B):
        alone = to_torch_params(_jparams(j, b))
        for name, v in vars(alone).items():
            got = getattr(index_params(pb, b), name)
            assert torch.equal(got, v) if isinstance(v, torch.Tensor) else got == v
    again = stack_params([index_params(pb, b) for b in range(B)])
    assert all(torch.equal(getattr(again, k), getattr(pb, k))
               for k, v in vars(pb).items() if isinstance(v, torch.Tensor))
    with pytest.raises(ValueError):
        stack_params([EnvParams3D.default("cpu"),
                      EnvParams3D.default("cpu", max_steps_in_episode=9)])


def test_pack_kernel_inputs_batched_matches_per_scenario():
    """The scenario-strided tables of K6/K7 (one pack for all B) hold each
    scenario's single-scenario pack, row by row."""
    _, p = _scenarios()
    draws = torch.randn(B, 3, generator=torch.Generator().manual_seed(1))
    env, pb = p["env"], p["params"]
    packed = rollout_cuda._pack_kernel_inputs(env, *_args(p), pb, draws, False,
                                              0.97, H)
    assert [tuple(x.shape) for x in packed] == [(B, 3 * H), (B, 3 * H), (B, 3 * H),
                                                (B, rollout_cuda.NSCAL),
                                                (B, rollout_cuda.NINT)]
    for b in range(B):
        one = rollout_cuda._pack_kernel_inputs(
            env, p["x0s"][b], p["t0s"][b], p["pos"][b], p["vel"][b],
            index_params(pb, b), draws[b], False, 0.97, H)
        for got, ref in zip(packed, one):
            assert torch.equal(got[b], ref)


# --- K6 / K7: the plain versions ------------------------------------------


@pytest.mark.parametrize("layout", ["nhd", "hdn"])
def test_rollout_batched_plain_matches_pallas(layout):
    """K6's plain version == JAX's batched kernel in interpret mode (fast
    keys), fed the same actions and each scenario's shared draw."""
    j, p = _scenarios()
    actions = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (B, N, H, 4)) * 0.4)
    if layout == "hdn":
        actions = np.ascontiguousarray(actions.transpose(0, 2, 3, 1))
    ref = j_rollout_batched(j["env"], interpret=True, fast_keys=True)(
        j["x0s"], j["t0s"], j["pos"], j["vel"], actions, j["params"], j["keys"],
        deterministic=False, discount=0.98,
        layout="bnhd" if layout == "nhd" else "bhdn",
    )
    draws = t(_j_draws(j))
    launches = rollout_cuda.ROLLOUT_BATCHED_KERNEL.launches
    got = rollout_cuda.make_rollout_batched_costs(p["env"])(
        *_args(p), t(actions), p["params"], draws, discount=0.98, layout=layout)
    assert rollout_cuda.ROLLOUT_BATCHED_KERNEL.launches == launches  # CPU: plain
    assert got.shape == (B, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-5)


@pytest.mark.parametrize("joint", [False, True], ids=["per_step", "joint"])
def test_sample_rollout_batched_plain_matches_jax(joint):
    """Both K7 plain versions against JAX's correlate + clip on the same
    normals (actions 1e-5), and the costs JAX's batched kernel gives those
    actions in interpret mode (2e-4): per-step under each scenario's shared
    draw (MPPI), joint deterministic (CoVO)."""
    j, p = _scenarios()
    rng = np.random.default_rng(2)
    a_means = (rng.normal(size=(B, H, 4)) * 0.2).astype(np.float32)
    if joint:
        facs = (rng.normal(size=(B, D, D)) * 0.1).astype(np.float32)
        z = rng.standard_normal((B, D, N)).astype(np.float32)
        a_ref = jnp.clip(a_means.reshape(B, D, 1) + jnp.einsum("bed,bdn->ben", facs, z),
                         -1.0, 1.0)
    else:
        A = rng.normal(size=(B, H, 4, 4)) * 0.3
        facs = np.linalg.cholesky(A @ A.transpose(0, 1, 3, 2) + 0.05 * np.eye(4)
                                  ).astype(np.float32)
        z = rng.standard_normal((B, H, 4, N)).astype(np.float32)
        a_ref = jnp.clip(a_means[..., None] + jnp.einsum("bhij,bhjn->bhin", facs, z),
                         -1.0, 1.0).reshape(B, D, N)
    deterministic = joint
    costs_ref = j_rollout_batched(j["env"], interpret=True, fast_keys=True)(
        j["x0s"], j["t0s"], j["pos"], j["vel"], a_ref, j["params"], j["keys"],
        deterministic=deterministic, discount=0.98, layout="bhdn",
    )
    draws = t(_j_draws(j))
    kernel = (rollout_cuda.JOINT_BATCHED_KERNEL if joint
              else rollout_cuda.SAMPLE_BATCHED_KERNEL)
    launches = kernel.launches
    costs, a_t = rollout_cuda.make_rollout_batched_sampling(p["env"], joint=joint)(
        *_args(p), t(a_means), t(facs), p["params"], 0, N,
        deterministic=deterministic, discount=0.98, draws=draws, z=t(z))
    assert kernel.launches == launches  # CPU: plain version
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_ref), atol=1e-5)
    np.testing.assert_allclose(costs.numpy(), np.asarray(costs_ref), atol=2e-4,
                               rtol=1e-5)


def test_sample_rollout_batched_plain_draws_from_seed():
    """Without z the plain versions draw from a generator seeded with
    ``seed``: the same seed gives the same draws, and a stochastic rollout
    without draws raises (the batched path runs the "shared" mode only)."""
    _, p = _scenarios()
    a_means = torch.zeros(B, H, 4)
    chols = (0.1 * torch.eye(4)).expand(B, H, 4, 4).contiguous()
    k7 = rollout_cuda.make_rollout_batched_sampling(p["env"])
    args = (*_args(p), a_means, chols, p["params"])
    c1, a1 = k7(*args, 5, 256, deterministic=True)
    c2, a2 = k7(*args, 5, 256, deterministic=True)
    _, a3 = k7(*args, 6, 256, deterministic=True)
    assert torch.equal(c1, c2) and torch.equal(a1, a2) and not torch.equal(a1, a3)
    assert a1.shape == (B, D, 256) and c1.shape == (B, 256)
    with pytest.raises(ValueError):
        k7(*args, 5, 256)


# --- the batched Hessian and Σ-designer -----------------------------------


A_RAND = (np.random.default_rng(7).normal(size=(B, D)) * 0.3).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _j_hessians(second_order: bool):
    """JAX's Hessian (scan primal) at A_RAND and its NS designer, for every
    scenario in one jit(vmap)."""
    j, _ = _scenarios()
    hess = j_hessian_adjoint(j["env"], H, primal="scan", second_order=second_order)

    def one(a, x0, t0, pos, vel, params):
        R = hess(a, x0, t0, pos, vel, params, jax.random.PRNGKey(9))
        return (R, *jcov.optimize_sigma_ns(R, 0.5, D))

    return jax.jit(jax.vmap(one))(A_RAND, j["x0s"], j["t0s"], j["pos"], j["vel"],
                                  j["params"])


@pytest.mark.parametrize("second_order", [False, True], ids=["gn", "adjoint"])
def test_batched_hessian_and_designer(second_order):
    """The batched Hessian and NS designer against a loop of the port's
    single-scenario functions (1e-5 relative) and against JAX's
    (make_hessian_adjoint(primal="scan"), optimize_sigma_ns)."""
    _, p = _scenarios()
    R = make_hessian_batched(p["env"], H, second_order=second_order)(
        t(A_RAND), *_args(p), p["params"])
    cov, fac = covariance.optimize_sigma_ns(R, 0.5, D)
    assert R.shape == (B, D, D) and fac.is_contiguous()
    hess = make_hessian_adjoint(p["env"], H, second_order=second_order)
    R_ref, c_ref, f_ref = (np.asarray(x) for x in _j_hessians(second_order))
    for b in range(B):
        pb = index_params(p["params"], b)
        R1 = hess(t(A_RAND[b]), p["x0s"][b], p["t0s"][b], p["pos"][b], p["vel"][b], pb)
        assert _rel(R[b], R1) < 1e-5
        c1, f1 = covariance.optimize_sigma_ns(R1, 0.5, D)
        assert _rel(cov[b], c1) < 1e-5 and _rel(fac[b], f1) < 1e-5
        assert _rel(R[b], R_ref[b]) < 1e-5
        np.testing.assert_allclose(cov[b].numpy(), c_ref[b], atol=2e-4)
        np.testing.assert_allclose(fac[b].numpy(), f_ref[b], atol=2e-4)


# --- the batched solves -----------------------------------------------------

GM, GS, DISC = 0.6, 0.5, 0.95  # non-default: the full update semantics


def _hover_means(j):
    return np.tile(np.asarray(j_hover(j["env"], H))[None], (B, 1, 1))


COVO_Z = np.random.default_rng(3).standard_normal((B, N, D)).astype(np.float32)
MPPI_Z = np.random.default_rng(4).standard_normal((B, N, H, 4)).astype(np.float32)
A_COVS = np.tile(np.eye(4, dtype=np.float32)[None, None] * 0.25, (B, H, 1, 1))


def _j_draws(j):
    """Each scenario's shared-disturbance normals, as JAX's fast-keys
    rollout draws them from the scenario's key."""
    return jax.vmap(lambda k: jax.random.normal(
        jdyn.derive_dynamics_keys(k, fast=True), (3,)))(j["keys"])


@functools.lru_cache(maxsize=None)
def _j_covo_reference():
    """JAX's per-scenario CoVO math on COVO_Z (the recipe of
    tests/test_sharding.py's batched CoVO test, the jnp rollout in place of
    the interpret kernel), adjoint Hessian: (new means, min costs)."""
    j, _ = _scenarios()
    hess = j_hessian_adjoint(j["env"], H, primal="scan")
    rollout = j_make_rollout(j["env"], fast_keys=True)

    def one(am, x0, t0, pos, vel, params, key, z):
        am = jnp.concatenate([am[1:], am[-1:]])
        R = hess(am.flatten(), x0, t0, pos, vel, params, jax.random.PRNGKey(0))
        _, F = jcov.optimize_sigma_ns(R, 0.5, D)
        a_s = jnp.clip((am.flatten()[None] + z @ F.T).reshape(N, H, 4), -1.0, 1.0)
        costs, _ = rollout(x0, t0, pos, vel, a_s, params, key, deterministic=True,
                           discount=DISC, collect_poses=False)
        return jred.mean_update(jred.mppi_weights(costs, LAM), a_s, am, GM), jnp.min(costs)

    return jax.jit(jax.vmap(one))(_hover_means(j), j["x0s"], j["t0s"], j["pos"], j["vel"],
                                  j["params"], j["keys"], COVO_Z)


@functools.lru_cache(maxsize=None)
def _j_mppi_reference():
    """JAX's per-scenario MPPI math on MPPI_Z and each scenario's shared
    draw (tests/test_sharding.py's batched MPPI test, the jnp rollout in
    place of the interpret kernel): (new means, new covariances, min costs)."""
    j, _ = _scenarios()
    rollout = j_make_rollout(j["env"], fast_keys=True)

    def one(am, ac, x0, t0, pos, vel, params, key, z):
        am = jnp.concatenate([am[1:], am[-1:]])
        ac = jnp.concatenate([ac[1:], ac[-1:]])
        a_s = jnp.clip(am[None] + jnp.einsum("hij,nhj->nhi", jnp.linalg.cholesky(ac), z),
                       -1.0, 1.0)
        costs, _ = rollout(x0, t0, pos, vel, a_s, params, key, deterministic=False,
                           discount=DISC, collect_poses=False)
        w = jred.mppi_weights(costs, LAM)
        mean = jred.mean_update(w, a_s, am, GM)
        return mean, jred.cov_update(w, a_s, mean, ac, GS), jnp.min(costs)

    return jax.jit(jax.vmap(one))(_hover_means(j), A_COVS, j["x0s"], j["t0s"], j["pos"],
                                  j["vel"], j["params"], j["keys"], MPPI_Z)


@pytest.mark.parametrize("engine,rng_mode", [
    ("torch", "fast"), ("cuda", "fast"), ("cuda", "kernel"),
])
def test_batched_covo_solve_matches_jax(engine, rng_mode):
    """The batched CoVO solve against JAX's per-scenario math on the same
    normals (:func:`_j_covo_reference`), adjoint Hessian."""
    j, p = _scenarios()
    solve = make_batched_covo_solve(p["env"], N, H, LAM, rng=rng_mode, engine=engine)
    a_new, min_costs = solve(*_args(p), t(_hover_means(j)), p["params"], gamma_mean=GM,
                             discount=DISC, z=t(COVO_Z))
    expect, min_ref = _j_covo_reference()
    np.testing.assert_allclose(a_new.numpy(), np.asarray(expect), atol=2e-4)
    np.testing.assert_allclose(min_costs.numpy(), np.asarray(min_ref), atol=2e-4, rtol=0)


@pytest.mark.parametrize("engine,rng_mode", [
    ("torch", "fast"), ("cuda", "fast"), ("cuda", "kernel"),
])
def test_batched_mppi_solve_matches_jax(engine, rng_mode):
    """The batched MPPI solve against JAX's per-scenario math on the same
    normals and shared draws (:func:`_j_mppi_reference`): mean AND
    covariance updates at γ_σ = 0.5."""
    j, p = _scenarios()
    solve = make_batched_mppi_solve(p["env"], N, H, LAM, rng=rng_mode, engine=engine)
    a_new, c_new, min_costs = solve(*_args(p), t(_hover_means(j)), t(A_COVS), p["params"],
                                    gamma_mean=GM, gamma_sigma=GS, discount=DISC,
                                    z=t(MPPI_Z), draws=t(_j_draws(j)))
    expect, cov_ref, min_ref = _j_mppi_reference()
    np.testing.assert_allclose(a_new.numpy(), np.asarray(expect), atol=2e-4)
    np.testing.assert_allclose(c_new.numpy(), np.asarray(cov_ref), atol=2e-4)
    np.testing.assert_allclose(min_costs.numpy(), np.asarray(min_ref), atol=2e-4, rtol=0)


def test_batched_solves_at_one_scenario_match_the_solvers():
    """B=1: the batched solves give what the port's single-scenario solvers
    give on the same state, params and normals (CoVO adjoint and MPPI,
    engine "torch")."""
    j, p = _scenarios()
    env, N1 = p["env"], 256
    x0, t0, pos, vel = (x[:1] for x in _args(p))
    p1 = index_params(p["params"], 0)
    pb = stack_params([p1])
    st = to_torch_state(jax.tree.map(
        lambda x: x[0], jax.vmap(lambda k, q: j["env"].reset_env(k, q)[1]["noisy_state"])(
            j["keys"], j["params"])))
    rng = np.random.default_rng(5)

    solver, cp = get_solver(env, "covo_online", f"N{N1}_H{H}_lam{LAM}",
                            hessian_mode="adjoint", engine="torch",
                            rng_mode="fast", sigma_mode="ns", collect_debug=False)
    z = t(rng.standard_normal((N1, D)))
    cp = CoVOParams(**{**vars(cp), "gamma_mean": GM, "discount": DISC})
    _, ref, _ = solver(None, st, p1, cp, None, z=z)
    got, _ = make_batched_covo_solve(env, N1, H, LAM)(
        x0, t0, pos, vel, cp.a_mean[None], pb, gamma_mean=GM, discount=DISC, z=z[None])
    torch.testing.assert_close(got[0], ref.a_mean, atol=1e-6, rtol=0)

    solver, cp = get_solver(env, "mppi", f"N{N1}_H{H}_lam{LAM}", engine="torch",
                            rng_mode="fast", collect_debug=False)
    z = t(rng.standard_normal((N1, H, 4)))
    draw = t(rng.standard_normal(3))
    cp = MPPIParams(**{**vars(cp), "gamma_mean": GM, "gamma_sigma": GS,
                       "discount": DISC})
    _, ref, _ = solver(None, st, p1, cp, None, z=z, draw=draw)
    got_m, got_c, _ = make_batched_mppi_solve(env, N1, H, LAM)(
        x0, t0, pos, vel, cp.a_mean[None], cp.a_cov[None], pb, gamma_mean=GM,
        gamma_sigma=GS, discount=DISC, z=z[None], draws=draw[None])
    torch.testing.assert_close(got_m[0], ref.a_mean, atol=1e-6, rtol=0)
    torch.testing.assert_close(got_c[0], ref.a_cov, atol=1e-6, rtol=0)


def test_batched_solves_draw_and_reject():
    """Without given normals the solves draw their own (finite means, one
    row per scenario; the same seed repeats); unsupported options raise;
    ``collect_metrics`` adds each scenario's metrics."""
    j, p = _scenarios()
    env = p["env"]
    a_means = t(_hover_means(j))
    a_covs = (0.25 * torch.eye(4)).expand(B, H, 4, 4).contiguous()
    for engine, rng_mode in (("torch", "fast"), ("cuda", "kernel")):
        covo = make_batched_covo_solve(env, 128, H, LAM, rng=rng_mode,
                                       hessian_mode="gn", engine=engine, seed=1)
        m1, c1 = covo(*_args(p), a_means, p["params"])
        covo.seed(1)
        m2, _ = covo(*_args(p), a_means, p["params"])
        assert m1.shape == (B, H, 4) and c1.shape == (B,)
        assert torch.equal(m1, m2) and bool(torch.isfinite(m1).all())
        mppi = make_batched_mppi_solve(env, 128, H, LAM, rng=rng_mode, engine=engine)
        m, c, mc = mppi(*_args(p), a_means, a_covs, p["params"])
        assert bool(torch.isfinite(m).all()) and c.shape == (B, H, 4, 4)
        assert torch.equal(c, a_covs)  # γ_σ = 0: the shifted covariance, untouched
    with pytest.raises(ValueError):
        make_batched_covo_solve(env, N, H, LAM, rng="philox")
    with pytest.raises(ValueError):
        make_batched_mppi_solve(env, N, H, LAM, rng="kernel", engine="torch")
    with pytest.raises(ValueError):
        make_batched_covo_solve(env, N, H, LAM, hessian_mode="bfgs")
    with pytest.raises(NotImplementedError, match="K8"):
        make_batched_covo_solve(env, N, H, LAM, sigma_mode="ns_pallas")
    with pytest.raises(ValueError, match="JAX keys"):  # a key-drawing solve needs keys
        make_batched_mppi_solve(env, 128, H, LAM, rng="invariant", engine="torch")(
            *_args(p), a_means, a_covs, p["params"])
    # collect_metrics appends each scenario's health metrics (ESS in [1, N])
    mppi = make_batched_mppi_solve(env, 128, H, LAM, engine="torch", collect_metrics=True)
    *_, mm = mppi(*_args(p), a_means, a_covs, p["params"])
    covo = make_batched_covo_solve(env, 128, H, LAM, hessian_mode="gn", engine="torch",
                                   collect_metrics=True)
    *_, cm = covo(*_args(p), a_means, p["params"])
    assert set(mm) == {"cost_min", "cost_mean", "cost_max", "ess"}
    assert set(cm) == set(mm) | {"sigma_cond", "sigma_logdet"}
    for m in (mm, cm):
        assert all(v.shape == (B,) and bool(torch.isfinite(v).all()) for v in m.values())
        assert bool(((m["ess"] >= 1.0 - 1e-4) & (m["ess"] <= 128 + 1e-3)).all())
    assert bool((cm["sigma_cond"] >= 1.0).all())
