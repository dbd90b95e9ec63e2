"""The port's parallel layer against the JAX package: the rank mesh, the
sample-sharded MPPI and CoVO solves, the multichip steps, the sharded solve
metrics and the distributed offline schedule.

Each rank is a process on the CPU under gloo (``parallel.run_ranks``);
the workers import torch and the port only, and build their inputs from
the numpy arrays the parent hands them (JAX's reset states, params, keys,
carried over by the port's ``*_from_numpy`` helpers). One launch a world
size (2, 3 and 4 ranks) runs every case of that size. The one-rank cases
run in this process with no process group. JAX runs on its 8 virtual CPU
devices, each function compiled once for the module (under ``jax.jit``):
the sharded MPPI solve at k = 1, 2, 4, everything else at the smallest
mesh that has the axis; the port's other mesh shapes are held against
JAX's and against the port's own one-rank result, which the invariant
sampler makes the same at any mesh shape. Sizes are JAX's tests': N=64,
H=4, the ``tracking`` env with the randomizer off. Tolerance 1e-5 (JAX's
own atol), 1e-7 where the covariance passes through at ``gamma_sigma=0``.
"""

import numpy as np
import pytest
import torch

from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv
from covo_mpc_tpu_torch.models.structs import pack_state, params_from_numpy, state_from_numpy
from covo_mpc_tpu_torch.parallel import (
    SAMPLE_AXIS,
    SCENARIO_AXIS,
    Mesh,
    make_distributed_covo_solve,
    make_distributed_offline_schedule,
    make_mesh,
    make_multichip_control_step,
    make_multichip_covo_step,
    make_sharded_covo_sample_rollout,
    make_sharded_mppi_solve,
    run_ranks,
)
from covo_mpc_tpu_torch.solvers import get_solver, hover_sequence

N, H, LAM = 64, 4, 0.01
B, STEPS = 4, 2
ENV_KW = dict(task="tracking", enable_randomizer=False, disturb_type="gaussian",
              disable_rollover_terminate=True, generate_noisy_state=True)
TOL = 1e-5
HESSIAN_MODES = ("gn", "adjoint")
# (samples, scenarios) of the multichip steps, by world size
STEP_MESHES = {1: [(1, 1)], 2: [(2, 1), (1, 2)], 4: [(2, 2)]}
OFFLINE = dict(rng_mode="invariant", hessian_mode="gn", sigma_mode="ns",
               collect_debug=False)


# --- the inputs, made by JAX, carried over as numpy ---------------------------


def _tree(x) -> dict:
    import dataclasses

    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)
            if getattr(x, f.name) is not None}


def _key(k) -> np.ndarray:
    return np.asarray(k).astype(np.int64)


def _jax_inputs():
    """JAX's env, and every input as numpy (built once)."""
    import jax
    import jax.numpy as jnp

    from covo_mpc_tpu.models import EnvConfig as JEnvConfig
    from covo_mpc_tpu.models import QuadEnv as JQuadEnv
    from covo_mpc_tpu.solvers import hover_sequence as j_hover

    jenv = JQuadEnv(JEnvConfig(**ENV_KW))
    jp = jenv.default_params
    reset = jax.jit(lambda k, p: jenv.reset_env(k, p)[2])
    state = reset(jax.random.PRNGKey(0), jp)
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    params_b = jax.jit(jax.vmap(jenv.sample_params))(keys)
    states_b = jax.jit(jax.vmap(reset))(keys, params_b)
    act_key, step_key = jax.random.split(jax.random.PRNGKey(5))
    rng = np.random.default_rng(3)
    g = rng.standard_normal((4 * H, 4 * H)).astype(np.float32)
    np_in = dict(
        state=_tree(state), params=_tree(jp), states_b=_tree(states_b),
        params_b=_tree(params_b), a_mean=np.asarray(j_hover(jenv, H)),
        a_cov=np.tile(np.eye(4, dtype=np.float32) * 0.25, (H, 1, 1)),
        factor=(0.3 * np.eye(4 * H) + 0.01 * g).astype(np.float32),
        act_key=_key(act_key), step_key=_key(step_key),
        rng=_key(jax.random.PRNGKey(21)), offline_key=_key(jax.random.PRNGKey(7)),
        step_keys=np.stack([_key(jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey(1), t), B)) for t in range(STEPS)]),
    )
    j_in = dict(env=jenv, params=jp, state=state, params_b=params_b, states_b=states_b,
                a_mean=j_hover(jenv, H), a_cov=jnp.asarray(np_in["a_cov"]),
                factor=jnp.asarray(np_in["factor"]), act_key=act_key, step_key=step_key,
                rng=jax.random.PRNGKey(21), offline_key=jax.random.PRNGKey(7),
                step_keys=[jax.random.split(jax.random.fold_in(jax.random.PRNGKey(1), t), B)
                           for t in range(STEPS)])
    return j_in, np_in


def _jax_outputs(j):
    """JAX's results of every function, each compiled once."""
    import jax
    import jax.numpy as jnp

    from covo_mpc_tpu.models import pack_state as jpack
    from covo_mpc_tpu.parallel import (
        make_distributed_offline_schedule as j_offline,
    )
    from covo_mpc_tpu.parallel import make_mesh as j_make_mesh
    from covo_mpc_tpu.parallel.scenarios import (
        make_multichip_control_step as j_mc_mppi,
    )
    from covo_mpc_tpu.parallel.scenarios import make_multichip_covo_step as j_mc_covo
    from covo_mpc_tpu.parallel.sharded import make_distributed_covo_solve as j_dist
    from covo_mpc_tpu.parallel.sharded import make_sharded_covo_sample_rollout as j_rollout
    from covo_mpc_tpu.parallel.sharded import make_sharded_mppi_solve as j_mppi
    from covo_mpc_tpu.solvers import get_solver as j_get_solver

    env, p, s = j["env"], j["params"], j["state"]
    args = (jpack(s), s.time, s.pos_traj, s.vel_traj)
    dev = jax.devices()
    out = {"grid": np.vectorize(lambda d: d.id)(j_make_mesh(samples=2, scenarios=2,
                                                            devices=dev[:4]).devices)}
    for k in (1, 2, 4):
        mesh = j_make_mesh(samples=k, scenarios=1, devices=dev[:k])
        solve = jax.jit(j_mppi(env, mesh, N=N, H=H, lam=LAM))
        out[f"mppi{k}"] = solve(*args, j["a_mean"], j["a_cov"], 1.0, 0.0, 1.0, p,
                                j["act_key"], j["step_key"])
    one = j_make_mesh(samples=1, scenarios=1, devices=dev[:1])
    out["rollout"] = jax.jit(j_rollout(env, one, N=N, H=H, lam=LAM))(
        *args, j["a_mean"].flatten(), j["factor"], 1.0, 1.0, p, j["act_key"],
        j["step_key"])
    for mode in HESSIAN_MODES:
        solve = jax.jit(j_dist(env, one, N=N, H=H, lam=LAM, engine="jnp",
                               hessian_mode=mode, collect_metrics=True))
        out[f"dist_{mode}"] = solve(*args, j["a_mean"], p, j["rng"])
    a_means = jnp.tile(j["a_mean"][None], (B, 1, 1))
    a_covs = jnp.tile(j["a_cov"][None], (B, 1, 1, 1))
    mc_mppi = j_mc_mppi(env, one, N=N, H=H, lam=LAM)
    mc_covo = j_mc_covo(env, one, N=N, H=H, lam=LAM, hessian_mode="gn")
    st_m = st_c = j["states_b"]
    am_m, ac_m, am_c = a_means, a_covs, a_means
    for t in range(STEPS):
        st_m, am_m, ac_m, r_m, d_m = mc_mppi(st_m, j["params_b"], am_m, ac_m,
                                             j["step_keys"][t])
        st_c, am_c, r_c, d_c = mc_covo(st_c, j["params_b"], am_c, j["step_keys"][t])
    out["mc_mppi"] = dict(pos=st_m.pos, a_means=am_m, a_covs=ac_m, rewards=r_m, dones=d_m)
    out["mc_covo"] = dict(pos=st_c.pos, a_means=am_c, rewards=r_c, dones=d_c)
    solver, _ = j_get_solver(env, "covo_offline", f"N{N}_H{H}_lam{LAM}", engine="jnp",
                             **OFFLINE)
    states, keys = jax.jit(solver.offline_schedule_inputs)(s, p, j["offline_key"])
    head = jax.tree.map(lambda x: x[:4], (states, keys))
    out["offline_head"] = jax.jit(jax.vmap(
        lambda st, k: solver.offline_sigma_at(st, k, p, 0.5)))(*head)
    with pytest.raises(ValueError, match="offline"):
        j_offline(j_get_solver(env, "covo_online", "N4_H2_lam0.01")[0], one)
    return jax.tree.map(np.asarray, out)


# --- the port's side: one function a world size, run on every rank --------------


def _env() -> QuadEnv:
    return QuadEnv(EnvConfig(**ENV_KW), device="cpu")


def _keys(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(v) for v in tree)
    return tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else tree


def _port_cases(world: int, inp: dict) -> dict:
    """Every case of this world size on this rank (the module docstring);
    the sharded outputs assembled over the scenario axis."""
    env = _env()
    p = params_from_numpy(inp["params"], device="cpu")
    s = state_from_numpy(inp["state"], device="cpu")
    args = (pack_state(s), s.time, s.pos_traj, s.vel_traj)
    a_mean, a_cov = torch.from_numpy(inp["a_mean"]), torch.from_numpy(inp["a_cov"])
    act_key, step_key = _keys(inp["act_key"]), _keys(inp["step_key"])
    out = {}
    mesh = make_mesh(samples=world)
    out["coords"] = None if world != 4 else make_mesh(samples=2, scenarios=2).coords
    if world in (1, 2, 4):
        out["mppi"] = make_sharded_mppi_solve(env, mesh, N, H, LAM, engine="torch")(
            *args, a_mean, a_cov, 1.0, 0.0, 1.0, p, act_key, step_key)
    if world in (1, 4):
        out["rollout"] = make_sharded_covo_sample_rollout(env, mesh, N, H, LAM)(
            *args, a_mean.flatten(), torch.from_numpy(inp["factor"]), 1.0, 1.0, p,
            act_key, step_key)
        for mode in HESSIAN_MODES:
            out[f"dist_{mode}"] = make_distributed_covo_solve(
                env, mesh, N, H, LAM, hessian_mode=mode, collect_metrics=True)(
                *args, a_mean, p, _keys(inp["rng"]))
    for samples, scenarios in STEP_MESHES.get(world, []):
        out[f"mc{samples}{scenarios}"] = _multichip(env, make_mesh(samples, scenarios), inp)
    if world in (1, 2, 3):
        solver, cp0 = get_solver(env, "covo_offline", f"N{N}_H{H}_lam{LAM}",
                                 engine="torch", **OFFLINE)
        cp = make_distributed_offline_schedule(solver, mesh)(s, p, cp0,
                                                             _keys(inp["offline_key"]))
        out["offline"] = (cp.a_cov_offline, cp.a_factor_offline)
    if world == 2:
        errors = {}
        for name, make in (("mppi", make_sharded_mppi_solve),
                           ("rollout", make_sharded_covo_sample_rollout),
                           ("dist", make_distributed_covo_solve)):
            with pytest.raises(ValueError, match="not divisible") as e:
                make(env, mesh, N - 1, H, LAM)
            errors[name] = str(e.value)
        with pytest.raises(ValueError, match="not divisible"):
            make_multichip_covo_step(env, mesh, N - 1, H, LAM)
        out["errors"] = errors
    return _np(out)


def _multichip(env, mesh, inp):
    """STEPS steps of both multichip steps on this rank's block of the B
    scenarios, the outputs gathered over the scenario axis."""
    params_b = mesh.shard(params_from_numpy(inp["params_b"], device="cpu"), SCENARIO_AXIS)
    states = mesh.shard(state_from_numpy(inp["states_b"], device="cpu"), SCENARIO_AXIS)
    a_mean = torch.from_numpy(inp["a_mean"])
    a_means = a_mean.expand(states.time.shape[0], H, 4).clone()
    a_covs = torch.from_numpy(inp["a_cov"]).expand(states.time.shape[0], H, 4, 4).clone()
    mc_mppi = make_multichip_control_step(env, mesh, N, H, LAM)
    mc_covo = make_multichip_covo_step(env, mesh, N, H, LAM, hessian_mode="gn")
    st_m = st_c = states
    am_m, ac_m, am_c = a_means, a_covs, a_means
    for t in range(STEPS):
        keys = mesh.shard(_keys(inp["step_keys"][t]), SCENARIO_AXIS)
        st_m, am_m, ac_m, r_m, d_m = mc_mppi(st_m, params_b, am_m, ac_m, keys)
        st_c, am_c, r_c, d_c = mc_covo(st_c, params_b, am_c, keys)
    return mesh.gather(dict(
        mppi=dict(pos=st_m.pos, time=st_m.time, a_means=am_m, a_covs=ac_m, rewards=r_m,
                  dones=d_m),
        covo=dict(pos=st_c.pos, time=st_c.time, a_means=am_c, rewards=r_c, dones=d_c)),
        SCENARIO_AXIS)


def _rank(rank: int, world: int, inp: dict) -> dict:
    return _port_cases(world, inp)


@pytest.fixture(scope="module")
def runs():
    """JAX's outputs, the port's single-device references, and each world
    size's outputs on every rank (module scope: built once)."""
    import concurrent.futures

    j_in, inp = _jax_inputs()
    # the ranks run beside JAX's compiles (each rank a process of its own)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        launches = pool.submit(lambda: {w: run_ranks(_rank, w, w, inp, timeout_s=240)
                                        for w in (2, 3, 4)})
        ref = _jax_outputs(j_in)
        worlds = {1: [_port_cases(1, inp)]}
        single = _single(inp)
        worlds.update(launches.result())
    return dict(ref=ref, single=single, worlds=worlds, inp=inp)


def _single(inp) -> dict:
    """The port's single-device solves and offline reset on the inputs."""
    env = _env()
    p = params_from_numpy(inp["params"], device="cpu")
    s = state_from_numpy(inp["state"], device="cpu")
    single = {}
    mppi, cp = get_solver(env, "mppi", f"N{N}_H{H}_lam{LAM}", rng_mode="invariant",
                          engine="torch", collect_debug=False)
    key = torch.from_numpy(inp["rng"])
    from covo_mpc_tpu_torch.parallel.sharded import act_step_keys

    # hover and the isotropic covariance are constant over the steps, so
    # the single solver's shift leaves them as the sharded core takes them
    cp = cp.replace(a_mean=torch.from_numpy(inp["a_mean"]),
                    a_cov=torch.from_numpy(inp["a_cov"]),
                    a_cov_chol=torch.linalg.cholesky(torch.from_numpy(inp["a_cov"])))
    _, cp1, _ = mppi(None, s, p, cp, None, key=key)
    single["mppi"] = (cp1.a_mean.numpy(), [k.numpy() for k in act_step_keys(key)])
    for mode in HESSIAN_MODES:
        covo, ccp = get_solver(env, "covo_online", f"N{N}_H{H}_lam{LAM}",
                               rng_mode="invariant", hessian_mode=mode, sigma_mode="ns",
                               engine="torch", collect_debug=False)
        ccp = ccp.replace(a_mean=torch.from_numpy(inp["a_mean"]))
        single[f"dist_{mode}"] = covo(None, s, p, ccp, None, key=key)[1].a_mean.numpy()
    off, ocp = get_solver(env, "covo_offline", f"N{N}_H{H}_lam{LAM}", engine="torch",
                          **OFFLINE)
    ocp = off.reset(s, p, ocp, key=torch.from_numpy(inp["offline_key"]))
    single["offline"] = (ocp.a_cov_offline.numpy(), ocp.a_factor_offline.numpy())
    return single


def _close(got, ref, atol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=atol,
                               err_msg=msg)


def test_mesh_rank_layout_matches_jax_device_grid(runs):
    """make_mesh(samples=2, scenarios=2): rank r sits where JAX's grid puts
    device r (reshape(scenarios, samples): the sample groups contiguous)."""
    grid = runs["ref"]["grid"]
    for rank, out in enumerate(runs["worlds"][4]):
        pos = np.argwhere(grid == rank)[0]
        assert out["coords"] == {SCENARIO_AXIS: int(pos[0]), SAMPLE_AXIS: int(pos[1])}


@pytest.mark.parametrize("k", [1, 2, 4])
def test_sharded_mppi_matches_jax_and_the_single_solver(runs, k):
    """Sharded MPPI over k ranks against JAX's over k devices and the port's
    single MPPI solve (invariant rng, the same keys); every rank returns the
    same; the covariance passes through at gamma_sigma=0."""
    ref, single = runs["ref"][f"mppi{k}"], runs["single"]["mppi"]
    for rank, out in enumerate(runs["worlds"][k]):
        a, c, mc = out["mppi"]
        _close(a, ref[0], msg=f"k={k} rank {rank} mean vs JAX")
        _close(c, ref[1], atol=1e-7, msg="covariance")
        _close(mc, ref[2], msg="min cost")
        _close(c, runs["inp"]["a_cov"], atol=1e-7)
    # the single solver draws from (act_key, step_key) of its key's chain:
    # rerun the one-rank core on those keys to compare
    env, inp = _env(), runs["inp"]
    p = params_from_numpy(inp["params"], device="cpu")
    s = state_from_numpy(inp["state"], device="cpu")
    act_key, step_key = (torch.from_numpy(x) for x in single[1])
    a, _, _ = make_sharded_mppi_solve(env, make_mesh(1), N, H, LAM, engine="torch")(
        pack_state(s), s.time, s.pos_traj, s.vel_traj, torch.from_numpy(inp["a_mean"]),
        torch.from_numpy(inp["a_cov"]), 1.0, 0.0, 1.0, p, act_key, step_key)
    _close(a, single[0], msg="one rank vs the single solver")


@pytest.mark.parametrize("k", [1, 4])
def test_sharded_covo_sample_rollout_matches_jax(runs, k):
    ref = runs["ref"]["rollout"]
    for out in runs["worlds"][k]:
        _close(out["rollout"][0], ref[0], msg=f"k={k}")
        _close(out["rollout"][1], ref[1])


@pytest.mark.parametrize("mode", HESSIAN_MODES)
@pytest.mark.parametrize("k", [1, 4])
def test_distributed_covo_solve_matches_jax_and_the_single_solver(runs, k, mode):
    """The full distributed solve (Hessian, NS designer, sharded core) at k
    ranks against JAX's and against the port's single CoVO solve (invariant
    rng, ns) on the same key."""
    ref = runs["ref"][f"dist_{mode}"]
    for out in runs["worlds"][k]:
        a, mc, _ = out[f"dist_{mode}"]
        _close(a, ref[0], msg=f"{mode} k={k}")
        _close(mc, ref[1])
        _close(a, runs["single"][f"dist_{mode}"], msg="vs the single solver")


def test_solve_metrics_sharded_over_an_axis_matches_jax(runs):
    """collect_metrics over 4 ranks: the cost min / mean / max and the ESS
    from all-reduced partials, and Σ's conditioning, against JAX's."""
    ref = runs["ref"]["dist_adjoint"][2]
    for out in runs["worlds"][4]:
        got = out["dist_adjoint"][2]
        assert set(got) == set(ref)
        for name in ("cost_min", "cost_mean", "cost_max", "ess"):
            np.testing.assert_allclose(got[name], ref[name], rtol=1e-5, err_msg=name)
        for name in ("sigma_cond", "sigma_logdet"):
            np.testing.assert_allclose(got[name], ref[name], rtol=1e-3, err_msg=name)
        assert got["cost_min"] <= got["cost_mean"] <= got["cost_max"]
        assert 1.0 <= got["ess"] <= N


@pytest.mark.parametrize("samples,scenarios", [(2, 1), (1, 2), (2, 2)])
def test_multichip_steps_match_jax(runs, samples, scenarios):
    """Two steps of the multichip MPPI and CoVO steps at B=4 on the mesh,
    gathered over the scenario axis, against JAX's and the port's one-rank
    steps: the new means and covariances, rewards, dones, positions."""
    world = samples * scenarios
    ref = runs["ref"]
    one = runs["worlds"][1][0]["mc11"]
    for out in runs["worlds"][world]:
        got = out[f"mc{samples}{scenarios}"]
        for kind in ("mppi", "covo"):
            for name, v in ref[f"mc_{kind}"].items():
                atol = 1e-7 if name == "a_covs" else TOL
                _close(got[kind][name], v, atol=atol, msg=f"{kind} {name} vs JAX")
                _close(got[kind][name], one[kind][name], atol=atol, msg=f"{kind} {name}")
            assert (got[kind]["time"] == STEPS).all()


def test_one_rank_multichip_steps_match_jax(runs):
    ref, got = runs["ref"], runs["worlds"][1][0]["mc11"]
    for kind in ("mppi", "covo"):
        for name, v in ref[f"mc_{kind}"].items():
            _close(got[kind][name], v, msg=f"{kind} {name}")
        assert np.abs(got[kind]["a_means"] - runs["inp"]["a_mean"]).max() > 0.0


@pytest.mark.parametrize("k", [2, 3])
def test_distributed_offline_schedule_matches_single_reset_and_jax(runs, k):
    """The schedule designed over k ranks (k=3 pads 300 to 301) equals the
    port's single-device offline reset, and its first states JAX's."""
    cov_s, fac_s = runs["single"]["offline"]
    head_c, head_f = runs["ref"]["offline_head"]
    for out in runs["worlds"][k]:
        cov, fac = out["offline"]
        assert cov.shape == cov_s.shape == (300, 4 * H, 4 * H)
        _close(cov, cov_s, atol=1e-6, msg=f"k={k} cov vs the single reset")
        _close(fac, fac_s, atol=1e-6, msg="factor")
        _close(cov[:4], head_c, msg="cov vs JAX")
        _close(fac[:4], head_f, msg="factor vs JAX")


def test_errors_match_jax():
    """N not divided by the shards, an unknown engine (JAX's names name the
    port's), rng='kernel' without engine='cuda', an online solver for the
    offline schedule, a mesh larger than the job."""
    env, mesh = _env(), make_mesh(1)
    for make in (make_sharded_mppi_solve, make_sharded_covo_sample_rollout,
                 make_distributed_covo_solve, make_multichip_control_step,
                 make_multichip_covo_step):
        with pytest.raises(ValueError, match="unknown engine 'pallas'.*'cuda'"):
            make(env, mesh, N, H, LAM, engine="pallas")
        with pytest.raises(ValueError, match="unknown engine"):
            make(env, mesh, N, H, LAM, engine="xla")
        with pytest.raises(ValueError, match="rng='kernel' requires engine='cuda'"):
            make(env, mesh, N, H, LAM, engine="torch", rng="kernel")
        with pytest.raises(ValueError, match="rng"):
            make(env, mesh, N, H, LAM, rng="fast")
    online, _ = get_solver(env, "covo_online", "N4_H2_lam0.01")
    with pytest.raises(ValueError, match="offline"):
        make_distributed_offline_schedule(online, mesh)
    with pytest.raises(ValueError, match="2x1 != 1 ranks"):
        make_mesh(samples=2)
    with pytest.raises(ValueError, match="initialize a process group"):
        Mesh((SAMPLE_AXIS,), (2,))


def test_indivisible_n_raises_on_every_rank(runs):
    for out in runs["worlds"][2]:
        assert set(out["errors"]) == {"mppi", "rollout", "dist"}
        assert all(f"N={N - 1} not divisible by 2" in m for m in out["errors"].values())


def test_bench_mesh_rows_and_metrics_jsonl(tmp_path, capsys):
    """``scripts/bench_mesh.py`` on the CPU at one rank: one JSON line a
    mode (sample sharding, scenario DP, the offline schedule), each marked
    plumbing with its method and device, and ``--metrics`` writes one
    finite health record a solve (JAX's tests/test_sharding.py:626)."""
    import json

    from covo_mpc_tpu_torch.scripts import bench_mesh

    path = tmp_path / "mesh_metrics.jsonl"
    assert bench_mesh.main(["--device", "cpu", "--n", "64", "--h", "4", "--k", "2",
                            "--hessian", "gn", "--scenarios", "1", "--b", "2",
                            "--offline", "--metrics", str(path),
                            "--metrics-steps", "3"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["axis"] for r in rows] == ["samples", "scenarios", "offline_schedule"]
    for r in rows:
        assert r["plumbing"] and r["method"] == "host_wall" and r["backend"] is None
        assert r["device"] == {"name": "cpu", "power_limit": None}
    assert rows[0]["shards"] == 1 and rows[0]["ms_per_solve"] > 0
    records = [json.loads(line) for line in open(path)]
    assert len(records) == 3
    for rec in records:
        assert rec["shards"] == 1
        for k in ("cost_min", "cost_mean", "cost_max", "ess", "sigma_cond", "sigma_logdet"):
            assert np.isfinite(rec[k]), k


def test_pod_scale_memory_arithmetic_matches_jax():
    """``scripts/pod_scale.py``'s static memory rows are JAX's, byte for
    byte, at config #5's per-rank block and at the sweep's first B."""
    import importlib.util
    import io
    import os

    from covo_mpc_tpu_torch.scripts import pod_scale

    spec = importlib.util.spec_from_file_location("j_pod_scale", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
        "pod_scale.py"))
    j_pod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_pod)
    for B in (8, 128):
        assert pod_scale.hbm_arithmetic(B, 8192, 32, out=io.StringIO()) == \
            j_pod.hbm_arithmetic(B, 8192, 32, out=io.StringIO())
