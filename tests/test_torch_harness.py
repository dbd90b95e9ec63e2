"""The port's harness against the JAX package's: solve metrics, the metrics
JSONL, checkpoints both ways, render traces, debug mode, the command line
and the supervised eval.

Inputs are made with numpy from a seed and handed to both packages (JAX on
the CPU). Tolerances: the cost statistics within relative 1e-5, the ESS
1e-4 and Sigma's conditioning and log-determinant 1e-3 on the same costs,
weights and Sigma; on a whole solve fed JAX's normals, the ESS within
relative 2e-3 (at lambda=0.01 a 1e-6 difference in a cost moves a weight by
about 1e-4), the cost statistics 1e-4 and Sigma's 1e-3; a solve from a
loaded schedule BASELINE.md's 2e-4. The supervisor cases mirror
tests/test_supervisor.py. The card's cases (captured episode metrics and
render against eager ones, the CLI eval's kernel launches) are in
tests/test_torch_graphs.py, which imports no JAX: the card's machine has
no flax, so this file does not import there.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covo_mpc_tpu import cli as jcli
from covo_mpc_tpu.runtime import checkpoint as jckpt
from covo_mpc_tpu.runtime import eval as jeval
from covo_mpc_tpu.runtime import metrics as jmetrics
from covo_mpc_tpu.runtime import render as jrender
from covo_mpc_tpu.solvers import get_solver as j_get_solver
from covo_mpc_tpu_torch import cli
from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv
from covo_mpc_tpu_torch.runtime import (
    EvalResult,
    checkpoint,
    debug,
    evaluate,
    metrics,
    render,
)
from covo_mpc_tpu_torch.runtime.episode import eager_episode
from covo_mpc_tpu_torch.runtime.eval import write_metrics_jsonl
from covo_mpc_tpu_torch.runtime.supervisor import run_supervised
from covo_mpc_tpu_torch.solvers import (
    FAST_PATH,
    PIDParams,
    PIDSolver,
    covo_params_from_numpy,
    get_solver,
    mppi_params_from_numpy,
)
from tests.test_torch_models import leaves, make_envs, to_torch_params, to_torch_state

N, H = 1024, 8
PSTR = f"N{N}_H{H}_lam0.01"
ENV_KW = dict(task="tracking", enable_randomizer=False, disturb_type="gaussian",
              disable_rollover_terminate=True, generate_noisy_state=True)


def cpu_env(**overrides):
    return QuadEnv(EnvConfig(**{**ENV_KW, **overrides}), device="cpu")


def _spd(rng, d):
    a = rng.standard_normal((d, d)).astype(np.float32)
    return (a @ a.T / d + 0.1 * np.eye(d, dtype=np.float32)).astype(np.float32)


# --- metrics -----------------------------------------------------------------------


def test_solve_and_sigma_metrics_match_jax():
    """solve_metrics on costs (8192,) and their softmax weights, and
    sigma_metrics on a 128x128 SPD Sigma, against JAX's on the same arrays;
    a leading axis gives one value per row."""
    rng = np.random.default_rng(0)
    costs = (rng.standard_normal(8192) * 3.0 - 50.0).astype(np.float32)
    w = np.exp(-(costs - costs.min()) / 2.0)
    w = (w / w.sum()).astype(np.float32)
    sigma = _spd(rng, 128)
    got = metrics.solve_metrics(torch.from_numpy(costs), torch.from_numpy(w))
    ref = jmetrics.solve_metrics(jnp.asarray(costs), jnp.asarray(w))
    assert set(got) == set(ref)
    for k in ("cost_min", "cost_mean", "cost_p90"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(got["ess"]), float(ref["ess"]), rtol=1e-4)
    got_s = metrics.sigma_metrics(torch.from_numpy(sigma))
    ref_s = jmetrics.sigma_metrics(jnp.asarray(sigma))
    assert set(got_s) == set(ref_s)
    for k in got_s:
        np.testing.assert_allclose(float(got_s[k]), float(ref_s[k]), rtol=1e-3, err_msg=k)
    batched = metrics.sigma_metrics(torch.from_numpy(np.stack([sigma, 2.0 * sigma])))
    assert batched["sigma_cond"].shape == (2,)
    torch.testing.assert_close(batched["sigma_cond"][0], got_s["sigma_cond"])
    sharded = metrics.solve_metrics_sharded(torch.from_numpy(costs), torch.from_numpy(w),
                                            None, 8192)
    ref_sh = jmetrics.solve_metrics_sharded(jnp.asarray(costs), jnp.asarray(w), None, 8192)
    assert set(sharded) == set(ref_sh)
    np.testing.assert_allclose(float(sharded["cost_max"]), float(ref_sh["cost_max"]))
    # over a mesh axis: a one-rank mesh's collectives are the identity, so
    # the sharded form equals the local one; a bare axis name raises
    from covo_mpc_tpu_torch.parallel import make_mesh

    one = metrics.solve_metrics_sharded(torch.from_numpy(costs), torch.from_numpy(w),
                                        make_mesh(1).axis("samples"), costs.shape[-1])
    for k in sharded:
        torch.testing.assert_close(one[k], sharded[k], rtol=1e-6, atol=0, msg=k)
    with pytest.raises(TypeError, match="mesh.axis"):
        metrics.solve_metrics_sharded(torch.from_numpy(costs), torch.from_numpy(w), "x", 1)
    # deferred: Sigma handed back, resolved over the stack afterwards
    with metrics.deferred_sigma():
        assert set(metrics.sigma_metrics(torch.from_numpy(sigma))) == {metrics.SIGMA}
    resolved = metrics.resolve_sigma({"ess": torch.ones(2),
                                      metrics.SIGMA: torch.from_numpy(np.stack([sigma] * 2))})
    assert set(resolved) == {"ess", "sigma_cond", "sigma_logdet"}
    assert torch.equal(resolved["sigma_cond"][0], got_s["sigma_cond"])


@pytest.mark.parametrize("name", ["covo_online", "mppi"])
def test_solve_info_metrics_match_jax(name):
    """info["metrics"] of one solve fed the normals JAX's fast sampler drew
    (and MPPI's shared disturbance draw): JAX's keys, the ESS within
    relative 2e-3."""
    jenv, env = make_envs()
    kw = dict(rng_mode="fast", engine="jnp", collect_debug=False, collect_metrics=True)
    if name != "mppi":
        kw.update(hessian_mode="gn", sigma_mode="ns")
    jsolver, jcp = j_get_solver(jenv, name, PSTR, **kw)
    jp = jenv.default_params
    obs, info, state = jenv.reset_env(jax.random.PRNGKey(0), jp)
    key = jax.random.PRNGKey(5)
    _, _, jout = jsolver(obs, state, jp, key, jcp, info)
    tkw = dict(rng_mode="fast", engine="torch", collect_debug=False, collect_metrics=True)
    if name != "mppi":
        tkw.update(hessian_mode="gn", sigma_mode="ns")
    solver, _ = get_solver(env, name, PSTR, **tkw)
    tinfo = {"noisy_state": to_torch_state(info["noisy_state"])}
    rest, act_key = jax.random.split(key)
    if name == "mppi":
        cp = mppi_params_from_numpy(leaves(jcp), device="cpu")
        z = jax.random.normal(act_key, (N, H, 4))
        extra = dict(draw=torch.from_numpy(np.array(
            jax.random.normal(jax.random.split(rest)[1], (3,)))))
    else:
        cp = covo_params_from_numpy(leaves(jcp), device="cpu")
        z = jax.random.normal(act_key, (N, 4 * H))
        extra = {}
    _, _, out = solver(None, to_torch_state(state), to_torch_params(jp), cp, tinfo,
                       z=torch.from_numpy(np.array(z)), **extra)
    got, ref = out["metrics"], jout["metrics"]
    assert set(got) == set(ref)
    np.testing.assert_allclose(float(got["ess"]), float(ref["ess"]), rtol=2e-3)
    for k in ("cost_min", "cost_mean", "cost_p90"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4, err_msg=k)
    for k in set(got) & {"sigma_cond", "sigma_logdet"}:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-3, err_msg=k)
    # without collect_metrics a solve reports nothing
    plain, _ = get_solver(env, name, PSTR, **{**tkw, "collect_metrics": False})
    assert plain(None, to_torch_state(state), to_torch_params(jp), cp, tinfo,
                 z=torch.from_numpy(np.array(z)), **extra)[2] == {}


def test_metrics_jsonl_matches_jax(tmp_path):
    """write_metrics_jsonl of both packages on the same (num_eps, T) arrays:
    the same records field for field but the wall-clock stamp; a second
    run on the same path truncates the first's records."""
    rng = np.random.default_rng(1)
    arrs = {k: rng.standard_normal((2, 5)).astype(np.float32)
            for k in ("cost_min", "ess", "sigma_cond")}
    err = rng.random(2).astype(np.float32)
    jpath, tpath = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    jeval.write_metrics_jsonl({k: jnp.asarray(v) for k, v in arrs.items()},
                              jnp.asarray(err), str(jpath))
    for _ in range(2):
        write_metrics_jsonl({k: torch.from_numpy(v) for k, v in arrs.items()},
                            torch.from_numpy(err), str(tpath))
    jrecs = [json.loads(line) for line in jpath.read_text().splitlines()]
    trecs = [json.loads(line) for line in tpath.read_text().splitlines()]
    assert len(trecs) == len(jrecs) == 10
    for a, b in zip(trecs, jrecs):
        a.pop("t"), b.pop("t")
        assert a == b
    log = metrics.MetricsLogger()
    log.log(0, err=0.1)
    log.log(1, err=0.2)
    assert log.summary()["err"]["last"] == pytest.approx(0.2)


# --- checkpoints -------------------------------------------------------------------


def test_solver_state_checkpoints_load_both_ways(tmp_path):
    """A JAX save_solver_state file loads into the port's params and a port
    file into JAX's load_solver_state, every array equal (MPPI and CoVO)."""
    jenv, env = make_envs()
    for name, from_numpy in (("mppi", mppi_params_from_numpy),
                             ("covo_speculative", covo_params_from_numpy)):
        _, jcp = j_get_solver(jenv, name, "N16_H4_lam0.01", rng_mode="fast",
                              engine="jnp", collect_debug=False)
        _, cp = get_solver(env, name, "N16_H4_lam0.01", **FAST_PATH)
        jcp2 = jcp.replace(a_mean=jcp.a_mean + 0.1, a_cov=jcp.a_cov * 1.5)
        jpath = jckpt.save_solver_state(jcp2, str(tmp_path / f"j_{name}.npz"))
        loaded = checkpoint.load_solver_state(cp, jpath)
        ref = from_numpy(leaves(jcp2), device="cpu")
        for f in ("a_mean", "a_cov"):
            assert torch.equal(getattr(loaded, f), getattr(ref, f)), (name, f)
        assert loaded.gamma_mean == jcp2.gamma_mean
        cp2 = cp.replace(a_mean=cp.a_mean - 0.2)
        tpath = checkpoint.save_solver_state(cp2, str(tmp_path / f"t_{name}.npz"))
        back = jckpt.load_solver_state(jcp, tpath)
        for f in ("a_mean", "a_cov"):
            np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                          getattr(cp2, f).numpy(), err_msg=f)
    r = EvalResult(err_pos_ep=torch.tensor([0.1, 0.2]), mean=0.15, std=0.05)
    with np.load(checkpoint.save_eval_result(r, str(tmp_path / "e.npz"))) as data:
        np.testing.assert_allclose(data["err_pos_ep"], [0.1, 0.2])
        assert float(data["mean"]) == pytest.approx(0.15)


def test_jax_offline_schedule_drives_the_port(tmp_path):
    """A JAX offline Sigma schedule (its first 4 steps, JAX's
    offline_sigma_at on its schedule states), saved by JAX and loaded into
    the port, gives the port's offline solve JAX's action within 2e-4 on
    JAX's normals."""
    jenv, env = make_envs()
    jkw = dict(rng_mode="fast", hessian_mode="gn", sigma_mode="ns", engine="jnp",
               collect_debug=False)
    jsolver, jcp = j_get_solver(jenv, "covo_offline", PSTR, **jkw)
    solver, cp = get_solver(env, "covo_offline", PSTR, rng_mode="fast", hessian_mode="gn",
                            sigma_mode="ns", engine="torch", collect_debug=False)
    jp = jenv.default_params
    obs, info, state = jenv.reset_env(jax.random.PRNGKey(0), jp)
    states, keys = jsolver.offline_schedule_inputs(state, jp, jax.random.PRNGKey(7))
    head = jax.tree_util.tree_map(lambda x: x[:4], (states, keys))
    c, f = jax.vmap(lambda s, k: jsolver.offline_sigma_at(s, k, jp, 0.5))(*head)
    jcp = jcp.replace(a_cov_offline=c, a_factor_offline=f)
    path = jckpt.save_solver_state(jcp, str(tmp_path / "schedule.npz"))
    loaded = checkpoint.load_solver_state(cp, path)
    assert loaded.a_factor_offline.shape == (4, 4 * H, 4 * H)
    key = jax.random.PRNGKey(9)
    a_ref, _, _ = jsolver(None, state, jp, key, jcp, info)
    z = torch.from_numpy(np.array(jax.random.normal(jax.random.split(key)[1], (N, 4 * H))))
    a, _, _ = solver(None, to_torch_state(state), to_torch_params(jp), loaded,
                     {"noisy_state": to_torch_state(info["noisy_state"])}, z=z)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), atol=2e-4)


# --- render ------------------------------------------------------------------------


def test_render_trace_matches_jax_channels(tmp_path):
    """The trace's channels and shapes equal a JAX render_episode's (5
    steps); err_pos is aligned with |pos - pos_tar| of the same row; the
    .npz round trip keeps every array."""
    from covo_mpc_tpu.models import EnvConfig as JEnvConfig
    from covo_mpc_tpu.models import QuadEnv as JQuadEnv

    jenv = JQuadEnv(JEnvConfig(**ENV_KW))
    jsolver, _ = j_get_solver(jenv, "pid")
    ref = jrender.render_episode(jenv, jsolver, seed=1, steps=5)
    env = cpu_env()
    solver, _ = get_solver(env, "pid")
    trace = render.render_episode(env, solver, seed=1, steps=5)
    assert set(trace) == set(ref) == set(render.RECORD_FIELDS) | {"reward", "done",
                                                                 "err_pos", "action"}
    for k in trace:
        assert trace[k].shape == ref[k].shape, k
    long = render.render_episode(env, solver, seed=1, steps=50)
    np.testing.assert_allclose(long["err_pos"],
                               np.linalg.norm(long["pos"] - long["pos_tar"], axis=-1),
                               atol=1e-5)
    loaded = render.load_trace(render.save_trace(long, str(tmp_path / "trace.npz")))
    assert set(loaded) == set(long)
    for k in long:
        np.testing.assert_array_equal(loaded[k], long[k])


def test_render_reset_on_done():
    """Mid-recording resets (the mirror of tests/test_harness.py's): the
    traces agree through the first done and part after it (new params and
    a controller reset)."""
    env = cpu_env(enable_randomizer=True)
    short = env.default_params.replace(max_steps_in_episode=10)
    solver, _ = get_solver(env, "mppi", "N8_H3_lam0.01", rng_mode="fast", collect_debug=False)
    kw = dict(seed=1, steps=25, env_params=short)
    t_plain = render.render_episode(env, solver, reset_on_done=False, **kw)
    t_reset = render.render_episode(env, solver, reset_on_done=True, **kw)
    done_at = int(np.argmax(t_plain["done"]))
    assert t_plain["done"][done_at]
    np.testing.assert_array_equal(t_reset["pos"][: done_at + 1],
                                  t_plain["pos"][: done_at + 1])
    np.testing.assert_array_equal(t_reset["action"][: done_at + 1],
                                  t_plain["action"][: done_at + 1])
    assert not np.allclose(t_reset["action"][done_at + 1:],
                           t_plain["action"][done_at + 1:])
    assert np.isfinite(t_reset["pos"]).all()


def test_plotting(tmp_path):
    pytest.importorskip("matplotlib")
    from covo_mpc_tpu_torch.utils.plotting import plot_episode, plot_eval_errors

    env = cpu_env()
    solver, _ = get_solver(env, "pid")
    trace = render.render_episode(env, solver, seed=1, steps=30)
    assert os.path.exists(plot_episode(trace, 0.02, str(tmp_path / "ep.png")))
    assert os.path.exists(plot_eval_errors(torch.tensor([0.1, 0.2]),
                                           str(tmp_path / "ev.png")))


# --- debug mode --------------------------------------------------------------------


def test_debug_mode_restores_and_checked_solver_raises():
    """debug_mode() sets the eager and non-finite switches for its scope
    only (nested too); checked_solver raises on a NaN state; an eager
    episode in debug mode names the step of the first non-finite solve."""
    assert not debug.jit_disabled() and not debug.nans_checked()
    with debug.debug_mode():
        assert debug.jit_disabled() and debug.nans_checked()
        with debug.debug_mode(nans=False, disable_jit=False):
            assert not debug.jit_disabled() and not debug.nans_checked()
        assert debug.jit_disabled() and debug.nans_checked()
    assert not debug.jit_disabled() and not debug.nans_checked()
    with pytest.raises(RuntimeError):
        with debug.debug_mode():
            raise RuntimeError("leaves the scope")
    assert not debug.nans_checked()

    env = cpu_env()
    solver, cp = get_solver(env, "mppi", "N16_H4_lam0.01", rng_mode="fast", collect_debug=False)
    obs, info, state = env.reset(torch.Generator().manual_seed(0))
    solve = debug.checked_solver(solver)
    action, _, _ = solve(obs, state, env.default_params, cp, info)
    assert bool(torch.isfinite(action).all())
    bad = state.replace(pos=torch.full_like(state.pos, float("nan")))
    with pytest.raises(FloatingPointError, match="non-finite"):
        solve(obs, bad, env.default_params, cp, None)

    nan_pid = PIDSolver(env, PIDParams.default("cpu", Kp=float("nan"), Kd=5.0, Ki=0.0,
                                               Kp_att=10.0))
    with debug.debug_mode():
        with pytest.raises(FloatingPointError, match="step 0"):
            eager_episode(env, nan_pid, 5, torch.Generator().manual_seed(0),
                          torch.Generator().manual_seed(1))


# --- the command line --------------------------------------------------------------


def _options(parser):
    return {s: a.default for a in parser._actions for s in a.option_strings
            if s not in ("-h", "--help")}


def test_cli_options_are_jax_plus_device():
    """The port's flags are JAX's build_parser() flags plus --device, with
    JAX's defaults; the JAX engine names raise, naming the counterpart."""
    ours, theirs = _options(cli.build_parser()), _options(jcli.build_parser())
    assert set(ours) == set(theirs) | {"--device"}
    assert {k: v for k, v in ours.items() if k != "--device"} == theirs
    assert ours["--device"] == "cuda"
    with pytest.raises(ValueError, match="'torch'"):
        cli.main(["--engine", "jnp", "--device", "cpu"])
    with pytest.raises(ValueError, match="--device cuda"):
        cli.main(["--engine", "cuda", "--device", "cpu"])


def test_cli_eval_metrics_jsonl(tmp_path, capsys):
    """eval --metrics at --debug on the CPU: 300 finite records (one per
    solve), the ESS within [1, N=4]."""
    rc = cli.main(["--device", "cpu", "--debug", "--task", "hovering",
                   "--controller", "covo_online", "--mode", "eval", "--noDR",
                   "--name", "msmoke", "--metrics", "--total-steps", "300",
                   "--results-dir", str(tmp_path)])
    assert rc == 0
    assert "err_pos:" in capsys.readouterr().out
    assert (tmp_path / "eval_msmoke.npz").exists()
    recs = [json.loads(line) for line in
            (tmp_path / "metrics_msmoke.jsonl").read_text().splitlines()]
    assert len(recs) == 300
    for key in ("ess", "sigma_cond", "sigma_logdet", "cost_min", "cost_p90", "err_pos"):
        assert all(np.isfinite(r[key]) for r in recs), key
    assert all(1.0 - 1e-6 <= r["ess"] <= 4.0 + 1e-6 for r in recs)


@pytest.mark.parametrize("mode", ["render", "bench"])
def test_cli_render_and_bench(tmp_path, capsys, mode):
    """render writes its trace; bench prints one parseable JSON line with
    JAX's keys and the device."""
    rc = cli.main(["--device", "cpu", "--debug", "--task", "hovering",
                   "--controller", "mppi", "--mode", mode, "--noDR", "--name", "smoke",
                   "--results-dir", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    if mode == "render":
        assert (tmp_path / "trace_smoke.npz").exists()
        assert "mean err_pos" in out
    else:
        line = json.loads([x for x in out.splitlines() if x.startswith("{")][-1])
        assert line["per_dispatch"]["iters"] == 20 and line["per_dispatch"]["p50"] > 0
        assert line["amortized_per_solve"] is None  # CUDA events need the card
        assert line["device"] == {"name": "cpu", "power_limit": None}


# --- the supervised eval (mirrors of tests/test_supervisor.py) ---------------------


def _pid(env):
    return get_solver(env, "pid")[0]


def test_supervised_matches_evaluate(tmp_path):
    """Chunked supervision equals the unchunked protocol bit for bit, a
    ragged tail chunk included (3 episodes in chunks of 2)."""
    env = cpu_env()
    ref = evaluate(env, _pid(env), total_steps=900, seed=1)
    sup = run_supervised(env, _pid(env), total_steps=900, seed=1,
                         checkpoint_dir=str(tmp_path / "ckpt"), chunk_episodes=2)
    np.testing.assert_array_equal(sup.err_pos_ep.numpy().astype(np.float32),
                                  ref.err_pos_ep.numpy())
    assert sup.mean == pytest.approx(ref.mean, rel=1e-6) and not sup.failed.any()
    with open(tmp_path / "ckpt" / "manifest.json") as fh:
        assert json.load(fh)["completed"] == 2


def test_supervised_crash_then_resume_mppi(tmp_path):
    """Retries exhausted -> RuntimeError after checkpointing; the same call
    resumes at the failed chunk, and the result (MPPI: the solver's seed
    stream and generator ride in the checkpoint) equals an uninterrupted
    run bit for bit; a backend failure is logged on disk."""
    env = cpu_env()
    make = lambda: get_solver(env, "mppi", "N16_H4_lam0.01",
                              rng_mode="fast", collect_debug=False)[0]
    ref = run_supervised(env, make(), total_steps=900, seed=5, chunk_episodes=1)
    ckpt = str(tmp_path / "ckpt")

    def hook(chunk, attempt):
        if chunk == 1:
            raise RuntimeError("persistent outage")

    with pytest.raises(RuntimeError, match="re-run the same command"):
        run_supervised(env, make(), total_steps=900, seed=5, checkpoint_dir=ckpt,
                       chunk_episodes=1, max_retries=1, _fault_hook=hook)
    with open(os.path.join(ckpt, "events.jsonl")) as fh:
        events = [json.loads(line) for line in fh]
    assert sum(e["kind"] == "backend_failure" for e in events) == 2
    sup = run_supervised(env, make(), total_steps=900, seed=5, checkpoint_dir=ckpt,
                         chunk_episodes=1)
    assert sup.resumed_at_chunk == 1
    np.testing.assert_array_equal(sup.err_pos_ep.numpy(), ref.err_pos_ep.numpy())
    unsup = evaluate(env, make(), total_steps=900, seed=5)
    np.testing.assert_array_equal(sup.err_pos_ep.numpy().astype(np.float32),
                                  unsup.err_pos_ep.numpy())


def test_supervised_refuses_a_mismatched_checkpoint(tmp_path):
    env = cpu_env()
    ckpt = str(tmp_path / "ckpt")
    run_supervised(env, _pid(env), total_steps=300, seed=1, checkpoint_dir=ckpt,
                   chunk_episodes=1, fingerprint="a")
    with pytest.raises(ValueError, match="different protocol"):
        run_supervised(env, _pid(env), total_steps=300, seed=1, checkpoint_dir=ckpt,
                       chunk_episodes=1, fingerprint="b")


def test_supervised_excludes_a_numeric_failure(tmp_path):
    env = cpu_env()
    nan_pid = PIDSolver(env, PIDParams.default("cpu", Kp=float("nan"), Kd=5.0, Ki=0.0,
                                               Kp_att=10.0))
    sup = run_supervised(env, nan_pid, total_steps=600, seed=1,
                         checkpoint_dir=str(tmp_path / "ckpt"), chunk_episodes=1,
                         max_retries=1)
    assert sup.failed.all() and np.isnan(sup.mean)
    assert any(e["kind"] == "numeric_failure" for e in sup.events)
    assert "FAILED" in sup.summary()


def test_supervised_non_divisible_total(tmp_path):
    """5 episodes' worth of steps over 4 trajectories: evaluate runs 4, and
    so does the supervisor."""
    env = cpu_env()
    ref = evaluate(env, _pid(env), total_steps=1500, seed=1)
    sup = run_supervised(env, _pid(env), total_steps=1500, seed=1,
                         checkpoint_dir=str(tmp_path / "ckpt"), chunk_episodes=3)
    assert sup.err_pos_ep.shape == ref.err_pos_ep.shape == (4,)
    np.testing.assert_array_equal(sup.err_pos_ep.numpy().astype(np.float32),
                                  ref.err_pos_ep.numpy())


def test_supervised_retries_a_backend_failure(tmp_path):
    env = cpu_env()
    ref = evaluate(env, _pid(env), total_steps=600, seed=3)
    armed = {"on": True}

    def hook(chunk, attempt):
        if chunk == 1 and attempt == 0 and armed.pop("on", False):
            raise RuntimeError("injected outage")

    sup = run_supervised(env, _pid(env), total_steps=600, seed=3,
                         checkpoint_dir=str(tmp_path / "ckpt"), chunk_episodes=1,
                         _fault_hook=hook)
    np.testing.assert_array_equal(sup.err_pos_ep.numpy().astype(np.float32),
                                  ref.err_pos_ep.numpy())
    assert "backend_failure" in [e["kind"] for e in sup.events]


def test_probe_gates_retry():
    env = cpu_env()
    calls = []

    def hook(chunk, attempt):
        raise RuntimeError("down")

    with pytest.raises(RuntimeError):
        run_supervised(env, _pid(env), total_steps=300, seed=1, max_retries=3,
                       probe=lambda: calls.append(1) or False, _fault_hook=hook)
    assert len(calls) == 1
