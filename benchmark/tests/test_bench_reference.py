"""The frozen reference against the port's plain path (the CPU engine) at
tiny sizes, the Philox draws against Random123's known answers, and the
comparison on answers made to agree and to disagree."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import check, harness
from benchmark.reference import covo, mppi, quad

H, N = 6, 48


def _cfg(name):
    return json.load(open(os.path.join(harness.ROOT, "benchmark", "configs", f"{name}.json")))


CFG = _cfg("covo_online_n8192_h32")


@pytest.fixture(scope="module")
def scene():
    """A CPU env a few steps into an episode, a CoVO solver on the plain
    engine, and the reference plant."""
    from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv
    from covo_mpc_tpu_torch.solvers import get_solver

    e = CFG["env"]
    env = QuadEnv(EnvConfig(task=e["task"], enable_randomizer=False,
                            disturb_type=e["disturb_type"], disable_rollover_terminate=True,
                            generate_noisy_state=True), device="cpu")
    g = torch.Generator().manual_seed(5)
    solver, cp = get_solver(env, "covo_online", f"N{N}_H{H}_lam0.01", rng_mode="fast",
                            hessian_mode="gn", sigma_mode="ns", collect_debug=False,
                            engine="torch", seed=1)
    obs, info, st = env.reset(g)
    p = env.default_params
    for _ in range(4):
        a, cp, _ = solver(obs, st, p, cp, info)
        obs, st, _, _, info = env.step(g, st, a, p)
    return env, solver, cp, obs, st, info, g, quad.Plant(e, torch.float64)


def _obs(state):
    from covo_mpc_tpu_torch.models.structs import pack_state

    return dict(x0=pack_state(state).double()[None], t0=state.time[None],
                pos_traj=state.pos_traj.double()[None], vel_traj=state.vel_traj.double()[None])


def test_philox_known_answers():
    """Random123's philox4x32-10 known-answer vectors."""
    cases = [((0, 0, 0, 0), 0, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, 0xFFFFFFFFFFFFFFFF,
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), 0x299F31D0A4093822,
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        got = quad.philox4x32_10([torch.tensor([w], dtype=torch.int64) for w in ctr], key)
        assert [int(x) for x in got] == list(want)


def test_seed_words_follow_the_seed_stream():
    """solve_key is the port's SeedStream word of the k-th solve."""
    from covo_mpc_tpu_torch.ops.sampling import SeedStream

    for seed in (0, 2**31 + 7, 2**64 - 9):
        stream = SeedStream("cpu", seed)
        for k in (1, 2, 3):
            word = int(stream.next()[0]) & quad.M64
            assert word == quad.solve_key(seed, k)


def test_hessian_sigma_costs_against_the_plain_path(scene):
    from covo_mpc_tpu_torch.models.structs import pack_state
    from covo_mpc_tpu_torch.ops.covariance import optimize_sigma_ns
    from covo_mpc_tpu_torch.ops.hessian import make_hessian_adjoint
    from covo_mpc_tpu_torch.ops.rollout import make_rollout

    env, solver, cp, obs, st, info, g, P = scene
    ns, p = info["noisy_state"], env.default_params
    o = _obs(ns)
    nom = quad.shift(cp.a_mean.double()[None])
    R_port = make_hessian_adjoint(env, H, second_order=False)(
        nom[0].float().flatten(), pack_state(ns), ns.time, ns.pos_traj, ns.vel_traj, p)
    R = quad.gn_hessian(P, o["x0"], o["t0"], o["pos_traj"], o["vel_traj"], nom)
    assert (R_port.double() - R[0]).abs().max() <= 1e-5 * R.abs().max()
    S_port, F_port = optimize_sigma_ns(R_port, 0.5, 4 * H)
    S, F = quad.ns_sigma(R, 0.5)
    assert (S_port.double() - S[0]).abs().max() <= 1e-5 * S.abs().max()
    assert (F_port.double() - F[0]).abs().max() <= 1e-5
    z = quad.kernel_normals(99, [0], N, H, "cpu").reshape(1, N, 4 * H)
    acts = quad.clip(nom.reshape(1, 1, -1) + z @ F.mT)
    c = quad.rollout_costs(P, o["x0"], o["t0"], o["pos_traj"], o["vel_traj"],
                           acts.reshape(1, N, H, 4), o["x0"].new_zeros(1, 3))
    c_port = make_rollout(env)(pack_state(ns), ns.time, ns.pos_traj, ns.vel_traj,
                               acts[0].float().reshape(N, H, 4), p, None, deterministic=True)
    assert (c_port.double() - c[0]).abs().max() <= 2e-5 * (1 + c.abs().max())


def test_covo_solve_against_the_plain_path(scene):
    """The reference's step against the port's solve fed the same normals."""
    env, solver, cp, obs, st, info, g, P = scene
    key = 4321
    z = quad.kernel_normals(key, [0], N, H, "cpu").reshape(N, 4 * H).float()
    _, cp2, _ = solver(obs, st, env.default_params, cp, info, z=z)
    mean, sigma, _ = covo.solve(P, dict(N=N, sample_sigma=0.5, lam=0.01),
                                _obs(info["noisy_state"]),
                             cp.a_mean.double()[None], key, [0])
    assert (cp2.a_mean.double() - mean[0]).abs().max() <= 1e-4
    assert (cp2.a_cov.double() - sigma[0]).abs().max() <= 1e-5 * sigma.abs().max()


def test_mppi_solve_against_the_plain_batched_path(scene):
    from covo_mpc_tpu_torch.models.structs import expand_params
    from covo_mpc_tpu_torch.parallel import make_batched_mppi_solve
    from covo_mpc_tpu_torch.solvers.factory import hover_sequence

    env, solver, cp, obs, st, info, g, P = scene
    ns, B = info["noisy_state"], 2
    o = {k: v.expand(B, *v.shape[1:]) for k, v in _obs(ns).items()}
    means = hover_sequence(env, H).double()[None].repeat(B, 1, 1)
    means[1] += 0.05
    covs = (torch.eye(4, dtype=torch.float64) * 0.25).expand(B, H, 4, 4)
    draws = torch.randn(B, 3, generator=torch.Generator().manual_seed(2)).double()
    key = 777
    ref, _, _ = mppi.solve(P, dict(N=N, lam=0.01), o, means, covs, key, [3, 9], draws)
    z = quad.kernel_normals(key, [3, 9], N, H, "cpu").float()
    solve = make_batched_mppi_solve(env, N, H, 0.01, rng="fast", engine="torch")
    new, _, _ = solve(o["x0"].float(), o["t0"], o["pos_traj"].float(), o["vel_traj"].float(),
                      means.float(), covs.float().contiguous(),
                      expand_params(env.default_params, B), 1.0, 0.0, 1.0, z=z,
                      draws=draws.float())
    assert (new.double() - ref).abs().max() <= 1e-4


def _fields(state):
    return {k: getattr(state, k)[None] for k in quad.STATE_FIELDS + ("f_disturb",)}


def test_env_step_and_restart_against_the_port(scene):
    """Every deterministic field of the port's next state; a terminal
    pre-step state restarts."""
    env, solver, cp, obs, st, info, g, P = scene
    act = cp.a_mean[0]
    _, st2, _, _, _ = env.step(g, st, act, env.default_params)
    post, done = quad.env_step(P, check._cast(_fields(st), torch.float64), act.double()[None])
    assert not bool(done[0])
    for k in quad.STATE_FIELDS:
        assert (getattr(st2, k).double() - post[k][0].double()).abs().max() <= 1e-6, k
    far = st.replace(pos=st.pos + torch.tensor([0.0, 0.0, 5.0]))
    _, st3, _, d3, _ = env.step(g, far, act, env.default_params)
    post, done = quad.env_step(P, check._cast(_fields(far), torch.float64), act.double()[None])
    restart = quad.reset_state(check._cast(_fields(st3), torch.float64))
    assert bool(done[0]) and bool(d3)
    for k in quad.STATE_FIELDS:
        assert (getattr(st3, k).double() - restart[k][0].double()).abs().max() == 0, k


SMALL = dict(CFG, controller=dict(CFG["controller"], N=N, H=H))


def _record(scene, key_seed=7):
    """A single-vehicle record whose answers are the reference's own, as
    the program would give them in float32."""
    env, solver, cp, obs, st, info, g, P = scene
    ref_mean, ref_sigma, _ = check._solve(SMALL, dict(
        pre=dict(obs=_fields(info["noisy_state"]), mean=cp.a_mean[None]),
        solve_seed=key_seed, replay=3, slot0=0), torch.float64)
    action = ref_mean[0, 0].float()
    _, st2, _, _, _ = env.step(g, st, action, env.default_params)
    return dict(replay=3, solve_seed=key_seed, slot0=0,
                pre=dict(state=_fields(st), obs=_fields(info["noisy_state"]),
                         mean=cp.a_mean[None]),
                post=dict(state=_fields(st2), mean=ref_mean.float(), sigma=ref_sigma.float(),
                          action=action[None]))


def test_judge_passes_agreeing_answers_and_fails_faults(scene):
    cfg = SMALL
    limits = dict(mean_gap=1e-4, env_gap=1e-5, sigma_gap=1e-5)
    rec = _record(scene)
    good = check.judge(cfg, [rec], limits)
    assert good["correct"], good
    altered = dict(rec, post=dict(rec["post"], mean=rec["post"]["mean"] + 1e-3))
    assert not check.judge(cfg, [altered], limits)["correct"]
    unchanged = dict(rec, post=dict(rec["post"], state=rec["pre"]["state"]))
    bad = check.judge(cfg, [unchanged], limits)
    assert not bad["correct"] and bad["numbers"]["env_gap"] > 1e-3
    control = check.judge(cfg, [rec], limits, control=True)
    assert not control["correct"], control["numbers"]
    assert check.judge(cfg, [], limits)["correct"] is False
    assert np.isfinite(good["numbers"]["mean_gap"])
