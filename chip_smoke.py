#!/usr/bin/env python3
"""Drive the PyTorch port's CoVO-online and MPPI paths once on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It builds the
CUDA kernels from ``covo_mpc_tpu_torch/csrc`` (nvcc, one process per
source, at first use), then:

1. holds each kernel (K1-K5) against its plain PyTorch version on the
   card, at the main paths' shapes (N=8192, H=32, D=128), on inputs made
   from a numpy seed, and times both with CUDA events; checks the moments
   of K1's in-kernel Philox draw;
2. runs one full-width CoVO solve with ``engine="cuda"`` (K1, and K4 under
   ``rng_mode="fast"``) and with ``engine="torch"``, and one MPPI solve
   with ``engine="cuda"`` (K5, and K4 under ``rng_mode="fast"``) and with
   ``engine="torch"``, each pair on the same normals (per-solve contract
   2e-4), and checks that no solve syncs with the host;
3. runs the closed loops, ``evaluate(env, solver, total_steps=1200,
   seed=1)``: CoVO with ``engine="cuda"``, ``rng_mode="kernel"`` (err_pos
   finite and below 5.0 cm); MPPI with ``engine="cuda"``,
   ``rng_mode="kernel"`` (finite, below 8.0 cm and above CoVO's on the same
   trajectories) and with ``rng_mode="fast"`` (finite, below 8.0 cm); and
   times the solves of both engines;
4. breaks one cuda-engine CoVO solve and one MPPI solve down by layer
   (CUDA events and torch.profiler device time) and reads the device's
   busy share.

Each kernel's launch count in the JSON record is read from the closed loop
that runs it: K1-K3 from CoVO's, K5 from MPPI's kernel-rng loop, K4 from
MPPI's fast loop (counts set to 0 just before each loop). Any failed
check raises, so the script exits non-zero; without a CUDA device it exits
at once. The line before the last is the kernels' JSON record, the last
``{"ok": true, "device": {...}}``. ``--total-steps 12000`` runs the
40-episode protocols in phase 3.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N, H = 8192, 32
D = 4 * H
ENV_KW = dict(task="tracking_zigzag", enable_randomizer=False,
              disturb_type="gaussian", disable_rollover_terminate=True,
              generate_noisy_state=True)
ERR_POS_LIMIT_CM = 5.0
MPPI_ERR_POS_LIMIT_CM = 8.0


def say(*args):
    print(*args, flush=True)


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``reps``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    say(f"  ok: {what}")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def costs_close(got: torch.Tensor, ref: torch.Tensor) -> bool:
    """Rollout costs within atol 2e-4, rtol 1e-5 (the JAX kernel tests')."""
    return bool(((got - ref).abs() <= 2e-4 + 1e-5 * ref.abs()).all())


def rel_fro(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm((a - b).double()) / torch.linalg.norm(b.double()))


def phase_kernels(env, dev, records):
    from covo_mpc_tpu_torch.models import pack_state
    from covo_mpc_tpu_torch.ops import hessian_cuda, rollout_cuda

    say("phase 1: kernels against their plain versions (N=8192, H=32, D=128)")
    p = env.default_params
    _, info, _ = env.reset(torch.Generator(dev).manual_seed(3), p)
    st = info["noisy_state"]
    x0 = pack_state(st)
    rng = np.random.default_rng(0)

    def cuda(x):
        return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(dev)

    # K1: joint sample + rollout, z given ("input_z")
    a_mean = cuda(rng.normal(size=(H, 4)) * 0.2)
    factor = cuda(rng.normal(size=(D, D)) * 0.1)
    z = cuda(rng.standard_normal((D, N)))
    k1 = rollout_cuda.make_rollout_joint_sampling(env)
    args = (x0, st.time, st.pos_traj, st.vel_traj, a_mean, factor, p)
    kw = dict(deterministic=True, discount=1.0)
    c_k, a_k = k1(*args, 0, N, z=z, **kw)
    c_p, a_p = k1.plain(*args, 0, N, z=z, **kw)
    torch.cuda.synchronize()
    err_a, err_c = max_err(a_k, a_p), max_err(c_k, c_p)
    say(f"  K1 max |actions - plain| = {err_a:.3e}, max |costs - plain| = {err_c:.3e}")
    check(err_a <= 1e-5, "K1 actions within atol 1e-5")
    check(bool(((c_k - c_p).abs() <= 2e-4 + 1e-5 * c_p.abs()).all()),
          "K1 costs within atol 2e-4, rtol 1e-5")
    c_64, a_64 = rollout_cuda.make_rollout_joint_sampling(env, block=64)(
        *args, 0, N, z=z, **kw)
    check(torch.equal(c_64, c_k) and torch.equal(a_64, a_k),
          "K1 results independent of the block size (64 vs 128)")
    # a stochastic gaussian rollout (own generator: later inputs stay put)
    draw = cuda(np.random.default_rng(1).standard_normal(3))
    c_k, _ = k1(*args, 0, N, z=z, draw=draw)
    c_p, _ = k1.plain(*args, 0, N, z=z, draw=draw)
    check(bool(((c_k - c_p).abs() <= 2e-4 + 1e-5 * c_p.abs()).all()),
          "K1 costs under a shared gaussian draw within atol 2e-4, rtol 1e-5")

    # K1 Philox moments: mean 0, F = 0.1 I
    zero = torch.zeros(H, 4, device=dev)
    eye = 0.1 * torch.eye(D, device=dev)
    margs = (x0, st.time, st.pos_traj, st.vel_traj, zero, eye, p)
    _, a1 = k1(*margs, 1234, N, **kw)
    _, a1b = k1(*margs, 1234, N, **kw)
    _, a2 = k1(*margs, 1235, N, **kw)
    mean_d = a1.mean(dim=1)
    var_d = a1.var(dim=1, correction=0)
    pooled = float(a1.pow(2).mean() - a1.mean().pow(2))
    say(f"  K1 Philox: max |mean_d| = {float(mean_d.abs().max()):.3e}, "
        f"var_d in [{float(var_d.min()):.5f}, {float(var_d.max()):.5f}], "
        f"pooled var = {pooled:.6f}")
    check(float(mean_d.abs().max()) <= 5e-3, "per-dimension mean within 5e-3")
    check(float((var_d / 0.01 - 1).abs().max()) <= 0.10,
          "per-dimension variance within 10% of 0.01")
    check(abs(pooled / 0.01 - 1) <= 0.01, "pooled variance within 1% of 0.01")
    check(torch.equal(a1, a1b) and not torch.equal(a1, a2),
          "same seed, same draws; another seed, other draws")

    # times at the main path's shapes: the kernel draws in-kernel, the
    # plain version draws with torch.randn
    ms_k1 = time_ms(lambda: k1(*args, 7, N, **kw), 50)
    ms_k1p = time_ms(lambda: k1.plain(*args, 7, N, **kw), 10)
    records["joint_sample_rollout"] = dict(max_abs_err=max(err_a, err_c),
                                          ms=ms_k1, plain_ms=ms_k1p)
    say(f"  K1 {ms_k1:.4f} ms, plain {ms_k1p:.4f} ms")

    # K2: primal
    a_seq = cuda(rng.uniform(-1.3, 1.3, size=(H, 4)))
    dist = torch.cat([x0[13:16][None], torch.zeros(H - 1, 3, device=dev)])
    k2 = rollout_cuda.make_primal(env, H)
    zs_k, zs_p = k2(x0, a_seq, dist, p), k2.plain(x0, a_seq, dist, p)
    err2 = max_err(zs_k, zs_p)
    say(f"  K2 max |z - plain| = {err2:.3e}")
    check(err2 <= 1e-5, "K2 within atol 1e-5")
    ms_k2 = time_ms(lambda: k2(x0, a_seq, dist, p), 200)
    ms_k2p = time_ms(lambda: k2.plain(x0, a_seq, dist, p), 20)
    records["primal"] = dict(max_abs_err=err2, ms=ms_k2, plain_ms=ms_k2p)
    say(f"  K2 {ms_k2:.4f} ms, plain {ms_k2p:.4f} ms")

    # K3: sensitivity chain (J = [A | B] with A near the identity, as a
    # step Jacobian is) and the pullback
    A = np.eye(13)[None] + 0.02 * rng.standard_normal((H, 13, 13))
    B = 0.1 * rng.standard_normal((H, 13, 4))
    J = cuda(np.concatenate([A, B], axis=2))
    Mh = rng.standard_normal((H, 17, 17))
    M = cuda((Mh + Mh.transpose(0, 2, 1)) / 2)
    T_k = hessian_cuda.sens_chain(J, 4)
    T_p = hessian_cuda.sens_chain_plain(J, 4)
    R_k, R_p = hessian_cuda.pullback(T_k, M), hessian_cuda.pullback(T_p, M)
    rel_T, rel_R = rel_fro(T_k, T_p), rel_fro(R_k, R_p)
    say(f"  K3 relative Frobenius error: T {rel_T:.3e}, Hessian {rel_R:.3e}")
    check(rel_T < 1e-5 and rel_R < 1e-5, "K3 T and Hessian within 1e-5 (relative)")
    ms_k3 = time_ms(lambda: hessian_cuda.sens_chain(J, 4), 200)
    ms_k3p = time_ms(lambda: hessian_cuda.sens_chain_plain(J, 4), 20)
    records["sens_chain"] = dict(max_abs_err=max_err(T_k, T_p), ms=ms_k3,
                                 plain_ms=ms_k3p)
    say(f"  K3 {ms_k3:.4f} ms, plain {ms_k3p:.4f} ms")

    # K4: rollout costs of given actions, both layouts, deterministic and
    # under the shared gaussian draw (own generator: K1-K3 inputs stay put)
    rng4 = np.random.default_rng(2)
    acts = cuda(rng4.normal(size=(H, 4, N)) * 0.5)
    k4 = rollout_cuda.make_rollout_costs(env)
    roll = (x0, st.time, st.pos_traj, st.vel_traj)
    err4 = 0.0
    for layout, a in (("hdn", acts), ("nhd", acts.permute(2, 0, 1).contiguous())):
        for what, kw4 in (("deterministic", dict(deterministic=True)),
                          ("shared gaussian draw", dict(draw=draw))):
            c_k = k4(*roll, a, p, layout=layout, **kw4)
            c_p = k4.plain(*roll, a, p, layout=layout, **kw4)
            err4 = max(err4, max_err(c_k, c_p))
            check(costs_close(c_k, c_p),
                  f"K4 costs ({layout}, {what}) within atol 2e-4, rtol 1e-5")
    say(f"  K4 max |costs - plain| = {err4:.3e}")
    c_64 = rollout_cuda.make_rollout_costs(env, block=64)(
        *roll, acts, p, draw=draw, layout="hdn")
    check(torch.equal(c_64, k4(*roll, acts, p, draw=draw, layout="hdn")),
          "K4 results independent of the block size (64 vs 128)")
    ms_k4 = time_ms(lambda: k4(*roll, acts, p, draw=draw, layout="hdn"), 50)
    ms_k4p = time_ms(lambda: k4.plain(*roll, acts, p, draw=draw, layout="hdn"), 10)
    records["rollout_costs"] = dict(max_abs_err=err4, ms=ms_k4, plain_ms=ms_k4p)
    say(f"  K4 {ms_k4:.4f} ms, plain {ms_k4p:.4f} ms")

    # K5: per-step sample + rollout, z given ("input_z"), then its own draws
    a_mean5 = cuda(rng4.normal(size=(H, 4)) * 0.2)
    A = rng4.normal(size=(H, 4, 4)) * 0.2
    chol5 = cuda(np.linalg.cholesky(A @ A.transpose(0, 2, 1) + 0.05 * np.eye(4)))
    z5 = cuda(rng4.standard_normal((H, 4, N)))
    k5 = rollout_cuda.make_rollout_sampling(env)
    args5 = (*roll, a_mean5, chol5, p)
    err_a5 = err_c5 = 0.0
    for what, kw5 in (("deterministic", dict(deterministic=True)),
                      ("shared gaussian draw", dict(draw=draw))):
        c_k, a_k = k5(*args5, 0, N, z=z5, **kw5)
        c_p, a_p = k5.plain(*args5, 0, N, z=z5, **kw5)
        err_a5 = max(err_a5, max_err(a_k, a_p))
        err_c5 = max(err_c5, max_err(c_k, c_p))
        check(max_err(a_k, a_p) <= 1e-5, f"K5 actions ({what}) within atol 1e-5")
        check(costs_close(c_k, c_p), f"K5 costs ({what}) within atol 2e-4, rtol 1e-5")
    say(f"  K5 max |actions - plain| = {err_a5:.3e}, max |costs - plain| = {err_c5:.3e}")
    # "krng": the kernel draws the shared disturbance itself; the plain
    # rollout of the kernel's own actions under the normals it wrote agrees
    draw_out = torch.zeros(3, device=dev)
    c_k, a_k = k5(*args5, 7, N, disturb_seed=8, draw_out=draw_out)
    c_p = k4.plain(*roll, a_k, p, draw_out.clone(), layout="hdn")
    err_k5 = max_err(c_k, c_p)
    say(f"  K5 krng draw {[round(float(v), 6) for v in draw_out]}, "
        f"max |costs - plain rollout| = {err_k5:.3e}")
    check(costs_close(c_k, c_p) and float(draw_out.abs().sum()) > 0,
          "K5 krng costs within atol 2e-4, rtol 1e-5 of the plain rollout fed its draw")
    c_64, a_64 = rollout_cuda.make_rollout_sampling(env, block=64)(
        *args5, 7, N, disturb_seed=8)
    check(torch.equal(c_64, c_k) and torch.equal(a_64, a_k),
          "K5 in-kernel draws independent of the block size (64 vs 128)")
    # times: in-kernel draws (krng), the plain version draws with torch.randn
    ms_k5 = time_ms(lambda: k5(*args5, 7, N, disturb_seed=8), 50)
    ms_k5p = time_ms(lambda: k5.plain(*args5, 7, N, disturb_seed=8), 10)
    records["sample_rollout"] = dict(max_abs_err=max(err_a5, err_c5, err_k5),
                                     ms=ms_k5, plain_ms=ms_k5p)
    say(f"  K5 {ms_k5:.4f} ms, plain {ms_k5p:.4f} ms")


def make_solver(env, engine, seed=0, rng_mode=None):
    """The CoVO-online main-path solver; rng_mode defaults to "kernel" on
    the cuda engine, "fast" on torch."""
    from covo_mpc_tpu_torch.solvers import get_solver

    rng_mode = rng_mode or ("kernel" if engine == "cuda" else "fast")
    return get_solver(env, "covo_online", f"N{N}_H{H}_lam0.01",
                      rng_mode=rng_mode, hessian_mode="gn", sigma_mode="ns",
                      engine=engine, collect_debug=False, seed=seed)


def make_mppi(env, engine, seed=0, rng_mode=None):
    """MPPI at the repo's configuration (N8192_H32_lam0.01, sigma 0.5);
    rng_mode defaults to "kernel" on the cuda engine, "fast" on torch."""
    from covo_mpc_tpu_torch.solvers import get_solver

    rng_mode = rng_mode or ("kernel" if engine == "cuda" else "fast")
    return get_solver(env, "mppi", f"N{N}_H{H}_lam0.01", rng_mode=rng_mode,
                      engine=engine, collect_debug=False, seed=seed)


def solve_once(solver, cp, args, kernel_list, **kw):
    """One warm-up solve, then one with the launch counters at 0 and host
    syncs turned into errors; returns its result and the counts."""
    solver(*args[:3], cp, args[3], **kw)
    torch.cuda.synchronize()
    for k in kernel_list:
        k.launches = 0
    # a host sync anywhere in the solve raises here
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = solver(*args[:3], cp, args[3], **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, {k.symbol: k.launches for k in kernel_list}


def phase_solve(env, dev, kernel_list):
    from covo_mpc_tpu_torch.ops import rollout_cuda

    say("phase 2: one full-width solve, engine='cuda' against engine='torch'")
    p = env.default_params
    obs, info, state = env.reset(torch.Generator(dev).manual_seed(5), p)
    args = (obs, state, p, info)
    z = torch.from_numpy(
        np.random.default_rng(1).standard_normal((N, D)).astype(np.float32)
    ).to(dev)
    out = {}
    # CoVO: cuda with K1 (kernel rng) and with K4 (fast), against torch
    for engine, rng_mode, first in (("cuda", "kernel", rollout_cuda.JOINT_KERNEL),
                                    ("cuda", "fast", rollout_cuda.ROLLOUT_KERNEL),
                                    ("torch", "fast", None)):
        solver, cp = make_solver(env, engine, rng_mode=rng_mode)
        out[engine, rng_mode], counts = solve_once(solver, cp, args,
                                                   kernel_list, z=z)
        if engine == "cuda":
            say(f"  launch counters after the cuda ({rng_mode}) solve: {counts}")
            used = [first.symbol, "primal", "sens_chain"]
            check(all(counts[k] > 0 for k in used),
                  f"{', '.join(used)} each launched by the solve")
    a_t, cp_t, _ = out["torch", "fast"]
    for rng_mode in ("kernel", "fast"):
        a_c, cp_c, _ = out["cuda", rng_mode]
        errs = {"action": max_err(a_c, a_t),
                "a_mean": max_err(cp_c.a_mean, cp_t.a_mean),
                "a_cov": max_err(cp_c.a_cov, cp_t.a_cov)}
        say(f"  CoVO ({rng_mode}) max |cuda - torch|: {errs}")
        check(all(v <= 2e-4 for v in errs.values()),
              f"CoVO ({rng_mode}): action, a_mean and a_cov within 2e-4 "
              "(no host sync in either solve)")
        check(all(bool(torch.isfinite(x).all()) for x in (a_c, cp_c.a_mean, cp_c.a_cov)),
              "solve outputs finite")

    say("phase 2b: one full-width MPPI solve, engine='cuda' against "
        "engine='torch', on the same z and draw")
    g = np.random.default_rng(3)
    z = torch.from_numpy(g.standard_normal((N, H, 4)).astype(np.float32)).to(dev)
    draw = torch.from_numpy(g.standard_normal(3).astype(np.float32)).to(dev)
    out = {}
    for engine, rng_mode, used in (("cuda", "kernel", rollout_cuda.SAMPLE_KERNEL),
                                   ("cuda", "fast", rollout_cuda.ROLLOUT_KERNEL),
                                   ("torch", "fast", None)):
        solver, cp = make_mppi(env, engine, rng_mode=rng_mode)
        out[engine, rng_mode], counts = solve_once(solver, cp, args, kernel_list,
                                                   z=z, draw=draw)
        if used is not None:
            say(f"  launch counters after the cuda ({rng_mode}) solve: {counts}")
            check(counts[used.symbol] > 0, f"{used.symbol} launched by the solve")
    a_t, cp_t, _ = out["torch", "fast"]
    for rng_mode in ("kernel", "fast"):
        a_c, cp_c, _ = out["cuda", rng_mode]
        errs = {"action": max_err(a_c, a_t)}
        errs.update({k: max_err(getattr(cp_c, k), getattr(cp_t, k))
                     for k in ("a_mean", "a_cov", "a_cov_chol")})
        say(f"  MPPI ({rng_mode}) max |cuda - torch|: {errs}")
        check(all(v <= 2e-4 for v in errs.values()),
              f"MPPI ({rng_mode}): action, a_mean, a_cov and a_cov_chol within "
              "2e-4 (no host sync in either solve)")
        check(all(bool(torch.isfinite(x).all()) for x in (a_c, cp_c.a_mean)),
              "solve outputs finite")


def solve_times(env, dev, make=make_solver, reps=60, warmup=5):
    """Median device ms per solve for each engine, from CUDA events around
    each solve of a chain of solves; engines in turns torch, cuda, cuda,
    torch."""
    p = env.default_params
    obs, info, state = env.reset(torch.Generator(dev).manual_seed(7), p)
    times = {"cuda": [], "torch": []}
    for engine in ("torch", "cuda", "cuda", "torch"):
        solver, cp = make(env, engine)
        events = []
        for i in range(warmup + reps // 2):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            _, cp, _ = solver(obs, state, p, cp, info)
            e1.record()
            if i >= warmup:
                events.append((e0, e1))
        torch.cuda.synchronize()
        times[engine] += [a.elapsed_time(b) for a, b in events]
    return {k: float(np.median(v)) for k, v in times.items()}, {
        k: len(v) for k, v in times.items()}


def device_ms(fn, reps: int = 10, name: str = "") -> float:
    """Device-only ms per call of ``fn`` from torch.profiler: the summed
    kernel and copy time on the card (only kernels whose name contains
    ``name``, when given), divided by ``reps``. Used in phase 4 only: a
    profiler session early in the run, followed by minutes of unprofiled
    work, made later sessions lose device events (sums below their own
    kernel's time) on the H100."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name)
    return us / reps / 1e3


def profile_solves(env, dev):
    """Where one cuda-engine solve's time goes: each layer alone on the
    inputs the solve gives it (CUDA-event ms, which include the host's
    launch time when the host is the bottleneck, and device-only ms from
    torch.profiler), then ten whole solves under the profiler: the device
    work launched per solve and the device's busy share of that window."""
    from covo_mpc_tpu_torch.models import pack_state
    from covo_mpc_tpu_torch.ops import covariance, hessian_cuda, reductions, rollout_cuda
    from covo_mpc_tpu_torch.ops.hessian import build_hessian_disturb_table, gn_curvature
    from covo_mpc_tpu_torch.ops.rollout import target_window

    say("profile: layers of one cuda-engine solve (N=8192, H=32)")
    p = env.default_params
    obs, info, state = env.reset(torch.Generator(dev).manual_seed(7), p)
    st = info["noisy_state"]
    solver, cp = make_solver(env, "cuda")
    x0 = pack_state(st)
    a_mean = torch.cat([cp.a_mean[1:], cp.a_mean[-1:]])
    aux = build_hessian_disturb_table(env, x0, H)
    ptars, vtars = target_window(st.time, st.pos_traj, st.vel_traj, H, offset=1)
    k2 = rollout_cuda.make_primal(env, H)
    zs = k2(x0, a_mean, aux, p)
    J, M = gn_curvature(env, p, zs, aux, ptars, vtars)
    tail = hessian_cuda.make_tail_pullback(H, 4)
    R = -tail(J, M)
    _, factor = covariance.optimize_sigma_ns(R, 0.5, D)
    k1 = rollout_cuda.make_rollout_joint_sampling(env)
    k1_args = (x0, st.time, st.pos_traj, st.vel_traj, a_mean, factor, p, 11, N)
    costs, a_t = k1(*k1_args, deterministic=True)
    layers = {
        "primal (K2)": (lambda: k2(x0, a_mean, aux, p), "primal_kernel"),
        "local derivatives + M": (
            lambda: gn_curvature(env, p, zs, aux, ptars, vtars), ""),
        "chain (K3) + pullback": (lambda: tail(J, M), "sens_chain_kernel"),
        "NS designer": (lambda: covariance.optimize_sigma_ns(R, 0.5, D), ""),
        "joint sample + rollout (K1)": (
            lambda: k1(*k1_args, deterministic=True), "joint_sample_rollout_kernel"),
        "weights + mean update": (lambda: reductions.mean_update_t(
            reductions.mppi_weights(costs, 0.01), a_t.reshape(H, 4, N), a_mean,
            1.0), ""),
        "whole solve": (lambda: solver(obs, state, p, cp, info), ""),
    }
    time_layers(layers)
    busy_window(solver, cp, obs, state, p, info)


def time_layers(layers):
    for name, (fn, kernel) in layers.items():
        ev = time_ms(fn, 20)
        dev_ms = device_ms(fn)
        line = f"  {name:30s} events {ev:9.4f} ms, device {dev_ms:9.4f} ms"
        if kernel:
            line += f", of it the kernel {device_ms(fn, name=kernel):9.4f} ms"
        say(line)


def busy_window(solver, cp, obs, state, p, info):
    """Ten chained solves under the profiler: device work per solve and the
    device's busy share of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        _, cp, _ = solver(obs, state, p, cp, info)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            _, cp, _ = solver(obs, state, p, cp, info)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    say(f"  profiler window: 10 solves, wall {wall_ms:.3f} ms (profiler on), "
        f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.2f}%), "
        f"{len(device) / 10:.0f} device kernels and copies per solve")


def profile_mppi(env, dev):
    """Where one MPPI cuda-engine (kernel rng) solve's time goes, as
    :func:`profile_solves` reads CoVO's, and the fast path's sample + K4
    beside K5."""
    from covo_mpc_tpu_torch.models import pack_state
    from covo_mpc_tpu_torch.ops import reductions, rollout_cuda, sampling

    say("profile: layers of one MPPI cuda-engine solve (N=8192, H=32, kernel rng)")
    p = env.default_params
    obs, info, state = env.reset(torch.Generator(dev).manual_seed(7), p)
    st = info["noisy_state"]
    solver, cp = make_mppi(env, "cuda")
    x0 = pack_state(st)
    shift = lambda x: torch.cat([x[1:], x[-1:]])  # noqa: E731
    a_mean, a_cov, a_chol = shift(cp.a_mean), shift(cp.a_cov), shift(cp.a_cov_chol)
    k5 = solver.rollout_sampling
    k5_args = (x0, st.time, st.pos_traj, st.vel_traj, a_mean, a_chol, p, 11, N)
    costs, a_flat = k5(*k5_args, disturb_seed=12)
    a_t = a_flat.reshape(H, 4, N)
    weight = reductions.mppi_weights(costs, 0.01)
    new_mean = reductions.mean_update_t(weight, a_t, a_mean, 1.0)
    k4 = rollout_cuda.make_rollout_costs(env)
    gen = torch.Generator(dev).manual_seed(13)
    draw = torch.randn(3, generator=gen, device=dev)

    def fast_sample_rollout():
        a = torch.clamp(sampling.sample_per_step_t(gen, a_mean, a_chol, N), -1.0, 1.0)
        return k4(x0, st.time, st.pos_traj, st.vel_traj, a, p, draw, layout="hdn")

    time_layers({
        "sample + rollout (K5)": (lambda: k5(*k5_args, disturb_seed=12),
                                  "sample_rollout_kernel"),
        "fast: torch sample + K4": (fast_sample_rollout, "rollout_kernel"),
        "weights + mean update": (lambda: reductions.mean_update_t(
            reductions.mppi_weights(costs, 0.01), a_t, a_mean, 1.0), ""),
        "cov update (gamma_sigma=0)": (lambda: reductions.cov_factor_update_t(
            weight, a_t, new_mean, a_cov, a_chol, cp.gamma_sigma), ""),
        "whole solve": (lambda: solver(obs, state, p, cp, info), ""),
    })
    busy_window(solver, cp, obs, state, p, info)


def closed_loop(env, solver, total_steps, kernel_list):
    """``evaluate`` with every launch counter at 0 just before it; returns
    the result and the counts just after."""
    from covo_mpc_tpu_torch.runtime import evaluate

    for k in kernel_list:
        k.launches = 0
    t0 = time.perf_counter()
    result = evaluate(env, solver, total_steps=total_steps, seed=1)
    wall = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in kernel_list}
    say(f"  {result.summary()} ({len(result.err_pos_ep)} episodes, {wall:.1f} s); "
        f"per episode [cm]: {[round(100 * float(e), 3) for e in result.err_pos_ep]}")
    say(f"  launches in the closed loop: {launches}")
    return result, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--total-steps", type=int, default=1200,
                    help="closed-loop length (12000: the 40-episode protocols)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv
    from covo_mpc_tpu_torch.ops import hessian_cuda, kernels, rollout_cuda

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    say(smi)
    nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"nvcc: {nvcc.splitlines()[-1]}")
    t0 = time.perf_counter()
    lib = kernels.library()
    say(f"kernel build: nvcc {lib.build_seconds:.2f} s, load {time.perf_counter() - t0:.2f} s")

    env = QuadEnv(EnvConfig(**ENV_KW), device=dev)
    covo_kernels = [rollout_cuda.JOINT_KERNEL, rollout_cuda.PRIMAL_KERNEL,
                    hessian_cuda.CHAIN_KERNEL]
    kernel_list = covo_kernels + [rollout_cuda.ROLLOUT_KERNEL,
                                  rollout_cuda.SAMPLE_KERNEL]
    records = {}
    phase_kernels(env, dev, records)
    phase_solve(env, dev, kernel_list)

    say(f"phase 3: closed loop, evaluate(total_steps={args.total_steps}, seed=1), "
        "engine='cuda', rng_mode='kernel'")
    solver, _ = make_solver(env, "cuda")
    result, launches = closed_loop(env, solver, args.total_steps, kernel_list)
    check(all(launches[k.symbol] > 0 for k in covo_kernels),
          "every kernel of the CoVO path launched by the main path")
    check(np.isfinite(result.mean) and result.mean * 100 < ERR_POS_LIMIT_CM,
          f"err_pos finite and below {ERR_POS_LIMIT_CM} cm")
    med, counts = solve_times(env, dev)
    say(f"  median device ms per solve: cuda {med['cuda']:.4f} ({counts['cuda']} solves), "
        f"torch {med['torch']:.4f} ({counts['torch']} solves)")

    say(f"phase 3b: MPPI closed loop, evaluate(total_steps={args.total_steps}, "
        "seed=1), engine='cuda', rng_mode='kernel'")
    solver, _ = make_mppi(env, "cuda")
    mppi, mppi_launches = closed_loop(env, solver, args.total_steps, kernel_list)
    launches["sample_rollout"] = mppi_launches["sample_rollout"]
    check(launches["sample_rollout"] > 0, "sample_rollout launched by the MPPI loop")
    check(np.isfinite(mppi.mean) and mppi.mean * 100 < MPPI_ERR_POS_LIMIT_CM,
          f"MPPI err_pos finite and below {MPPI_ERR_POS_LIMIT_CM} cm")
    check(mppi.mean > result.mean,
          "MPPI err_pos above CoVO's on the same reset trajectories")
    say(f"phase 3c: MPPI closed loop, evaluate(total_steps={args.total_steps}, "
        "seed=1), engine='cuda', rng_mode='fast'")
    solver, _ = make_mppi(env, "cuda", rng_mode="fast")
    fast, fast_launches = closed_loop(env, solver, args.total_steps, kernel_list)
    launches["rollout_costs"] = fast_launches["rollout_costs"]
    check(launches["rollout_costs"] > 0, "rollout_costs launched by the MPPI fast loop")
    check(np.isfinite(fast.mean) and fast.mean * 100 < MPPI_ERR_POS_LIMIT_CM,
          f"MPPI (fast) err_pos finite and below {MPPI_ERR_POS_LIMIT_CM} cm")
    med, counts = solve_times(env, dev, make=make_mppi)
    say(f"  MPPI median device ms per solve: cuda {med['cuda']:.4f} "
        f"({counts['cuda']} solves), torch {med['torch']:.4f} ({counts['torch']} solves)")

    profile_solves(env, dev)
    profile_mppi(env, dev)

    say(json.dumps({"kernels": [
        {"name": k.symbol, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[k.symbol],
         **records[k.symbol]}
        for k in kernel_list
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
