#!/usr/bin/env python3
"""Drive the PyTorch port's CoVO, MPPI, PID and Random paths once on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It builds the
CUDA kernels from ``covo_mpc_tpu_torch/csrc`` (nvcc, one process per
source, at first use), then:

1. holds each kernel (K1-K5) against its plain PyTorch version on the
   card, at the main paths' shapes (N=8192, H=32, D=128), on inputs made
   from a numpy seed, and times both with CUDA events; checks the moments
   of K1's in-kernel Philox draw; prints K1's and K5's launch geometry
   (samples and threads a block, shared memory, blocks an SM, registers)
   and times K1's correlate alone as one ``torch.matmul`` (a yardstick,
   TF32 off); K5's in-kernel draws at every block size it takes;
   (1b) times K2 and K3 alone (bare launches) beside their earlier
   designs (``covo_mpc_tpu_torch/tools/earlier``, built in the same run),
   holds their results against the earlier ones bit for bit (on one input
   and through the first :data:`LOOP_BITS_STEPS` steps of the main path's
   closed loop), and counts
   each step loop's critical path from its SASS (``tools/sass_chain.py``:
   ``chain_ms``, the least time of the H dependent steps on one SM, with
   instruction latencies measured on the card by ``tools/latency_probe.cu``);
   (1c) times K4 (B=1) and K6 (B=16) alone beside their earlier design
   (``tools/earlier/rollout.cu``, built in the same run), holds their costs
   against it bit for bit (on one input and on every K4 input of one
   episode of MPPI with fast rng), and reads from their SASS K4's
   ``chain_ms`` (its attitude warp's longest recurrence over H steps) and K6's
   ``issue_ms`` (its step loop's instructions over the grid's warps, at one
   instruction a cycle on each of an SM's four schedulers);
2. runs one full-width CoVO solve with ``engine="cuda"`` (K1, and K4 under
   ``rng_mode="fast"``) and with ``engine="torch"``, and one MPPI solve
   with ``engine="cuda"`` (K5, and K4 under ``rng_mode="fast"``) and with
   ``engine="torch"``, each pair on the same normals (per-solve contract
   2e-4), and checks that no solve syncs with the host; (2c) captures
   each solve the JAX package jits as a CUDA graph (``runtime/graphs.py``:
   CoVO online on the main path and with ``ns_pallas``, speculative
   ``act()`` and ``prepare()``, offline, MPPI kernel and fast rng, PID,
   random) and holds 20 chained replays against 20 chained eager solves
   from the same seed and params (2e-4 on every output), checks that two
   replays on the same inputs draw afresh and that the replays launch what
   the eager solves launch, prints p50 / p99 (``time_blocking``) and ms per
   solve of a chain (``time_chained``) eager and captured, timed
   ``graphs.SETTLE_S`` after the last capture and once the main path's
   replay has sped up or kept one speed ``graphs.SETTLE_WATCH_S``
   (``graphs.settle``'s watch), and the device's busy share
   inside the replays; the captured main-path solve's
   p50 must be under 20 ms, the 50 Hz budget;
3. runs the closed loops, ``evaluate(env, solver, total_steps, seed=1)``,
   every one through the captured runner (one CUDA graph a control step):
   CoVO with ``engine="cuda"``, ``rng_mode="kernel"`` (err_pos finite and
   below 5.0 cm); MPPI with ``engine="cuda"``, ``rng_mode="kernel"``
   (finite, below 8.0 cm and above CoVO's on the same trajectories) and
   with ``rng_mode="fast"`` (finite, below 8.0 cm), each 1200 steps (four
   episodes; the 40-episode protocol is the sweeps' and the batched
   protocol's, phases 5e and 10b); and times the eager solves of both
   engines;
4. breaks one cuda-engine CoVO solve and one MPPI solve down by layer
   (CUDA events and torch.profiler device time) and reads the device's
   busy share;
5. the scenario-batched solves (``covo_mpc_tpu_torch.parallel``) on a
   domain-randomized env, B=16 scenarios at N=8192, H=32: (a) K6, K7
   per-step and K7 joint against their plain versions, at B=1 against
   K4, K5 and K1, the in-kernel draws of one scenario at B=4 and B=16,
   and K7's episode offset (a device word): scenarios 8..15 launched from
   offset 8 against the same scenarios from offset 0 (bit for bit), their
   costs against the plain rollout of their actions, the plain version's
   offset; timed with CUDA events, K7 joint's correlate alone as one
   ``torch.bmm`` (a yardstick); (b) one batched CoVO solve and one
   batched MPPI solve per rng, ``engine="cuda"`` against
   ``engine="torch"`` on the same normals (2e-4, no host sync); (c) the
   hand-written batched closed loops on the main path's env, B=4
   scenarios reset from seed 1, 150 steps, each solve captured (CoVO below
   5.0 cm, MPPI below 8.0 cm and above CoVO's); (d) aggregate solves/s at B = 1, 16, 64 for
   both solvers and engines, eager, and beside them each cuda solve
   (kernel rng) captured as a CUDA graph: replays against eager solves bit
   for bit, p50 / p99 (``time_blocking``) and chained ms (``time_chained``)
   eager and captured, solves/s, the graph's nodes, the device ms of a
   replay and its busy share; the device kernels per batched solve at B=16
   and B=64, and one batched CoVO and MPPI solve broken down by layer at
   B=16; (e) the batched protocol on the main path's env at N=8192, H=32:
   ``evaluate_batched(num_eps=16, seed=1)`` (one batch of 16 captured
   episodes of 300 steps) for CoVO online (K7 joint), MPPI kernel rng (K7
   per-step), MPPI fast rng (K6) and PID, below 5.0 / 8.0 / 8.0 / 40.0 cm,
   CoVO below MPPI; captured batched episodes against eager ones bit for
   bit; ``run_supervised_batched`` (MPPI, chunks of 8) crashed at chunk 1
   and resumed, equal bit for bit to an uninterrupted run;
6. the fused Sigma-designer K8 (``sigma_mode="ns_pallas"``) and the other
   CoVO modes on the main path's env: (a) K8 against the plain designer on
   the gn Hessian of a reset state and on the JAX kernel test's R at scales
   1 and 100, two launches on the gn Hessian bit-identical, its cluster
   size and shared memory per CTA, timed alone, through its wrapper and as
   plain ops; (b) one
   full-width online solve with ``"ns_pallas"``, ``engine="cuda"`` (K8)
   against ``engine="torch"`` on the same normals (2e-4, no host sync); (c)
   the speculative ``act`` + ``prepare`` the same way, and ``act()`` and
   ``prepare()`` timed alone; (d) the closed loops of covo_speculative
   (K8, kernel rng) and covo_offline (kernel rng), 1200 steps each, below
   5.0 cm, PID (below 40 cm and above both
   CoVO modes') and one episode of random actions;
7. the disturbance modes of the rollout kernels ("table" for sin and
   periodic, "drag", "mixed"): (a) K1, K4, K5 and, at B=16, K6 and K7
   against their plain versions in each mode on given normals and draws,
   from t0 = 47 (a redraw inside the horizon), and every rollout kernel
   alone in each mode (bare launches, the gaussian "shared" mode too); K3
   at sd=16 on the drag Hessian's J and M, K2 on a periodic table; (b)
   full-width solves under drag (CoVO gn with K1, adjoint with K4, MPPI with
   K5, the batched CoVO and MPPI at B=16) and mixed (CoVO gn with K1),
   ``engine="cuda"`` against ``engine="torch"`` on the same normals and
   draws (2e-4, no host sync); (c) the drag closed loops at half depth (600
   steps): CoVO online with RESULTS_DRAG.md's settings (adjoint, fast rng:
   K4) and with the main path's (gn, kernel rng: K1), both below MPPI's
   (fast rng: K4), and the drag solve's median events ms;
8. the realworld reward of ``tracking_slow`` (the slow Lissajous task): (a)
   K1, K4, K5 (and its "krng"), K6 and K7 (B=16) with the realworld reward
   against their plain versions in the shared (gaussian) and drag modes,
   and each kernel alone in both; (b) full-width solves on tracking_slow,
   ``engine="cuda"`` against ``engine="torch"`` on the same normals and draw
   (2e-4, no host sync): CoVO online gn with kernel rng (K1, K2, K3), CoVO
   adjoint with fast rng (K4), MPPI with kernel rng (K5), batched CoVO at
   B=16 (K7 joint), and one main-path CoVO solve on ``tracking`` (the
   Lissajous tables, penyaw); (c) the tracking_slow closed loops (1200
   steps): CoVO online with the main path's settings and MPPI with kernel
   rng, both finite, CoVO below MPPI, and the CoVO solve's median events ms;
9. the command line, ``covo_mpc_tpu_torch.cli.main`` in-process into a
   temporary results directory: (a) eval on the main path (gn, ns, kernel
   rng, cuda) at 1200 steps with ``--metrics``: err_pos below 5.0 cm, 1200
   finite JSONL records with 1 <= ess <= N and sigma_cond >= 1, K1-K3
   launched at least once a step; (b) render, MPPI kernel rng: a 300-row
   trace with err_pos aligned to |pos - pos_tar| on every row that is not
   done (a done row holds the auto-reset's), K5 launched; (c) bench
   with ``ns_pallas``: K8 launched, the captured p50 under 20 ms, the JSON
   line echoed; (d) eval ``--supervised --chunk-episodes 2`` with MPPI
   equal to the unsupervised eval bit for bit, and a supervised run crashed
   after its first chunk, then resumed, equal to both;
10. the paper's sweeps: (a) K1, K4, K5, K6, K7 per-step and K7 joint at
   N = 16 (below one block of every size they take) and N = 100 (ragged
   over a few), H=32, B=4, against their plain versions on given normals,
   their in-kernel draws (every block size bit for bit, the n samples
   those of an N=8192 launch, K7's scenario 0 that of a B=1 launch), and
   each alone at N=16; (b) the ported scripts
   (``covo_mpc_tpu_torch/scripts``) in-process with ``--quick`` (4
   episodes a cell), every file into a temporary directory:
   paper_results (PID, MPPI, CoVO online and offline at N=8192: CoVO below
   5.0, MPPI below 8.0, PID below 40.0 cm, CoVO online below MPPI; a second
   run on the same checkpoint root all cached, writing the same bytes),
   mode_gates (the 8 cells, its section appended to a file of one line,
   CoVO below MPPI at each N) and n_ablation of MPPI and CoVO online at
   N = 16 and 100 (CoVO online below MPPI at each); every cell finite, no
   episode failed;
11. the bench, ``python -m covo_mpc_tpu_torch.bench --all --scenarios 64
   --k 8``, in a process of its own after every earlier phase, its rows
   echoed as they come: it exits 0, its last line has the root
   ``bench.py``'s record keys (``BENCH_r05.json``) plus ``device`` and
   ``method``, the latency keys with the device per-solve ones; every row
   of the JAX bench printed with its capture and method; the main path's
   per-solve p50 within 10% of phase 2c's captured chained ms; the
   per-solve marker is K1 (``joint_sample_rollout_kernel``); the batched
   rows at B=64 give the device ms of a batched solve from a complete
   profiler session or say "not measured" with the counts;
12. JAX's key tree on the card (``utils/prng.py``): (a) keys, splits,
   fold_ins and uniforms on the card equal the CPU's bit for bit, normals
   within 2 ulp of max(|x|, 1), at the samplers' widths (8192 keys, 128
   draws each); (b) one full-width solve each of CoVO online parity
   (fwd_fwd, eigh: JAX's defaults), MPPI parity and CoVO invariant (gn,
   ns), ``engine="cuda"`` (K4 on the key's samples and the disturbance draw
   through the reference's chain) against ``engine="torch"`` on the same
   key: action, a_mean and Σ within 2e-4, K4 launched, no host sync but
   eigh's; (c) the MPPI parity and CoVO invariant solves captured with the
   key as a graph input: replays equal eager solves bit for bit; (d)
   ``evaluate`` under JAX's key schedule: CoVO online parity for
   :data:`KEY_COVO_STEPS` steps (eager: eigh reads the host), below 5.0
   cm, and MPPI parity captured for :data:`KEY_MPPI_STEPS` steps, below
   8.0 cm; err_pos and
   wall of each printed; K4's launches there go to its record's
   ``key_tree_launches``.
13. every controller in the batched protocol, the supervisors and render:
   (a) the batched twins of CoVO speculative and offline under kernel
   and fast rng at B=16, N=8192, H=32 (gn, ns): the reset (speculative's
   step-0 Σ; offline's 16 schedules of 300 states, its wall and peak
   memory printed) and one step on ``engine="cuda"`` against the
   ``engine="torch"`` twin within 2e-4 (fast: the same generators, K6
   against the plain rollout; kernel: ``sample_update`` on the same
   normals, K7 joint's input-z mode), and one step captured equal to the
   eager step bit for bit; the eigh twin (online, fast rng) eager within
   2e-4 of the torch twin, its batched Hessian's graph equal to the eager
   Hessian bit for bit; (b) ``evaluate_batched(num_eps=16, seed=1)``,
   captured, of speculative (kernel rng, K7 joint) and offline (fast rng,
   K6): no failed episode, below 5.0 cm and below phase 5e's MPPI row;
   (c) JAX's key schedule in the batched protocol: each episode's reset
   state on its reset key equal to the single keyed reset's bit for bit,
   ``evaluate_batched`` of MPPI parity (K6, ``nhd``) below 8.0 cm; the
   fwd_fwd batched Hessian as one graph at B=2 (capture s, nodes, replay
   ms, peak memory); one full-width batched CoVO parity solve
   (fwd_fwd, eigh) at B=2 within 2e-4 of the single parity solve of each
   episode; (d) ``run_supervised`` of MPPI parity, :data:`KEY_MPPI_STEPS`
   steps in chunks of 1 episode, a fault injected at chunk 1 and retried,
   equal to phase
   12d's ``evaluate`` bit for bit; (e) ``render_episode`` of MPPI parity,
   300 steps captured, finite, its first :data:`RENDER_CHECK_STEPS` steps
   equal to the eager recorder's bit for bit. K4's, K6's and K7 joint's
   launches in these runs go to their records' ``batched_modes_launches``.
   ``--phase13`` builds the kernels and runs this phase alone (no kernels
   record, no result line);
14. the parallel layer on ``torch.distributed`` at the main path's width:
   K1 and K4-K7 at a rank's share of N over two ranks (4096 samples; B=16
   for K6, K7) against their plain versions and their in-kernel draws
   against the first 4096 of an N launch (``per_shard`` in each record);
   (a) one rank under an initialized NCCL group (its collectives real
   all-reduces): sharded MPPI (K5 under kernel rng, K4 under invariant)
   and the distributed CoVO solve (gn: K2, K3 and K1 or K4) against the
   single-device solvers on the same seed or key (2e-4 under kernel rng,
   1e-5 under invariant), each captured and its replay equal to the eager
   solve bit for bit; their captured ms against the single-device solves
   captured the same way and the three all-reduces alone, timed in turns
   after ``graphs.settle()`` (once 14c has run); (b) the multichip control and CoVO steps at
   B=16 (phase 5's DR env) against the batched twins on the same keys
   (2e-4), K6 and both K7 forms launched, the CoVO step captured equal to
   eager; (c) two ranks sharing the card under gloo (two processes,
   ``parallel.run_ranks``): the distributed CoVO solve on (samples=2,
   scenarios=1) and the multichip CoVO step on (2, 1) and (1, 2) within
   1e-5 of (a) / (b), the pipeline for 20 steps within 1e-5 of a
   stage-sequential oracle built from the kernels' wrappers and the
   reductions (not from the pipeline's code) on the same keys, the
   distributed offline schedule within 1e-5 of the single-device reset,
   and ``bench_mesh --distributed`` in that job, each run's launches
   counted alone by rank, its lines one a mode at 2 ranks; their wall
   times are plumbing; (d) ``pod_scale``'s per-rank block of config #5
   (B=128, N=8192, H=32, kernel rng, K7 joint), captured: ms a step and
   peak memory against ``hbm_arithmetic``; and ``bench_mesh`` in-process,
   one line a mode at 1 rank (the pipeline takes 2).
   ``--phase14`` builds the kernels and runs this phase alone;
15. JAX's randomized-config net (``tests/test_random_configs.py``: its 20
   seeded cases of task x obs x disturbance x domain randomization x
   controller x N x H x rng x Hessian x designer, drawn by
   :func:`random_config_cases`, a copy of its draw) on the card: each
   case's env reset and stepped on the card within 1e-5 of the CPU's; its
   solve on ``engine="cuda"`` after the solver's reset (offline: the whole
   300-state schedule), on JAX's keys (parity, invariant) or given normals
   and draws (fast), against ``engine="torch"`` on the same inputs (the
   action, the mean and Σ within 2e-4, the costs at :func:`costs_close`;
   an online eigh solve under fast or invariant rng samples the torch
   solve in the cuda solve's eigenbasis), or, under kernel rng, two solves
   from one seed equal bit for bit, every output finite and |a| <= 1, the
   kernel's costs held against the plain rollout on its sampled actions;
   each cuda solve's launches (counters at 0 just before it; host syncs
   errors but for eigh's) exactly those its route takes (K4, or K5 / K1
   under kernel rng; K3 and K2 for online CoVO under gn and adjoint, K2
   not under drag and mixed), the torch solve's none.
   ``--phase15`` builds the kernels and runs this phase alone.

Each kernel's launch count in the JSON record is read from the closed loop
that runs it (a replayed graph adds its kernels' launches at each replay):
K1-K3 from CoVO's, K5 from MPPI's kernel-rng loop, K4 from MPPI's fast
loop, K7 joint, K7 per-step and K6 from phase 5e's ``evaluate_batched``
runs of CoVO, MPPI kernel rng and MPPI fast rng, K8 from the speculative
loop (counts set to 0 just before each run); the
records of K1-K3, K5 and K8 also hold ``cli_launches``, their launches in
the command line's run that drives them (phase 9); ``parallel_launches``,
their launches in each of phase 14's runs under test (counts set to 0
just before each; the references' launches not counted); those of K1-K5
``random_configs_launches``, their launches in each case's cuda solve of
phase 15 (counts set to 0 just before each); the records of K1-K5
hold ``sweep_launches``, their launches in each script's run of phase
10b (counts set to 0 just before each), K4's ``key_tree_launches``, its
launches in each of phase 12's solves and loops, and those of K1, K4-K7
``small_n``, phase 10a's max abs error at N = 16 and 100 and the time
alone and bound at N=16. A
record's ``modes`` holds, for each disturbance mode it was checked in (and
"sd13" / "sd16" for K3), the kernel's max abs error, the environments that
ran it, its time alone, its bound counting the mode's extra operations and
table, and its launches in the drag loops; its ``realworld`` (K1, K4-K7)
holds the same for the realworld reward in the shared and drag modes, the
bound counting that reward's own operations, and K1's and K5's launches in
the tracking_slow loops. Each kernel's record also holds
its bound, the least time the card could take
for the same work at the timed shapes (the larger of its fp32 operations
over the fp32 peak and its bytes over the memory rate), and the time of
one PyTorch call computing the same function (none exists for K1-K8:
null); K1's and K7 joint's also hold ``correlate_library_ms``, the
library product of their correlate part alone; K2's and K3's hold
``alone_ms``, ``graph_ms`` (launches replayed in a CUDA graph),
``chain_ms`` (and its cycles a step), ``issue_ms`` (the step loop's stall
counts over H steps: what one warp needs to issue it), and their earlier
designs' ``earlier_alone_ms``, ``earlier_graph_ms``, ``earlier_chain_ms``,
the max abs difference from them and how many launches of one closed-loop
episode differ from them (phase 1b); K4's and K6's hold ``alone_ms``,
``earlier_alone_ms``, ``earlier_max_abs_diff``, K4's ``chain_ms`` and
``earlier_loop_launches_differing``, K6's ``issue_ms`` and
``step_instructions`` (phase 1c). Any failed check raises,
so the script exits non-zero; without a CUDA device it exits at once. The
line before the last is the kernels' JSON record, the last ``{"ok": true,
"device": {...}}``.
``--total-steps`` sets the single-scenario closed loops of phases 3, 6d, 7c
and 8c (1200 by default; 7c runs half of it).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from covo_mpc_tpu_torch.ops.counts import (
    HBM_BYTES_PER_S,
    fp32_peak,
    k1_bound,
    k2_bound,
    k3_bound,
    k4_bound,
    k5_bound,
    k8_bound,
)
from covo_mpc_tpu_torch.runtime.profiling import graph_nodes, graph_profile

N, H = 8192, 32
D = 4 * H
ENV_KW = dict(task="tracking_zigzag", enable_randomizer=False,
              disturb_type="gaussian", disable_rollover_terminate=True,
              generate_noisy_state=True)
ERR_POS_LIMIT_CM = 5.0
MPPI_ERR_POS_LIMIT_CM = 8.0
SCEN_B = 16  # the checks' scenario count (RESULTS.md's "64 chips at B=16")
SCEN_TIMING_B = (1, 16, 64)
# 150 batched steps (300 through PR 5; cut to keep the run with phase 7
# inside about 800 s)
SCEN_LOOP_B, SCEN_LOOP_STEPS = 4, 150
PID_ERR_POS_LIMIT_CM = 40.0
# the command line's eval runs (phase 9)
CLI_STEPS = 1200
# phase 12's closed loops under JAX's key schedule: CoVO online parity runs
# eagerly (eigh reads the host) for one episode, MPPI parity captured for
# two (13d's supervised run: a chunk each)
KEY_COVO_STEPS, KEY_MPPI_STEPS = 300, 600
# phase 13: the batched twins' and keyed harness's checks at B=TWIN_B, the
# captured recorder against the eager one over its first RENDER_CHECK_STEPS
TWIN_B, RENDER_CHECK_STEPS = 16, 20
# phase 1b: the K2 / K3 inputs of the main path's closed loop held against the
# earlier designs (an eager solve a step)
LOOP_BITS_STEPS = 100
T0 = time.perf_counter()


def say(*args):
    print(*args, flush=True)


def phase(title: str) -> None:
    say(f"[{time.perf_counter() - T0:7.1f} s] {title}")


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


def err_by_scenario(label: str, got: torch.Tensor, ref: torch.Tensor) -> None:
    """Print, for each scenario (leading axis; one when ``ref`` is 1-d), the
    max abs error of ``got`` against ``ref``, |ref| where it sits, and the
    max relative error |got - ref| / |ref|."""
    d, r = (got - ref).abs().reshape(-1, ref.shape[-1]), ref.abs().reshape(-1, ref.shape[-1])
    at = d.argmax(1, keepdim=True)

    def row(x):
        return "[" + ", ".join(f"{float(v):.2e}" for v in x.flatten()) + "]"

    say(f"  {label} per scenario: max abs err {row(d.gather(1, at))}, |plain| there "
        f"{row(r.gather(1, at))}, max rel err {row((d / r).amax(1))}")


_SEED_WORDS = {}


def seed_ptr(value: int) -> int:
    """The device address of a 0-d int64 word holding ``value``: the
    Philox key operand of the sampling kernels' C entry points (K1, K5, K7),
    made once a value and kept alive."""
    if value not in _SEED_WORDS:
        _SEED_WORDS[value] = torch.full((), value, dtype=torch.int64, device="cuda")
    return _SEED_WORDS[value].data_ptr()


def bare_launch_ms(kernel, *args, reps: int = 50) -> float:
    """Device ms per launch of ``kernel``'s C entry point alone, operands
    packed once: CUDA events around ``reps`` back-to-back launches, which
    are not the wrapper's and so not counted."""
    from covo_mpc_tpu_torch.ops import kernels

    fn = getattr(kernels.library(), kernel.symbol)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{kernel.symbol}: CUDA launch failed, cudaError {err}")

    return time_ms(launch, reps)


def say_geometry(label: str, g: dict) -> None:
    """Print a tiled kernel's launch geometry ``g`` (``rollout_cuda.joint_info``
    or one of ``sample_info``'s or ``rollout_info``'s, read from the built
    library)."""
    say(f"  {label} geometry: S={g['samples']} samples a block, T={g['threads']} "
        f"threads, {g['smem']} B of shared memory a block; blocks an SM, "
        f"registers, local bytes: penyaw {tuple(g['penyaw'].values())}, realworld "
        f"{tuple(g['realworld'].values())}")


def say_sample_geometry() -> None:
    """Print K5 / K7 per-step's two kernels' geometry at the wrappers'
    default block and the main path's H."""
    from covo_mpc_tpu_torch.ops import rollout_cuda

    for name, g in rollout_cuda.sample_info(H=H).items():
        say_geometry(f"K5 / K7 per-step ({name} kernel)", g)


def phase_kernels(env, dev, records):
    from covo_mpc_tpu_torch.models import pack_state
    from covo_mpc_tpu_torch.ops import hessian_cuda, rollout_cuda

    phase("phase 1: kernels against their plain versions (N=8192, H=32, D=128)")
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
    err_by_scenario("K1 costs", c_k, c_p)
    check(err_a <= 1e-5, "K1 actions within atol 1e-5")
    check(bool(((c_k - c_p).abs() <= 2e-4 + 1e-5 * c_p.abs()).all()),
          "K1 costs within atol 2e-4, rtol 1e-5")
    other = 128 if k1.block == 64 else 64
    c_o, a_o = rollout_cuda.make_rollout_joint_sampling(env, block=other)(
        *args, 0, N, z=z, **kw)
    check(torch.equal(c_o, c_k) and torch.equal(a_o, a_k),
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
    # plain version draws with torch.randn; the correlate alone as one
    # library product, a yardstick the port never calls (library_ms stays
    # null: no PyTorch call computes the fused sample + rollout)
    say_geometry("K1 / K7 joint", rollout_cuda.joint_info(H=H))
    ms_k1 = time_ms(lambda: k1(*args, 7, N, **kw), 50)
    ms_k1p = time_ms(lambda: k1.plain(*args, 7, N, **kw), 10)
    ms_mm = time_ms(lambda: torch.matmul(factor, z), 50)
    records["joint_sample_rollout"] = dict(max_abs_err=max(err_a, err_c),
                                          ms=ms_k1, plain_ms=ms_k1p, **k1_bound(1, N, H),
                                          correlate_library_ms=ms_mm)
    say(f"  K1 {ms_k1:.4f} ms, plain {ms_k1p:.4f} ms; correlate yardstick "
        f"torch.matmul (D, D) x (D, N) {ms_mm:.4f} ms "
        f"(allow_tf32={torch.backends.cuda.matmul.allow_tf32})")

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
    # x0, actions (H, 4), disturbance table (H, 3), the scalars in; (H, 13) out
    records["primal"] = dict(max_abs_err=err2, ms=ms_k2, plain_ms=ms_k2p,
                             **k2_bound(H))
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
    # J (H, 13, 17) in, T (H, 17, D) out; per step a (13 x 17) x (17 x D) product
    records["sens_chain"] = dict(max_abs_err=max_err(T_k, T_p), ms=ms_k3,
                                 plain_ms=ms_k3p,
                                 **k3_bound(H))
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
    other = 128 if k4.block == 64 else 64
    c_o = rollout_cuda.make_rollout_costs(env, block=other)(
        *roll, acts, p, draw=draw, layout="hdn")
    check(torch.equal(c_o, k4(*roll, acts, p, draw=draw, layout="hdn")),
          "K4 results independent of the block size (64 vs 128)")
    ms_k4 = time_ms(lambda: k4(*roll, acts, p, draw=draw, layout="hdn"), 50)
    ms_k4p = time_ms(lambda: k4.plain(*roll, acts, p, draw=draw, layout="hdn"), 10)
    records["rollout_costs"] = dict(max_abs_err=err4, ms=ms_k4, plain_ms=ms_k4p,
                                    **k4_bound(1, N, H))
    say_geometry("K4 / K6 (split kernel)", rollout_cuda.rollout_info()["split"])
    say_geometry("K4 / K6 (step kernel)", rollout_cuda.rollout_info()["step"])
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
    others = [s for s in rollout_cuda.SAMPLE_BLOCKS if s != k5.block]
    for s in others:
        c_s, a_s = rollout_cuda.make_rollout_sampling(env, block=s)(
            *args5, 7, N, disturb_seed=8)
        check(torch.equal(c_s, c_k) and torch.equal(a_s, a_k),
              f"K5 in-kernel draws and costs independent of the block size "
              f"({k5.block} vs {s} samples)")
    say_sample_geometry()
    # times: in-kernel draws (krng), the plain version draws with torch.randn
    ms_k5 = time_ms(lambda: k5(*args5, 7, N, disturb_seed=8), 50)
    ms_k5p = time_ms(lambda: k5.plain(*args5, 7, N, disturb_seed=8), 10)
    records["sample_rollout"] = dict(max_abs_err=max(err_a5, err_c5, err_k5),
                                     ms=ms_k5, plain_ms=ms_k5p, **k5_bound(1, N, H))
    say(f"  K5 {ms_k5:.4f} ms, plain {ms_k5p:.4f} ms")


def phase_chain_kernels(dev, records, earlier, probe, clock_mhz):
    """1b: K2 and K3 alone beside their earlier designs (``tools/earlier``)
    in this run, from the host (bare launches, as every kernel's "alone")
    and replayed in a CUDA graph (the host out of the way), with an empty
    kernel's times as the launch floor; the new results against the earlier
    ones bit for bit, on one input and on every input of the main path's
    closed loop's first LOOP_BITS_STEPS steps; and each step loop's critical
    path from its SASS
    (``chain_ms``: H steps at the SM clock ``clocks.max.sm``, with the
    latencies the probe measures on this card)."""
    from covo_mpc_tpu_torch.ops import hessian_cuda, kernels, rollout_cuda
    from covo_mpc_tpu_torch.tools import sass_chain
    from covo_mpc_tpu_torch.tools.primal_chain_variants import (
        chain_j,
        chain_of,
        empty_launcher,
        events_ms,
        graph_ms,
        launcher,
        loop_bits,
        primal_operands,
    )

    phase("phase 1b: K2 and K3 alone beside their earlier designs; their chains")
    lat = sass_chain.measure_latencies(probe)
    say("  latencies (cycles, probe): " + ", ".join(f"{k} {v:.2f}" for k, v in lat.items()))
    empty = empty_launcher(probe)
    say(f"  an empty one-warp kernel: {events_ms(empty(), 200):.4f} ms a launch from the "
        f"host, {graph_ms(empty):.4f} ms in a graph")
    lib = kernels.library()
    _, _, x0, scal, a, dist = primal_operands(H, dev, "zero")
    k2_ops = (x0, scal, a.reshape(-1).contiguous(), dist.reshape(-1).contiguous())
    J = chain_j(13, H, dev)
    for name, kernel, ops, out, sd in (
            ("primal", rollout_cuda.PRIMAL_KERNEL, k2_ops, torch.empty(H, 13, device=dev), 13),
            ("sens_chain", hessian_cuda.CHAIN_KERNEL, (J,), torch.empty(H, 17, D, device=dev),
             13)):
        old_out = torch.empty_like(out)
        launcher(earlier[name][1], name, ops, old_out, H, sd)()
        launcher(lib, name, ops, out, H, sd)()
        torch.cuda.synchronize()
        same = torch.equal(out, old_out)
        diff = max_err(out, old_out)
        args = (*[t.data_ptr() for t in ops], out.data_ptr(), H) + (
            (sd, 4) if name == "sens_chain" else ())
        ms = bare_launch_ms(kernel, *args, reps=200)
        times = {}
        for which, cdll, dst in (("new", lib, out), ("earlier", earlier[name][1], old_out),
                                 ("new again", lib, out)):
            make = lambda cdll=cdll, dst=dst: launcher(cdll, name, ops, dst, H, sd)  # noqa: E731
            times[which] = (events_ms(make(), 200), graph_ms(make))
        loop = chain_of(lib, name, sd, lat)
        loop_old = chain_of(earlier[name][1], name, sd, lat)
        chain = sass_chain.chain_ms(H, loop["cycles"], clock_mhz)
        chain_old = sass_chain.chain_ms(H, loop_old["cycles"], clock_mhz)
        records[name].update(alone_ms=ms, graph_ms=times["new"][1], chain_ms=chain,
                             chain_cycles=loop["cycles"],
                             issue_ms=sass_chain.chain_ms(H, loop["issue"], clock_mhz),
                             earlier_alone_ms=times["earlier"][0],
                             earlier_graph_ms=times["earlier"][1], earlier_chain_ms=chain_old,
                             earlier_max_abs_diff=diff)
        say(f"  {kernel.symbol}: alone {ms:.4f} ms; equal to the earlier design bit for bit: "
            f"{same} (max |diff| {diff:.3e}); from the host / in a graph, in turns: " + ", ".join(
                f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in times.items()) + " ms")
        say(f"  {kernel.symbol} chain {chain:.4f} ms at {clock_mhz:.0f} MHz: "
            f"{sass_chain.describe(loop)}")
        say(f"  {kernel.symbol} earlier design's chain {chain_old:.4f} ms: "
            f"{sass_chain.describe(loop_old)}")
    # every K2 / K3 input of the main path's closed loop's first steps
    for name, (n, bad, diff) in loop_bits(earlier, dev, LOOP_BITS_STEPS).items():
        records[name]["earlier_loop_launches_differing"] = f"{bad} of {n}"
        say(f"  {name} in the main path's closed loop's first {LOOP_BITS_STEPS} steps: "
            f"{bad} of {n} launches differ from the earlier design, max |diff| {diff:.3e}")


def phase_rollout_kernels(dev, records, earlier, probe, clock_mhz):
    """1c: K4 (B=1) and K6 (B=SCEN_B) alone (bare launches, in turns)
    beside the kernel they replaced (``tools/earlier/rollout.cu``, built in
    this run), their costs against its bit for bit, and on every K4 input
    of one episode of MPPI with fast rng; K4's ``chain_ms`` (the split
    kernel's attitude loop: its longest recurrence from its SASS over H
    steps at the SM clock ``clocks.max.sm``) and K6's ``issue_ms`` (the step kernel's
    loop: its instructions over H steps and the grid's warps, at one
    instruction a cycle on each of four schedulers an SM)."""
    from covo_mpc_tpu_torch.ops import kernels, rollout_cuda
    from covo_mpc_tpu_torch.tools import rollout_variants, sass_chain

    phase("phase 1c: K4 and K6 alone beside their earlier design; chain and issue floors")
    lat = sass_chain.measure_latencies(probe)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = kernels.library()
    B, block = SCEN_B, rollout_cuda.ROLLOUT_BLOCK
    ops16, mode, reward = rollout_variants.operands("gaussian", "tracking_zigzag", B, H, dev)
    acts16 = torch.from_numpy((0.8 * np.random.default_rng(0).standard_normal(
        (B, H, 4, N))).astype(np.float32)).to(dev)
    loops = rollout_variants.kernel_loops(Path(lib._name), rollout_variants.OUT / "sass", lat,
                                          {k: v for k, v in rollout_variants.SASS_KERNELS.items()
                                           if "split" in v or "step" in v})
    for name, kernel, b in (("rollout_costs", rollout_cuda.ROLLOUT_KERNEL, 1),
                            ("rollout_costs_batched", rollout_cuda.ROLLOUT_BATCHED_KERNEL, B)):
        ops = [t[:b].contiguous() for t in ops16]
        acts = acts16[:b].contiguous()
        new, old = torch.empty(b, N, device=dev), torch.empty(b, N, device=dev)
        launches = {which: rollout_variants.launcher(cdll, ops, acts, out, b, N, H, 0, mode,
                                                     reward, blk)
                    for which, cdll, out, blk in (("new", lib, new, block),
                                                  ("earlier", earlier, old, 128))}
        for launch in launches.values():
            launch()
        torch.cuda.synchronize()
        same, diff = torch.equal(new, old), max_err(new, old)
        times = {key: time_ms(launches[which], 200)  # in turns
                 for key, which in (("new", "new"), ("earlier", "earlier"),
                                    ("new again", "new"))}
        rec = records.setdefault(name, {})
        rec.update(alone_ms=times["new"], earlier_alone_ms=times["earlier"],
                   earlier_max_abs_diff=diff)
        if b == 1:
            loop = loops["split kernel, attitude"]
            rec.update(chain_ms=sass_chain.chain_ms(H, loop["recurrence"], clock_mhz),
                       chain_cycles=loop["recurrence"])
            floor = (f"chain {rec['chain_ms']:.4f} ms ({loop['recurrence']:.1f} cycles a "
                     f"step, the attitude recurrence)")
        else:
            loop = loops["step kernel"]
            rec.update(issue_ms=sass_chain.issue_ms(loop["count"], H, b * -(-N // 32), sms,
                                                    clock_mhz),
                       step_instructions=loop["count"])
            floor = f"issue {rec['issue_ms']:.4f} ms ({loop['count']} instructions a step)"
        say(f"  {kernel.symbol} (B={b}): alone {times['new']:.4f} ms, earlier design "
            f"{times['earlier']:.4f} ms, again {times['new again']:.4f} ms; equal to the earlier "
            f"design bit for bit: {same} (max |diff| {diff:.3e}); {floor} at "
            f"{clock_mhz:.0f} MHz")
        check(same, f"{kernel.symbol}: costs equal to the earlier design's bit for bit")
    for label, loop in loops.items():
        say(f"  {label} loop: {sass_chain.describe(loop)}; its longest recurrence "
            f"{loop['recurrence']:.1f} cycles")
    n, bad, diff = rollout_variants.loop_bits(earlier, dev, 300)
    records["rollout_costs"]["earlier_loop_launches_differing"] = f"{bad} of {n}"
    say(f"  rollout_costs in one 300-step MPPI fast episode: {bad} of {n} launches differ "
        f"from the earlier design, max |diff| {diff:.3e}")


def make_solver(env, engine, seed=0, rng_mode=None, name="covo_online",
                sigma_mode="ns"):
    """A CoVO solver at the main path's configuration (default: the
    CoVO-online main path); rng_mode defaults to "kernel" on the cuda
    engine, "fast" on torch."""
    from covo_mpc_tpu_torch.solvers import get_solver

    rng_mode = rng_mode or ("kernel" if engine == "cuda" else "fast")
    return get_solver(env, name, f"N{N}_H{H}_lam0.01",
                      rng_mode=rng_mode, hessian_mode="gn", sigma_mode=sigma_mode,
                      engine=engine, collect_debug=False, seed=seed)


def make_mppi(env, engine, seed=0, rng_mode=None):
    """MPPI at the repo's configuration (N8192_H32_lam0.01, sigma 0.5);
    rng_mode defaults to "kernel" on the cuda engine, "fast" on torch."""
    from covo_mpc_tpu_torch.solvers import get_solver

    rng_mode = rng_mode or ("kernel" if engine == "cuda" else "fast")
    return get_solver(env, "mppi", f"N{N}_H{H}_lam0.01", rng_mode=rng_mode,
                      engine=engine, collect_debug=False, seed=seed)


def run_once(fn, kernel_list):
    """``fn()`` once to warm up, then once with the launch counters at 0 and
    host syncs turned into errors; returns its result and the counts."""
    fn()
    torch.cuda.synchronize()
    for k in kernel_list:
        k.launches = 0
    # a host sync anywhere in the solve raises here
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, {k.symbol: k.launches for k in kernel_list}


def phase_solve(env, dev, kernel_list):
    from covo_mpc_tpu_torch.ops import rollout_cuda

    phase("phase 2: one full-width solve, engine='cuda' against engine='torch'")
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
        out[engine, rng_mode], counts = run_once(
            lambda: solver(*args[:3], cp, args[3], z=z), kernel_list)
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

    phase("phase 2b: one full-width MPPI solve, engine='cuda' against "
        "engine='torch', on the same z and draw")
    g = np.random.default_rng(3)
    z = torch.from_numpy(g.standard_normal((N, H, 4)).astype(np.float32)).to(dev)
    draw = torch.from_numpy(g.standard_normal(3).astype(np.float32)).to(dev)
    out = {}
    for engine, rng_mode, used in (("cuda", "kernel", rollout_cuda.SAMPLE_KERNEL),
                                   ("cuda", "fast", rollout_cuda.ROLLOUT_KERNEL),
                                   ("torch", "fast", None)):
        solver, cp = make_mppi(env, engine, rng_mode=rng_mode)
        out[engine, rng_mode], counts = run_once(
            lambda: solver(*args[:3], cp, args[3], z=z, draw=draw), kernel_list)
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


# --- phase 2c: the captured solves (CUDA graphs) ----------------------------

CAPTURE_CHAIN = 20  # eager solves and replays held against each other
MAIN_PATH = "covo_online (gn, ns, kernel rng: the main path)"  # 2c's case label
SCHEDULE_FIELDS = ("a_cov_offline", "a_factor_offline")  # offline's, read only


def solve_outputs(method: str, out) -> dict:
    """The tensors one solve gives, by name: the action and the solver
    params' tensors (offline's schedule aside: a solve reads it only)."""
    action, cp = (None, out) if method == "prepare" else out[:2]
    named = {} if action is None else {"action": action}
    if cp is not None:
        named.update({f: getattr(cp, f) for f in cp.__dataclass_fields__
                      if isinstance(getattr(cp, f), torch.Tensor)
                      and f not in SCHEDULE_FIELDS})
    return named


def captured_cases(env):
    """(label, solver, its first params, method, draws): every solve JAX
    jits, on the main path's env; speculative and offline params after
    their reset at the reset state of phase 2."""
    from covo_mpc_tpu_torch.solvers import get_solver

    p = env.default_params
    _, _, state = env.reset(torch.Generator(env.device).manual_seed(5), p)
    spec, spec_cp = make_solver(env, "cuda", name="covo_speculative", sigma_mode="ns_pallas")
    spec_cp = spec.reset(state, p, spec_cp)
    off, off_cp = make_solver(env, "cuda", name="covo_offline")
    off_cp = off.reset(state, p, off_cp)
    return [
        (MAIN_PATH, *make_solver(env, "cuda"),
         "call", True),
        ("covo_online (gn, ns_pallas, kernel rng)",
         *make_solver(env, "cuda", sigma_mode="ns_pallas"), "call", True),
        ("covo_speculative act() (ns_pallas, kernel rng)", spec, spec_cp, "act", True),
        # a deterministic model step and Hessian under the gaussian model
        ("covo_speculative prepare() (ns_pallas)", spec, spec_cp, "prepare", False),
        ("covo_offline (kernel rng)", off, off_cp, "call", True),
        ("mppi (kernel rng: K5)", *make_mppi(env, "cuda"), "call", True),
        ("mppi (fast rng: torch normals + K4)", *make_mppi(env, "cuda", rng_mode="fast"),
         "call", True),
        ("pid", *get_solver(env, "pid"), "call", False),
        ("random", *get_solver(env, "random", rng_mode="fast"), "call", True),
    ]


def solve_calls(solver, method, obs, state, p, info):
    """(the solve, ``call(f, cp)`` that runs f on the case's arguments,
    ``carry(out)`` the params the next solve of a chain takes)."""
    if method == "prepare":
        return (solver.prepare, lambda f, cp: f(state, p, cp, info), lambda out: out)
    return (solver.act if method == "act" else solver,
            lambda f, cp: f(obs, state, p, cp, info), lambda out: out[1])


def phase_captured(env, dev, kernel_list):
    """Phase 2c: each solve JAX jits, captured as a CUDA graph
    (runtime/graphs.py) and held against its eager twin. First every case
    is captured and its replays profiled (the graph's nodes, the device ms
    a replay from sessions that lost no event; profiled first, as sessions
    late in a long process lose events); then, per case, CAPTURE_CHAIN
    chained eager solves and as many replays from the same seed and params
    (2e-4 on every output), fresh draws at each replay, the replays' launch
    counts equal to the eager ones, p50 / p99 by time_blocking and ms per
    solve by time_chained for both, and the device's busy share inside the
    replays (device ms a replay over the chained ms a replay), the timing
    after ``graphs.settle()`` watching the main path's replay. Returns a
    summary by case."""
    from covo_mpc_tpu_torch.runtime import graphs, profiling

    p = env.default_params
    obs, info, state = env.reset(torch.Generator(dev).manual_seed(5), p)
    phase("phase 2c: captured solves (CUDA graphs), each captured and its replays profiled")
    cases = []
    for label, solver, cp0, method, draws in captured_cases(env):
        fn, call, carry = solve_calls(solver, method, obs, state, p, info)
        t0 = time.perf_counter()
        cap = call(lambda *a: graphs.capture_solver(fn, solver, *a), cp0)
        capture_s = time.perf_counter() - t0
        nodes = graph_nodes(cap)
        dev_ms, complete, seen = graph_profile(cap.replay, nodes)
        say(f"  {label}: captured in {capture_s:.2f} s, {nodes} graph nodes; device "
            f"{fmt_ms(dev_ms)} a replay ({complete} sessions of 10 replays complete; "
            f"device ops recorded: {seen})")
        cases.append((label, solver, cp0, method, draws, fn, call, carry, cap,
                      dict(capture_s=capture_s, graph_nodes=nodes, device_ms=dev_ms)))
    main_cap = next(c[8] for c in cases if c[0] == MAIN_PATH)
    slept = graphs.settle(probe=main_cap.replay)
    ms = [r for _, r in graphs.last_readings]
    say(f"  timing starts {slept:.1f} s later: {graphs.SETTLE_S:.0f} s after the last "
        f"capture, then {len(ms)} readings of the main path's replay, first / median / "
        f"last {ms[0]:.4f} / {sorted(ms)[len(ms) // 2]:.4f} / {ms[-1]:.4f} ms (the card's "
        "slow spell after a capture, PERF.md §7)")
    summary = {}
    for label, solver, cp0, method, draws, fn, call, carry, cap, rec in cases:
        phase(f"phase 2c: captured solves, {label}")
        slow = "covo" in label
        # the eager chain and the replayed one from the same seed and
        # params (seed() after the capture: the graph reads the new keys),
        # launch counts from 0 for each
        chains, counts = {}, {}
        for kind, f in (("eager", fn), ("captured", cap)):
            solver.seed(3)
            for k in kernel_list:
                k.launches = 0
            chains[kind], cp = [], cp0
            for _ in range(CAPTURE_CHAIN):
                out = call(f, cp)
                chains[kind].append(solve_outputs(method, out))
                cp = carry(out)
            counts[kind] = {k.symbol: k.launches for k in kernel_list}
        torch.cuda.synchronize()
        errs = {}
        for eager, replayed in zip(chains["eager"], chains["captured"]):
            for name in eager:
                errs[name] = max(errs.get(name, 0.0), max_err(replayed[name], eager[name]))
        say(f"  max |replay - eager| over {CAPTURE_CHAIN} chained solves: {errs}")
        check(all(v <= 2e-4 for v in errs.values()),
              f"{label}: {CAPTURE_CHAIN} replays match {CAPTURE_CHAIN} eager solves "
              "within 2e-4 on every output")
        say(f"  launches, eager / replayed: { {k: v for k, v in counts['eager'].items() if v} }"
            f" / { {k: v for k, v in counts['captured'].items() if v} }")
        check(counts["captured"] == counts["eager"], f"{label}: the replays' launch counts "
              "equal the eager solves'")
        if draws:
            first = solve_outputs(method, call(cap, cp0))
            second = solve_outputs(method, call(cap, cp0))
            same = [n for n in first if torch.equal(first[n], second[n])]
            say(f"  two replays on the same inputs: outputs equal bit for bit: {same or 'none'}")
            check(not torch.equal(first["action"], second["action"]),
                  f"{label}: consecutive replays draw different samples")
        # latency: host wall per call, then device ms per call of a chain
        iters = 20 if slow else 60
        blocking = {"eager": profiling.time_blocking(lambda: call(fn, cp0), iters, 2),
                    "captured": profiling.time_blocking(lambda: call(cap, cp0), 60, 2)}
        chained = {
            "eager": profiling.time_chained(lambda c: carry(call(fn, c)), cp0,
                                            iters=4 if slow else 8, k=8 if slow else 16),
            "captured": profiling.time_chained(lambda c: carry(call(cap, c)), cp0,
                                               iters=8, k=16)}
        for kind in ("eager", "captured"):
            b, c = blocking[kind], chained[kind]
            say(f"  {kind:8s} time_blocking p50 {b['p50'] * 1e3:9.4f} ms, p99 "
                f"{b['p99'] * 1e3:9.4f} ms ({b['iters']} calls); time_chained "
                f"{c['p50'] * 1e3:9.4f} ms per solve (median of {c['iters']} chains of "
                f"{c['k']})")
        replay_ms = chained["captured"]["p50"] * 1e3
        busy = None if rec["device_ms"] is None else rec["device_ms"] / replay_ms
        say(f"  inside the replays: device busy "
            f"{'not measured' if busy is None else f'{100 * busy:.2f}%'} (device "
            f"{fmt_ms(rec['device_ms'])} a replay over {replay_ms:.4f} ms a chained replay)")
        summary[label] = {
            "max_abs_diff": errs, **rec, "busy": busy,
            **{f"{kind}_{q}_ms": blocking[kind][q] * 1e3 for kind in blocking
               for q in ("p50", "p99")},
            **{f"{kind}_chained_ms": chained[kind]["p50"] * 1e3 for kind in chained}}
    del cases
    say("captured summary: " + json.dumps(summary))
    main_path = summary[MAIN_PATH]
    check(main_path["captured_p50_ms"] < 20.0,
          "the captured main-path solve's p50 (time_blocking) under 20 ms, the 50 Hz budget")
    return summary


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


def device_profile(fn, reps: int = 1, sessions: int = 2, name: str = "") -> dict:
    """``runtime.profiling.device_profile``, its check of the host's
    enqueued work printed."""
    from covo_mpc_tpu_torch.runtime import profiling

    prof = profiling.device_profile(fn, reps, sessions, name)
    check(True, f"the same device work enqueued in every session: {{{prof['enqueued']}}}")
    return prof


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:9.4f} ms"


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

    phase("profile: layers of one cuda-engine solve (N=8192, H=32)")
    p = env.default_params
    obs, info, state = env.reset(torch.Generator(dev).manual_seed(7), p)
    st = info["noisy_state"]
    solver, cp = make_solver(env, "cuda")
    x0 = pack_state(st)
    a_mean = torch.cat([cp.a_mean[1:], cp.a_mean[-1:]])
    aux = build_hessian_disturb_table(env, x0, st.time, p, None, H)
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
        # two calls per profiler session (five through PR 5: the sessions'
        # event processing cost ~3 s each on the CoVO layers)
        prof = device_profile(fn, reps=2, name=kernel)
        line = f"  {name:30s} events {ev:9.4f} ms, device {fmt_ms(prof['ms'])}"
        if kernel:
            line += f", of it the kernel {fmt_ms(prof['kernel_ms'])}"
        say(line + f" ({prof['complete']} sessions complete)")


def busy_window(solver, cp, obs, state, p, info):
    """Solves under the profiler, five to a session: the device work one
    solve enqueues and, from the complete sessions, the device's busy share
    of the solves' wall time."""
    prof = device_profile(lambda: solver(obs, state, p, cp, info), reps=2)
    busy = ("not measured" if prof["busy"] is None else
            f"{prof['ms']:.4f} of {prof['wall_ms']:.4f} ms ({100 * prof['busy']:.2f}%)")
    say(f"  profiler window: {prof['ops']} device kernels and copies per solve; "
        f"device busy per solve {busy} (profiler on; {prof['complete']} sessions "
        "complete)")


def profile_mppi(env, dev):
    """Where one MPPI cuda-engine (kernel rng) solve's time goes, as
    :func:`profile_solves` reads CoVO's, and the fast path's sample + K4
    beside K5."""
    from covo_mpc_tpu_torch.models import pack_state
    from covo_mpc_tpu_torch.ops import reductions, rollout_cuda, sampling

    phase("profile: layers of one MPPI cuda-engine solve (N=8192, H=32, kernel rng)")
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
                                  "sample_rollout_"),  # the tile or step kernel
        "fast: torch sample + K4": (fast_sample_rollout, "rollout_split_kernel"),
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


def phase_closed_loops(env, dev, total_steps, covo_kernels, kernel_list):
    """Phase 3: the single-scenario closed loops (captured: each control
    step one CUDA graph), CoVO online, MPPI kernel rng and MPPI fast rng
    at ``total_steps``, and the eager solve times; returns each kernel's
    launch count from the loop that runs it."""
    phase(f"phase 3: closed loop, evaluate(total_steps={total_steps}, seed=1), "
        "engine='cuda', rng_mode='kernel'")
    solver, _ = make_solver(env, "cuda")
    result, launches = closed_loop(env, solver, total_steps, kernel_list)
    check(all(launches[k.symbol] > 0 for k in covo_kernels),
          "every kernel of the CoVO path launched by the main path")
    check(np.isfinite(result.mean) and result.mean * 100 < ERR_POS_LIMIT_CM,
          f"err_pos finite and below {ERR_POS_LIMIT_CM} cm")
    med, counts = solve_times(env, dev)
    say(f"  median device ms per solve: cuda {med['cuda']:.4f} ({counts['cuda']} solves), "
        f"torch {med['torch']:.4f} ({counts['torch']} solves)")

    phase(f"phase 3b: MPPI closed loop, evaluate(total_steps={total_steps}, "
        "seed=1), engine='cuda', rng_mode='kernel'")
    solver, _ = make_mppi(env, "cuda")
    mppi, mppi_launches = closed_loop(env, solver, total_steps, kernel_list)
    launches["sample_rollout"] = mppi_launches["sample_rollout"]
    check(launches["sample_rollout"] > 0, "sample_rollout launched by the MPPI loop")
    check(np.isfinite(mppi.mean) and mppi.mean * 100 < MPPI_ERR_POS_LIMIT_CM,
          f"MPPI err_pos finite and below {MPPI_ERR_POS_LIMIT_CM} cm")
    check(mppi.mean > result.mean,
          "MPPI err_pos above CoVO's on the same reset trajectories")
    phase(f"phase 3c: MPPI closed loop, evaluate(total_steps={total_steps}, "
        "seed=1), engine='cuda', rng_mode='fast'")
    solver, _ = make_mppi(env, "cuda", rng_mode="fast")
    fast, fast_launches = closed_loop(env, solver, total_steps, kernel_list)
    launches["rollout_costs"] = fast_launches["rollout_costs"]
    check(launches["rollout_costs"] > 0, "rollout_costs launched by the MPPI fast loop")
    check(np.isfinite(fast.mean) and fast.mean * 100 < MPPI_ERR_POS_LIMIT_CM,
          f"MPPI (fast) err_pos finite and below {MPPI_ERR_POS_LIMIT_CM} cm")
    med, counts = solve_times(env, dev, make=make_mppi)
    say(f"  MPPI median device ms per solve: cuda {med['cuda']:.4f} "
        f"({counts['cuda']} solves), torch {med['torch']:.4f} ({counts['torch']} solves)")
    return launches


# --- phase 5: the scenario-batched solves -----------------------------------


def solve_args(infos):
    """(x0s (B, 16), t0s (B,), pos_trajs (B, T, 3), vel_trajs) of the
    scenarios' noisy states: the state inputs of one batched solve."""
    from covo_mpc_tpu_torch.models import pack_state

    sts = [info["noisy_state"] for info in infos]
    return (torch.stack([pack_state(s) for s in sts]),
            torch.stack([s.time for s in sts]),
            torch.stack([s.pos_traj for s in sts]),
            torch.stack([s.vel_traj for s in sts]))


def scenario_batch(env, B: int, seed: int, randomize: bool = True):
    """B scenarios drawn from one generator seeded ``seed``: each one's
    params (``env.sample_params`` when ``randomize``, else the defaults),
    then its reset. Returns (the solve's state inputs, params_b, the
    states, the infos)."""
    from covo_mpc_tpu_torch.models.structs import stack_params

    gen = torch.Generator(env.device).manual_seed(seed)
    params = [env.sample_params(gen) if randomize else env.default_params
              for _ in range(B)]
    resets = [env.reset(gen, p) for p in params]
    infos = [r[1] for r in resets]
    return solve_args(infos), stack_params(params), [r[2] for r in resets], infos


def sub_batch(args, params_b, idx):
    """Scenarios ``idx`` (a list) of batched solve inputs and params."""
    from covo_mpc_tpu_torch.models.structs import index_params, stack_params

    return (tuple(x[idx] for x in args),
            stack_params([index_params(params_b, b) for b in idx]))


def initial_means(env, B: int):
    """B copies of the hover sequence and of MPPI's sigma^2 I per step."""
    from covo_mpc_tpu_torch.solvers.factory import DEFAULT_SIGMA, hover_sequence

    a_means = hover_sequence(env, H).expand(B, H, 4).contiguous()
    a_covs = (DEFAULT_SIGMA**2 * torch.eye(4, device=env.device)).expand(
        B, H, 4, 4).contiguous()
    return a_means, a_covs


def make_batched(env, kind: str, engine: str, rng_mode=None, seed: int = 0):
    """A batched CoVO-online (adjoint Hessian, as ``bench.py --scenarios``)
    or MPPI solve at N8192_H32_lam0.01; rng_mode defaults to "kernel" on
    the cuda engine, "fast" on torch."""
    from covo_mpc_tpu_torch.parallel import make_batched_covo_solve, make_batched_mppi_solve

    rng_mode = rng_mode or ("kernel" if engine == "cuda" else "fast")
    make = make_batched_covo_solve if kind == "covo" else make_batched_mppi_solve
    return make(env, N, H, 0.01, rng=rng_mode, engine=engine, seed=seed)


def phase_scenario_kernels(env, dev, records):
    from covo_mpc_tpu_torch.models.structs import index_params
    from covo_mpc_tpu_torch.ops import rollout_cuda

    B = SCEN_B
    phase(f"phase 5a: K6 and K7 against their plain versions (B={B}, N={N}, "
        f"H={H}, D={D}, domain-randomized scenarios)")
    args, pb, _, _ = scenario_batch(env, B, seed=21)
    say(f"  masses {[round(float(m), 5) for m in pb.m]}, alpha_bodyrate "
        f"{[round(float(a), 4) for a in pb.alpha_bodyrate]}, action_scale "
        f"{[round(float(a), 4) for a in pb.action_scale]}")
    rng = np.random.default_rng(5)

    def cuda(x):
        return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(dev)

    draws = cuda(rng.standard_normal((B, 3)))
    one, pb1 = sub_batch(args, pb, [0])
    four, pb4 = sub_batch(args, pb, [0, 1, 2, 3])
    single, p0 = tuple(x[0] for x in args), index_params(pb, 0)
    modes = (("deterministic", dict(deterministic=True)),
             ("per-scenario gaussian draws", dict(draws=draws)))

    # K6: rollout costs of given actions, both layouts
    acts = cuda(rng.normal(size=(B, H, 4, N)) * 0.5)
    k6 = rollout_cuda.make_rollout_batched_costs(env)
    err6 = 0.0
    for layout, a in (("hdn", acts), ("nhd", acts.permute(0, 3, 1, 2).contiguous())):
        for what, kw in modes:
            c_k = k6(*args, a, pb, layout=layout, **kw)
            c_p = k6.plain(*args, a, pb, layout=layout, **kw)
            err6 = max(err6, max_err(c_k, c_p))
            check(costs_close(c_k, c_p),
                  f"K6 costs ({layout}, {what}) within atol 2e-4, rtol 1e-5")
            if layout == "hdn":
                err_by_scenario(f"K6 costs ({what})", c_k, c_p)
    say(f"  K6 max |costs - plain| = {err6:.3e}")
    c1 = k6(*one, acts[:1], pb1, draws=draws[:1])
    c4 = rollout_cuda.make_rollout_costs(env)(*single, acts[0], p0, draws[0],
                                              layout="hdn")
    say(f"  K6 at B=1 against K4: max |costs| diff {max_err(c1[0], c4):.3e}")
    check(max_err(c1[0], c4) <= 2e-6, "K6 at B=1: costs within 2e-6 of K4's")
    ms6 = time_ms(lambda: k6(*args, acts, pb, draws=draws), 50)
    ms6p = time_ms(lambda: k6.plain(*args, acts, pb, draws=draws), 5, warmup=1)
    records.setdefault("rollout_costs_batched", {}).update(
        max_abs_err=err6, ms=ms6, plain_ms=ms6p, **k4_bound(B, N, H))
    # the bare launches, on operands the wrapper's own packing made
    ops = rollout_cuda._launch_operands(env, *args, pb, draws, False, 1.0, H)
    ptrs = [t.data_ptr() for t in ops]
    costs = torch.empty(B, N, device=dev)
    ms6k = bare_launch_ms(rollout_cuda.ROLLOUT_BATCHED_KERNEL, *ptrs, acts.data_ptr(),
                          costs.data_ptr(), B, N, H, k6._check_rollover, k6.mode,
                          k6.reward, k6.block)
    say(f"  K6 {ms6:.4f} ms, plain {ms6p:.4f} ms, kernel alone {ms6k:.4f} ms")

    # K7 per-step (MPPI) and joint (CoVO): input-z against the plain
    # versions, then in-kernel draws at B=1 against K5 / K1 and at B=4
    # against B=16
    a_means = cuda(rng.normal(size=(B, H, 4)) * 0.2)
    A = rng.normal(size=(B, H, 4, 4)) * 0.2
    chols = cuda(np.linalg.cholesky(A @ A.swapaxes(-1, -2) + 0.05 * np.eye(4)))
    factors = cuda(rng.normal(size=(B, D, D)) * 0.1)
    k5 = rollout_cuda.make_rollout_sampling(env)
    k1 = rollout_cuda.make_rollout_joint_sampling(env)
    for joint, name, fac, z, single_k in (
            (False, "sample_rollout_batched", chols,
             cuda(rng.standard_normal((B, H, 4, N))), k5),
            (True, "joint_sample_rollout_batched", factors,
             cuda(rng.standard_normal((B, D, N))), k1)):
        label = "K7 joint" if joint else "K7 per-step"
        k7 = rollout_cuda.make_rollout_batched_sampling(env, joint=joint)
        kargs = (*args, a_means, fac, pb)
        err_a = err_c = 0.0
        for what, kw in modes:
            c_k, a_k = k7(*kargs, 0, N, z=z, **kw)
            c_p, a_p = k7.plain(*kargs, 0, N, z=z, **kw)
            err_a, err_c = max(err_a, max_err(a_k, a_p)), max(err_c, max_err(c_k, c_p))
            check(max_err(a_k, a_p) <= 1e-5, f"{label} actions ({what}) within atol 1e-5")
            check(costs_close(c_k, c_p), f"{label} costs ({what}) within atol 2e-4, rtol 1e-5")
            err_by_scenario(f"{label} costs ({what})", c_k, c_p)
        say(f"  {label} max |actions - plain| = {err_a:.3e}, max |costs - plain| = {err_c:.3e}")
        # B=1 against the single-scenario kernel, the same seed and draw
        c1, a1 = k7(*one, a_means[:1], fac[:1], pb1, 7, N, draws=draws[:1])
        cs, a_s = single_k(*single, a_means[0], fac[0], p0, 7, N, draw=draws[0])
        say(f"  {label} at B=1 against {'K1' if joint else 'K5'}: actions equal "
            f"{torch.equal(a1[0], a_s)}, max |costs| diff {max_err(c1[0], cs):.3e}")
        check(torch.equal(a1[0], a_s) and max_err(c1[0], cs) <= 2e-6,
              f"{label} at B=1: the single-scenario kernel's draws, costs within 2e-6")
        # scenario 2's in-kernel draws do not depend on the scenario count
        c16, a16 = k7(*kargs, 9, N, deterministic=True)
        _, a4 = k7(*four, a_means[:4], fac[:4], pb4, 9, N, deterministic=True)
        check(torch.equal(a4[2], a16[2]),
              f"{label}: scenario 2's in-kernel draws the same at B=4 and B={B}")
        check_offset(label, k7, args, pb, a_means, fac, a16, c16, B, dev)
        ms = time_ms(lambda: k7(*kargs, 7, N, draws=draws), 50)
        ms_p = time_ms(lambda: k7.plain(*kargs, 7, N, draws=draws), 5, warmup=1)
        records[name] = dict(max_abs_err=max(err_a, err_c), ms=ms, plain_ms=ms_p,
                             **(k1_bound if joint else k5_bound)(B, N, H))
        if joint:  # the correlate alone as one library product (a yardstick)
            say_geometry("K1 / K7 joint", rollout_cuda.joint_info(H=H))
            ms_mm = time_ms(lambda: torch.bmm(fac, z), 50)
            records[name]["correlate_library_ms"] = ms_mm
            say(f"  {label} correlate yardstick torch.bmm (B, D, D) x (B, D, N) "
                f"{ms_mm:.4f} ms (allow_tf32={torch.backends.cuda.matmul.allow_tf32})")
        else:
            say_sample_geometry()
        mean = a_means.reshape(B, -1).contiguous()
        a_out = torch.empty(B, D, N, device=dev)
        kern = (rollout_cuda.JOINT_BATCHED_KERNEL if joint
                else rollout_cuda.SAMPLE_BATCHED_KERNEL)
        ms_k = bare_launch_ms(kern, *ptrs, mean.data_ptr(), fac.data_ptr(), None, seed_ptr(7),
                              None, costs.data_ptr(), a_out.data_ptr(), B, N, H,
                              k7._check_rollover, k7.mode, k7.reward, k7.block)
        say(f"  {label} {ms:.4f} ms, plain {ms_p:.4f} ms, kernel alone {ms_k:.4f} ms")


def check_offset(label, k7, args, pb, a_means, fac, a_all, c_all, B, dev):
    """K7's episode offset (a 0-d int32 device word): the upper half of the
    scenarios launched from offset B/2 draws what they draw in the launch
    from 0 (``a_all``, ``c_all``), bit for bit; the offset launch's costs
    against the plain rollout of its actions (atol 2e-4, rtol 1e-5); and
    the plain version's own offset property, bit for bit."""
    from covo_mpc_tpu_torch.ops.rollout import make_rollout_batched

    o = B // 2
    upper, pbu = sub_batch(args, pb, list(range(o, B)))
    word = torch.full((), o, dtype=torch.int32, device=dev)
    c_o, a_o = k7(*upper, a_means[o:], fac[o:], pbu, 9, N, deterministic=True, offset=word)
    check(torch.equal(a_o, a_all[o:]) and torch.equal(c_o, c_all[o:]),
          f"{label}: scenarios {o}..{B - 1} from offset {o} (a device word) draw what "
          "they draw from offset 0, actions and costs bit for bit")
    c_p = make_rollout_batched(k7.env)(*upper, a_o, pbu, None, True, 1.0, layout="hdn")
    say(f"  {label} from offset {o}: max |costs - plain rollout of its actions| "
        f"{max_err(c_o, c_p):.3e}")
    check(costs_close(c_o, c_p), f"{label} from offset {o}: costs within atol 2e-4, rtol "
          "1e-5 of the plain rollout of its actions")
    _, ap_all = k7.plain(*args, a_means, fac, pb, 9, N, deterministic=True)
    _, ap_o = k7.plain(*upper, a_means[o:], fac[o:], pbu, 9, N, deterministic=True, offset=o)
    check(torch.equal(ap_o, ap_all[o:]),
          f"{label} plain version: from offset {o} it draws what it draws from 0")


def phase_scenario_solves(env, dev, kernel_list):
    from covo_mpc_tpu_torch.ops import rollout_cuda

    B = SCEN_B
    phase(f"phase 5b: one full-width batched solve per rng (B={B}), engine='cuda' "
        "against engine='torch' on the same normals")
    args, pb, _, _ = scenario_batch(env, B, seed=22)
    a_means, a_covs = initial_means(env, B)
    g = np.random.default_rng(6)

    def cuda(x):
        return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(dev)

    for kind, z, extra in (
            ("covo", cuda(g.standard_normal((B, N, D))), ()),
            ("mppi", cuda(g.standard_normal((B, N, H, 4))), (a_covs,))):
        kw = dict(z=z)
        if kind == "mppi":  # γ_σ > 0: the covariance update is checked too
            kw.update(draws=cuda(g.standard_normal((B, 3))), gamma_sigma=0.5)
        out = {}
        for engine, rng_mode, used in (
                ("cuda", "kernel", rollout_cuda.JOINT_BATCHED_KERNEL if kind == "covo"
                 else rollout_cuda.SAMPLE_BATCHED_KERNEL),
                ("cuda", "fast", rollout_cuda.ROLLOUT_BATCHED_KERNEL),
                ("torch", "fast", None)):
            solve = make_batched(env, kind, engine, rng_mode)
            out[engine, rng_mode], counts = run_once(
                lambda: solve(*args, a_means, *extra, pb, **kw), kernel_list)
            if used is not None:
                launched = {k: v for k, v in counts.items() if v}
                say(f"  {kind} cuda ({rng_mode}): launches {launched}")
                check(counts[used.symbol] > 0, f"{used.symbol} launched by the solve")
        ref = out["torch", "fast"]
        for rng_mode in ("kernel", "fast"):
            got = out["cuda", rng_mode]
            errs = {"action": max_err(got[0][:, 0], ref[0][:, 0]),
                    "a_mean": max_err(got[0], ref[0])}
            if kind == "mppi":
                errs["a_cov"] = max_err(got[1], ref[1])
            say(f"  batched {kind} ({rng_mode}) max |cuda - torch|: {errs}, "
                f"min cost {max_err(got[-1], ref[-1]):.3e}")
            check(all(v <= 2e-4 for v in errs.values()),
                  f"batched {kind} ({rng_mode}): action, a_mean"
                  f"{' and a_cov' if kind == 'mppi' else ''} within 2e-4 "
                  "(no host sync in either solve)")
            check(costs_close(got[-1], ref[-1]),
                  "min costs within atol 2e-4, rtol 1e-5")
            check(all(bool(torch.isfinite(x).all()) for x in got),
                  "batched solve outputs finite")


def batched_closed_loop(env, solve, kind: str, kernel_list):
    """SCEN_LOOP_B scenarios of the main path's env (default params), reset
    from one generator seeded 1, SCEN_LOOP_STEPS steps: each step one
    batched solve on the noisy states, then each scenario's auto-resetting
    env step; the solve captured as one CUDA graph (its replays equal its
    eager solves bit for bit, phase 5d). Launch counters at 0 just before;
    returns the mean err_pos [m] and the counts just after."""
    from covo_mpc_tpu_torch.runtime import graphs

    B = SCEN_LOOP_B
    _, pb, states, infos = scenario_batch(env, B, seed=1, randomize=False)
    p = env.default_params
    gen = torch.Generator(env.device).manual_seed(2)
    a_means, a_covs = initial_means(env, B)
    carry = (a_means,) if kind == "covo" else (a_means, a_covs)
    cap = graphs.capture_solver(solve, solve, *solve_args(infos), *carry, pb)
    solve.seed(1)
    for k in kernel_list:
        k.launches = 0
    t0 = time.perf_counter()
    errs = []
    for _ in range(SCEN_LOOP_STEPS):
        carry = cap(*solve_args(infos), *carry, pb)[:len(carry)]
        a_means = carry[0]
        row = []
        for b in range(B):
            _, states[b], _, _, infos[b] = env.step(gen, states[b], a_means[b, 0], p)
            row.append(infos[b]["err_pos"])
        errs.append(torch.stack(row))
    err = torch.stack(errs).mean(dim=0).cpu()
    wall = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in kernel_list}
    say(f"  err_pos {100 * float(err.mean()):.2f} cm over {B} scenarios x "
        f"{SCEN_LOOP_STEPS} steps ({wall:.1f} s); per scenario [cm]: "
        f"{[round(100 * float(e), 3) for e in err]}")
    say(f"  launches in the loop: { {k: v for k, v in launches.items() if v} }")
    return float(err.mean()), launches


def phase_scenario_loops(env, kernel_list):
    """5c: the batched closed loops; returns each batched kernel's launch
    count from the loop that runs it."""
    phase(f"phase 5c: batched closed loops, B={SCEN_LOOP_B} scenarios from seed 1, "
        f"{SCEN_LOOP_STEPS} steps, engine='cuda'")
    say("  CoVO (kernel rng: K7 joint)")
    covo, launches = batched_closed_loop(env, make_batched(env, "covo", "cuda"),
                                         "covo", kernel_list)
    out = {"joint_sample_rollout_batched": launches["joint_sample_rollout_batched"]}
    check(np.isfinite(covo) and covo * 100 < ERR_POS_LIMIT_CM,
          f"batched CoVO err_pos finite and below {ERR_POS_LIMIT_CM} cm")
    say("  MPPI (kernel rng: K7 per-step)")
    mppi, launches = batched_closed_loop(env, make_batched(env, "mppi", "cuda"),
                                         "mppi", kernel_list)
    out["sample_rollout_batched"] = launches["sample_rollout_batched"]
    check(np.isfinite(mppi) and mppi * 100 < MPPI_ERR_POS_LIMIT_CM,
          f"batched MPPI err_pos finite and below {MPPI_ERR_POS_LIMIT_CM} cm")
    check(mppi > covo, "batched MPPI err_pos above batched CoVO's")
    say("  MPPI (fast rng: torch draw + K6)")
    fast, launches = batched_closed_loop(
        env, make_batched(env, "mppi", "cuda", "fast"), "mppi", kernel_list)
    out["rollout_costs_batched"] = launches["rollout_costs_batched"]
    check(np.isfinite(fast) and fast * 100 < MPPI_ERR_POS_LIMIT_CM,
          f"batched MPPI (fast) err_pos finite and below {MPPI_ERR_POS_LIMIT_CM} cm")
    check(all(v > 0 for v in out.values()),
          f"every batched kernel launched by its loop: {out}")
    return out


def capture_batched(env, kind: str, B: int, args, carry0, pb):
    """One batched cuda solve (kernel rng) at B scenarios captured as a CUDA
    graph (``runtime/graphs.capture_solver``, its seed stream and generator
    registered) and its replays profiled (``graph_profile``: the device ms a
    replay from sessions that lost no node). Returns (the solve, the
    captured call, its row so far)."""
    from covo_mpc_tpu_torch.runtime import graphs

    solve = make_batched(env, kind, "cuda")
    t0 = time.perf_counter()
    cap = graphs.capture_solver(solve, solve, *args, *carry0, pb)
    capture_s = time.perf_counter() - t0
    nodes = graph_nodes(cap)
    # 1 session (3 before phase 11): phase 11 reads these graphs' device ms
    dev_ms, complete, seen = graph_profile(cap.replay, nodes, reps=2 if kind == "covo" else 10,
                                           sessions=1)
    return solve, cap, {"graph_nodes": nodes, "capture_s": capture_s, "device_ms": dev_ms,
                        "profile_sessions_complete": complete, "device_ops_recorded": seen}


def captured_batched_row(kind: str, B: int, solve, cap, args, carry0, pb, row) -> dict:
    """The captured batched solve of :func:`capture_batched` against its
    eager twin: 3 chained replays against 3 chained eager solves from the
    same seed, bit for bit; p50 / p99 of ``time_blocking`` and ms per solve
    of ``time_chained`` eager and captured; solves/s = B / the chained ms;
    the busy share, the profiled device ms a replay over the chained ms.
    Returns the row."""
    from covo_mpc_tpu_torch.runtime import profiling

    n = len(carry0)

    def call(f, carry):
        return f(*args, *carry, pb)

    chains = {}
    for name, f in (("eager", solve), ("captured", cap)):
        solve.seed(3)
        carry, chains[name] = carry0, []
        for _ in range(3):
            out = call(f, carry)
            chains[name].append(out)
            carry = out[:n]
    check(all(torch.equal(x, y) for e, r in zip(chains["eager"], chains["captured"])
              for x, y in zip(e, r)),
          f"batched {kind} B={B}: 3 chained replays equal 3 chained eager solves bit for bit")
    slow = kind == "covo"
    blocking = {"eager": profiling.time_blocking(lambda: call(solve, carry0),
                                                 5 if slow else 20, 1),
                "captured": profiling.time_blocking(lambda: call(cap, carry0), 20 if slow
                                                    else 60, 2)}
    chained = {"eager": profiling.time_chained(lambda c: call(solve, c)[:n], carry0,
                                               iters=2 if slow else 4, k=4 if slow else 8),
               "captured": profiling.time_chained(lambda c: call(cap, c)[:n], carry0,
                                                  iters=4, k=8)}
    for k in ("eager", "captured"):
        row[f"{k}_p50_ms"] = blocking[k]["p50"] * 1e3
        row[f"{k}_p99_ms"] = blocking[k]["p99"] * 1e3
        row[f"{k}_chained_ms"] = chained[k]["p50"] * 1e3
        row[f"{k}_solves_per_s"] = B * 1e3 / row[f"{k}_chained_ms"]
    dev_ms = row["device_ms"]
    row["busy"] = None if dev_ms is None else dev_ms / row["captured_chained_ms"]
    busy = "not measured" if row["busy"] is None else f"{100 * row['busy']:.2f}%"
    say(f"  B={B:3d} {kind} captured ({row['graph_nodes']} graph nodes, captured in "
        f"{row['capture_s']:.2f} s): p50 / p99 {row['captured_p50_ms']:.4f} / "
        f"{row['captured_p99_ms']:.4f} ms, chained {row['captured_chained_ms']:.4f} ms, "
        f"{row['captured_solves_per_s']:.1f} solves/s; eager p50 / p99 "
        f"{row['eager_p50_ms']:.4f} / {row['eager_p99_ms']:.4f} ms, chained "
        f"{row['eager_chained_ms']:.4f} ms, {row['eager_solves_per_s']:.1f} solves/s; device "
        f"{fmt_ms(dev_ms)} a replay ({row['profile_sessions_complete']} sessions complete, "
        f"device ops recorded {row['device_ops_recorded']}), busy {busy}")
    return row


def phase_scenario_timing(env, dev):
    """5d: aggregate solves/s = B / (median events ms per batched solve) at
    each B, both solvers, engines in turns torch, cuda, cuda, torch (cuda
    with kernel rng); beside them, the same cuda solve captured as a CUDA
    graph (``captured_batched_row``: replays against eager solves bit for
    bit, p50 / p99 and chained ms eager and captured, solves/s, graph nodes,
    device ms and busy share of a replay); then the device kernels and
    copies one batched cuda solve enqueues at B=16 and B=64, which must not
    grow with B."""
    phase(f"phase 5d: aggregate solves/s at B = {SCEN_TIMING_B} (events; cuda "
        "engine with kernel rng), eager and captured")
    # every case captured and its replays profiled first, as phase 2c does
    # (profiler sessions late in a long process lose events)
    inputs, graphs_b = {}, {}
    for B in SCEN_TIMING_B:
        args, pb, _, _ = scenario_batch(env, B, seed=23)
        inputs[B] = (args, pb, *initial_means(env, B))
        for kind in ("covo", "mppi"):
            carry0 = inputs[B][2:3] if kind == "covo" else inputs[B][2:4]
            graphs_b[kind, B] = capture_batched(env, kind, B, args, carry0, pb)
    kernels_per_solve, captured = {}, {}
    for B in SCEN_TIMING_B:
        args, pb, a_means, a_covs = inputs[B]
        for kind in ("covo", "mppi"):
            extra = () if kind == "covo" else (a_covs,)
            times = {"cuda": [], "torch": []}
            for engine in ("torch", "cuda", "cuda", "torch"):
                solve = make_batched(env, kind, engine)
                events = []
                # 1 warm-up + 2 timed solves per turn (2 + 5 through PR 3,
                # 1 + 3 through PR 5; cut to keep the whole run inside
                # about 800 s)
                for i in range(1 + 2):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    solve(*args, a_means, *extra, pb)
                    e1.record()
                    if i >= 1:
                        events.append((e0, e1))
                torch.cuda.synchronize()
                times[engine] += [a.elapsed_time(b) for a, b in events]
            med = {k: float(np.median(v)) for k, v in times.items()}
            say(f"  B={B:3d} {kind}: " + ", ".join(
                f"{e} {med[e]:.4f} ms per batch-step, {1e3 * B / med[e]:.1f} solves/s"
                for e in ("cuda", "torch")) + f" ({len(times['cuda'])} solves each)")
            solve, cap, row = graphs_b.pop((kind, B))
            captured[f"{kind} B={B}"] = captured_batched_row(
                kind, B, solve, cap, args, (a_means, *extra), pb, row)
            if B in (16, 64):
                solve = make_batched(env, kind, "cuda")
                # 1 session (3 before phase 11; each processes a whole batched
                # solve's events): the ops are counted exactly in every
                # session, and phase 11 reads the batched solves' device ms in
                # a process of its own
                prof = device_profile(lambda: solve(*args, a_means, *extra, pb), sessions=1)
                kernels_per_solve[kind, B] = prof["ops"]
                say(f"  B={B:3d} {kind} cuda: {prof['ops']} device kernels and copies per "
                    f"batched solve; device {fmt_ms(prof['ms'])} ({prof['complete']} "
                    "sessions complete)")
    for kind in ("covo", "mppi"):
        check(kernels_per_solve[kind, 16] == kernels_per_solve[kind, 64],
              f"batched {kind}: device kernels and copies per solve the same at "
              "B=16 and B=64")
    say("batched captured summary: " + json.dumps(captured))


def profile_batched(env, dev):
    """Where one batched cuda-engine solve's time goes (kernel rng, B=SCEN_B):
    each layer alone on the inputs the solve gives it; CUDA-event ms, the
    device kernels and copies it enqueues and, from the complete profiler
    sessions, its device ms (and its kernel's)."""
    from covo_mpc_tpu_torch.ops import covariance, reductions, rollout_cuda
    from covo_mpc_tpu_torch.ops.hessian import make_hessian_batched

    B = SCEN_B
    phase(f"profile: layers of one batched cuda-engine solve (B={B}, N={N}, H={H}, "
        "kernel rng)")
    args, pb, _, _ = scenario_batch(env, B, seed=24)
    a_means, a_covs = initial_means(env, B)
    m = torch.cat([a_means[:, 1:], a_means[:, -1:]], dim=1)
    hess = make_hessian_batched(env, H)
    R = hess(m.reshape(B, D), *args, pb)
    _, factors = covariance.optimize_sigma_ns(R, 0.5, D)
    k7j = rollout_cuda.make_rollout_batched_sampling(env, joint=True)
    costs, a_t = k7j(*args, m, factors, pb, 11, N, deterministic=True)
    chols = torch.linalg.cholesky_ex(a_covs).L.contiguous()
    draws = torch.randn(B, 3, generator=torch.Generator(dev).manual_seed(25), device=dev)
    k7p = rollout_cuda.make_rollout_batched_sampling(env, joint=False)
    covo, mppi = make_batched(env, "covo", "cuda"), make_batched(env, "mppi", "cuda")
    layers = {
        "CoVO: Hessian (vmap, adjoint)": (lambda: hess(m.reshape(B, D), *args, pb), ""),
        "CoVO: NS designer": (lambda: covariance.optimize_sigma_ns(R, 0.5, D), ""),
        "CoVO: K7 joint": (lambda: k7j(*args, m, factors, pb, 11, N, deterministic=True),
                           "joint_sample_rollout_kernel"),
        "CoVO: weights + mean update": (lambda: reductions.mean_update_t(
            reductions.mppi_weights(costs, 0.01), a_t.reshape(B, H, 4, N), m, 1.0), ""),
        "CoVO: whole solve": (lambda: covo(*args, a_means, pb), ""),
        "MPPI: K7 per-step": (lambda: k7p(*args, m, chols, pb, 11, N, draws=draws),
                              "sample_rollout_"),  # the tile or step kernel
        "MPPI: whole solve": (lambda: mppi(*args, a_means, a_covs, pb), ""),
    }
    for name, (fn, kernel) in layers.items():
        ev = time_ms(fn, 5, warmup=1)
        # one session a layer: a session of an eager batched CoVO layer
        # (~5,000 device ops) costs ~8 s on the H100 host
        prof = device_profile(fn, sessions=1, name=kernel)
        line = (f"  {name:30s} events {ev:9.4f} ms, {prof['ops']:5d} device kernels and "
                f"copies; device {fmt_ms(prof['ms'])}")
        if kernel:
            line += f", of it the kernel {fmt_ms(prof['kernel_ms'])}"
        say(line + f" ({prof['complete']} sessions complete)")

# --- phase 5e: the batched protocol (evaluate_batched, run_supervised_batched) ---

PROTOCOL_EPS = 16  # one batch of episodes (SCEN_B), 300 steps each
PROTOCOL_CHUNK = 8  # run_supervised_batched's chunk of episodes
EAGER_CHECK_B, EAGER_CHECK_STEPS = 4, 30  # captured against eager batched episodes


def protocol_run(env, label, solver, kernel_list):
    """``evaluate_batched(env, solver, num_eps=PROTOCOL_EPS, seed=1)`` with
    every launch counter at 0 just before it: (the result, the counts just
    after, wall s)."""
    from covo_mpc_tpu_torch.runtime import evaluate_batched

    for k in kernel_list:
        k.launches = 0
    t0 = time.perf_counter()
    res = evaluate_batched(env, solver, num_eps=PROTOCOL_EPS, seed=1)
    wall = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in kernel_list}
    say(f"  {label}: {res.summary()} ({PROTOCOL_EPS} episodes at once, {wall:.1f} s); per "
        f"episode [cm]: {[round(100 * float(e), 3) for e in res.err_pos_ep]}")
    say(f"  launches: { {k: v for k, v in launches.items() if v} }")
    return res, launches, wall


def phase_batched_protocol(env, kernel_list, refs: dict):
    """5e: the batched protocol on the main path's env at N=8192, H=32, one
    batch of PROTOCOL_EPS captured episodes of 300 steps (the batched
    runner: one CUDA graph a batched control step): ``evaluate_batched`` for
    CoVO online (kernel rng: K7 joint), MPPI kernel rng (K7 per-step), MPPI
    fast rng (K6) and PID, each finite and under its limit, CoVO below MPPI
    on the same episodes, each batched kernel launched by its run; the
    captured batched episodes against the eager ones (debug mode) bit for
    bit at B=EAGER_CHECK_B; then ``run_supervised_batched`` (MPPI kernel
    rng, chunks of PROTOCOL_CHUNK) crashed at chunk 1 and resumed, equal bit
    for bit to an uninterrupted supervised run. Returns each batched
    kernel's launch count from the run that drives it; puts the MPPI row in
    ``refs`` (phase 13 holds its twins against it)."""
    import tempfile

    from covo_mpc_tpu_torch.ops import rollout_cuda
    from covo_mpc_tpu_torch.runtime import debug, make_batched_episode_runner
    from covo_mpc_tpu_torch.runtime import run_supervised_batched
    from covo_mpc_tpu_torch.solvers import get_solver

    t_phase = time.perf_counter()
    phase(f"phase 5e: the batched protocol, evaluate_batched(num_eps={PROTOCOL_EPS}, "
          f"seed=1), N={N}, H={H}, captured")
    runs = {
        "covo": ("CoVO online (gn, ns, kernel rng: K7 joint)", make_solver(env, "cuda")[0],
                 rollout_cuda.JOINT_BATCHED_KERNEL, ERR_POS_LIMIT_CM),
        "mppi": ("MPPI (kernel rng: K7 per-step)", make_mppi(env, "cuda")[0],
                 rollout_cuda.SAMPLE_BATCHED_KERNEL, MPPI_ERR_POS_LIMIT_CM),
        "mppi_fast": ("MPPI (fast rng: torch normals + K6)",
                      make_mppi(env, "cuda", rng_mode="fast")[0],
                      rollout_cuda.ROLLOUT_BATCHED_KERNEL, MPPI_ERR_POS_LIMIT_CM),
        "pid": ("PID", get_solver(env, "pid")[0], None, PID_ERR_POS_LIMIT_CM),
    }
    results, out, walls = {}, {}, {}
    for key, (label, solver, kernel, limit) in runs.items():
        res, launches, walls[key] = protocol_run(env, label, solver, kernel_list)
        results[key] = res
        check(bool(torch.isfinite(res.err_pos_ep).all()) and res.mean * 100 < limit,
              f"batched protocol, {label}: err_pos finite and below {limit} cm")
        if kernel is not None:
            out[kernel.symbol] = launches[kernel.symbol]
            check(out[kernel.symbol] > 0, f"{kernel.symbol} launched by the {label} run")
    check(results["covo"].mean < results["mppi"].mean,
          "batched protocol: CoVO's err_pos below MPPI's on the same episodes")
    refs["5e mppi"] = results["mppi"]
    # the batched control step's graph: the solve, the vmapped env step and
    # each episode's draws from its own generators (one capture, 1 step)
    for key, (label, solver, _, _) in runs.items():
        run = make_batched_episode_runner(env, solver, steps=1)
        run(1, 0, PROTOCOL_EPS)
        say(f"  {label}: the batched control step at B={PROTOCOL_EPS} is "
            f"{graph_nodes(run.captured[PROTOCOL_EPS])} graph nodes")
    say("  captured batched episodes against eager ones (debug mode), "
        f"B={EAGER_CHECK_B}, {EAGER_CHECK_STEPS} steps")
    for key in ("covo", "mppi"):
        run = make_batched_episode_runner(env, runs[key][1], steps=EAGER_CHECK_STEPS)
        err_c, done_c = run(1, 0, EAGER_CHECK_B)
        with debug.debug_mode(nans=False):
            err_e, done_e = run(1, 0, EAGER_CHECK_B)
        check(torch.equal(err_c, err_e) and torch.equal(done_c, done_e),
              f"{runs[key][0]}: captured batched episodes equal eager ones bit for bit")
    say(f"  run_supervised_batched, {runs['mppi'][0]}, chunks of {PROTOCOL_CHUNK}")
    mppi = runs["mppi"][1]
    kw = dict(num_eps=PROTOCOL_EPS, seed=1, chunk_episodes=PROTOCOL_CHUNK)
    ref = run_supervised_batched(env, mppi, **kw)
    say(f"  uninterrupted: {ref.summary()}; max |supervised - evaluate_batched| per "
        f"episode {max_err(ref.err_pos_ep.float(), results['mppi'].err_pos_ep):.3e}")

    def fault(chunk, attempt):
        if chunk == 1:
            raise RuntimeError("injected fault at chunk 1")

    with tempfile.TemporaryDirectory() as ckpt:
        try:
            run_supervised_batched(env, mppi, checkpoint_dir=ckpt, max_retries=0,
                                   _fault_hook=fault, **kw)
            raise AssertionError("the injected fault did not stop the run")
        except RuntimeError as e:
            check("re-run the same command" in str(e),
                  "the fault at chunk 1 stopped the run after its checkpoint")
        sup = run_supervised_batched(env, mppi, checkpoint_dir=ckpt, **kw)
    check(sup.resumed_at_chunk == 1 and torch.equal(sup.err_pos_ep, ref.err_pos_ep),
          "the resumed run started at chunk 1 and equals the uninterrupted one bit for bit")
    wall = time.perf_counter() - t_phase
    say(f"  phase 5e wall {wall:.1f} s; evaluate_batched runs {walls}")
    say("batched protocol summary: " + json.dumps({
        key: {"mean_cm": 100 * r.mean, "std_cm": 100 * r.std,
              "per_episode_cm": [100 * float(e) for e in r.err_pos_ep], "wall_s": walls[key]}
        for key, r in results.items()}))
    return out


# --- phase 6: the fused Sigma-designer (K8) and the other CoVO modes ---------


def synthetic_R(scale: float, dev) -> torch.Tensor:
    """The JAX kernel test's R = A A^T / D * scale - 0.3 * scale * I (numpy
    seed 0)."""
    A = np.random.default_rng(0).standard_normal((D, D))
    R = (A @ A.T / D) * scale - 0.3 * scale * np.eye(D)
    return torch.from_numpy(R.astype(np.float32)).to(dev)


def phase_sigma_kernel(env, dev, records):
    """6a: K8 against the plain designer on three R, and its times."""
    from covo_mpc_tpu_torch.ops import covariance, covariance_cuda

    phase(f"phase 6a: K8 (fused NS Sigma-designer, D={D}) against the plain designer")
    p = env.default_params
    _, info, _ = env.reset(torch.Generator(dev).manual_seed(3), p)
    solver, cp = make_solver(env, "cuda")
    nominal = torch.cat([cp.a_mean[1:], cp.a_mean[-1:]])
    sources = {"gn Hessian of a reset state": solver.get_hessian(info["noisy_state"], p,
                                                                 nominal),
               "synthetic R, scale 1": synthetic_R(1.0, dev),
               "synthetic R, scale 100": synthetic_R(100.0, dev)}
    err = 0.0
    for what, R in sources.items():
        c_k, f_k = covariance_cuda.optimize_sigma_ns_cuda(R, 0.5, D)
        c_p, f_p = covariance.optimize_sigma_ns(R, 0.5, D)
        rel_c, rel_f = rel_fro(c_k, c_p), rel_fro(f_k, f_p)
        abs_c, ffT = max_err(c_k, c_p), max_err(f_k @ f_k.T, c_k)
        say(f"  {what}: relative Frobenius a_cov {rel_c:.3e}, factor {rel_f:.3e}; "
            f"max |a_cov - plain| {abs_c:.3e}; max |F F^T - a_cov| {ffT:.3e}")
        check(rel_c <= 1e-3 and rel_f <= 1e-3 and ffT <= 2e-4
              and torch.equal(f_k, torch.tril(f_k)),
              f"K8 ({what}): a_cov and factor within 1e-3 (relative), a lower "
              "factor with F F^T within 2e-4 of a_cov")
        if "scale 100" not in what:
            # at scale 100 the shifted spectrum's floor (an absolute 1e-2
            # under lambda_min = -30) moves with each ulp of lambda_min
            check(abs_c <= 2e-4, f"K8 ({what}): a_cov within 2e-4")
            err = max(err, abs_c)
    R = sources["gn Hessian of a reset state"]
    first = covariance_cuda.optimize_sigma_ns_cuda(R, 0.5, D)
    again = covariance_cuda.optimize_sigma_ns_cuda(R, 0.5, D)
    check(all(torch.equal(x, y) for x, y in zip(first, again)),
          "K8 (gn Hessian): two launches give bit-identical a_cov and factor")
    info = covariance_cuda.kernel_info()
    say(f"  K8 launch: one cluster of {info['cluster']} CTAs x {info['threads']} threads; "
        f"shared memory per CTA {info['dynamic_smem']} B dynamic + "
        f"{info['static_smem']} B static; {info['registers']} registers, "
        f"{info['local_bytes']} B local memory per thread")
    a_cov, factor = torch.empty(D, D, device=dev), torch.empty(D, D, device=dev)
    ms_bare = bare_launch_ms(
        covariance_cuda.SIGMA_KERNEL, R.data_ptr(), a_cov.data_ptr(), factor.data_ptr(),
        D, 0.5, covariance._LIFT_A, covariance._LIFT_B,
        covariance._LIFT_C, 14, 3, 4, 8, 5, reps=20)
    ms = time_ms(lambda: covariance_cuda.optimize_sigma_ns_cuda(R, 0.5, D), 20)
    ms_p = time_ms(lambda: covariance.optimize_sigma_ns(R, 0.5, D), 20)
    rec = dict(max_abs_err=err, ms=ms, plain_ms=ms_p, **k8_bound(D))
    records["sigma_ns"] = rec
    say(f"  K8 alone {ms_bare:.4f} ms, wrapper {ms:.4f} ms, plain {ms_p:.4f} ms; "
        f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}): "
        f"{100 * rec['bound_ms'] / ms_bare:.2f}% of it")


def phase_sigma_solves(env, dev, kernel_list):
    """6b and 6c: full-width online and speculative solves with
    ``sigma_mode="ns_pallas"``, engine="cuda" (K8) against engine="torch"
    on the same normals; then act() and prepare() timed alone."""
    from covo_mpc_tpu_torch.ops import covariance_cuda, rollout_cuda

    phase("phase 6b: one full-width online solve, sigma_mode='ns_pallas', "
          "engine='cuda' (K8) against engine='torch'")
    p = env.default_params
    obs, info, state = env.reset(torch.Generator(dev).manual_seed(5), p)
    z = torch.from_numpy(
        np.random.default_rng(7).standard_normal((N, D)).astype(np.float32)).to(dev)
    used = [covariance_cuda.SIGMA_KERNEL.symbol, rollout_cuda.JOINT_KERNEL.symbol,
            "primal", "sens_chain"]
    for name in ("covo_online", "covo_speculative"):
        out = {}
        for engine in ("cuda", "torch"):
            solver, cp = make_solver(env, engine, name=name, sigma_mode="ns_pallas")
            cp = solver.reset(state, p, cp)
            out[engine], counts = run_once(
                lambda: solver(obs, state, p, cp, info, z=z), kernel_list)
            if engine == "cuda":
                say(f"  {name} launch counters after the cuda solve: "
                    f"{ {k: v for k, v in counts.items() if v} }")
                check(all(counts[k] > 0 for k in used),
                      f"{', '.join(used)} each launched by the {name} solve")
        a_c, cp_c, _ = out["cuda"]
        a_t, cp_t, _ = out["torch"]
        names = ("a_mean", "a_cov") + (("a_factor",) if name == "covo_speculative" else ())
        errs = {"action": max_err(a_c, a_t),
                **{k: max_err(getattr(cp_c, k), getattr(cp_t, k)) for k in names}}
        say(f"  {name} max |cuda - torch|: {errs}")
        check(all(v <= 2e-4 for v in errs.values()),
              f"{name}: action and {', '.join(names)} within 2e-4 (no host sync)")
        check(all(bool(torch.isfinite(x).all()) for x in (a_c, cp_c.a_mean, cp_c.a_cov)),
              "solve outputs finite")
        if name == "covo_online":
            phase("phase 6c: speculative act() + prepare(), the same way")

    solver, cp = make_solver(env, "cuda", name="covo_speculative", sigma_mode="ns_pallas")
    cp = solver.reset(state, p, cp)
    _, cp_next, _ = solver.act(obs, state, p, cp, info)
    ms_act = time_ms(lambda: solver.act(obs, state, p, cp, info), 50)
    ms_prep = time_ms(lambda: solver.prepare(state, p, cp_next, info), 20)
    walls = []
    for _ in range(50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a, _, _ = solver.act(obs, state, p, cp, info)
        a.cpu()
        walls.append((time.perf_counter() - t0) * 1e3)
    say(f"  act() {ms_act:.4f} ms per call (events, 50 back to back), "
        f"obs->action {float(np.median(walls)):.4f} ms median wall with the "
        f"action on the host (50 calls); prepare() {ms_prep:.4f} ms (events, 20)")


def phase_mode_loops(env, total_steps, kernel_list, covo_kernels):
    """6d: the closed loops (captured) of the speculative CoVO mode, the
    offline mode and PID at ``total_steps``, and one episode of random
    actions; returns K8's launch count from the speculative loop."""
    from covo_mpc_tpu_torch.ops import covariance_cuda
    from covo_mpc_tpu_torch.solvers import get_solver

    phase(f"phase 6d: closed loops, evaluate(total_steps={total_steps}, seed=1): "
          "covo_speculative (ns_pallas, kernel rng)")
    solver, _ = make_solver(env, "cuda", name="covo_speculative", sigma_mode="ns_pallas")
    spec, launches = closed_loop(env, solver, total_steps, kernel_list)
    k8 = launches[covariance_cuda.SIGMA_KERNEL.symbol]
    check(k8 > 0 and all(launches[k.symbol] > 0 for k in covo_kernels),
          "sigma_ns and every kernel of the CoVO path launched by the speculative loop")
    check(np.isfinite(spec.mean) and spec.mean * 100 < ERR_POS_LIMIT_CM,
          f"speculative err_pos finite and below {ERR_POS_LIMIT_CM} cm")
    phase(f"  covo_offline (kernel rng), evaluate(total_steps={total_steps}, seed=1)")
    solver, _ = make_solver(env, "cuda", name="covo_offline")
    off, _ = closed_loop(env, solver, total_steps, kernel_list)
    check(np.isfinite(off.mean) and off.mean * 100 < ERR_POS_LIMIT_CM,
          f"offline err_pos finite and below {ERR_POS_LIMIT_CM} cm")
    phase("  pid")
    pid, _ = closed_loop(env, get_solver(env, "pid")[0], total_steps, kernel_list)
    check(np.isfinite(pid.mean) and pid.mean * 100 < PID_ERR_POS_LIMIT_CM,
          f"pid err_pos finite and below {PID_ERR_POS_LIMIT_CM} cm")
    check(pid.mean > max(spec.mean, off.mean),
          "pid err_pos above both CoVO modes' on the same reset trajectories")
    phase("  random (one episode)")
    rnd, _ = closed_loop(env, get_solver(env, "random", rng_mode="fast")[0],
                         env.default_params.max_steps_in_episode, kernel_list)
    check(np.isfinite(rnd.mean), "random err_pos finite")
    return {covariance_cuda.SIGMA_KERNEL.symbol: k8}


# --- phase 7: the disturbance modes (table, drag, mixed) --------------------

DISTURB_T0 = 47  # a redraw (t % disturb_period == 0) falls inside the horizon
F0 = (0.02, -0.01, 0.015)  # a start force
MODE_OF = {"gaussian": "shared", "periodic": "table", "sin": "table",
           "drag": "drag", "mixed": "mixed"}


def disturb_env(kind: str, randomize: bool = False):
    """The main path's env under the disturbance ``kind``."""
    from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv

    return QuadEnv(EnvConfig(**{**ENV_KW, "disturb_type": kind,
                                "enable_randomizer": randomize}))


def to_dev(x, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(dev)


def mode_inputs(env, dev, seed: int):
    """Params with non-zero disturb_params (the wind and the sinusoid, from a
    numpy seed), a noisy reset state moved to DISTURB_T0 with the start
    force F0, and the model's rollout draw (None for sin and drag)."""
    rng = np.random.default_rng(seed)
    p = env.default_params.replace(disturb_params=to_dev(rng.uniform(-1, 1, 6), dev))
    _, info, _ = env.reset(torch.Generator(dev).manual_seed(seed), p)
    st = info["noisy_state"].replace(
        time=torch.tensor(DISTURB_T0, dtype=torch.int32, device=dev),
        f_disturb=torch.tensor(F0, device=dev))
    return p, st, env.draw_disturb(torch.Generator(dev).manual_seed(seed + 1))


def mode_record(records, name: str, mode: str, **values) -> None:
    """Keep a kernel's numbers in one disturbance mode (the JSON record's
    ``modes``)."""
    records.setdefault(name, {}).setdefault("modes", {}).setdefault(mode, {}).update(values)


def mode_kernel_inputs(dev, seed: int, n: int = N, B: int = SCEN_B):
    """The operands K1, K4-K7 are checked and timed on, from a numpy seed: a
    mean and full factor with normals (K1), actions (K4), per-step means and
    Cholesky factors with normals (K5), the same at B scenarios (K6, K7), the
    output buffers of the bare launches, and the numpy generator after its
    draws (``rng``); n samples (N=8192 and B=SCEN_B by default)."""
    rng = np.random.default_rng(seed)
    cuda = lambda x: to_dev(x, dev)  # noqa: E731
    a_mean, factor = cuda(rng.normal(size=(H, 4)) * 0.2), cuda(rng.normal(size=(D, D)) * 0.1)
    z1 = cuda(rng.standard_normal((D, n)))
    acts = cuda(rng.normal(size=(H, 4, n)) * 0.5)
    A = rng.normal(size=(H, 4, 4)) * 0.2
    chol = cuda(np.linalg.cholesky(A @ A.transpose(0, 2, 1) + 0.05 * np.eye(4)))
    z5 = cuda(rng.standard_normal((H, 4, n)))
    acts_b = cuda(rng.normal(size=(B, H, 4, n)) * 0.5)
    means_b = cuda(rng.normal(size=(B, H, 4)) * 0.2)
    Ab = rng.normal(size=(B, H, 4, 4)) * 0.2
    chols_b = cuda(np.linalg.cholesky(Ab @ Ab.swapaxes(-1, -2) + 0.05 * np.eye(4)))
    factors_b = cuda(rng.normal(size=(B, D, D)) * 0.1)
    z7 = {False: cuda(rng.standard_normal((B, H, 4, n))),
          True: cuda(rng.standard_normal((B, D, n)))}
    return types.SimpleNamespace(
        a_mean=a_mean, factor=factor, z1=z1, acts=acts, chol=chol, z5=z5, acts_b=acts_b,
        means_b=means_b, chols_b=chols_b, factors_b=factors_b, z7=z7,
        costs=torch.empty(n, device=dev), a_out=torch.empty(D, n, device=dev),
        costs_b=torch.empty(B, n, device=dev), a_out_b=torch.empty(B, D, n, device=dev),
        rng=rng)


def mode_case(env, env_b, dev, seed: int, B: int = SCEN_B):
    """One scenario's rollout inputs on ``env`` (:func:`mode_inputs` from
    ``seed``) and B scenarios' on ``env_b`` (domain-randomized, reset from
    seed + 1, the start force F0, t0 = 47 .. 50, draws from seed + 2)."""
    from covo_mpc_tpu_torch.models import pack_state

    p, st, draw = mode_inputs(env, dev, seed)
    args, pb, _, _ = scenario_batch(env_b, B, seed=seed + 1)
    x0s = args[0].clone()
    x0s[:, 13:16] = torch.tensor(F0, device=dev)
    args = (x0s, DISTURB_T0 + torch.arange(B, device=dev, dtype=torch.int32) % 4, *args[2:])
    return types.SimpleNamespace(
        env=env, roll=(pack_state(st), st.time, st.pos_traj, st.vel_traj), p=p, draw=draw,
        env_b=env_b, args=args, pb=pb,
        draws=env_b.draw_disturb(torch.Generator(dev).manual_seed(seed + 2), B))


def check_rollout_kernels(label: str, inp, case) -> dict:
    """K1, K4, K5, K6 and K7 (per-step and joint) against their plain
    versions on ``inp``'s normals and ``case``'s inputs and draws (CoVO's
    rollouts deterministic, MPPI's stochastic): actions within 1e-5, costs
    within atol 2e-4, rtol 1e-5, at ``inp``'s sample count. Returns each
    kernel's max abs error."""
    from covo_mpc_tpu_torch.ops import rollout_cuda

    n = inp.costs.shape[0]
    env, roll, p, draw = case.env, case.roll, case.p, case.draw
    args, pb, draws = case.args, case.pb, case.draws
    errs = {}
    k1 = rollout_cuda.make_rollout_joint_sampling(env)
    kw1 = dict(deterministic=True, draw=draw, z=inp.z1)
    c_k, a_k = k1(*roll, inp.a_mean, inp.factor, p, 0, n, **kw1)
    c_p, a_p = k1.plain(*roll, inp.a_mean, inp.factor, p, 0, n, **kw1)
    check(max_err(a_k, a_p) <= 1e-5 and costs_close(c_k, c_p),
          f"K1 ({label}): actions within 1e-5, costs within atol 2e-4, rtol 1e-5")
    errs["joint_sample_rollout"] = max(max_err(a_k, a_p), max_err(c_k, c_p))
    k4 = rollout_cuda.make_rollout_costs(env)
    c_k, c_p = (f(*roll, inp.acts, p, draw, layout="hdn") for f in (k4, k4.plain))
    check(costs_close(c_k, c_p), f"K4 ({label}): costs within atol 2e-4, rtol 1e-5")
    errs["rollout_costs"] = max_err(c_k, c_p)
    k5 = rollout_cuda.make_rollout_sampling(env)
    c_k, a_k = k5(*roll, inp.a_mean, inp.chol, p, 0, n, draw=draw, z=inp.z5)
    c_p, a_p = k5.plain(*roll, inp.a_mean, inp.chol, p, 0, n, draw=draw, z=inp.z5)
    check(max_err(a_k, a_p) <= 1e-5 and costs_close(c_k, c_p),
          f"K5 ({label}): actions within 1e-5, costs within atol 2e-4, rtol 1e-5")
    errs["sample_rollout"] = max(max_err(a_k, a_p), max_err(c_k, c_p))
    k6 = rollout_cuda.make_rollout_batched_costs(case.env_b)
    c_k, c_p = (f(*args, inp.acts_b, pb, draws) for f in (k6, k6.plain))
    check(costs_close(c_k, c_p), f"K6 ({label}): costs within atol 2e-4, rtol 1e-5")
    errs["rollout_costs_batched"] = max_err(c_k, c_p)
    for joint, name, fac in ((False, "sample_rollout_batched", inp.chols_b),
                             (True, "joint_sample_rollout_batched", inp.factors_b)):
        k7 = rollout_cuda.make_rollout_batched_sampling(case.env_b, joint=joint)
        kw7 = dict(deterministic=joint, draws=draws, z=inp.z7[joint])
        c_k, a_k = k7(*args, inp.means_b, fac, pb, 0, n, **kw7)
        c_p, a_p = k7.plain(*args, inp.means_b, fac, pb, 0, n, **kw7)
        check(max_err(a_k, a_p) <= 1e-5 and costs_close(c_k, c_p),
              f"K7 {'joint' if joint else 'per-step'} ({label}): actions within "
              "1e-5, costs within atol 2e-4, rtol 1e-5")
        errs[name] = max(max_err(a_k, a_p), max_err(c_k, c_p))
    return errs


def kernels_alone(inp, case, mode: str, reward: str = "penyaw") -> dict:
    """Each rollout kernel alone in ``mode`` with ``reward``: bare launches
    (in-kernel draws, K5 without "krng", rollover off) on operands the
    wrappers' own packing made from ``case``, at ``inp``'s sample and
    scenario counts. Returns {name: (ms, bound)}."""
    from covo_mpc_tpu_torch.ops import rollout_cuda

    B, n = inp.costs_b.shape
    mi, ri = rollout_cuda.MODES[mode], rollout_cuda.REWARDS[reward]
    ops = rollout_cuda._launch_operands(case.env, *case.roll, case.p, case.draw, False, 1.0, H)
    ptrs = [t.data_ptr() for t in ops]
    ops_b = rollout_cuda._launch_operands(case.env_b, *case.args, case.pb, case.draws, False,
                                          1.0, H)
    ptrs_b = [t.data_ptr() for t in ops_b]
    mean = inp.a_mean.reshape(-1).contiguous()
    mean_b = inp.means_b.reshape(B, -1).contiguous()
    out, out_b = (inp.costs.data_ptr(), inp.a_out.data_ptr()), (inp.costs_b.data_ptr(),
                                                                 inp.a_out_b.data_ptr())
    return {
        "joint_sample_rollout": (bare_launch_ms(
            rollout_cuda.JOINT_KERNEL, *ptrs, mean.data_ptr(), inp.factor.data_ptr(), None,
            seed_ptr(7), *out, n, H, 0, mi, ri, rollout_cuda.JOINT_BLOCK),
            k1_bound(1, n, H, mode, reward)),
        "rollout_costs": (bare_launch_ms(
            rollout_cuda.ROLLOUT_KERNEL, *ptrs, inp.acts.data_ptr(), out[0], n, H,
            0, mi, ri, rollout_cuda.ROLLOUT_BLOCK), k4_bound(1, n, H, mode, reward)),
        "sample_rollout": (bare_launch_ms(
            rollout_cuda.SAMPLE_KERNEL, *ptrs, mean.data_ptr(), inp.chol.data_ptr(), None,
            seed_ptr(7), None, 0, None, *out, n, H, 0, mi, ri, rollout_cuda.SAMPLE_BLOCK),
            k5_bound(1, n, H, mode, reward)),
        "rollout_costs_batched": (bare_launch_ms(
            rollout_cuda.ROLLOUT_BATCHED_KERNEL, *ptrs_b, inp.acts_b.data_ptr(),
            out_b[0], B, n, H, 0, mi, ri, rollout_cuda.ROLLOUT_BLOCK),
            k4_bound(B, n, H, mode, reward)),
        "sample_rollout_batched": (bare_launch_ms(
            rollout_cuda.SAMPLE_BATCHED_KERNEL, *ptrs_b, mean_b.data_ptr(),
            inp.chols_b.data_ptr(), None, seed_ptr(7), None, *out_b, B, n, H, 0, mi, ri,
            rollout_cuda.SAMPLE_BLOCK), k5_bound(B, n, H, mode, reward)),
        "joint_sample_rollout_batched": (bare_launch_ms(
            rollout_cuda.JOINT_BATCHED_KERNEL, *ptrs_b, mean_b.data_ptr(),
            inp.factors_b.data_ptr(), None, seed_ptr(7), None, *out_b, B, n, H, 0, mi, ri,
            rollout_cuda.JOINT_BLOCK), k1_bound(B, n, H, mode, reward)),
    }


def phase_mode_kernels(dev, records):
    """7a: K1, K4, K5, K6 and K7 in each mode against their plain versions
    on given normals, at N=8192, H=32 (K6/K7 at B=SCEN_B), t0 = 47; each
    mode's kernel alone (bare launches); K3 at sd=16 on the drag Hessian's J
    and M; K2 on a periodic table."""
    from covo_mpc_tpu_torch.models import pack_state
    from covo_mpc_tpu_torch.ops import hessian_cuda, rollout_cuda
    from covo_mpc_tpu_torch.ops.hessian import (
        adjoint_curvature,
        build_hessian_aux_table,
        build_hessian_disturb_table,
        primal16,
    )
    from covo_mpc_tpu_torch.ops.rollout import target_window

    B = SCEN_B
    phase(f"phase 7a: K1, K4-K7 in the table (sin, periodic), drag and mixed modes "
          f"against their plain versions (N={N}, H={H}, B={B}, t0={DISTURB_T0}), "
          "and each mode's kernels alone")
    say_sample_geometry()
    inp = mode_kernel_inputs(dev, 71)
    rng = inp.rng  # K2 / K3's actions
    cuda = lambda x: to_dev(x, dev)  # noqa: E731
    for kind in ("gaussian", "periodic", "sin", "drag", "mixed"):
        mode = MODE_OF[kind]
        case = mode_case(disturb_env(kind), disturb_env(kind, randomize=True), dev, 72)
        if kind != "gaussian":  # the shared mode's checks are phases 1 and 5's
            errs = check_rollout_kernels(kind, inp, case)
            say(f"  {kind} ({mode} mode) max abs errors: "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        else:
            errs = {name: records[name]["max_abs_err"] for name in (
                "joint_sample_rollout", "rollout_costs", "sample_rollout",
                "rollout_costs_batched", "sample_rollout_batched",
                "joint_sample_rollout_batched")}
        for name, err in errs.items():
            rec = records.get(name, {}).get("modes", {}).get(mode, {})
            mode_record(records, name, mode, max_abs_err=max(err, rec.get("max_abs_err", 0.0)),
                        checked_in=rec.get("checked_in", []) + [kind])
        if kind == "sin":  # the "table" mode is timed on periodic's table
            continue
        alone = kernels_alone(inp, case, mode)
        for name, (ms, bnd) in alone.items():
            mode_record(records, name, mode, alone_ms=ms, bound_ms=bnd["bound_ms"],
                        bound_by=bnd["bound_by"])
        say(f"  {mode} mode ({kind}) alone ms: " + ", ".join(
            f"{k} {v[0]:.4f} (bound {v[1]['bound_ms']:.5f})" for k, v in alone.items()))

    phase("phase 7a: K3 at sd=16 on the drag Hessian's J and M; K2 on a periodic table")
    env = disturb_env("drag")
    p, st, _ = mode_inputs(env, dev, 75)
    x0 = pack_state(st)
    a_seq = cuda(rng.normal(size=(H, 4)) * 0.3)
    aux = build_hessian_aux_table(env, st.time, p, None, H)
    zs = primal16(env, x0, a_seq, aux, p)
    ptars, vtars = target_window(st.time, st.pos_traj, st.vel_traj, H, offset=1)
    J, M = adjoint_curvature(env, p, zs, aux, ptars, vtars)
    J = J.contiguous()
    T_k, T_p = hessian_cuda.sens_chain(J, 4), hessian_cuda.sens_chain_plain(J, 4)
    R_k, R_p = hessian_cuda.pullback(T_k, M), hessian_cuda.pullback(T_p, M)
    rel_T, rel_R = rel_fro(T_k, T_p), rel_fro(R_k, R_p)
    say(f"  K3 sd=16: J {tuple(J.shape)}, M {tuple(M.shape)}; relative Frobenius error "
        f"T {rel_T:.3e}, Hessian {rel_R:.3e}")
    check(rel_T < 1e-5 and rel_R < 1e-5, "K3 at sd=16: T and Hessian within 1e-5 (relative)")
    T_out = torch.empty_like(T_k)
    ms3 = bare_launch_ms(hessian_cuda.CHAIN_KERNEL, J.data_ptr(), T_out.data_ptr(), H, 16, 4,
                         reps=200)
    b3 = k3_bound(H, sd=16)
    mode_record(records, "sens_chain", "sd13", max_abs_err=records["sens_chain"]["max_abs_err"],
                checked_in=["gaussian"])
    mode_record(records, "sens_chain", "sd16", alone_ms=ms3, max_abs_err=max_err(T_k, T_p),
                bound_ms=b3["bound_ms"], bound_by=b3["bound_by"], checked_in=["drag"])
    say(f"  K3 sd=16 alone {ms3:.4f} ms, bound {b3['bound_ms']:.7f} ms")
    env = disturb_env("periodic")
    p, st, _ = mode_inputs(env, dev, 76)
    x0 = pack_state(st)
    draws = env.draw_disturb(torch.Generator(dev).manual_seed(77), H, deterministic=True)
    dist = build_hessian_disturb_table(env, x0, st.time, p, draws, H)
    k2 = rollout_cuda.make_primal(env, H)
    zs_k, zs_p = k2(x0, a_seq, dist, p), k2.plain(x0, a_seq, dist, p)
    err2 = max_err(zs_k, zs_p)
    say(f"  K2 on a periodic table (rows {int((dist.abs().sum(1) > 0).sum())} of {H} "
        f"non-zero): max |z - plain| = {err2:.3e}")
    check(err2 <= 1e-5 and bool((dist[1:] != 0).any()), "K2 on a non-zero table within 1e-5")
    scal = torch.stack(rollout_cuda._dyn_scalars(env, p, dev) + [rollout_cuda._full(1.0, dev)])
    a_flat, d_flat = a_seq.reshape(-1).contiguous(), dist.reshape(-1).contiguous()
    states = torch.empty(H, 13, device=dev)
    ms2 = bare_launch_ms(rollout_cuda.PRIMAL_KERNEL, x0.contiguous().data_ptr(), scal.data_ptr(),
                         a_flat.data_ptr(), d_flat.data_ptr(), states.data_ptr(), H, reps=200)
    b2 = k2_bound(H)
    mode_record(records, "primal", "shared", max_abs_err=records["primal"]["max_abs_err"],
                checked_in=["gaussian"])
    mode_record(records, "primal", "table", alone_ms=ms2, max_abs_err=err2,
                bound_ms=b2["bound_ms"], bound_by=b2["bound_by"], checked_in=["periodic"])
    say(f"  K2 (table) alone {ms2:.4f} ms")


def phase_mode_solves(dev, kernel_list):
    """7b: full-width solves under drag and mixed, engine="cuda" against
    engine="torch" on the same normals and draws (2e-4, no host sync)."""
    from covo_mpc_tpu_torch.ops import hessian_cuda, rollout_cuda
    from covo_mpc_tpu_torch.solvers import get_solver

    phase("phase 7b: full-width solves under drag and mixed, engine='cuda' against "
          "engine='torch' on the same normals and draws")
    g = np.random.default_rng(78)
    z = to_dev(g.standard_normal((N, D)), dev)
    for kind, hessian_mode, rng_mode, used in (
            ("drag", "gn", "kernel", rollout_cuda.JOINT_KERNEL),
            ("drag", "adjoint", "fast", rollout_cuda.ROLLOUT_KERNEL),
            ("mixed", "gn", "kernel", rollout_cuda.JOINT_KERNEL)):
        env = disturb_env(kind)
        p = env.default_params
        obs, info, state = env.reset(torch.Generator(dev).manual_seed(5), p)
        gen = torch.Generator(dev).manual_seed(79)
        draw = env.draw_disturb(gen, deterministic=True)
        hess_draws = env.draw_disturb(gen, H, deterministic=True)
        out = {}
        for engine in ("cuda", "torch"):
            solver, cp = get_solver(
                env, "covo_online", f"N{N}_H{H}_lam0.01",
                rng_mode=rng_mode if engine == "cuda" else "fast",
                hessian_mode=hessian_mode, sigma_mode="ns", engine=engine,
                collect_debug=False)
            out[engine], counts = run_once(
                lambda: solver(obs, state, p, cp, info, z=z, draw=draw,
                               hess_draws=hess_draws), kernel_list)
            if engine == "cuda":
                say(f"  CoVO {kind} {hessian_mode} ({rng_mode}) cuda launches: "
                    f"{ {k: v for k, v in counts.items() if v} }")
                check(counts[used.symbol] > 0 and counts["sens_chain"] > 0
                      and counts["primal"] == 0,
                      f"{used.symbol} and sens_chain (sd=16) launched, the plain primal "
                      "(no K2) under a velocity-coupled force")
        (a_c, cp_c, _), (a_t, cp_t, _) = out["cuda"], out["torch"]
        errs = {"action": max_err(a_c, a_t), "a_mean": max_err(cp_c.a_mean, cp_t.a_mean),
                "a_cov": max_err(cp_c.a_cov, cp_t.a_cov)}
        say(f"  CoVO {kind} {hessian_mode} ({rng_mode}) max |cuda - torch|: {errs}")
        check(all(v <= 2e-4 for v in errs.values())
              and all(bool(torch.isfinite(x).all()) for x in (a_c, cp_c.a_mean, cp_c.a_cov)),
              f"CoVO {kind}: action, a_mean and a_cov finite and within 2e-4 (no host sync)")

    env = disturb_env("drag")
    p = env.default_params
    obs, info, state = env.reset(torch.Generator(dev).manual_seed(5), p)
    z5 = to_dev(g.standard_normal((N, H, 4)), dev)
    out = {}
    for engine, rng_mode in (("cuda", "kernel"), ("torch", "fast")):
        solver, cp = make_mppi(env, engine, rng_mode=rng_mode)
        out[engine], counts = run_once(lambda: solver(obs, state, p, cp, info, z=z5),
                                       kernel_list)
        if engine == "cuda":
            check(counts["sample_rollout"] > 0, "sample_rollout launched by the drag MPPI solve")
    (a_c, cp_c, _), (a_t, cp_t, _) = out["cuda"], out["torch"]
    errs = {"action": max_err(a_c, a_t)}
    errs.update({k: max_err(getattr(cp_c, k), getattr(cp_t, k))
                 for k in ("a_mean", "a_cov", "a_cov_chol")})
    say(f"  MPPI drag (kernel) max |cuda - torch|: {errs}")
    check(all(v <= 2e-4 for v in errs.values()),
          "MPPI drag: action, a_mean, a_cov and a_cov_chol within 2e-4 (no host sync)")

    B = SCEN_B
    env_b = disturb_env("drag", randomize=True)
    args, pb, _, _ = scenario_batch(env_b, B, seed=80)
    a_means, a_covs = initial_means(env_b, B)
    for kind, zb, extra, used in (
            ("covo", to_dev(g.standard_normal((B, N, D)), dev), (),
             rollout_cuda.JOINT_BATCHED_KERNEL),
            ("mppi", to_dev(g.standard_normal((B, N, H, 4)), dev), (a_covs,),
             rollout_cuda.SAMPLE_BATCHED_KERNEL)):
        out = {}
        for engine in ("cuda", "torch"):
            solve = make_batched(env_b, kind, engine)
            out[engine], counts = run_once(lambda: solve(*args, a_means, *extra, pb, z=zb),
                                           kernel_list)
            if engine == "cuda":
                check(counts[used.symbol] > 0, f"{used.symbol} launched by the batched "
                      f"drag {kind} solve")
        got, ref = out["cuda"], out["torch"]
        errs = {"action": max_err(got[0][:, 0], ref[0][:, 0]), "a_mean": max_err(got[0], ref[0])}
        if kind == "mppi":
            errs["a_cov"] = max_err(got[1], ref[1])
        say(f"  batched {kind} drag (B={B}) max |cuda - torch|: {errs}")
        check(all(v <= 2e-4 for v in errs.values())
              and all(bool(torch.isfinite(x).all()) for x in got),
              f"batched {kind} under drag: finite, within 2e-4 (no host sync)")


def phase_drag_loops(dev, total_steps, kernel_list, records):
    """7c: the closed loops on the drag env, at half the other loops' depth
    (600 steps, 2 episodes, at the default) to leave room for phase 8: CoVO
    online with RESULTS_DRAG.md's settings (adjoint, ns, fast rng: K4) and
    with the main path's (gn, kernel rng: K1), MPPI (fast rng: K4) as the
    same-run anchor; the drag solve's events ms."""
    from covo_mpc_tpu_torch.solvers import get_solver

    env = disturb_env("drag")
    steps = total_steps // 2
    phase(f"phase 7c: drag closed loops, evaluate(total_steps={steps}, seed=1): "
          "covo_online adjoint, ns, fast rng (K4; RESULTS_DRAG.md's settings)")
    solver, _ = get_solver(env, "covo_online", f"N{N}_H{H}_lam0.01", rng_mode="fast",
                           hessian_mode="adjoint", sigma_mode="ns", engine="cuda",
                           collect_debug=False)
    covo_fast, l_fast = closed_loop(env, solver, steps, kernel_list)
    check(l_fast["rollout_costs"] > 0 and l_fast["sens_chain"] > 0
          and l_fast["primal"] == 0,
          "rollout_costs and sens_chain (sd=16) launched by the drag loop, no K2")
    phase("  covo_online gn, kernel rng (K1; the main path's settings)")
    covo_k, l_k = closed_loop(env, make_solver(env, "cuda")[0], steps, kernel_list)
    check(l_k["joint_sample_rollout"] > 0, "joint_sample_rollout launched by the drag loop")
    phase("  mppi, fast rng (K4), the same-run anchor")
    mppi, l_m = closed_loop(env, make_mppi(env, "cuda", rng_mode="fast")[0], steps,
                            kernel_list)
    check(all(np.isfinite(r.mean) for r in (covo_fast, covo_k, mppi)),
          "drag err_pos finite for every loop")
    check(covo_fast.mean < mppi.mean and covo_k.mean < mppi.mean,
          "CoVO's drag err_pos (both settings) below MPPI's on the same episodes")
    for name, n in (("rollout_costs", l_fast["rollout_costs"]),
                    ("joint_sample_rollout", l_k["joint_sample_rollout"])):
        mode_record(records, name, "drag", launches=n)
    mode_record(records, "sens_chain", "sd16", launches=l_fast["sens_chain"])
    med, counts = solve_times(env, dev, reps=12, warmup=2)
    say(f"  drag CoVO (gn, kernel rng) median events ms per solve: cuda {med['cuda']:.4f} "
        f"({counts['cuda']} solves), torch {med['torch']:.4f} ({counts['torch']} solves)")


# --- phase 8: the realworld reward (tracking_slow) ---------------------------

SLOW_KINDS = ("gaussian", "drag")  # the shared mode and a velocity-coupled one


def slow_env(kind: str = "gaussian", randomize: bool = False, task: str = "tracking_slow"):
    """The main path's env on ``task`` (default tracking_slow: the slow
    Lissajous and the realworld reward) under the disturbance ``kind``."""
    from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv

    return QuadEnv(EnvConfig(**{**ENV_KW, "task": task, "disturb_type": kind,
                                "enable_randomizer": randomize}))


def reward_record(records, name: str, mode: str, **values) -> None:
    """Keep a kernel's numbers with the realworld reward in one disturbance
    mode (the JSON record's ``realworld``)."""
    records.setdefault(name, {}).setdefault("realworld", {}).setdefault(mode, {}).update(values)


def phase_realworld_kernels(dev, records):
    """8a: K1, K4, K5 (shared and krng), K6 and K7 (per-step and joint,
    B=SCEN_B) with the realworld reward against their plain versions, in the
    shared (gaussian) and drag modes, at N=8192, H=32, D=128, t0 = 47; each
    kernel alone in each (bare launches)."""
    from covo_mpc_tpu_torch.ops import rollout_cuda

    phase(f"phase 8a: the realworld reward (tracking_slow) in K1, K4-K7 against their "
          f"plain versions (N={N}, H={H}, B={SCEN_B}), shared and drag modes, and alone")
    say_sample_geometry()
    inp = mode_kernel_inputs(dev, 81)
    for kind in SLOW_KINDS:
        mode = MODE_OF[kind]
        case = mode_case(slow_env(kind), slow_env(kind, randomize=True), dev, 82)
        check(all(w.reward == rollout_cuda.REWARDS["realworld"] for w in (
            rollout_cuda.make_rollout_costs(case.env),
            rollout_cuda.make_rollout_batched_sampling(case.env_b, joint=True))),
            f"the wrappers launch the realworld branch on tracking_slow ({kind})")
        errs = check_rollout_kernels(f"realworld, {kind}", inp, case)
        if kind == "gaussian":
            # "krng": K5 draws the shared force; the plain rollout of its own
            # actions under the normals it wrote agrees
            k5 = rollout_cuda.make_rollout_sampling(case.env)
            draw_out = torch.zeros(3, device=dev)
            c_k, a_k = k5(*case.roll, inp.a_mean, inp.chol, case.p, 7, N, disturb_seed=8,
                          draw_out=draw_out)
            c_p = k5._rollout(*case.roll, a_k, case.p, draw_out.clone(), layout="hdn")
            check(costs_close(c_k, c_p) and float(draw_out.abs().sum()) > 0,
                  "K5 krng (realworld) costs within atol 2e-4, rtol 1e-5 of the plain "
                  "rollout fed its draw")
            errs["sample_rollout"] = max(errs["sample_rollout"], max_err(c_k, c_p))
        alone = kernels_alone(inp, case, mode, "realworld")
        for name, (ms, bnd) in alone.items():
            reward_record(records, name, mode, max_abs_err=errs[name], alone_ms=ms,
                          bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"],
                          checked_in=[f"tracking_slow, {kind}"])
        say(f"  realworld, {kind} ({mode} mode) max abs errors: "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        say(f"  realworld, {mode} mode alone ms: " + ", ".join(
            f"{k} {v[0]:.4f} (bound {v[1]['bound_ms']:.5f} {v[1]['bound_by']})"
            for k, v in alone.items()))


def compare_solves(label: str, make, call, used, names, kernel_list):
    """One solve with ``make("cuda")`` against one with ``make("torch")``
    through ``call(solver, cp)`` on the same inputs (no host sync in either):
    ``used`` (kernel symbols) each launched by the cuda one; the action and
    the params ``names`` finite and within 2e-4."""
    out = {}
    for engine in ("cuda", "torch"):
        solver, cp = make(engine)
        out[engine], counts = run_once(lambda: call(solver, cp), kernel_list)
        if engine == "cuda":
            say(f"  {label} cuda launches: { {k: v for k, v in counts.items() if v} }")
            check(all(counts[k] > 0 for k in used), f"{', '.join(used)} launched by the "
                  f"{label} solve")
    (a_c, cp_c, _), (a_t, cp_t, _) = out["cuda"], out["torch"]
    errs = {"action": max_err(a_c, a_t),
            **{k: max_err(getattr(cp_c, k), getattr(cp_t, k)) for k in names}}
    say(f"  {label} max |cuda - torch|: {errs}")
    check(all(v <= 2e-4 for v in errs.values())
          and all(bool(torch.isfinite(x).all()) for x in (a_c, *(getattr(cp_c, k)
                                                               for k in names))),
          f"{label}: action, {', '.join(names)} finite and within 2e-4 (no host sync)")


def phase_realworld_solves(dev, kernel_list):
    """8b: full-width solves on tracking_slow, engine="cuda" against
    engine="torch" on the same normals and draw: CoVO online with the main
    path's settings (gn, ns, kernel rng: K2, K3, K1), CoVO adjoint with fast
    rng (K4), MPPI with kernel rng (K5), one batched CoVO solve at B=SCEN_B
    (K7 joint); and one main-path CoVO solve on tracking (the Lissajous
    tables through the penyaw branch)."""
    from covo_mpc_tpu_torch.ops import rollout_cuda
    from covo_mpc_tpu_torch.solvers import get_solver

    phase("phase 8b: full-width solves on tracking_slow (and one on tracking), "
          "engine='cuda' against engine='torch' on the same normals")
    g = np.random.default_rng(85)
    z = to_dev(g.standard_normal((N, D)), dev)
    covo_names = ("a_mean", "a_cov")
    for task, hessian_mode, rng_mode, first in (
            ("tracking_slow", "gn", "kernel", rollout_cuda.JOINT_KERNEL),
            ("tracking_slow", "adjoint", "fast", rollout_cuda.ROLLOUT_KERNEL),
            ("tracking", "gn", "kernel", rollout_cuda.JOINT_KERNEL)):
        env = slow_env(task=task)
        p = env.default_params
        obs, info, state = env.reset(torch.Generator(dev).manual_seed(5), p)

        def make(engine, env=env, hessian_mode=hessian_mode, rng_mode=rng_mode):
            return get_solver(env, "covo_online", f"N{N}_H{H}_lam0.01",
                              rng_mode=rng_mode if engine == "cuda" else "fast",
                              hessian_mode=hessian_mode, sigma_mode="ns", engine=engine,
                              collect_debug=False)

        compare_solves(f"CoVO {task} {hessian_mode} ({rng_mode})", make,
                       lambda solver, cp: solver(obs, state, p, cp, info, z=z),
                       [first.symbol, "primal", "sens_chain"], covo_names, kernel_list)

    env = slow_env()
    p = env.default_params
    obs, info, state = env.reset(torch.Generator(dev).manual_seed(5), p)
    z5 = to_dev(g.standard_normal((N, H, 4)), dev)
    draw = to_dev(g.standard_normal(3), dev)
    compare_solves("MPPI tracking_slow (kernel)",
                   lambda engine: make_mppi(env, engine, rng_mode="kernel" if engine == "cuda"
                                            else "fast"),
                   lambda solver, cp: solver(obs, state, p, cp, info, z=z5, draw=draw),
                   [rollout_cuda.SAMPLE_KERNEL.symbol], ("a_mean", "a_cov", "a_cov_chol"),
                   kernel_list)

    B = SCEN_B
    env_b = slow_env(randomize=True)
    args, pb, _, _ = scenario_batch(env_b, B, seed=86)
    a_means, _ = initial_means(env_b, B)
    zb = to_dev(g.standard_normal((B, N, D)), dev)
    out = {}
    for engine in ("cuda", "torch"):
        solve = make_batched(env_b, "covo", engine)
        out[engine], counts = run_once(lambda: solve(*args, a_means, pb, z=zb), kernel_list)
        if engine == "cuda":
            check(counts[rollout_cuda.JOINT_BATCHED_KERNEL.symbol] > 0,
                  "joint_sample_rollout_batched launched by the batched tracking_slow solve")
    got, ref = out["cuda"], out["torch"]
    errs = {"action": max_err(got[0][:, 0], ref[0][:, 0]), "a_mean": max_err(got[0], ref[0])}
    say(f"  batched CoVO tracking_slow (B={B}) max |cuda - torch|: {errs}, min cost "
        f"{max_err(got[1], ref[1]):.3e}")
    check(all(v <= 2e-4 for v in errs.values()) and costs_close(got[1], ref[1])
          and all(bool(torch.isfinite(x).all()) for x in got),
          "batched CoVO on tracking_slow: finite, within 2e-4 (no host sync)")


def phase_realworld_loops(dev, total_steps, kernel_list, records):
    """8c: the closed loops on tracking_slow, evaluate(total_steps, seed=1):
    CoVO online with the main path's settings (K2, K3, K1) and MPPI with
    kernel rng (K5); both finite, CoVO below MPPI on the same episodes; the
    CoVO solve's median events ms."""
    env = slow_env()
    phase(f"phase 8c: tracking_slow closed loops, evaluate(total_steps={total_steps}, "
          "seed=1): covo_online gn, kernel rng (K1, K2, K3)")
    covo, l_c = closed_loop(env, make_solver(env, "cuda")[0], total_steps, kernel_list)
    check(all(l_c[k] > 0 for k in ("joint_sample_rollout", "primal", "sens_chain")),
          "joint_sample_rollout, primal and sens_chain launched by the tracking_slow loop")
    phase("  mppi, kernel rng (K5)")
    mppi, l_m = closed_loop(env, make_mppi(env, "cuda")[0], total_steps, kernel_list)
    check(l_m["sample_rollout"] > 0, "sample_rollout launched by the tracking_slow MPPI loop")
    check(np.isfinite(covo.mean) and np.isfinite(mppi.mean),
          "tracking_slow err_pos finite for both loops")
    check(covo.mean < mppi.mean, "CoVO's tracking_slow err_pos below MPPI's on the same "
          "episodes")
    reward_record(records, "joint_sample_rollout", "shared", launches=l_c["joint_sample_rollout"])
    reward_record(records, "sample_rollout", "shared", launches=l_m["sample_rollout"])
    med, counts = solve_times(env, dev, reps=12, warmup=2)
    say(f"  tracking_slow CoVO (gn, kernel rng) median events ms per solve: cuda "
        f"{med['cuda']:.4f} ({counts['cuda']} solves), torch {med['torch']:.4f} "
        f"({counts['torch']} solves)")


# --- phase 9: the command line ----------------------------------------------


def cli_run(argv, kernel_list):
    """``cli.main(argv)`` in-process with every launch counter at 0 just
    before it; returns its standard output (echoed) and the counts just
    after."""
    import contextlib
    import io

    from covo_mpc_tpu_torch import cli

    for k in kernel_list:
        k.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    counts = {k.symbol: k.launches for k in kernel_list}
    out = buf.getvalue()
    for line in out.splitlines():
        say(f"  | {line}")
    check(rc == 0, f"cli.main({' '.join(argv[:6])} ...) returned 0")
    return out, counts


def phase_cli(kernel_list, records):
    """Phase 9: ``python -m covo_mpc_tpu_torch.cli``'s three modes through
    ``cli.main``, in-process, into a temporary results directory: (a) eval
    on the main path at --total-steps with --metrics (err_pos, the JSONL,
    K1-K3 once a step); (b) render with MPPI's kernel rng (a 300-row trace
    with aligned err_pos, K5); (c) bench with ``ns_pallas`` (K8, the
    captured p50 under the 50 Hz budget); (d) eval --supervised
    --chunk-episodes 2 with MPPI equal to the unsupervised eval bit for
    bit, and a run crashed after its first chunk and resumed equal to both.
    Returns each kernel's launches in its CLI run (also its record's
    ``cli_launches``)."""
    import shutil
    import tempfile

    from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv
    from covo_mpc_tpu_torch.runtime.supervisor import run_supervised
    from covo_mpc_tpu_torch.solvers import get_solver

    steps = CLI_STEPS
    d = tempfile.mkdtemp(prefix="covo_cli_")
    base = ["--task", "tracking_zigzag", "--controller-params", f"N{N}_H{H}_lam0.01",
            "--noDR", "--engine", "cuda", "--rng-mode", "kernel", "--results-dir", d]
    launches = {}
    try:
        phase(f"phase 9a: cli eval, the main path (covo_online gn ns kernel rng cuda), "
              f"--total-steps {steps} --metrics")
        t0 = time.perf_counter()
        _, counts = cli_run([*base, "--controller", "covo_online", "--mode", "eval",
                             "--hessian-mode", "gn", "--sigma-mode", "ns",
                             "--total-steps", str(steps), "--metrics", "--name", "main"],
                            kernel_list)
        wall = time.perf_counter() - t0
        with np.load(f"{d}/eval_main.npz") as data:
            err = data["err_pos_ep"] * 100
            mean = float(data["mean"]) * 100
        say(f"  eval: {len(err)} episodes, err_pos {mean:.4f} cm, per episode "
            f"{[round(float(e), 4) for e in err]} ({wall:.1f} s); launches {counts}")
        check(np.isfinite(mean) and mean < ERR_POS_LIMIT_CM,
              f"cli eval err_pos finite and below {ERR_POS_LIMIT_CM} cm")
        with open(f"{d}/metrics_main.jsonl") as fh:
            recs = [json.loads(line) for line in fh]
        keys = ("cost_min", "cost_mean", "cost_p90", "ess", "sigma_cond", "sigma_logdet")
        check(len(recs) == steps and all(np.isfinite(r[k]) for r in recs for k in keys),
              f"{steps} finite metrics records")
        ess = np.array([r["ess"] for r in recs])
        cond = np.array([r["sigma_cond"] for r in recs])
        check(bool(((ess >= 1.0 - 1e-4) & (ess <= N + 1e-2)).all()) and bool((cond >= 1.0).all()),
              f"1 <= ess <= {N} and sigma_cond >= 1 in every record")
        say(f"  metrics: ess median {np.median(ess):.2f} (min {ess.min():.2f}, max "
            f"{ess.max():.2f}); sigma_cond median {np.median(cond):.4e}")
        for sym in ("joint_sample_rollout", "primal", "sens_chain"):
            check(counts[sym] >= steps, f"{sym} launched at least once a step by the cli eval")
            launches[sym] = counts[sym]

        phase("phase 9b: cli render, mppi kernel rng (K5)")
        _, counts = cli_run([*base, "--controller", "mppi", "--mode", "render",
                             "--name", "mppi"], kernel_list)
        with np.load(f"{d}/trace_mppi.npz") as data:
            trace = {k: data[k] for k in data.files}
        T = 300
        check(all(v.shape[0] == T for v in trace.values()) and trace["action"].shape == (T, 4),
              f"a {T}-row trace, every channel")
        # a done row's step-returned info is the auto-reset's (JAX's too)
        live = ~trace["done"]
        align = float(np.abs(trace["err_pos"] - np.linalg.norm(
            trace["pos"] - trace["pos_tar"], axis=-1))[live].max())
        say(f"  trace channels {sorted(trace)}; {int(trace['done'].sum())} done rows; max "
            f"|err_pos - |pos - pos_tar|| over the others {align:.3e}; launches {counts}")
        check(align <= 1e-5, "the trace's err_pos aligned with |pos - pos_tar| (1e-5) on "
              "every row that is not done")
        check(counts["sample_rollout"] >= T, "sample_rollout launched by the cli render")
        launches["sample_rollout"] = counts["sample_rollout"]

        phase("phase 9c: cli bench, covo_online gn, sigma_mode ns_pallas (K8), captured")
        out, counts = cli_run([*base, "--controller", "covo_online", "--mode", "bench",
                               "--hessian-mode", "gn", "--sigma-mode", "ns_pallas"],
                              kernel_list)
        line = json.loads([x for x in out.splitlines() if x.startswith("{")][-1])
        p50 = line["per_dispatch"]["p50"]
        check(counts["sigma_ns"] > 0, "sigma_ns launched by the cli bench")
        check(p50 < 0.020, f"the captured bench p50 {p50 * 1e3:.4f} ms under the 20 ms budget")
        check(line["amortized_per_solve"]["method"] == "cuda_events",
              "the bench's chained time by CUDA events")
        launches["sigma_ns"] = counts["sigma_ns"]

        phase("phase 9d: cli eval --supervised --chunk-episodes 2, mppi kernel rng, "
              "against the unsupervised eval and a crashed-and-resumed run")
        mppi = [*base, "--controller", "mppi", "--mode", "eval", "--total-steps", str(steps)]
        cli_run([*mppi, "--name", "mppi_plain"], kernel_list)
        cli_run([*mppi, "--name", "mppi_sup", "--supervised", "--chunk-episodes", "2"],
                kernel_list)
        with np.load(f"{d}/eval_mppi_plain.npz") as a, np.load(f"{d}/eval_mppi_sup.npz") as b:
            plain, sup = a["err_pos_ep"], b["err_pos_ep"].astype(np.float32)
        check(np.array_equal(plain, sup), "the supervised eval equals the unsupervised "
              "one bit for bit")
        env = QuadEnv(EnvConfig(**ENV_KW))
        make = lambda: get_solver(env, "mppi", f"N{N}_H{H}_lam0.01", rng_mode="kernel",
                                  engine="cuda", collect_debug=False)[0]

        def crash(chunk, attempt):
            if chunk == 1:
                raise RuntimeError("injected outage after the first chunk")

        ckpt = f"{d}/ckpt_resume"
        try:
            run_supervised(env, make(), total_steps=steps, seed=1, checkpoint_dir=ckpt,
                           chunk_episodes=2, max_retries=0, _fault_hook=crash)
            check(False, "the injected outage raised")
        except RuntimeError as e:
            check("re-run the same command" in str(e), "the crashed run checkpointed")
        resumed = run_supervised(env, make(), total_steps=steps, seed=1,
                                 checkpoint_dir=ckpt, chunk_episodes=2)
        say(f"  plain {[round(100 * float(e), 4) for e in plain]} cm; resumed at chunk "
            f"{resumed.resumed_at_chunk}")
        check(resumed.resumed_at_chunk == 1 and np.array_equal(
            resumed.err_pos_ep.numpy().astype(np.float32), plain),
              "the resumed run equals the uninterrupted one bit for bit")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for sym, n in launches.items():
        records[sym]["cli_launches"] = n
    return launches


# --- phase 10: the paper's sweeps (covo_mpc_tpu_torch/scripts) ---------------

# N=16 lies below one block of every size the rollout kernels take (32, 64,
# 128); N=100 is ragged over 4, 2 or 1 of them (the N-ablation's range)
SMALL_NS = (16, 100)
SMALL_B = 4  # K6's and K7's scenarios in 10a
# the kernels the sweeps run (sequential protocol, ns designer: no K6-K8)
SWEEP_KERNELS = ("joint_sample_rollout", "primal", "sens_chain", "rollout_costs",
                 "sample_rollout")


def check_small_draws(inp, case) -> None:
    """In-kernel draws at ``inp``'s sample count n: K1 at each block it takes
    and K5 at each of its blocks give the same bits, and their n samples
    equal the first n of a launch at N (the last block's idle lanes draw and
    write nothing); K7 (per-step, joint): scenario 0 of the B-scenario
    launch equals the one-scenario launch."""
    from covo_mpc_tpu_torch.models.structs import index_params, stack_params
    from covo_mpc_tpu_torch.ops import rollout_cuda

    n = inp.costs.shape[0]
    roll, p, draw = case.roll, case.p, case.draw
    for label, make, blocks, fac in (
            ("K1", rollout_cuda.make_rollout_joint_sampling, rollout_cuda.JOINT_BLOCKS,
             inp.factor),
            ("K5", rollout_cuda.make_rollout_sampling, rollout_cuda.SAMPLE_BLOCKS, inp.chol)):
        outs = [make(case.env, block=b)(*roll, inp.a_mean, fac, p, 31, n, draw=draw)
                for b in blocks]
        c_f, a_f = make(case.env)(*roll, inp.a_mean, fac, p, 31, N, draw=draw)
        check(all(torch.equal(x, y) for o in outs[1:] for x, y in zip(outs[0], o))
              and torch.equal(outs[0][1], a_f[:, :n]) and torch.equal(outs[0][0], c_f[:n]),
              f"{label} at N={n}: blocks {blocks} bit for bit, and the first {n} samples "
              f"of an N={N} launch")
    one = tuple(x[:1] for x in case.args)
    pb1 = stack_params([index_params(case.pb, 0)])
    for joint, fac in ((False, inp.chols_b), (True, inp.factors_b)):
        k7 = rollout_cuda.make_rollout_batched_sampling(case.env_b, joint=joint)
        c_b, a_b = k7(*case.args, inp.means_b, fac, case.pb, 33, n, draws=case.draws)
        c_1, a_1 = k7(*one, inp.means_b[:1], fac[:1], pb1, 33, n, draws=case.draws[:1])
        check(torch.equal(a_1[0], a_b[0]) and torch.equal(c_1[0], c_b[0]),
              f"K7 {'joint' if joint else 'per-step'} at N={n}: scenario 0 of B="
              f"{a_b.shape[0]} equals the B=1 launch bit for bit")


def phase_small_n(dev, records):
    """10a: K1, K4, K5, K6, K7 per-step and K7 joint at N = 16 (below one
    block) and 100 (ragged over a few), H=32, B=SMALL_B, against their plain
    versions on given normals (:func:`check_rollout_kernels`), their
    in-kernel draws (:func:`check_small_draws`), and each kernel alone at
    N=16 (bare launches). Kept in each record's ``small_n``."""
    from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv

    phase(f"phase 10a: K1, K4-K7 at N = {SMALL_NS} (below one block, ragged over a "
          f"few), H={H}, B={SMALL_B}, against their plain versions, and alone at "
          f"N={SMALL_NS[0]}")
    env = QuadEnv(EnvConfig(**ENV_KW))
    env_b = QuadEnv(EnvConfig(**{**ENV_KW, "enable_randomizer": True}))
    for n in SMALL_NS:
        inp = mode_kernel_inputs(dev, 160 + n, n=n, B=SMALL_B)
        case = mode_case(env, env_b, dev, 170 + n, B=SMALL_B)
        errs = check_rollout_kernels(f"N={n}", inp, case)
        check_small_draws(inp, case)
        alone = kernels_alone(inp, case, "shared") if n == SMALL_NS[0] else {}
        for name, err in errs.items():
            rec = dict(max_abs_err=err)
            if name in alone:
                ms, bnd = alone[name]
                rec.update(alone_ms=ms, bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"])
            records.setdefault(name, {}).setdefault("small_n", {})[str(n)] = rec
        say(f"  N={n} max abs errors: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        if alone:
            say(f"  N={n} alone ms: " + ", ".join(
                f"{k} {v[0]:.4f} (bound {v[1]['bound_ms']:.6f} {v[1]['bound_by']})"
                for k, v in alone.items()))


def sweep_run(script, argv, kernel_list):
    """``script.run`` of ``argv`` at the --quick protocol, every launch counter
    at 0 just before it; returns its rows and the counts just after."""
    from covo_mpc_tpu_torch.scripts import protocol_steps

    args = script.build_parser().parse_args(argv)
    for k in kernel_list:
        k.launches = 0
    t0 = time.perf_counter()
    rows = script.run(args, protocol_steps(args.quick))
    torch.cuda.synchronize()
    counts = {k.symbol: k.launches for k in kernel_list}
    say(f"  {script.__name__.rsplit('.', 1)[1]} {' '.join(argv)}: "
        f"{time.perf_counter() - t0:.1f} s; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return rows, counts


def check_cells(label: str, cells) -> None:
    check(all(np.isfinite(c["mean"]) and c["failed"] == 0 for c in cells),
          f"{label}: every cell finite, no failed episode")


def phase_sweeps(kernel_list, records):
    """10b: the ported scripts in-process with --quick (4 episodes a cell),
    every file into a temporary directory: paper_results (PID, MPPI, CoVO
    online and offline at N=8192; PERF.md's limits, CoVO online below MPPI;
    a second run all cached, writing the same bytes), mode_gates (the 8
    cells; its section appended to a file of one line; CoVO below MPPI at
    each N) and n_ablation of MPPI and CoVO online at N = 16 and 100 (CoVO
    online below MPPI at each). Each of K1-K5 launched; their launches kept in each record's
    ``sweep_launches`` by script."""
    import shutil
    import tempfile

    from covo_mpc_tpu_torch.scripts import mode_gates, n_ablation, paper_results

    t_phase = time.perf_counter()
    d = tempfile.mkdtemp(prefix="covo_sweeps_")
    launches = {}
    try:
        phase("phase 10b: paper_results --quick (pid, mppi, covo_online, covo_offline; "
              f"N={N}, H={H}), in-process")
        argv = ["--quick", "--out", f"{d}/RESULTS_TORCH.md", "--checkpoint-root",
                f"{d}/ckpt_paper"]
        rows, launches["paper_results"] = sweep_run(paper_results, argv, kernel_list)
        check_cells("paper_results", rows)
        by = {r["name"]: r["mean"] for r in rows}
        check(by["covo_online"] < ERR_POS_LIMIT_CM and by["covo_offline"] < ERR_POS_LIMIT_CM
              and by["mppi"] < MPPI_ERR_POS_LIMIT_CM and by["pid"] < PID_ERR_POS_LIMIT_CM,
              f"paper_results: CoVO online and offline below {ERR_POS_LIMIT_CM}, MPPI below "
              f"{MPPI_ERR_POS_LIMIT_CM}, PID below {PID_ERR_POS_LIMIT_CM} cm")
        check(by["covo_online"] < by["mppi"], "paper_results: CoVO online below MPPI")
        with open(f"{d}/RESULTS_TORCH.md", "rb") as fh:
            first = fh.read()
        again, _ = sweep_run(paper_results, argv, kernel_list)
        with open(f"{d}/RESULTS_TORCH.md", "rb") as fh:
            second = fh.read()
        check(all(r["cached"] for r in again) and second == first,
              "paper_results again on the same checkpoint root: every cell cached, the "
              "same bytes written")
        for line in first.decode().splitlines():
            say(f"  | {line}")

        phase("phase 10b: mode_gates --quick (the 8 cells), its section appended")
        head = "# the sweeps' check\n"
        with open(f"{d}/gates.md", "w") as fh:
            fh.write(head)
        rows, launches["mode_gates"] = sweep_run(
            mode_gates, ["--quick", "--out", f"{d}/gates.md", "--json", f"{d}/gates.json",
                         "--checkpoint-root", f"{d}/ckpt_gates"], kernel_list)
        check_cells("mode_gates", rows)
        with open(f"{d}/gates.md") as fh:
            doc = fh.read()
        check(doc.startswith(head + "\n" + mode_gates.BEGIN)
              and doc.endswith(mode_gates.END + "\n") and len(rows) == 8,
              "mode_gates: 8 cells, the section appended after the file's line")
        for n in (N, 1024):
            at = [r for r in rows if r["n"] == n]
            mppi = min(r["mean"] for r in at if r["name"] == "mppi")
            covo = max(r["mean"] for r in at if r["name"] != "mppi")
            check(covo < mppi, f"mode_gates at N={n}: every CoVO cell ({covo:.2f} cm at "
                  f"most) below MPPI ({mppi:.2f} cm at least)")
        check(all(r["mean"] < (MPPI_ERR_POS_LIMIT_CM if r["name"] == "mppi"
                               else ERR_POS_LIMIT_CM) for r in rows if r["n"] == N),
              f"mode_gates at N={N}: CoVO below {ERR_POS_LIMIT_CM}, MPPI below "
              f"{MPPI_ERR_POS_LIMIT_CM} cm")
        for line in doc.splitlines():
            say(f"  | {line}")

        phase(f"phase 10b: n_ablation --quick --ns {' '.join(map(str, SMALL_NS))} "
              "--controllers mppi covo_online")
        cells, launches["n_ablation"] = sweep_run(
            n_ablation, ["--quick", "--ns", *map(str, SMALL_NS), "--controllers", "mppi",
                         "covo_online", "--out",
                         f"{d}/RESULTS_N_TORCH.md", "--checkpoint-root", f"{d}/ckpt_n"],
            kernel_list)
        check_cells("n_ablation", cells.values())
        for n in SMALL_NS:
            check(cells[(n, "covo_online")]["mean"] < cells[(n, "mppi")]["mean"],
                  f"n_ablation at N={n}: CoVO online below MPPI")
        with open(f"{d}/RESULTS_N_TORCH.md") as fh:
            for line in fh.read().splitlines():
                say(f"  | {line}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for sym in SWEEP_KERNELS:
        by_script = {script: counts[sym] for script, counts in launches.items()}
        check(sum(by_script.values()) > 0, f"{sym} launched by the sweeps")
        records.setdefault(sym, {})["sweep_launches"] = by_script
    say(f"  phase 10b wall {time.perf_counter() - t_phase:.1f} s (budget 120 s)")
    return launches


# --- phase 11: the bench (python -m covo_mpc_tpu_torch.bench) ------------------

# one process: every row, the batched rows at B=64 and the latency pass;
# --k 8 gives the rows' and the latency pass's chains of 64 solves (256 by
# default)
BENCH_ARGV = ["--all", "--scenarios", "64", "--k", "8"]
BENCH_TIMEOUT_S = 900.0
# the rows --all prints (the JAX bench's, with the port's engines), by text
ALL_ROWS = ("mppi         engine=torch ", "mppi         engine=cuda ",
            "covo_online  engine=torch ", "covo_online  engine=cuda ",
            "mppi         engine=cuda+krng ", "covo_online  engine=cuda+krng ",
            "covo_online  engine=cuda+eigh ", "covo_online  engine=cuda+gn ",
            "covo_online  engine=cuda+krng+gn ", "engine=cuda+drag", "covo_offline engine",
            "covo_spec    engine=cuda ", "covo_spec    engine=cuda+gn ",
            "covo_spec    engine=cuda+krng ", "pid ")


def bench_run(argv):
    """``python -m covo_mpc_tpu_torch.bench argv`` in a process of its own,
    its rows echoed as they come: (its JSON record, its row lines, wall s).
    A nonzero exit, or no end within BENCH_TIMEOUT_S, raises."""
    import collections
    import tempfile
    import threading

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    rows, tail = [], collections.deque(maxlen=60)
    with tempfile.TemporaryFile("w+") as out:
        proc = subprocess.Popen([sys.executable, "-m", "covo_mpc_tpu_torch.bench", *argv],
                                stdout=out, stderr=subprocess.PIPE, text=True, cwd=root)
        timer = threading.Timer(BENCH_TIMEOUT_S, proc.kill)
        timer.start()
        try:
            for line in proc.stderr:
                line = line.rstrip("\n")
                tail.append(line)
                if line.startswith("[bench]"):
                    rows.append(line)
                    say("  " + line)
            rc = proc.wait()
        finally:
            timer.cancel()
        out.seek(0)
        stdout = out.read()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"bench {argv} exited {rc}:\n" + "\n".join(tail))
    return json.loads(stdout.strip().splitlines()[-1]), rows, wall


def check_batched_rows(rows, B: int) -> None:
    """The batched CoVO and MPPI rows at B: device ms from a complete
    session, or "not measured" with the device ops recorded."""
    for kind in ("covo_online", "mppi"):
        line = next(r for r in rows if r.startswith(f"[bench] {kind}") and
                    f"scenario-batched B={B} " in r)
        check(re.search(r"device \d+\.\d+ ms a solve, busy", line) is not None
              or "device ms not measured (" in line,
              f"bench: the batched {kind} row at B={B} gives its device ms from a complete "
              "session or says it was not measured, with the counts")


def phase_bench(main_path):
    """Phase 11: the bench in a process of its own (:data:`BENCH_ARGV`),
    checked as the module docstring says; ``main_path`` is phase 2c's row of
    the captured main-path solve."""
    from covo_mpc_tpu_torch.ops import kernels

    argv = BENCH_ARGV
    phase(f"phase 11: python -m covo_mpc_tpu_torch.bench {' '.join(argv)} (a process "
          "of its own)")
    record, rows, wall = bench_run(argv)
    say("  " + json.dumps(record))
    say(f"  phase 11 wall {wall:.1f} s")
    jax_keys = set(json.loads(
        (Path(__file__).resolve().parent / "BENCH_r05.json").read_text())["parsed"])
    check(set(record) == jax_keys | {"device", "method"},
          "bench: the record has bench.py's keys (the device per-solve ones too), device "
          "and method")
    solve_rows = [r for r in rows if "solves/s" in r or "obs->action" in r]
    check(all("method=" in r for r in solve_rows),
          f"bench: each of {len(solve_rows)} rows prints its method")
    check(record["method"] in ("trace", "events"), f"bench: value measured by "
          f"{record['method']}")
    missing = [r for r in ALL_ROWS if not any(r in line for line in rows)]
    check(not missing, f"bench --all: every row of the JAX bench printed (missing: {missing})")
    ref = main_path["captured_chained_ms"]
    got = record["per_solve_p50_ms"]
    check(abs(got - ref) <= 0.1 * ref, f"bench: the main path's per-solve p50 "
          f"{got:.4f} ms within 10% of phase 2c's captured chained {ref:.4f} ms")
    line = next(r for r in rows if r.startswith("[bench] latency covo_online ")
                and "marker " in r)
    marker = line.split("marker ", 1)[1].rsplit(", ", 1)[0]
    check(kernels.device_kernel(marker) == "joint_sample_rollout_kernel",
          f"bench: the per-solve marker is K1 ({marker[:60]})")
    check_batched_rows(rows, int(argv[argv.index("--scenarios") + 1]))


# --- phase 12: JAX's key tree on the card -------------------------------------


def normal_ulps(ours: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |ours - ref| in ulps of max(|ref|, 1)."""
    ours, ref = ours.cpu().double(), ref.cpu().double()
    ulp = torch.from_numpy(np.spacing(ref.abs().clamp_min(1.0).numpy().astype(np.float32)))
    return float(((ours - ref).abs() / ulp).max())


def keyed_solve(solver):
    """``solver`` as ``f(obs, state, p, cp, info, key)``: the key a
    positional input, so a capture takes it as a graph buffer."""
    return lambda obs, state, p, cp, info, key: solver(obs, state, p, cp, info, key=key)


def phase_key_tree(env, dev, kernel_list, refs: dict) -> dict:
    """Phase 12 (the module docstring); returns K4's launches in (b) and
    (d), by run, and puts (d)'s results in ``refs``."""
    from covo_mpc_tpu_torch.ops import rollout_cuda
    from covo_mpc_tpu_torch.runtime import graphs
    from covo_mpc_tpu_torch.solvers import get_solver
    from covo_mpc_tpu_torch.utils import prng

    t_phase = time.perf_counter()
    k4 = rollout_cuda.ROLLOUT_KERNEL.symbol
    phase("phase 12a: utils/prng on the card against the CPU (8192 keys, 128 draws each)")
    for seed in (0, 1, 2**31 - 1):
        cpu, gpu = prng.PRNGKey(seed), prng.PRNGKey(seed, dev)
        kc, kg = prng.split(cpu, N), prng.split(gpu, N)
        same = (torch.equal(kg.cpu(), kc)
                and torch.equal(prng.fold_in(gpu, 7919).cpu(), prng.fold_in(cpu, 7919))
                and torch.equal(prng.fold_in(gpu, torch.arange(N, device=dev)).cpu(),
                                prng.fold_in(cpu, torch.arange(N)))
                and torch.equal(prng.uniform(kg, (D,), -1.0, 1.0).cpu(),
                                prng.uniform(kc, (D,), -1.0, 1.0)))
        check(same, f"seed {seed}: split, fold_in and uniform on the card equal the CPU's "
              "bit for bit")
        zg, zc = prng.normal(kg, (D,)), prng.normal(kc, (D,))
        ulps = normal_ulps(zg, zc)
        say(f"  seed {seed}: normals differing from the CPU's "
            f"{float((zg.cpu() != zc).double().mean()):.2e} of {zc.numel()}, "
            f"max {ulps:.1f} ulp")
        check(ulps <= 2.0, f"seed {seed}: normals on the card within 2 ulp of the CPU's")
    kg = prng.PRNGKey(3, dev)
    say(f"  parity draw (N={N}, D={D}): {time_ms(lambda: prng.normal(prng.split(kg, N), (D,)), 10):.3f} ms, "
        f"invariant {time_ms(lambda: prng.normal(prng.fold_in(kg, torch.arange(N, device=dev)), (D,)), 10):.3f} ms, "
        f"MPPI parity ({N} x {H} keys of 4) "
        f"{time_ms(lambda: prng.normal(prng.split(prng.split(kg, N), H), (4,)), 10):.3f} ms")

    p = env.default_params
    obs, info, state = env.reset(prng.PRNGKey(42, dev), p)
    cases = {
        "covo_online parity (fwd_fwd, eigh)": ("covo_online", dict(
            rng_mode="parity", hessian_mode="fwd_fwd", sigma_mode="eigh"), True),
        "mppi parity": ("mppi", dict(rng_mode="parity"), False),
        "covo_online invariant (gn, ns)": ("covo_online", dict(
            rng_mode="invariant", hessian_mode="gn", sigma_mode="ns"), False),
    }
    launches, solvers = {}, {}
    for label, (name, kw, eigh) in cases.items():
        phase(f"phase 12b: one full-width {label} solve, engine='cuda' (K4) against "
              "engine='torch' on the same key")
        out = {}
        for engine in ("cuda", "torch"):
            solver, cp = get_solver(env, name, f"N{N}_H{H}_lam0.01", engine=engine,
                                    collect_debug=False, **kw)
            solvers[label, engine] = (solver, cp)
            key = prng.PRNGKey(3, dev)
            fn = lambda: solver(obs, state, p, cp, info, key=key)
            t0 = time.perf_counter()
            if eigh:  # eigh reads its status on the host: no sync check
                fn()
                torch.cuda.synchronize()
                for k in kernel_list:
                    k.launches = 0
                res = fn()
                torch.cuda.synchronize()
                counts = {k.symbol: k.launches for k in kernel_list}
            else:
                res, counts = run_once(fn, kernel_list)
            wall = (time.perf_counter() - t0) * 1e3
            out[engine] = res
            say(f"  {engine}: {wall:.1f} ms for the solves (warm-up and checked), "
                f"launches { {k: v for k, v in counts.items() if v} }")
            if engine == "cuda":
                launches[f"solve {label}"] = counts[k4]
                check(counts[k4] > 0, f"{label}: K4 launched by the cuda solve")
        (a_c, cp_c, _), (a_t, cp_t, _) = out["cuda"], out["torch"]
        errs = {"action": max_err(a_c, a_t), "a_mean": max_err(cp_c.a_mean, cp_t.a_mean),
                "a_cov": max_err(cp_c.a_cov, cp_t.a_cov)}
        say(f"  {label} max |cuda - torch|: {errs}")
        check(all(v <= 2e-4 for v in errs.values())
              and all(bool(torch.isfinite(x).all()) for x in (a_c, cp_c.a_mean, cp_c.a_cov)),
              f"{label}: action, a_mean and a_cov finite and within 2e-4"
              + ("" if eigh else " (no host sync)"))

    for label in ("mppi parity", "covo_online invariant (gn, ns)"):
        phase(f"phase 12c: the {label} solve captured, the key a graph input")
        solver, cp = solvers[label, "cuda"]
        fn = keyed_solve(solver)
        cap = graphs.capture_solver(fn, solver, obs, state, p, cp, info, prng.PRNGKey(0, dev))
        same = True
        for seed in (5, 6, 7):
            key = prng.PRNGKey(seed, dev)
            a_r, cp_r, _ = cap(obs, state, p, cp, info, key)
            a_e, cp_e, _ = fn(obs, state, p, cp, info, key)
            same &= torch.equal(a_r, a_e) and torch.equal(cp_r.a_mean, cp_e.a_mean)
        check(same, f"{label}: three replays on three keys equal their eager solves "
              "bit for bit")
        say(f"  {label}: graph of {graph_nodes(cap)} nodes, replay "
            f"{time_ms(lambda: cap(obs, state, p, cp, info, key), 20):.3f} ms, eager "
            f"{time_ms(lambda: fn(obs, state, p, cp, info, key), 5):.3f} ms (events)")

    loops = {"covo_online parity (fwd_fwd, eigh), eager": (
        "covo_online parity (fwd_fwd, eigh)", KEY_COVO_STEPS, ERR_POS_LIMIT_CM),
        "mppi parity, captured": ("mppi parity", KEY_MPPI_STEPS, MPPI_ERR_POS_LIMIT_CM)}
    for label, (case, steps, limit) in loops.items():
        phase(f"phase 12d: {label}, evaluate(total_steps={steps}, seed=1) under JAX's "
              "key schedule")
        solver, _ = solvers[case, "cuda"]
        result, counts = closed_loop(env, solver, steps, kernel_list)
        refs[f"12d {case}"] = result
        launches[f"loop {label}"] = counts[k4]
        check(counts[k4] > 0, f"{label}: K4 launched in the closed loop")
        check(np.isfinite(result.mean) and result.mean * 100 < limit,
              f"{label}: err_pos finite and below {limit} cm")
    say(f"  K4 launches in phase 12: {launches}")
    say(f"  phase 12 wall {time.perf_counter() - t_phase:.1f} s")
    return launches


# --- phase 13: every controller in the batched protocol, the supervisors, render ---


def twin_of(env, name, engine, rng_mode, sigma_mode="ns"):
    """The batched twin of a CoVO solver at the main path's N, H and
    estimator (gn), on ``engine`` with ``rng_mode``."""
    from covo_mpc_tpu_torch.parallel import batched_controller

    return batched_controller(make_solver(env, engine, rng_mode=rng_mode, name=name,
                                          sigma_mode=sigma_mode)[0])


def episode_gens(dev, seed: int, B: int) -> list:
    return [torch.Generator(device=dev).manual_seed(seed * 1000 + b) for b in range(B)]


def tree_max_err(a, b) -> float:
    from covo_mpc_tpu_torch.models.structs import tree_flatten

    return max(max_err(x.float(), y.float())
               for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]))


def trees_equal(a, b) -> bool:
    from covo_mpc_tpu_torch.models.structs import tree_flatten

    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def act_factors(kind: str, carry, state):
    """The (a_covs, factors) a twin's step samples with: speculative's
    carried ones, offline's gathered at each episode's time."""
    if kind == "covo_speculative":
        return carry[1], carry[2]
    covs, facs = carry[1], carry[2]
    idx = torch.clamp(state.time, 0, covs.shape[1] - 1).long()
    b = torch.arange(covs.shape[0], device=idx.device)
    return covs[b, idx], facs[b, idx]


def captured_twin_step(twin, p, state, info, carry, gens):
    """One step of ``twin`` captured (its solve's streams and the episodes'
    generators registered) and replayed, against the eager step from the
    same stream states: (bit for bit, graph nodes, replay ms)."""
    from covo_mpc_tpu_torch.runtime import graphs

    def fn(state, info, carry):
        return twin(state, info, p, carry, gens, 0)

    streams = [*twin.random_streams(), *([] if twin.draws_from_keys else gens)]
    cap = graphs.capture(fn, state, info, carry, streams=streams)
    saved = [s.get_state() for s in streams]
    eager = fn(state, info, carry)
    for s, st in zip(streams, saved):
        s.set_state(st)
    replay = cap(state, info, carry)
    same = trees_equal(eager, replay)
    ms = time_ms(lambda: cap(state, info, carry), 5, warmup=1)
    return same, graph_nodes(cap), ms


def phase_twins(env, dev) -> None:
    """13a: the speculative and offline twins under kernel and fast rng, and
    the online twin with the ns and the eigh designer, at B=TWIN_B, N=8192,
    H=32."""
    from covo_mpc_tpu_torch.models.batched import BatchedEnv
    from covo_mpc_tpu_torch.models.structs import expand_params
    from covo_mpc_tpu_torch.parallel.scenarios import _shift, _solve_inputs

    B, p = TWIN_B, env.default_params
    _, info, state = BatchedEnv(env).reset(episode_gens(dev, 1, B), p)
    pb = expand_params(p, B)
    for name in ("covo_speculative", "covo_offline"):
        ref = twin_of(env, name, "torch", "fast")
        t0 = time.perf_counter()
        carry_t = ref.reset(B, state, p, episode_gens(dev, 2, B))
        torch.cuda.synchronize()
        say(f"  {name} torch twin's reset at B={B}: {time.perf_counter() - t0:.2f} s")
        for rng in ("fast", "kernel"):
            phase(f"phase 13a: the batched {name} twin, {rng} rng, B={B}, engine='cuda' "
                  "against engine='torch'")
            twin = twin_of(env, name, "cuda", rng)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            carry = twin.reset(B, state, p, episode_gens(dev, 2, B))
            torch.cuda.synchronize()
            err = tree_max_err(carry, carry_t)
            say(f"  reset {time.perf_counter() - t0:.2f} s, peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                f"max |cuda - torch| of the reset's carry {err:.3e}")
            check(err <= 2e-4, f"{name} {rng}: the twin's reset within 2e-4 of the torch twin's")
            if rng == "fast":
                a_c, new_c = twin(state, info, p, carry, episode_gens(dev, 3, B))
                a_t, new_t = ref(state, info, p, carry_t, episode_gens(dev, 3, B))
                errs = {"action": max_err(a_c, a_t), "carry": tree_max_err(new_c, new_t)}
            else:
                z = torch.randn(B, N, D, generator=torch.Generator(device=dev).manual_seed(4),
                                device=dev)
                covs, facs = act_factors(name, carry, state)
                args = (*_solve_inputs(state, info), _shift(carry[0]), covs, facs, pb)
                m_c, c_c, _ = twin.solve.sample_update(*args, z=z)
                m_t, c_t, _ = ref.solve.sample_update(*args, z=z)
                errs = {"a_mean": max_err(m_c, m_t), "costs": max_err(c_c, c_t)}
                a_c = m_c
            say(f"  one step, max |cuda - torch| on the same normals: {errs}")
            check(all(v <= 2e-4 for v in errs.values()) and bool(torch.isfinite(a_c).all()),
                  f"{name} {rng}: the batched step within 2e-4 of the torch twin's")
            same, nodes, ms = captured_twin_step(twin, p, state, info, carry,
                                                 episode_gens(dev, 5, B))
            say(f"  the twin's step captured: {nodes} graph nodes, replay {ms:.3f} ms")
            check(same, f"{name} {rng}: the captured step equals the eager step bit for bit")
    for sigma_mode in ("ns", "eigh"):
        phase(f"phase 13a: the batched CoVO online twin with sigma_mode={sigma_mode!r}, "
              f"fast rng, B={B}, engine='cuda' against engine='torch'")
        designer_step(env, dev, state, info, sigma_mode)


def designer_step(env, dev, state, info, sigma_mode: str) -> None:
    """13a's online twin with the ``sigma_mode`` designer (fast rng): its
    design (the batched Hessian, the designer) and step on the card's
    engine against the torch twin's on the same normals, taken apart: Σ,
    the costs, the action and the new mean (printed with the ESS of the
    scenario where it parts most), Σ and the action held to 2e-4 and the
    costs to K6's contract; the design repeated bit for bit; for eigh (not
    capturable) the batched Hessian's graph against the eager Hessian."""
    from covo_mpc_tpu_torch.models.structs import expand_params
    from covo_mpc_tpu_torch.parallel.scenarios import _inputs, _shift, _solve_inputs

    B, p = TWIN_B, env.default_params
    twin = twin_of(env, "covo_online", "cuda", "fast", sigma_mode=sigma_mode)
    ref = twin_of(env, "covo_online", "torch", "fast", sigma_mode=sigma_mode)
    check(twin.capturable == (sigma_mode != "eigh"),
          f"{sigma_mode} twin capturable: {twin.capturable} (eigh reads the host)")
    pb, means = expand_params(p, B), _shift(twin.reset(B))
    inputs = _solve_inputs(state, info)
    t0 = time.perf_counter()
    covs_c, facs_c = twin.solve.design(*inputs, means, pb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    covs_t, facs_t = ref.solve.design(*inputs, means, pb)
    again = twin.solve.design(*inputs, means, pb)
    z = torch.stack([torch.randn(N, D, generator=g, device=dev)
                     for g in episode_gens(dev, 6, B)])
    m_c, c_c, w_c = twin.solve.sample_update(*inputs, means, covs_c, facs_c, pb, z=z)
    m_t, c_t, _ = ref.solve.sample_update(*inputs, means, covs_t, facs_t, pb, z=z)
    errs = {"a_cov": max_err(covs_c, covs_t), "costs": max_err(c_c, c_t),
            "action": max_err(m_c[:, 0], m_t[:, 0]), "a_mean": max_err(m_c, m_t)}
    worst = int((m_c - m_t).abs().flatten(1).amax(dim=1).argmax())
    ess = 1.0 / (w_c ** 2).sum(dim=-1)
    say(f"  design {wall:.2f} s; max |cuda - torch|: {errs}; the mean parts most in "
        f"scenario {worst}, ESS {float(ess[worst]):.2f} (ESS over the batch "
        f"{float(ess.min()):.2f}-{float(ess.max()):.2f})")
    check(trees_equal(again, (covs_c, facs_c)), f"{sigma_mode}: the design repeats bit for bit")
    # BASELINE.md's per-solve contract (action and Σ) and K6's own (costs);
    # the rest of the mean follows the costs through the weights, which a
    # cost's last bits move where two samples share them (ESS near 2)
    check(errs["a_cov"] <= 2e-4 and errs["action"] <= 2e-4 and costs_close(c_c, c_t),
          f"{sigma_mode} twin: Σ and the action within 2e-4 of the torch twin's, the "
          "costs within atol 2e-4, rtol 1e-5")
    if sigma_mode == "eigh":
        hess = twin.solve._hessian
        h_args = (means.reshape(B, D), *_inputs(info["noisy_state"]), pb, None)
        same = torch.equal(hess(*h_args), hess.fn(*h_args))
        say(f"  its batched Hessian: replay "
            f"{time_ms(lambda: hess(*h_args), 5, warmup=1):.3f} ms against eager "
            f"{time_ms(lambda: hess.fn(*h_args), 3, warmup=1):.3f} ms")
        check(same, "eigh twin: the graphed batched Hessian equals the eager one bit for bit")


def hessian_graph_row(env, solve, info, means, keys) -> None:
    """The fwd_fwd batched Hessian of ``solve`` (parity, eigh) as one graph
    on the inputs of the solve that follows it (B scenarios of ``info``, the
    nominals of ``means``, the draws of ``keys``): capture s, replay ms,
    graph nodes, peak memory; that solve then replays the graph."""
    from covo_mpc_tpu_torch.models.structs import expand_params
    from covo_mpc_tpu_torch.ops.rollout import hessian_draws_from_key
    from covo_mpc_tpu_torch.parallel.scenarios import _shift, _solve_inputs

    B = keys.shape[0]
    args = (_shift(means).reshape(B, D), *_solve_inputs(None, info),
            expand_params(env.default_params, B), hessian_draws_from_key(env, keys, H))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    R = solve._hessian(*args)
    torch.cuda.synchronize()
    cap_s = time.perf_counter() - t0
    nodes = graph_nodes(next(iter(solve._hessian._captured.values())))
    say(f"  fwd_fwd batched Hessian, B={B}: captured in {cap_s:.1f} s, {nodes} nodes, "
        f"replay {time_ms(lambda: solve._hessian(*args), 5, warmup=1):.3f} ms, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, finite "
        f"{bool(torch.isfinite(R).all())}")


def batched_run(env, label, solver, kernels_used, kernel_list, limit):
    """``evaluate_batched(num_eps=TWIN_B, seed=1)`` (counts at 0 just before
    it), finite and below ``limit``, each of ``kernels_used`` launched:
    (result, counts)."""
    res, launches, _ = protocol_run(env, label, solver, kernel_list)
    check(bool(torch.isfinite(res.err_pos_ep).all()) and res.mean * 100 < limit,
          f"{label}: no failed episode, err_pos below {limit} cm")
    for k in kernels_used:
        check(launches[k.symbol] > 0, f"{label}: {k.symbol} launched")
    return res, launches


def phase_batched_modes(env, dev, kernel_list, refs: dict) -> dict:
    """Phase 13 (the module docstring); returns each kernel's launches in
    its runs. ``refs`` holds phase 5e's MPPI row and phase 12d's MPPI parity
    loop; a missing one (``--phase13``) is run here."""
    import tempfile

    from covo_mpc_tpu_torch.models.batched import BatchedEnv
    from covo_mpc_tpu_torch.models.structs import expand_params, index, tree_flatten
    from covo_mpc_tpu_torch.ops import rollout_cuda
    from covo_mpc_tpu_torch.parallel import make_batched_covo_solve
    from covo_mpc_tpu_torch.parallel.scenarios import _solve_inputs
    from covo_mpc_tpu_torch.runtime import debug, evaluate, render_episode, run_supervised
    from covo_mpc_tpu_torch.runtime.episode import batched_keys
    from covo_mpc_tpu_torch.solvers import get_solver

    t_phase = time.perf_counter()
    k4, k6 = rollout_cuda.ROLLOUT_KERNEL, rollout_cuda.ROLLOUT_BATCHED_KERNEL
    k7j = rollout_cuda.JOINT_BATCHED_KERNEL
    launches = {k4.symbol: {}, k6.symbol: {}, k7j.symbol: {}}
    p = env.default_params
    pstr = f"N{N}_H{H}_lam0.01"
    phase_twins(env, dev)
    t_a = time.perf_counter() - t_phase

    phase(f"phase 13b: evaluate_batched(num_eps={TWIN_B}, seed=1), captured, the new twins")
    if "5e mppi" not in refs:
        refs["5e mppi"] = protocol_run(env, "MPPI (kernel rng), the 5e row",
                                       make_mppi(env, "cuda")[0], kernel_list)[0]
    mppi_5e = refs["5e mppi"].mean
    runs = {"speculative (gn, ns, kernel rng: K7 joint)": (
                make_solver(env, "cuda", name="covo_speculative")[0], k7j),
            "offline (gn, ns, fast rng: K6)": (
                make_solver(env, "cuda", rng_mode="fast", name="covo_offline")[0], k6)}
    for label, (solver, kernel) in runs.items():
        res, counts = batched_run(env, label, solver, [kernel], kernel_list,
                                  ERR_POS_LIMIT_CM)
        launches[kernel.symbol][f"13b {label}"] = counts[kernel.symbol]
        check(res.mean < mppi_5e, f"{label}: err_pos below MPPI's phase-5e row "
              f"({100 * mppi_5e:.2f} cm)")

    phase("phase 13c: JAX's key schedule in the batched protocol (MPPI parity: K6, nhd)")
    mppi_parity = get_solver(env, "mppi", pstr, rng_mode="parity", engine="cuda",
                             collect_debug=False)[0]
    reset_keys, run_keys = batched_keys(1, 0, TWIN_B, dev)
    _, info_b, states = BatchedEnv(env).reset(reset_keys, p)
    same = all(trees_equal(index(states, b), env.reset(reset_keys[b], p)[2])
               for b in range(TWIN_B))
    check(same, "each episode's reset state equals the single keyed reset's bit for bit")
    res, counts = batched_run(env, "MPPI parity", mppi_parity, [k6], kernel_list,
                              MPPI_ERR_POS_LIMIT_CM)
    launches[k6.symbol]["13c MPPI parity"] = counts[k6.symbol]
    solve = make_batched_covo_solve(env, N, H, 0.01, rng="parity", hessian_mode="fwd_fwd",
                                    engine="cuda", sigma_mode="eigh")
    single, cp = get_solver(env, "covo_online", pstr, rng_mode="parity", engine="cuda",
                            collect_debug=False)
    keys = first_rng_act(run_keys[:2])
    info2 = {"noisy_state": index(info_b["noisy_state"], slice(0, 2))}
    a_means = cp.a_mean.expand(2, H, 4).contiguous()
    hessian_graph_row(env, solve, info2, a_means, keys)
    say("  one full-width batched CoVO parity solve (fwd_fwd, eigh), B=2, against the "
        "single parity solve of each episode")
    means, _ = solve(*_solve_inputs(None, info2), a_means, expand_params(p, 2), key=keys)
    errs = []
    for b in range(2):
        one = index(info2, b)
        _, cp_b, _ = single(None, one["noisy_state"], p, cp, one, key=keys[b])
        errs.append(max_err(means[b], cp_b.a_mean))
    say(f"  max |batched - single| of the new means: {errs}")
    check(max(errs) <= 2e-4, "batched CoVO parity solve within 2e-4 of the single solves")

    phase(f"phase 13d: run_supervised(MPPI parity, total_steps={KEY_MPPI_STEPS}, "
          "chunk_episodes=1) with a fault injected at chunk 1")
    if "12d mppi parity" not in refs:
        refs["12d mppi parity"] = closed_loop(env, mppi_parity, KEY_MPPI_STEPS,
                                              kernel_list)[0]
    ref = refs["12d mppi parity"]
    faults = []

    def fault(chunk, attempt):
        if chunk == 1 and attempt == 0:
            faults.append(chunk)
            raise RuntimeError("injected fault at chunk 1")

    for k in kernel_list:
        k.launches = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckpt:
        sup = run_supervised(env, mppi_parity, total_steps=KEY_MPPI_STEPS, seed=1,
                             checkpoint_dir=ckpt, chunk_episodes=1, max_retries=1,
                             _fault_hook=fault)
    launches[k4.symbol]["13d supervised MPPI parity"] = k4.launches
    say(f"  {sup.summary()} in {time.perf_counter() - t0:.1f} s; phase 12d's evaluate "
        f"{ref.summary()}; events {[e['kind'] for e in sup.events]}")
    check(faults == [1] and torch.equal(sup.err_pos_ep.float(), ref.err_pos_ep),
          "the supervised run, retried after the fault, equals phase 12d's evaluate bit "
          "for bit")

    phase("phase 13e: render_episode(MPPI parity), 300 steps, captured, against eager")
    for k in kernel_list:
        k.launches = 0
    t0 = time.perf_counter()
    trace = render_episode(env, mppi_parity, seed=1)
    launches[k4.symbol]["13e render MPPI parity"] = k4.launches
    wall = time.perf_counter() - t0
    with debug.debug_mode(nans=False):
        eager = render_episode(env, mppi_parity, seed=1, steps=RENDER_CHECK_STEPS)
    same = all(np.array_equal(trace[k][:RENDER_CHECK_STEPS], v) for k, v in eager.items())
    finite = all(np.isfinite(v).all() for v in trace.values() if v.dtype.kind == "f")
    say(f"  {wall:.1f} s, mean err_pos {100 * float(trace['err_pos'].mean()):.2f} cm, "
        f"finite {finite}; the first {RENDER_CHECK_STEPS} steps equal eager: {same}")
    check(finite and trace["err_pos"].shape == (300,), "render: 300 finite steps")
    check(same, f"render: the captured recorder equals the eager one over the first "
          f"{RENDER_CHECK_STEPS} steps bit for bit")
    say(f"  launches in phase 13: {launches}")
    say(f"  phase 13 wall {time.perf_counter() - t_phase:.1f} s (13a {t_a:.1f} s)")
    return launches


# --- phase 14: the parallel layer on torch.distributed ---------------------------
# 14b's scenario count (phase 5's B), 14c's pipeline steps and its sample
# count, a rank's share of N in the per-shard kernel checks (two ranks)
MESH_B, PIPE_STEPS, TWO_RANK_N, SHARD_N = 16, 20, N, N // 2
MESH_AXES = ["offline_schedule", "pipe", "samples", "scenarios"]  # bench_mesh's lines


def count_launches(kernel_list, label: str, launches: dict) -> None:
    """Add every kernel's count since the last reset to ``launches[symbol]
    [label]``, then set the counts to 0."""
    for k in kernel_list:
        launches.setdefault(k.symbol, {})[label] = (
            launches.get(k.symbol, {}).get(label, 0) + k.launches)
        k.launches = 0


def reset_counts(kernel_list) -> None:
    for k in kernel_list:
        k.launches = 0


def mesh_inputs(env, dev):
    """The single-scenario inputs of 14a and 14c: the reset state of key 0,
    the default params, the hover mean, MPPI's σ² I and its factor, JAX's
    key 21 and its solve chain's (act_key, step_key)."""
    from covo_mpc_tpu_torch.models import pack_state
    from covo_mpc_tpu_torch.parallel.sharded import act_step_keys
    from covo_mpc_tpu_torch.solvers.factory import DEFAULT_SIGMA, hover_sequence
    from covo_mpc_tpu_torch.utils import prng

    _, _, st = env.reset(prng.PRNGKey(0, device=dev))
    key = prng.PRNGKey(21, device=dev)
    cov = (DEFAULT_SIGMA ** 2 * torch.eye(4, device=dev)).expand(H, 4, 4).contiguous()
    return types.SimpleNamespace(
        st=st, x=(pack_state(st), st.time, st.pos_traj, st.vel_traj),
        p=env.default_params, hover=hover_sequence(env, H), cov=cov, key=key,
        keys=act_step_keys(key))


def scenario_inputs(dev):
    """14b's and 14c's B=MESH_B randomized scenarios (phase 5's DR env),
    each params and reset from its own JAX key, and the step's keys."""
    from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv
    from covo_mpc_tpu_torch.scripts.bench_mesh import scenario_batch
    from covo_mpc_tpu_torch.utils import prng

    env_dr = QuadEnv(EnvConfig(**{**ENV_KW, "enable_randomizer": True}), device=dev)
    states, params_b, _ = scenario_batch(env_dr, MESH_B, key=1)
    a_means, a_covs = initial_means(env_dr, MESH_B)
    return env_dr, states, params_b, a_means, a_covs, prng.split(
        prng.PRNGKey(31, device=dev), MESH_B)


def phase_shard_kernels(env, dev, records) -> None:
    """14 (kernels): what a rank of a two-rank sharded solve launches, at its
    share n = SHARD_N of the main path's N: K1, K4 and K5, and K6 and both
    K7 forms at B=MESH_B, against their plain versions on given normals
    (:func:`check_rollout_kernels`), and their in-kernel draws at n (the
    first n samples of an N launch: :func:`check_small_draws`). Kept in
    each record's ``per_shard`` (None: not kept)."""
    from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv

    phase(f"phase 14 (kernels): K1, K4-K7 at a rank's share n={SHARD_N} of N={N} (two "
          f"ranks), H={H}, B={MESH_B}, against their plain versions")
    env_b = QuadEnv(EnvConfig(**{**ENV_KW, "enable_randomizer": True}))
    inp = mode_kernel_inputs(dev, 140, n=SHARD_N, B=MESH_B)
    case = mode_case(env, env_b, dev, 141, B=MESH_B)
    errs = check_rollout_kernels(f"n={SHARD_N}", inp, case)
    check_small_draws(inp, case)
    say(f"  n={SHARD_N} max abs errors: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    if records is not None:
        for name, err in errs.items():
            records[name]["per_shard"] = {"n": SHARD_N, "max_abs_err": err}


def phase_mesh_solves(env, dev, kernel_list, launches):
    """14a: one rank under an initialized NCCL group: sharded MPPI (K5 under
    kernel rng, K4 under invariant) and the distributed CoVO solve (gn: K2,
    K3 and K1 under kernel, K4 under invariant) against the single-device
    solvers, eager and captured. Returns the captured calls and their
    references to time later (:func:`capture_references`) and the
    distributed solves' means (14c's references)."""
    from covo_mpc_tpu_torch.parallel import (
        make_distributed_covo_solve,
        make_mesh,
        make_sharded_mppi_solve,
    )
    from covo_mpc_tpu_torch.parallel.sharded import act_step_keys
    from covo_mpc_tpu_torch.runtime import graphs

    phase("phase 14a: one rank under an NCCL group: the sharded MPPI and distributed CoVO "
          "solves against the single-device solvers, eager and captured")
    mesh = make_mesh(1, device=dev)
    check(mesh.backend == "nccl" and mesh.axis("samples").group is not None,
          f"a one-rank mesh under NCCL runs real collectives ({mesh})")
    m = mesh_inputs(env, dev)
    act_key, step_key = m.keys
    draw = env.disturb_from_key(step_key, fast=True)
    out, caps, t_a = {}, {}, time.perf_counter()
    for rng in ("kernel", "invariant"):
        mppi, cp = make_mppi(env, "cuda", seed=5, rng_mode=rng)
        kw = dict(draw=draw) if rng == "kernel" else dict(key=m.key)
        ref = mppi(None, m.st, m.p, cp, None, **kw)[1].a_mean
        make = lambda capture: make_sharded_mppi_solve(  # noqa: E731
            env, mesh, N, H, 0.01, rng=rng, engine="cuda", seed=5, capture=capture)
        args = (*m.x, cp.a_mean, cp.a_cov, cp.gamma_mean, cp.gamma_sigma, cp.discount,
                m.p, act_key, step_key)
        reset_counts(kernel_list)
        got = make(False)(*args)
        count_launches(kernel_list, f"14a sharded MPPI {rng}", launches)
        cap = make(True)
        again = cap(*args)
        err = max_err(got[0], ref)
        tol = 2e-4 if rng == "kernel" else 1e-5
        say(f"  sharded MPPI, {rng} rng: max |sharded - single| of the new mean {err:.3e}; "
            f"captured: {graph_nodes(cap.graph)} graph nodes")
        check(err <= tol, f"sharded MPPI {rng}: within {tol:g} of the single MPPI solve")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"sharded MPPI {rng}: the captured replay equals the eager solve bit for bit")
        timed = cap.graph
        if rng == "invariant":
            # the single solve splits its key inside its graph; so does the
            # sharded one that is timed beside it
            timed = graphs.capture(lambda k, s=cap: s.solve(*args[:-2], *act_step_keys(k)),
                                   m.key, streams=cap.random_streams())
        caps[f"mppi {rng}"] = (timed, mppi, cp, kw)

        covo, ccp = make_solver(env, "cuda", seed=5, rng_mode=rng)
        ccp = ccp.replace(a_mean=m.hover)
        ckw = dict(key=m.key) if rng == "invariant" else {}
        ref = covo(None, m.st, m.p, ccp, None, **ckw)[1].a_mean
        make = lambda capture: make_distributed_covo_solve(  # noqa: E731
            env, mesh, N, H, 0.01, sample_sigma=ccp.sample_sigma, rng=rng,
            hessian_mode="gn", engine="cuda", seed=5, capture=capture)
        args = (*m.x, m.hover, m.p, m.key, ccp.gamma_mean, ccp.discount)
        reset_counts(kernel_list)
        got = make(False)(*args)
        count_launches(kernel_list, f"14a distributed CoVO {rng}", launches)
        cap = make(True)
        again = cap(*args)
        err = max_err(got[0], ref)
        say(f"  distributed CoVO (gn), {rng} rng: max |distributed - single| of the new "
            f"mean {err:.3e}; captured: {graph_nodes(cap.graph)} graph nodes")
        check(err <= tol, f"distributed CoVO {rng}: within {tol:g} of the single CoVO solve")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"distributed CoVO {rng}: the captured replay equals the eager solve bit "
              "for bit")
        caps[f"covo {rng}"] = (cap.graph, covo, ccp, ckw)
        out[f"covo {rng}"] = got[0]
    refs = capture_references(env, dev, mesh, caps)
    say(f"  14a checks {time.perf_counter() - t_a:.1f} s")
    return caps, refs, out


def capture_references(env, dev, mesh, caps: dict):
    """14a's references for the timing: each single-device solve captured
    on the same inputs (the MPPI draw from the step key inside its graph,
    as the sharded solve draws it) and a graph of the three all-reduces
    alone at the solve's shapes (a MIN and a SUM of a scalar, a SUM of (H,
    4))."""
    from covo_mpc_tpu_torch.runtime import graphs

    m = mesh_inputs(env, dev)

    def single(solver, kw):
        def call(st, p, cp):
            if "draw" in kw:
                return solver(None, st, p, cp, None,
                              draw=env.disturb_from_key(m.keys[1], fast=True))
            return solver(None, st, p, cp, None, **kw)
        return call

    refs = {name: graphs.capture(single(solver, kw), m.st, m.p, cp,
                                 streams=solver.random_streams())
            for name, (_, solver, cp, kw) in caps.items()}
    ax = mesh.axis("samples")
    refs["collectives"] = graphs.capture(
        lambda a, b, c: (ax.pmin(a), ax.psum(b), ax.psum(c)),
        torch.zeros((), device=dev), torch.ones((), device=dev),
        torch.ones(H, 4, device=dev))
    return refs


def time_mesh_solves(caps, refs) -> None:
    """14a's timing, after graphs.settle(): ms a captured solve replayed
    back to back, sharded at one rank and the single-device solve in turns
    (sharded, single, single, sharded), each pair doing the same work (the
    sharded MPPI invariant solve's graph splits its key, as the single
    solve's does), and the three all-reduces alone."""
    from covo_mpc_tpu_torch.runtime import graphs

    phase("phase 14a (timing): captured solves, one rank under NCCL against the "
          "single device")
    slept = graphs.settle()
    for name, (timed, _, _, _) in caps.items():
        times = {"sharded": [], "single": []}
        for which in ("sharded", "single", "single", "sharded"):
            graph = timed if which == "sharded" else refs[name]
            times[which].append(time_ms(graph.replay, 200, warmup=10))
        sharded, alone = (sum(times[k]) / 2 for k in ("sharded", "single"))
        say(f"  {name}: {sharded:.4f} ms a captured sharded solve (one rank, NCCL; "
            f"{graph_nodes(timed)} nodes), {alone:.4f} ms the single-device solve "
            f"({graph_nodes(refs[name])} nodes); difference {sharded - alone:+.4f} ms "
            f"(turns {[round(t, 4) for k in times for t in times[k]]})")
    coll = time_ms(refs["collectives"].replay, 500, warmup=20)
    say(f"  the three all-reduces alone, captured ({graph_nodes(refs['collectives'])} "
        f"nodes): {coll:.4f} ms (settled {slept:.1f} s)")


def phase_multichip(env, dev, kernel_list, launches) -> dict:
    """14b: the multichip control and CoVO steps at B=MESH_B on one rank
    (NCCL) against the batched twin of the same solver on the same keys;
    K6 (invariant) and K7 (kernel) launched; the kernel-rng CoVO step
    captured equal to its eager step bit for bit."""
    from covo_mpc_tpu_torch.ops import sampling
    from covo_mpc_tpu_torch.ops.rollout import hessian_draws_from_key
    from covo_mpc_tpu_torch.parallel import (
        make_batched_covo_solve,
        make_batched_mppi_solve,
        make_mesh,
        make_multichip_control_step,
        make_multichip_covo_step,
    )
    from covo_mpc_tpu_torch.parallel.scenarios import _inputs, _shift
    from covo_mpc_tpu_torch.utils import prng

    phase(f"phase 14b: the multichip control and CoVO steps at B={MESH_B}, one rank "
          "under NCCL, against the batched twins on the same keys")
    mesh = make_mesh(1, 1, device=dev)
    env_dr, states, pb, a_means, a_covs, keys = scenario_inputs(dev)
    x = _inputs(states)
    out = {}
    for rng in ("kernel", "invariant"):
        twin_rng = "kernel" if rng == "kernel" else "fast"
        split = prng.split(keys, 4)
        act_keys, step_keys = split[:, 1], split[:, 2]
        draws = env_dr.disturb_from_key(step_keys, fast=True)
        z = (None if rng == "kernel" else
             sampling.std_normal_invariant(act_keys, N, (H, 4)))
        twin = make_batched_mppi_solve(env_dr, N, H, 0.01, rng=twin_rng, engine="cuda",
                                       seed=9)
        ref, _, _ = twin(*x, a_means, a_covs, pb, 1.0, 0.0, 1.0, z=z, draws=draws,
                         offset=0 if rng == "kernel" else None)
        step = make_multichip_control_step(env_dr, mesh, N, H, 0.01, rng=rng, engine="cuda",
                                           seed=9)
        reset_counts(kernel_list)
        got = step(states, pb, a_means, a_covs, keys)
        count_launches(kernel_list, f"14b multichip MPPI {rng}", launches)
        err = max_err(got[1], ref)
        say(f"  multichip MPPI step, {rng} rng: max |multichip - batched twin| {err:.3e}; "
            f"time {int(got[0].time.min())}..{int(got[0].time.max())}")
        check(err <= 2e-4 and bool(torch.isfinite(got[3]).all()),
              f"multichip MPPI {rng}: within 2e-4 of the batched MPPI solve, finite rewards")

        split = prng.split(keys, 5)
        hess_keys, act_keys, step_keys = split[:, 1], split[:, 2], split[:, 3]
        twin = make_batched_covo_solve(env_dr, N, H, 0.01, rng=twin_rng, hessian_mode="gn",
                                       engine="cuda", seed=9)
        means = _shift(a_means)
        covs, facs = twin.design(*x, means, pb,
                                 hess_draws=hessian_draws_from_key(env_dr, hess_keys, H))
        z = (None if rng == "kernel" else
             sampling.std_normal_invariant(act_keys, N, (4 * H,)))
        ref, _, _ = twin.sample_update(
            *x, means, covs, facs, pb, z=z,
            draws=env_dr.disturb_from_key(step_keys, deterministic=True, fast=True),
            offset=0 if rng == "kernel" else None)
        make = lambda capture: make_multichip_covo_step(  # noqa: E731
            env_dr, mesh, N, H, 0.01, rng=rng, hessian_mode="gn", engine="cuda", seed=9,
            capture=capture)
        reset_counts(kernel_list)
        got = make(False)(states, pb, a_means, keys)
        count_launches(kernel_list, f"14b multichip CoVO {rng}", launches)
        err = max_err(got[1], ref)
        say(f"  multichip CoVO step (gn), {rng} rng: max |multichip - batched twin| "
            f"{err:.3e}")
        check(err <= 2e-4 and bool(torch.isfinite(got[2]).all()),
              f"multichip CoVO {rng}: within 2e-4 of the batched CoVO solve's design + "
              "sample_update, finite rewards")
        out[rng] = got[1]
        if rng == "kernel":
            cap = make(True)
            again = cap(states, pb, a_means, keys)
            same = all(torch.equal(a, b) for a, b in zip(flat(got), flat(again)))
            ms = time_ms(cap.graph.replay, 20, warmup=3)
            say(f"  captured multichip CoVO step: {graph_nodes(cap.graph)} graph "
                f"nodes, replay {ms:.3f} ms ({MESH_B / ms * 1e3:.0f} solves/s)")
            check(same, "the captured multichip CoVO step equals the eager step bit for bit")
    for sym, what in (("rollout_costs_batched", "invariant"),
                      ("sample_rollout_batched", "kernel"),
                      ("joint_sample_rollout_batched", "kernel")):
        n = sum(v for k, v in launches[sym].items() if k.startswith("14b") and what in k)
        check(n >= 1, f"{sym} launched in 14b's {what} steps ({n})")
    return out


def flat(tree) -> list:
    from covo_mpc_tpu_torch.models.structs import tree_flatten

    return tree_flatten(tree)[0]


def pipeline_oracle(env, m, n: int, seed: int):
    """The pipeline step's semantics with its stages one after the other,
    from the building blocks and independent of ``parallel/pipeline.py``'s
    step and act core: act with LAST step's factor (K1's wrapper on a seed
    stream seeded as the pipeline's, its one word a step; the weights and
    mean update of ``ops/reductions.py``), then design at the state one
    deterministic model step along the PRE-update shifted mean (K2 + K3
    under the Gauss–Newton Hessian, the Newton–Schulz designer). Returns
    ``step(a_mean, factor, key) -> (a_mean_new, factor_next, min_cost)``."""
    from covo_mpc_tpu_torch.ops import covariance, reductions, sampling
    from covo_mpc_tpu_torch.ops.hessian import make_hessian_adjoint
    from covo_mpc_tpu_torch.ops.rollout import hessian_draws_from_key
    from covo_mpc_tpu_torch.ops.rollout_cuda import make_rollout_joint_sampling
    from covo_mpc_tpu_torch.parallel.pipeline import predict_next_state
    from covo_mpc_tpu_torch.utils import prng

    k1 = make_rollout_joint_sampling(env)
    hess = make_hessian_adjoint(env, H, primal="cuda", tail="cuda", second_order=False)
    seeds = sampling.SeedStream(m.x[0].device, seed)
    x0, t0, pos_traj, vel_traj = m.x

    def step(a_mean, factor, key):
        mean = torch.cat([a_mean[1:], a_mean[-1:]])
        k_act, k_step, k_prep = prng.split(key, 3).unbind(-2)
        draw = env.disturb_from_key(k_step, deterministic=True, fast=True)
        costs, a_t = k1(*m.x, mean, factor, m.p, seeds.next()[0], n, draw=draw,
                        deterministic=True)
        a_new = reductions.mean_update_t(reductions.mppi_weights(costs, 0.01),
                                         a_t.reshape(H, 4, n), mean, 1.0)
        x1 = predict_next_state(env, x0, t0, mean, m.p, k_prep)
        R = hess(torch.cat([mean[1:], mean[-1:]]).reshape(-1), x1, t0 + 1, pos_traj,
                 vel_traj, m.p, hessian_draws_from_key(env, k_prep, H))
        return a_new, covariance.optimize_sigma_ns(R, 0.5, D)[1], torch.amin(costs)

    return step


def two_rank_checks(rank: int, n: int, expect: dict) -> dict:
    """14c, on each of two ranks sharing the card (gloo): the distributed
    CoVO solve on (samples=2, scenarios=1) and the multichip CoVO step on
    (2, 1) and (1, 2) (invariant rng, gn) against ``expect`` (14a / 14b's
    one-rank results), the pipeline for PIPE_STEPS steps (kernel rng: K1
    acts, K2 + K3 design) against :func:`pipeline_oracle` on the same keys,
    the distributed offline schedule against the single-device reset, and
    ``bench_mesh --distributed`` joining the job. Every run under test has
    the counts set to 0 just before it and read just after, under its own
    label; the references' launches are not counted. Returns the errors,
    wall times, launches by label and bench_mesh's rows."""
    from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv
    from covo_mpc_tpu_torch.ops import kernels as _kernels  # noqa: F401
    from covo_mpc_tpu_torch.ops import hessian_cuda, rollout_cuda
    import contextlib
    import io

    from covo_mpc_tpu_torch.parallel import (
        SCENARIO_AXIS,
        device_topology,
        make_distributed_covo_solve,
        make_distributed_offline_schedule,
        make_init_factor,
        make_mesh,
        make_multichip_covo_step,
        make_pipeline_mesh,
        make_pipeline_step,
    )
    from covo_mpc_tpu_torch.scripts import bench_mesh
    from covo_mpc_tpu_torch.solvers import get_solver
    from covo_mpc_tpu_torch.utils import prng

    dev = torch.device("cuda", 0)  # the card both ranks share
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel_list = [rollout_cuda.JOINT_KERNEL, rollout_cuda.PRIMAL_KERNEL,
                   hessian_cuda.CHAIN_KERNEL, rollout_cuda.ROLLOUT_KERNEL,
                   rollout_cuda.SAMPLE_KERNEL, rollout_cuda.ROLLOUT_BATCHED_KERNEL,
                   rollout_cuda.SAMPLE_BATCHED_KERNEL, rollout_cuda.JOINT_BATCHED_KERNEL]
    env = QuadEnv(EnvConfig(**ENV_KW), device=dev)
    m = mesh_inputs(env, dev)
    out, walls, launches = {}, {}, {}

    def run(label, fn):
        """``fn()`` with every count at 0 just before it, read just after
        into ``launches`` under ``label`` (added up over repeated runs)."""
        reset_counts(kernel_list)
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        walls[label] = walls.get(label, 0.0) + time.perf_counter() - t0
        count_launches(kernel_list, label, launches)
        return result

    mesh = make_mesh(samples=2, device=dev)
    solve = make_distributed_covo_solve(env, mesh, n, H, 0.01, rng="invariant",
                                        hessian_mode="gn", engine="cuda")
    got = run("distributed CoVO (2, 1)", lambda: solve(*m.x, m.hover, m.p, m.key)[0])
    out["distributed CoVO (2, 1)"] = max_err(got.cpu(), expect["covo"])

    env_dr, states, pb, a_means, _, keys = scenario_inputs(dev)
    for samples, scenarios in ((2, 1), (1, 2)):
        mesh = make_mesh(samples, scenarios, device=dev)
        step = make_multichip_covo_step(env_dr, mesh, n, H, 0.01, rng="invariant",
                                        hessian_mode="gn", engine="cuda")
        shard = lambda x: mesh.shard(x, SCENARIO_AXIS)  # noqa: E731
        label = f"multichip CoVO ({samples}, {scenarios})"
        got = run(label, lambda: step(shard(states), shard(pb), shard(a_means),
                                      shard(keys))[1])
        out[label] = max_err(mesh.gather(got, SCENARIO_AXIS).cpu(), expect["multichip"])

    mesh = make_pipeline_mesh(device=dev)
    pipe = make_pipeline_step(env, mesh, n, H, 0.01, rng="kernel", hessian_mode="gn",
                              engine="cuda", seed=3)
    oracle = pipeline_oracle(env, m, n, seed=3)
    f0 = make_init_factor(env, H, hessian_primal="cuda", hessian_mode="gn")(
        *m.x, m.hover, m.p, prng.PRNGKey(4, device=dev))
    a, f, a_o, f_o, errs = m.hover, f0, m.hover, f0, []
    for t in range(PIPE_STEPS):
        key = prng.fold_in(prng.PRNGKey(5, device=dev), t)
        a, f, mc = run("pipeline", lambda: pipe(*m.x, a, f, m.p, key))  # noqa: B023
        a_o, f_o, mc_o = oracle(a_o, f_o, key)
        errs.append(max(max_err(a, a_o), max_err(f, f_o), abs(float(mc - mc_o))))
    out["pipeline vs stage-sequential oracle"] = max(errs)

    mesh = make_mesh(samples=2, device=dev)
    solver, cp0 = get_solver(env, "covo_offline", f"N{n}_H{H}_lam0.01",
                             rng_mode="invariant", hessian_mode="gn", sigma_mode="ns",
                             engine="cuda", collect_debug=False)
    okey = prng.PRNGKey(7, device=dev)
    schedule = make_distributed_offline_schedule(solver, mesh)
    got = run("offline schedule", lambda: schedule(m.st, m.p, cp0, okey))
    ref = solver.reset(m.st, m.p, cp0, key=okey)
    out["offline schedule vs single reset"] = max(
        max_err(got.a_cov_offline, ref.a_cov_offline),
        max_err(got.a_factor_offline, ref.a_factor_offline))

    # bench_mesh joins this job through the launcher contract (--distributed)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        run("bench_mesh --distributed", lambda: bench_mesh.main(
            ["--distributed", "--backend", "gloo", "--k", "1", "--hessian", "gn",
             "--rng", "kernel", "--scenarios", "2", "--b", str(MESH_B), "--offline",
             "--pipeline", "--device", dev.type]))
    rows = [json.loads(line) for line in text.getvalue().splitlines()
            if line.startswith("{")]
    return dict(errors=out, walls=walls, launches=launches,
                topology=device_topology(dev), bench_rows=rows)


def phase_two_ranks(kernel_list, launches, expect: dict) -> None:
    """14c: two ranks on the one card (two processes, gloo), the results
    equal to 14a / 14b's one-rank results and to the stage-sequential and
    single-device runs within 1e-5; each rank's launches kept by run and
    rank; wall times printed as plumbing."""
    from covo_mpc_tpu_torch.parallel import run_ranks

    phase(f"phase 14c: two ranks on the one card (gloo), N={TWO_RANK_N}: the distributed "
          "CoVO solve, the multichip CoVO step, the pipeline, the offline schedule and "
          "bench_mesh --distributed")
    t0 = time.perf_counter()
    outs = run_ranks(two_rank_checks, 2, TWO_RANK_N,
                     {k: v.cpu() for k, v in expect.items()}, backend="gloo",
                     timeout_s=300)
    wall = time.perf_counter() - t0
    for rank, o in enumerate(outs):
        say(f"  rank {rank} {o['topology']}: max errors {o['errors']}")
        say(f"  rank {rank} wall s (plumbing: two ranks share one card under gloo, "
            f"their collectives staged through the host): "
            + ", ".join(f"{k} {v:.2f}" for k, v in o["walls"].items()))
        for sym, by in o["launches"].items():
            for label, n in by.items():
                launches.setdefault(sym, {})[f"14c {label}, rank {rank}"] = n
        for name, err in o["errors"].items():
            check(err <= 1e-5, f"rank {rank}: {name} within 1e-5")
    for sym, want in (("joint_sample_rollout", "pipeline, rank 0"),
                      ("primal", "pipeline, rank 1"), ("sens_chain", "pipeline, rank 1"),
                      ("rollout_costs", "distributed CoVO (2, 1), rank 0"),
                      ("rollout_costs_batched", "multichip CoVO (2, 1), rank 0")):
        n = launches.get(sym, {}).get(f"14c {want}", 0)
        check(n >= 1, f"{sym} launched in 14c's {want} ({n})")
    rows = outs[0]["bench_rows"]
    for r in rows:
        say(f"  bench_mesh --distributed (2 processes): {json.dumps(r)}")
    check(not outs[1]["bench_rows"] and sorted(r["axis"] for r in rows) == MESH_AXES
          and all(r.get("shards", r.get("chips")) == 2 and r["plumbing"]
                  and r["device"]["power_limit"] for r in rows),
          f"bench_mesh --distributed in the two-rank job: rank 0 prints a line for each of "
          f"{MESH_AXES} (2 ranks, plumbing, the card's power limit)")
    say(f"  14c wall {wall:.1f} s (the ranks' start, CUDA contexts and kernel loads "
        "included; plumbing)")


def phase_pod_block(kernel_list, launches) -> None:
    """14d: pod_scale's per-rank block of config #5 (1024 scenarios over 8
    ranks: B=128, N, H, kernel rng, K7 joint), captured, against
    hbm_arithmetic; then bench_mesh in this process, one line a mode at one
    rank (its two-rank lines come from 14c's job), its launches counted."""
    import contextlib
    import io
    import tempfile

    from covo_mpc_tpu_torch.scripts import bench_mesh, pod_scale

    phase(f"phase 14d: the pod block (config #5 at one rank: B="
          f"{pod_scale.POD_SCENARIOS // pod_scale.POD_RANKS}, N={N}, H={H}, kernel rng) "
          "and bench_mesh")
    args = pod_scale.build_parser().parse_args(["--block", "--k", "2"])
    reset_counts(kernel_list)
    rec = pod_scale.block(args)["block"]
    count_launches(kernel_list, "14d pod block", launches)
    say(f"  {json.dumps(rec)}")
    check(rec["ms_per_step"] > 0 and rec["peak_gib"] < rec["card_gib"],
          f"pod block: {rec['ms_per_step']:.2f} ms a step, peak {rec['peak_gib']:.2f} GiB "
          f"(estimate {rec['estimate_gib']:.2f} GiB)")
    check(launches["joint_sample_rollout_batched"]["14d pod block"] >= 1,
          "K7 joint launched in the pod block")
    with tempfile.TemporaryDirectory() as d:
        argv = ["--k", "1", "--hessian", "gn", "--rng", "kernel", "--samples", "1",
                "--scenarios", "1", "--b", str(MESH_B), "--offline",
                "--metrics", f"{d}/mesh_metrics.jsonl", "--metrics-steps", "4"]
        text = io.StringIO()
        t0 = time.perf_counter()
        reset_counts(kernel_list)
        with contextlib.redirect_stdout(text):
            bench_mesh.main(argv)
        count_launches(kernel_list, "14d bench_mesh", launches)
        rows = [json.loads(line) for line in text.getvalue().splitlines()
                if line.startswith("{")]
        for r in rows:
            say(f"  bench_mesh: {json.dumps(r)}")
        say(f"  bench_mesh {' '.join(argv)}: {len(rows)} lines in "
            f"{time.perf_counter() - t0:.1f} s (its two-rank lines came from 14c's job)")
        want = [a for a in MESH_AXES if a != "pipe"]  # the pipeline takes two ranks
        check(sorted(r["axis"] for r in rows) == want
              and all(r.get("shards", r.get("chips")) == 1 and r["device"]["power_limit"]
                      for r in rows),
              f"bench_mesh: a line for each of {want} at 1 rank, each with the card's "
              "power limit")
        check(sum(1 for _ in open(f"{d}/mesh_metrics.jsonl")) == 4,
              "bench_mesh --metrics: 4 JSONL records")


def phase_parallel(env, dev, kernel_list, records=None) -> dict:
    """Phase 14 (the per-shard kernels, 14a-14d); returns each kernel's
    launches by run under test."""
    import torch.distributed as dist

    from covo_mpc_tpu_torch.parallel.distributed import free_port

    t_phase = time.perf_counter()
    launches: dict = {}
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        phase_shard_kernels(env, dev, records)
        caps, refs, single = phase_mesh_solves(env, dev, kernel_list, launches)
        multi = phase_multichip(env, dev, kernel_list, launches)
        phase_two_ranks(kernel_list, launches, {"covo": single["covo invariant"],
                                                "multichip": multi["invariant"]})
        # 14a's timing after 14c, whose ranks run in processes of their own:
        # the capture's slow spell has passed by then (14d captures again)
        time_mesh_solves(caps, refs)
        phase_pod_block(kernel_list, launches)
    finally:
        dist.destroy_process_group()
    say("  launches in phase 14: " + json.dumps(
        {sym: {k: v for k, v in by.items() if v} for sym, by in launches.items()}))
    say(f"  phase 14 wall {time.perf_counter() - t_phase:.1f} s")
    return launches


# --- phase 15: JAX's randomized-config net on the card --------------------------
# JAX's net (tests/test_random_configs.py) draws its cases with this function,
# these axes and this seed; the script imports nothing of JAX, so it keeps a
# copy, which tests/test_torch_random_configs.py holds equal to JAX's cases
# and ids
RC_TASKS = ["tracking", "tracking_slow", "tracking_zigzag", "hovering"]
RC_OBS_TYPES = ["quad", "quad_params", "params", "adapt_hist"]
RC_DISTURBS = ["periodic", "sin", "drag", "mixed", "gaussian", "none"]
RC_CONTROLLERS = ["mppi", "covo_online", "covo_offline"]
RC_NS, RC_HS = [16, 64, 256], [8, 16]
RC_RNGS = ["parity", "fast", "invariant"]
RC_HESSIANS = ["fwd_fwd", "fwd_rev", "sensitivity", "adjoint", "gn"]
RC_SIGMAS = ["eigh", "ns"]
RC_RESET_KEY, RC_SOLVE_KEY, RC_SEED = 7, 3, 0  # JAX's net's keys; the solvers' seed


def random_config_cases(n_cases: int = 20, seed: int = 20240820):
    """JAX's net's cases and their ids, drawn as it draws them: the last 4
    under the kernel rng."""
    import random

    rng = random.Random(seed)
    cases, seen = [], set()
    while len(cases) < n_cases:
        kernel = len(cases) >= n_cases - 4
        c = dict(
            task=rng.choice(RC_TASKS),
            obs_type=rng.choice(RC_OBS_TYPES),
            disturb=rng.choice(RC_DISTURBS),
            randomizer=rng.random() < 0.5,
            controller=rng.choice(RC_CONTROLLERS),
            n=rng.choice(RC_NS),
            h=rng.choice(RC_HS),
            rng_mode="kernel" if kernel else rng.choice(RC_RNGS),
            hessian=rng.choice(RC_HESSIANS),
            sigma=rng.choice(RC_SIGMAS),
        )
        key = tuple(sorted(c.items()))
        if key not in seen:
            seen.add(key)
            cases.append(c)
    ids = [f"{c['controller']}-{c['task']}-{c['disturb']}-{c['obs_type']}-"
           f"N{c['n']}H{c['h']}-{c['rng_mode']}-{c['hessian']}-{c['sigma']}"
           for c in cases]
    return cases, ids


def rc_env(c, device):
    from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv

    return QuadEnv(EnvConfig(task=c["task"], obs_type=c["obs_type"],
                             enable_randomizer=c["randomizer"], disturb_type=c["disturb"],
                             disable_rollover_terminate=True, generate_noisy_state=True),
                   device=device)


def rc_solver(env, c, engine: str):
    """The case's solver on ``engine`` (JAX's net's settings: the Hessian is
    CoVO's only), seeded with :data:`RC_SEED`."""
    from covo_mpc_tpu_torch.solvers import get_solver

    return get_solver(env, c["controller"], f"N{c['n']}_H{c['h']}_lam0.01",
                      rng_mode=c["rng_mode"], sigma_mode=c["sigma"], engine=engine,
                      hessian_mode=c["hessian"] if "covo" in c["controller"] else "fwd_fwd",
                      collect_debug=False, seed=RC_SEED)


def rc_plain_costs(rec) -> torch.Tensor:
    """The plain rollout's costs of the actions a recorded fused sample +
    rollout call returned, on that call's state, params and draw."""
    from covo_mpc_tpu_torch.ops.rollout_cuda import _kernel_draws

    x0, t0, pos_traj, vel_traj, _, _, params = rec["args"][:7]
    kw = rec["kw"]
    if _kernel_draws(rec["inner"].env, kw.get("draw"), kw["deterministic"]):
        raise AssertionError("the kernel drew the disturbance itself: no plain reference")
    return rec["inner"]._rollout(x0, t0, pos_traj, vel_traj, rec["out"][1], params,
                                 kw.get("draw"), kw["deterministic"], kw["discount"],
                                 layout="hdn")


def rc_expected(c) -> dict:
    """The kernels one cuda solve of the case launches, once each: K5 (MPPI)
    or K1 (CoVO) under kernel rng, else K4; K3, and K2 but under drag and
    mixed (the plain 16-dim primal), for an online CoVO solve under gn or
    adjoint (offline designs its schedule at reset, on the plain path)."""
    from covo_mpc_tpu_torch.ops import hessian_cuda, rollout_cuda

    if c["rng_mode"] == "kernel":
        used = [rollout_cuda.SAMPLE_KERNEL if c["controller"] == "mppi"
                else rollout_cuda.JOINT_KERNEL]
    else:
        used = [rollout_cuda.ROLLOUT_KERNEL]
    if c["controller"] == "covo_online" and c["hessian"] in ("gn", "adjoint"):
        used.append(hessian_cuda.CHAIN_KERNEL)
        if c["disturb"] not in ("drag", "mixed"):
            used.append(rollout_cuda.PRIMAL_KERNEL)
    return {k.symbol: 1 for k in used}


def rc_record(solver, attr: str) -> dict:
    """Wrap ``solver.<attr>`` (its rollout, or its fused sample + rollout) to
    keep its last call's arguments and result."""
    rec, inner = {}, getattr(solver, attr)

    def call(*args, **kw):
        out = inner(*args, **kw)
        rec.update(inner=inner, args=args, kw=kw, out=out)
        return out

    setattr(solver, attr, call)
    return rec


def rc_hooks(env, c, dev) -> dict:
    """The solve's random inputs: JAX's key (parity, invariant); under fast
    rng normals from a numpy seed, the rollout's disturbance draw by the
    fast chain from the key and (CoVO online) the Hessian's draws from it;
    none under kernel rng (the solver's seed stream)."""
    from covo_mpc_tpu_torch.ops.rollout import hessian_draws_from_key
    from covo_mpc_tpu_torch.utils import prng

    key = prng.PRNGKey(RC_SOLVE_KEY, dev)
    if c["rng_mode"] in ("parity", "invariant"):
        return dict(key=key)
    if c["rng_mode"] == "kernel":
        return {}
    N, H = c["n"], c["h"]
    rng = np.random.default_rng(RC_SOLVE_KEY)
    step_key = prng.split(prng.split(key)[0])[1]
    if c["controller"] == "mppi":
        return dict(z=to_dev(rng.standard_normal((N, H, 4)), dev),
                    draw=env.disturb_from_key(step_key, fast=True))
    hooks = dict(z=to_dev(rng.standard_normal((N, 4 * H)), dev),
                 draw=env.disturb_from_key(step_key, deterministic=True, fast=True))
    if c["controller"] == "covo_online":
        hooks["hess_draws"] = hessian_draws_from_key(env, key, H)
    return hooks


def rc_env_half(c, dev) -> tuple:
    """The env on the card against the env on the CPU: reset from key 0,
    one step under the action 0.1 from key 1; obs, reward and every state
    leaf finite and within 1e-5. Returns the card's env and its reset."""
    from covo_mpc_tpu_torch.models.structs import tree_flatten
    from covo_mpc_tpu_torch.utils import prng

    outs = []
    for device in (dev, torch.device("cpu")):
        env = rc_env(c, device)
        p = env.default_params
        obs, info, state = env.reset(prng.PRNGKey(0, device), p)
        step = env.step(prng.PRNGKey(1, device), state,
                        torch.full((env.action_dim,), 0.1, device=device), p)
        outs.append((env, (obs, info, state), step))
    leaves = [tree_flatten(out[1:])[0] for out in outs]
    ok = len(leaves[0]) == len(leaves[1]) and all(
        a.shape == b.shape and bool(torch.isfinite(a).all())
        and (not a.is_floating_point() or max_err(a.cpu(), b) <= 1e-5)
        and (a.is_floating_point() or torch.equal(a.cpu(), b))
        for a, b in zip(*leaves))
    check(ok, f"env: reset and one step on the card within 1e-5 of the CPU's, finite "
          f"({len(leaves[0])} leaves)")
    return outs[0][0], outs[0][1]


def rc_eigh_basis(solver, basis: dict) -> None:
    """An online solve that samples with the eigh factor (the eigen square
    root U diag(s), whose columns' signs are the eigensolver's choice):
    have ``solver``'s designer keep its factor in ``basis["factor"]`` if
    that is empty, else hand its factor in that one's basis, ``F Qᵀ`` with
    ``F = basis Q``, after checking that Q is orthogonal (1e-3), so that two
    engines' solves draw the same actions from the same normals."""
    design = solver._optimize_sigma

    def designer(R, sample_sigma, D):
        a_cov, F = design(R, sample_sigma, D)
        if "factor" not in basis:
            basis["factor"] = F
            return a_cov, F
        Q = torch.linalg.solve(basis["factor"].double(), F.double())
        eye = torch.eye(Q.shape[0], dtype=Q.dtype, device=Q.device)
        basis.update(flips=int((torch.diagonal(Q) < 0).sum()),
                     orth=float((Q.T @ Q - eye).abs().max()))
        if basis["orth"] > 1e-3:
            raise AssertionError(f"the two eigh factors span no one basis "
                                 f"(|QᵀQ - I| {basis['orth']:.2e})")
        return a_cov, (F.double() @ Q.T).float().contiguous()

    solver._optimize_sigma = designer


def rc_solve(env, c, engine, reset, hooks, kernel_list, basis=None):
    """The case's solver on ``engine``, reset, then one solve from the
    solver's seed three times: ``first``, a warm-up and the counted run
    ``out`` (launch counters at 0 just before it; host syncs errors but for
    eigh's, which reads the host). Returns them, the counted run's
    launches, its recorded rollout and the seconds, reset included."""
    from covo_mpc_tpu_torch.utils import prng

    t0 = time.perf_counter()
    obs, info, state = reset
    solver, cp = rc_solver(env, c, engine)
    p = env.default_params
    cp = solver.reset(state, p, cp, key=prng.PRNGKey(RC_RESET_KEY, state.pos.device))
    rec = rc_record(solver, "rollout_sampling" if c["rng_mode"] == "kernel" else "rollout")
    if basis is not None:
        rc_eigh_basis(solver, basis)

    def fn():
        solver.seed(RC_SEED)
        return solver(obs, state, p, cp, info, **hooks)

    first = fn()
    if solver.capturable:
        out, counts = run_once(fn, kernel_list)
    else:
        fn()
        torch.cuda.synchronize()
        reset_counts(kernel_list)
        out = fn()
        torch.cuda.synchronize()
        counts = {k.symbol: k.launches for k in kernel_list}
    return types.SimpleNamespace(first=first, out=out, rec=rec,
                                 counts={k: v for k, v in counts.items() if v},
                                 secs=time.perf_counter() - t0)


def rc_outputs(c, out) -> dict:
    names = ["a_mean"] + (["a_cov"] if "covo" in c["controller"] else [])
    return {"action": out[0], **{k: getattr(out[1], k) for k in names}}


def phase_random_configs(dev, kernel_list) -> dict:
    """Phase 15 (the module docstring); returns each kernel's launches by
    case."""
    t_phase = time.perf_counter()
    cases, ids = random_config_cases()
    launches: dict = {}
    for i, (c, label) in enumerate(zip(cases, ids)):
        phase(f"phase 15 case {i}: {label}{' DR' if c['randomizer'] else ''}")
        t_case = time.perf_counter()
        env, reset = rc_env_half(c, dev)
        hooks = rc_hooks(env, c, dev)
        expected = rc_expected(c)
        # an online eigh solve under fast or invariant rng samples with the
        # eigen square root: the torch solve takes the cuda solve's basis
        basis = ({} if c["controller"] == "covo_online" and c["sigma"] == "eigh"
                 and c["rng_mode"] != "parity" else None)
        run = rc_solve(env, c, "cuda", reset, hooks, kernel_list, basis)
        say(f"  cuda solve: launches {run.counts} ({run.secs:.1f} s with its reset)")
        for sym, n in run.counts.items():
            launches.setdefault(sym, {})[label] = n
        check(run.counts == expected, f"the cuda solve launched {expected} and nothing else")
        got = rc_outputs(c, run.out)
        check(all(bool(torch.isfinite(x).all()) for x in got.values())
              and float(got["action"].abs().max()) <= 1.0 + 1e-6,
              "outputs finite, |action| <= 1")
        if c["rng_mode"] == "kernel":
            again = rc_outputs(c, run.first)
            check(all(torch.equal(got[k], again[k]) for k in got),
                  "two solves from the same seed equal bit for bit")
            costs, a_t = run.rec["out"]
            ref = rc_plain_costs(run.rec)
            say(f"  kernel costs against the plain rollout on its actions: max abs err "
                f"{max_err(costs, ref):.2e}; actions in [{float(a_t.min()):.3f}, "
                f"{float(a_t.max()):.3f}]")
            check(costs_close(costs, ref) and float(a_t.abs().max()) <= 1.0 + 1e-6,
                  "the kernel's costs within atol 2e-4, rtol 1e-5 of the plain rollout on "
                  "its sampled actions, |a| <= 1")
        else:
            plain = rc_solve(env, c, "torch", reset, hooks, kernel_list, basis)
            check(not plain.counts, f"the torch solve launched no kernel ({plain.secs:.1f} s)")
            if basis is not None:
                say(f"  eigh factors: the torch solve's in the cuda solve's basis, "
                    f"{basis['flips']} columns' signs flipped, |QᵀQ - I| {basis['orth']:.1e}")
            ref = rc_outputs(c, plain.out)
            errs = {k: max_err(got[k], ref[k]) for k in got}
            say(f"  max |cuda - torch|: {errs}; costs "
                f"{max_err(run.rec['out'], plain.rec['out']):.2e}")
            check(all(v <= 2e-4 for v in errs.values()),
                  f"action, {', '.join(list(got)[1:])} within 2e-4 of the torch solve")
            check(costs_close(run.rec["out"], plain.rec["out"]),
                  "costs within atol 2e-4, rtol 1e-5 of the torch solve's")
        say(f"  case {i}: {time.perf_counter() - t_case:.1f} s")
    say("  launches in phase 15: " + json.dumps(launches))
    say(f"  phase 15 wall {time.perf_counter() - t_phase:.1f} s")
    return launches


def first_rng_act(keys):
    """Each episode's ``rng_act`` of the first step of JAX's episode chain
    from its run key: ``rng_control, rng = split(key)``, then ``rng,
    rng_act, ... = split(rng, 4)``."""
    from covo_mpc_tpu_torch.utils import prng

    rng = prng.split(keys)[..., 1, :]
    return prng.split(rng, 4)[..., 1, :]



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--total-steps", type=int, default=1200,
                    help="length of the single-scenario closed loops (phases 3, "
                         "6d, 7c at half, 8c)")
    ap.add_argument("--phase13", action="store_true",
                    help="build the kernels and run phase 13 alone (a quick check of "
                         "the batched modes, the supervisors and render; no kernels "
                         "record, no result line)")
    ap.add_argument("--phase14", action="store_true",
                    help="build the kernels and run phase 14 alone (the parallel layer: "
                         "one rank under NCCL, two ranks on the card, the pod block, "
                         "bench_mesh; no kernels record, no result line)")
    ap.add_argument("--phase15", action="store_true",
                    help="build the kernels and run phase 15 alone (JAX's "
                         "randomized-config net, cuda against torch; no kernels record, "
                         "no result line)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv
    from covo_mpc_tpu_torch.ops import covariance_cuda, hessian_cuda, kernels, rollout_cuda
    from covo_mpc_tpu_torch.tools import primal_chain_variants, rollout_variants, sass_chain

    dev = torch.device("cuda", 0)
    # fp32 products in full fp32 (PyTorch's default, stated: the plain
    # versions and the correlate yardsticks run in it)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    say(smi)
    nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"nvcc: {nvcc.splitlines()[-1]}")
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # 128 fp32 lanes per SM, an FMA counted as two operations
    say(f"fp32 peak {fp32_peak() / 1e12:.2f} TFLOP/s ({sms} SMs at {clock_mhz:.0f} MHz), "
        f"memory {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    t0 = time.perf_counter()
    # the earlier K2 / K3 and K4 / K6 and the latency probe build beside the
    # library
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        earlier_f = pool.submit(primal_chain_variants.build_earlier)
        earlier_rollout_f = pool.submit(rollout_variants.build_earlier)
        probe_f = pool.submit(sass_chain.build_probe, primal_chain_variants.OUT)
        lib = kernels.library()
        earlier, probe = earlier_f.result(), probe_f.result()
        earlier_rollout = earlier_rollout_f.result()[1]
    say(f"kernel build: nvcc {lib.build_seconds:.2f} s, load and the earlier K2 / K3 / K4 "
        f"and the latency probe {time.perf_counter() - t0:.2f} s in all")
    probe = sass_chain.load_probe(probe)

    env = QuadEnv(EnvConfig(**ENV_KW))
    covo_kernels = [rollout_cuda.JOINT_KERNEL, rollout_cuda.PRIMAL_KERNEL,
                    hessian_cuda.CHAIN_KERNEL]
    single_kernels = covo_kernels + [rollout_cuda.ROLLOUT_KERNEL,
                                     rollout_cuda.SAMPLE_KERNEL]
    kernel_list = single_kernels + [rollout_cuda.ROLLOUT_BATCHED_KERNEL,
                                    rollout_cuda.SAMPLE_BATCHED_KERNEL,
                                    rollout_cuda.JOINT_BATCHED_KERNEL,
                                    covariance_cuda.SIGMA_KERNEL]
    records, refs = {}, {}
    if args.phase13:
        phase_batched_modes(env, dev, kernel_list, refs)
        return 0
    if args.phase14:
        phase_parallel(env, dev, kernel_list)
        return 0
    if args.phase15:
        phase_random_configs(dev, kernel_list)
        return 0
    phase_kernels(env, dev, records)
    phase_chain_kernels(dev, records, earlier, probe, clock_mhz)
    phase_rollout_kernels(dev, records, earlier_rollout, probe, clock_mhz)
    phase_solve(env, dev, single_kernels)
    captured = phase_captured(env, dev, kernel_list)
    launches = phase_closed_loops(env, dev, args.total_steps, covo_kernels,
                                  single_kernels)
    profile_solves(env, dev)
    profile_mppi(env, dev)
    env_dr = QuadEnv(EnvConfig(**{**ENV_KW, "enable_randomizer": True}))
    phase_scenario_kernels(env_dr, dev, records)
    phase_scenario_solves(env_dr, dev, kernel_list)
    launches.update(phase_scenario_loops(env, kernel_list))
    phase_scenario_timing(env_dr, dev)
    profile_batched(env_dr, dev)
    # the batched kernels' launches are read from the batched protocol
    launches.update(phase_batched_protocol(env, kernel_list, refs))
    phase_sigma_kernel(env, dev, records)
    phase_sigma_solves(env, dev, kernel_list)
    launches.update(phase_mode_loops(env, args.total_steps, kernel_list, covo_kernels))
    phase_mode_kernels(dev, records)
    phase_mode_solves(dev, kernel_list)
    phase_drag_loops(dev, args.total_steps, kernel_list, records)
    phase_realworld_kernels(dev, records)
    phase_realworld_solves(dev, kernel_list)
    phase_realworld_loops(dev, args.total_steps, kernel_list, records)
    phase_cli(kernel_list, records)
    phase_small_n(dev, records)
    phase_sweeps(kernel_list, records)
    phase_bench(captured[MAIN_PATH])
    records[rollout_cuda.ROLLOUT_KERNEL.symbol]["key_tree_launches"] = phase_key_tree(
        env, dev, kernel_list, refs)
    for symbol, counts in phase_batched_modes(env, dev, kernel_list, refs).items():
        records[symbol]["batched_modes_launches"] = counts
    parallel = phase_parallel(env, dev, kernel_list, records)
    for k in kernel_list:
        records[k.symbol]["parallel_launches"] = {
            label: n for label, n in parallel.get(k.symbol, {}).items() if n}
    for symbol, counts in phase_random_configs(dev, kernel_list).items():
        records[symbol]["random_configs_launches"] = counts
    phase("done")

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
