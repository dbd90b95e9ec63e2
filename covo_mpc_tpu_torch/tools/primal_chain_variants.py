"""Variants of the sensitivity chain (``csrc/sens_chain.cu``, K3) and the
primal (``csrc/primal.cu``, K2), side by side on one card: register use and
spills, agreement bit for bit, time, and the critical path of each step
loop from its SASS.

Each variant is a kernel's source with a few lines replaced. K3: J staged
4 or 6 steps ahead in place of 2, and S1 passed between a column's lanes by
shuffles in place of shared memory. K2: the attitude chain reading each step's
body-rate target from global memory, as the one-thread kernel read its
action, in place of shared memory, and the chain run by the IEEE square
root and divisions alone (each division around its slow-path test) in
place of their fast paths. The ablations' results
are wrong, and only their times mean anything, as the cost of the part they
skip. K3: no T stores (the last step's only), no J staging (each row read
from global memory as scalars), every block starting its chain at step 0,
scalar shared loads in place of float4 ones. K2: the attitude chain alone
(no loads, no accelerations, no velocity or position), one state row stored
a chunk in place of all. Other sources with the same C entry point, given
on the command line (an earlier kernel, from ``git show
<commit>:covo_mpc_tpu_torch/csrc/sens_chain.cu``, or
``tools/earlier/*.cu``), join the comparison under their file names; each
is a K3 or a K2 by the entry point it defines.

Every source is built with ``nvcc -Xptxas -v`` into its own library under
``build/primal_chain_variants/`` (all builds at once) and launched through
ctypes. Every variant that is not an ablation is held bit for bit against
the first other source of its kernel (else the committed kernel): K3 at sd
13 and 16, H in {8, 13, 32}, on J = [I + 0.02 N | 0.1 N] from numpy seed 0;
K2 at H in {8, 13, 32} on a reset state of the main path's env, raw actions
in [-1.3, 1.3] (some clipped), on a zero force table and on a sin table.
Times (K3 sd 13 and 16, K2 on the sin table, all at H = 32), in four
rounds whose order alternates, all printed: CUDA events around 50 launches
from the host after 3, and around replays of a CUDA graph of 50 launches
(the host out of the way), beside an empty one-warp kernel's. By part:
each committed kernel once more with clock reads put in (``PARTS``), its
SM cycles by phase (K2) or before and in its step loop (K3, every block,
with the global timer's start and end) and the SM clock they imply. The chain: ``sass_chain.step_loop`` on each library's kernel, with
the latencies ``sass_chain.measure_latencies`` reads on this card, at the
SM clock ``nvidia-smi`` reads (``clocks.max.sm``). Run on a machine with an
NVIDIA GPU, from the root of a checkout::

    python -m covo_mpc_tpu_torch.tools.primal_chain_variants [other.cu ...]
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv, pack_state
from covo_mpc_tpu_torch.ops import hessian_cuda, kernels, rollout_cuda
from covo_mpc_tpu_torch.tools import sass_chain
from covo_mpc_tpu_torch.tools.joint_rollout_variants import build_all, edited

H_MAIN = 32
HS = (8, 13, 32)
SDS = (13, 16)
ROUNDS = 4
OUT = kernels.BUILD_DIR.parent / "primal_chain_variants"
EARLIER = Path(__file__).resolve().parent / "earlier"
ENTRIES = ("sens_chain", "primal")
# the kernel functions' names in the SASS (mangled names hold these)
SASS_NAMES = {"sens_chain": {13: "sens_chain_kernelILi13E", 16: "sens_chain_kernelILi16E"},
              "primal": "primal_kernel"}
ENV_KW = dict(task="tracking_zigzag", enable_randomizer=False, disturb_type="gaussian",
              disable_rollover_terminate=True, generate_noisy_state=True)

_AHEAD = "constexpr int kAhead = 2;"
_T_STORE = "    store_T(h);\n"
_PREFIX = "  for (int i = lane; i < h0 * Z * kCols; i += 32) {"
_PREFETCH = "  for (int j = 0; j < kAhead; ++j) stage<SD>(J_base, J, h0 + j, H, lane, off);"
_STAGE = ("    stage<SD>(J_base, J, h + kAhead, H, lane, off);\n"
          "    wait_groups<kAhead>();  // J_h is in\n")
_ROW = "    load_vec<ZP>(row, J_s + (h & (kRing - 1)) * G::kSlot + r * ZP);\n"
_H0 = "  const int h0 = c0 / kDA;"
_VEC = "    const float4 v = reinterpret_cast<const float4*>(src)[q];\n"
_EXCHANGE = ("    S_s[h & 1][col][r] = acc;\n    __syncwarp();\n    float next[kRowLanes];\n"
             "    load_vec<kRowLanes>(next, S_s[h & 1][col]);\n#pragma unroll\n"
             "    for (int k = 0; k < SD; ++k) S1[k] = next[k];\n")
_ACT = "      const float act[4] = {a[4 * h], a[4 * h + 1], a[4 * h + 2], a[4 * h + 3]};\n"
_FORCE = ("      fdx = dist[3 * h];\n      fdy = dist[3 * h + 1];\n"
          "      fdz = dist[3 * h + 2];\n")
_ACCEL = "    if (lane < n) {\n      const float nx"
_VELPOS = "    if (lane < 3) {\n#pragma unroll 4"
_FAST = "    if (lane == 0) attitude<false>(ch, n, q, w, wt, alpha, dt);\n"
_STORES = "    for (int i = lane; i < 13 * n; i += 32) states[13 * c + i] = ch.out[i];\n"
_WT_MAP = "      ch.wt[lane][{k}] = quad::clip1(act[{a}]) * mo{k} * ascale;\n"
_WT = "    const float* wt = &ch.wt[0][0];\n"

COMMITTED = "as committed"
# name -> (kernel, edits of its committed source, ablation)
RUNS = {
    f"K3 {COMMITTED} (kAhead 2)": ("sens_chain", [], False),
    **{f"K3 kAhead {a}": ("sens_chain", [(_AHEAD, _AHEAD.replace("2", str(a)))], False)
       for a in (4, 6)},
    "K3 with S1 exchanged by shuffles": ("sens_chain", [(_EXCHANGE, (
        "#pragma unroll\n    for (int k = 0; k < SD; ++k) {\n"
        "      S1[k] = __shfl_sync(0xffffffffu, acc, (lane & ~(kRowLanes - 1)) | k);\n"
        "    }\n"))], False),
    "K3 without T stores (the last step's only)": ("sens_chain", [
        (_T_STORE, ""),
        (_PREFIX, _PREFIX.replace("h0 * Z * kCols", "0"))], True),
    "K3 without J staging (rows from global memory)": ("sens_chain", [
        (_PREFETCH, _PREFETCH.replace("j < kAhead", "j < 0")), (_STAGE, ""),
        (_ROW, "    for (int u = 0; u < Z; ++u) row[u] = J[(static_cast<size_t>(h) * SD + "
               "min(r, SD - 1)) * Z + u];\n")], True),
    "K3 with every block from step 0": ("sens_chain", [(_H0, "  const int h0 = 0;")], True),
    "K3 with scalar shared loads": ("sens_chain", [(_VEC, (
        "    const volatile float* s = src + 4 * q;\n"
        "    const float4 v = make_float4(s[0], s[1], s[2], s[3]);\n"))], True),
    f"K2 {COMMITTED}": ("primal", [], False),
    # the targets staged in global memory (the chunk's rows of states, which
    # it writes last), so the chain loads one each step as before
    "K2 with per-step global loads in the chain": ("primal", [
        *[(_WT_MAP.format(k=k, a=k + 1), _WT_MAP.format(k=k, a=k + 1).replace(
            f"ch.wt[lane][{k}]", f"states[13 * c + 3 * lane + {k}]")) for k in range(3)],
        (_WT, "    __syncwarp();\n    const float* wt = states + 13 * c;\n")], False),
    "K2 by the IEEE operations only (each division around its test)": ("primal", [
        (_FAST, "    if (lane == 0) attitude<true>(ch, n, q, w, wt, alpha, dt);\n")], False),
    "K2 attitude chain alone (the floor)": ("primal", [
        (_ACT, "      const float act[4] = {0.0f, 0.0f, 0.0f, 0.0f};\n"), (_FORCE, ""),
        (_ACCEL, _ACCEL.replace("lane < n", "false")),
        (_VELPOS, _VELPOS.replace("lane < 3", "false"))], True),
    "K2 with one state row stored a chunk": ("primal", [
        (_STORES, "    if (lane < 13) states[lane] = ch.out[13 * (n - 1) + lane];\n")], True),
}

# Clock reads put into the committed kernels: each writes, in place of
# results, the SM cycles of its parts (and the global timer's ns) into its
# output, read back by ``main`` under the labels given.
_START = "  const int lane = threadIdx.x;\n"
_CLOCKS = (_START + "  const long long c_start = clock64();\n"
           "  unsigned long long g_start, g_end;\n"
           "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g_start));\n")
_G_END = "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g_end));\n"


def _tick(var: str) -> str:
    return f"    {{ const long long t = clock64(); {var} += t - c_prev; c_prev = t; }}\n"


_K3_END = "  store_T(H - 1);\n"
_K2_END = "    __syncwarp();\n  }\n}\n"
PARTS = {
    "K3 by part": ("sens_chain", [
        (_START, _CLOCKS),
        ("  float S1[SD];  // the column's S1_h, in every lane of the column\n",
         "  const long long c_loop = clock64();\n  float S1[SD];\n"),
        (_K3_END, "  store_T(H - 1);\n" + _G_END + (
            "  const long long c_end = clock64();\n"
            "  if (lane < kCols) {  // in the block's own columns of T's last two rows\n"
            "    float* mark = T + (static_cast<size_t>(H) * Z - 2) * D + c0 + lane;\n"
            "    const long long v[4] = {static_cast<long long>(g_start % (1ull << 24)),\n"
            "                            static_cast<long long>(g_end % (1ull << 24)),\n"
            "                            c_end - c_loop, c_end - c_start};\n"
            "    mark[0] = static_cast<float>(v[lane]);\n"
            "    mark[D] = static_cast<float>(v[kCols + lane]);\n"
            "    if (blockIdx.x == 0) {  // its own columns of rows 0 and 1\n"
            "      const long long w[4] = {c_loop - c_start, c_end - c_loop, c_end - c_start,\n"
            "                              static_cast<long long>(g_end - g_start)};\n"
            "      T[lane] = static_cast<float>(w[lane]);\n"
            "      T[D + lane] = static_cast<float>(w[kCols + lane]);\n"
            "    }\n  }\n"))]),
    "K2 by part": ("primal", [
        (_START, _CLOCKS + "  long long c_a = 0, c_b = 0, c_c = 0, c_d = 0, c_e = 0, "
                           "c_prev = c_start;\n"),
        ("    // (b) the attitude chain", _tick("c_a") + "    // (b) the attitude chain"),
        ("    // (c) step c", _tick("c_b") + "    // (c) step c"),
        ("    // (d) position", _tick("c_c") + "    // (d) position"),
        (_STORES, _tick("c_d") + _STORES),
        (_K2_END, "    __syncwarp();\n" + _tick("c_e") + "  }\n" + _G_END + (
            "  if (lane == 0) {\n"
            "    states[0] = c_a; states[1] = c_b; states[2] = c_c; states[3] = c_d;\n"
            "    states[4] = c_e; states[5] = clock64() - c_start;\n"
            "    states[6] = static_cast<float>(g_end - g_start);\n  }\n}\n"))]),
}
PART_LABELS = {
    "K3 by part": ("block 0: cycles to the loop", "its loop", "in all", "ns in all"),
    "K2 by part": ("cycles of (a) loads and action map", "(b) attitude chain",
                   "(c) accelerations", "(d) velocity and position", "state stores",
                   "in all", "ns in all"),
}


def kernel_of(text: str) -> str:
    """"sens_chain" or "primal": the C entry point a source defines."""
    found = [e for e in ENTRIES if f'extern "C" int {e}(' in text]
    if len(found) != 1:
        raise ValueError(f"a source defines {found}, expected one of {ENTRIES}")
    return found[0]


def chain_j(sd: int, H: int, dev, seed: int = 0) -> torch.Tensor:
    """J (H, sd, sd + 4) = [A | B], A near the identity as a step Jacobian is."""
    rng = np.random.default_rng(seed)
    A = np.eye(sd)[None] + 0.02 * rng.standard_normal((H, sd, sd))
    B = 0.1 * rng.standard_normal((H, sd, 4))
    return torch.from_numpy(np.concatenate([A, B], axis=2).astype(np.float32)).to(dev)


def primal_operands(H: int, dev, table: str, seed: int = 0):
    """(env, params, x0 (16,), scal (10,), actions (H, 4), dist (H, 3)) on a
    reset state of the main path's env; ``table`` "zero" (x0's force at
    step 0, then 0, as the gaussian Hessian's) or "sin"."""
    env = QuadEnv(EnvConfig(**ENV_KW), device=dev)
    p = env.default_params
    _, info, _ = env.reset(torch.Generator(dev).manual_seed(3), p)
    x0 = pack_state(info["noisy_state"]).contiguous()
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(-1.3, 1.3, size=(H, 4)).astype(np.float32)).to(dev)
    if table == "zero":
        dist = torch.cat([x0[13:16][None], torch.zeros(H - 1, 3, device=dev)])
    else:
        h = np.arange(H)[:, None]
        dist = torch.from_numpy((0.05 * np.sin(0.3 * h + np.arange(3))).astype(
            np.float32)).to(dev)
    scal = torch.stack(rollout_cuda._dyn_scalars(env, p, dev) + [rollout_cuda._full(1.0, dev)])
    return env, p, x0, scal, a, dist.contiguous()


def launcher(cdll, kernel: str, ops: tuple, out: torch.Tensor, H: int, sd: int = 13):
    """A closure launching ``cdll``'s entry point on ``ops`` into ``out``, on
    the stream current when it is made."""
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in ops]
    if kernel == "sens_chain":
        args = (*ptrs, out.data_ptr(), H, sd, 4, stream)
    else:
        args = (*ptrs, out.data_ptr(), H, stream)
    fn = getattr(cdll, kernel)

    def launch():
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{kernel}: CUDA launch failed, cudaError {err}")
    return launch


def events_ms(launch, reps: int = 50, warmup: int = 3) -> float:
    """Device ms per launch, from CUDA events around ``reps`` back-to-back
    launches from the host (after ``warmup``)."""
    for _ in range(warmup):
        launch()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        launch()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def empty_launcher(probe):
    """A maker of closures launching the probe library's empty kernel."""
    def make():
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            if probe.empty_launch(stream) != 0:
                raise RuntimeError("empty_launch: CUDA launch failed")
        return launch
    return make


def graph_ms(make_launch, reps: int = 50, replays: int = 5) -> float:
    """Device ms per launch with the host out of the way: ``reps`` launches
    of ``make_launch()`` (made on the capturing stream) captured in one CUDA
    graph, replayed ``replays`` times under CUDA events."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        launch = make_launch()
        for _ in range(reps):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (reps * replays)


def cases(kernel: str, dev):
    """(label, operands, output, H, sd, plain result) of every bit check."""
    out = []
    if kernel == "sens_chain":
        for sd in SDS:
            for H in HS:
                J = chain_j(sd, H, dev)
                out.append((f"sd={sd} H={H}", (J,), torch.empty(H, sd + 4, 4 * H, device=dev),
                            H, sd, hessian_cuda.sens_chain_plain(J, 4)))
    else:
        for table in ("zero", "sin"):
            for H in HS:
                env, p, x0, scal, a, dist = primal_operands(H, dev, table)
                plain = rollout_cuda.Primal(env, H).plain(x0, a, dist, p)[:, :13]
                out.append((f"{table} table H={H}", (x0, scal, a.reshape(-1).contiguous(),
                                                     dist.reshape(-1).contiguous()),
                            torch.empty(H, 13, device=dev), H, 13, plain))
    return out


def build_earlier(out: Path = OUT) -> dict:
    """The earlier K2 and K3 (``tools/earlier/{primal,sens_chain}.cu``)
    built, each into its own library: kernel -> (ptxas lines, library)."""
    texts = {k: (EARLIER / f"{k}.cu").read_text() for k in ENTRIES}
    built = build_all(texts, out / "earlier", ENTRIES)
    return {kernel: built[text] for kernel, text in texts.items()}


def chain_of(cdll, kernel: str, sd: int, lat: dict) -> dict:
    """``sass_chain.step_loop`` of ``cdll``'s K2 or K3 (at ``sd``)."""
    name = SASS_NAMES[kernel][sd] if kernel == "sens_chain" else SASS_NAMES[kernel]
    return sass_chain.step_loop(sass_chain.function_sass(Path(cdll._name), name), lat)


def loop_bits(earlier: dict, dev, steps: int = 300, dump: str = "") -> dict:
    """K2 and K3 on every input the main path's closed loop gives them (CoVO
    online, gn, kernel rng, tracking_zigzag, one eager episode of ``steps``
    steps from seed 1),
    each launch also run through the earlier kernels (``build_earlier``) on
    the same operands: name -> (launches, launches that differ, max abs
    difference). With ``dump``, the first launch of each that differs goes
    there as JSON: its operands and both results."""
    from covo_mpc_tpu_torch.runtime.episode import eager_episode
    from covo_mpc_tpu_torch.solvers import get_solver

    env = QuadEnv(EnvConfig(**ENV_KW), device=dev)
    solver, _ = get_solver(env, "covo_online", f"N8192_H{H_MAIN}_lam0.01", rng_mode="kernel",
                           hessian_mode="gn", sigma_mode="ns", engine="cuda",
                           collect_debug=False, seed=0)
    stats = {k: [0, 0, 0.0] for k in ENTRIES}
    firsts = {}  # name -> the first launch that differs: its operands and both results

    def tally(name, got, ref, ops):
        s = stats[name]
        s[0] += 1
        if not torch.equal(got, ref):
            s[1] += 1
            firsts.setdefault(name, dict(ops=[t.tolist() for t in ops], got=got.tolist(),
                                         ref=ref.tolist()))
        s[2] = max(s[2], float((got - ref).abs().max()))

    primal_call, chain = rollout_cuda.Primal.__call__, hessian_cuda.sens_chain

    def primal_twice(self, x0, a_seq, dist, params):
        z = primal_call(self, x0, a_seq, dist, params)
        scal = torch.stack(rollout_cuda._dyn_scalars(self.env, params, x0.device)
                           + [rollout_cuda._full(1.0, x0.device)])
        ops = (x0[:16].contiguous(), scal, a_seq.reshape(-1).contiguous(),
               dist.reshape(-1).contiguous())
        ref = torch.empty(self.H, 13, device=x0.device)
        launcher(earlier["primal"][1], "primal", ops, ref, self.H)()
        tally("primal", z[:, :13], ref, ops)
        return z

    def chain_twice(J, dA):
        T = chain(J, dA)
        ref = torch.empty_like(T)
        launcher(earlier["sens_chain"][1], "sens_chain", (J,), ref, J.shape[0], J.shape[1])()
        tally("sens_chain", T, ref, (J,))
        return T

    rollout_cuda.Primal.__call__, hessian_cuda.sens_chain = primal_twice, chain_twice
    try:
        # eager: each launch is compared on the host as it runs
        solver.seed(1)
        eager_episode(env, solver, steps, torch.Generator(dev).manual_seed(1),
                      torch.Generator(dev).manual_seed(2))
    finally:
        rollout_cuda.Primal.__call__, hessian_cuda.sens_chain = primal_call, chain
    if dump:
        Path(dump).write_text(json.dumps(firsts))
    return {k: tuple(v) for k, v in stats.items()}


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("others", nargs="*", help="other K3 / K2 sources to compare")
    ap.add_argument("--loop-steps", type=int, default=300,
                    help="steps of the main path's closed loop whose K2 / K3 inputs are "
                         "held against the earlier kernels (0: none)")
    ap.add_argument("--loop-only", action="store_true", help="only that check")
    ap.add_argument("--loop-dump", default="", help="JSON file for the first launch that differs")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    print(smi("name,power.limit"), flush=True)
    if args.loop_steps:
        for name, (n, bad, diff) in loop_bits(build_earlier(), dev, args.loop_steps,
                                                     args.loop_dump).items():
            print(f"{name} in the main path's closed loop ({args.loop_steps} steps): {bad} of "
                  f"{n} launches differ from the earlier kernel, max |diff| {diff:.3e}",
                  flush=True)
    if args.loop_only:
        return
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    sources = {k: (kernels.CSRC / f"{k}.cu").read_text() for k in ENTRIES}
    # name -> (kernel, source text, ablation)
    runs = {name: (k, edited(sources[k], name, edits), abl)
            for name, (k, edits, abl) in RUNS.items()}
    for path in args.others:
        text = Path(path).read_text()
        runs[Path(path).name] = (kernel_of(text), text, False)
    built = build_all({name: text for name, (_, text, _) in runs.items()}, OUT, ENTRIES)
    for text, (info, _) in built.items():
        names = [n for n, (_, t, _) in runs.items() if t == text]
        print(f"{' | '.join(names)}: ptxas {'; '.join(info)}", flush=True)
    probe = sass_chain.load_probe(sass_chain.build_probe(OUT))
    lat = sass_chain.measure_latencies(probe)
    print("latencies, cycles: " + ", ".join(f"{k} {v:.2f}" for k, v in lat.items())
          + f"; SM clock {clock_mhz:.0f} MHz (clocks.max.sm)", flush=True)
    empty = empty_launcher(probe)
    print(f"an empty one-warp kernel: {events_ms(empty()):.4f} ms a launch from the host, "
          f"{graph_ms(empty):.4f} ms in a graph", flush=True)

    for kernel in ENTRIES:
        names = [n for n, (k, _, _) in runs.items() if k == kernel]
        committed = names[0]
        ref = next((n for n in names if n in {Path(p).name for p in args.others}), committed)
        same = {n: True for n in names if not runs[n][2]}
        for label, ops, out, H, sd, plain in cases(kernel, dev):
            launcher(built[runs[ref][1]][1], kernel, ops, out, H, sd)()
            torch.cuda.synchronize()
            want = out.clone()
            for name in names:
                out.fill_(float("nan"))
                launcher(built[runs[name][1]][1], kernel, ops, out, H, sd)()
                torch.cuda.synchronize()
                rel = float((out - plain).norm() / plain.norm())
                diff = float((out - want).abs().max())
                if name in same:
                    same[name] = same[name] and torch.equal(out, want)
                print(f"  {kernel} {label} {name}: max |x - {ref!r}| {diff:.3e}, relative "
                      f"Frobenius error vs plain {rel:.3e}"
                      + (" (ablation: wrong by design)" if runs[name][2] else ""), flush=True)
        for name, ok in same.items():
            print(f"{name}: {'equal' if ok else 'NOT equal'} to {ref!r} bit for bit in every "
                  "case", flush=True)

        timed = [(f"sd={sd}", cases_at(kernel, dev, sd)) for sd in SDS] \
            if kernel == "sens_chain" else [("sin table", cases_at(kernel, dev, 13))]
        for part, (k, edits) in PARTS.items():
            if k != kernel:
                continue
            text = edited(sources[k], part, edits)
            cdll = build_all({part: text}, OUT / "parts" / kernel, ENTRIES)[text][1]
            for label, (ops, out, H, sd) in timed:
                launch = launcher(cdll, kernel, ops, out, H, sd)
                for _ in range(5):
                    launch()
                torch.cuda.synchronize()
                flat = out.flatten()
                got = (torch.cat([flat[:2], flat[4 * H:4 * H + 2]]) if kernel == "sens_chain"
                       else flat[:len(PART_LABELS[part])]).tolist()
                print(f"{part}, {label} H={H}: " + ", ".join(
                    f"{name} {v:.0f}" for name, v in zip(PART_LABELS[part], got))
                    + f"; {got[-2] / got[-1] * 1e3:.0f} MHz", flush=True)
                if kernel == "sens_chain":  # each block's marks in its own columns
                    cols = 32 // int(re.search(r"constexpr int kRowLanes = (\d+);",
                                               sources[k]).group(1))
                    rows = out.reshape(-1, 4 * H)[-2:].reshape(2, -1, cols)
                    marks = torch.cat([rows[0], rows[1]], dim=1).tolist()
                    first = min(m[0] for m in marks)
                    print("  by block (ns from the first start: start, end; loop cycles, "
                          "cycles in all): " + "; ".join(
                              f"{b}: {m[0] - first:.0f}, {m[1] - first:.0f}; {m[2]:.0f}, "
                              f"{m[3]:.0f}" for b, m in enumerate(marks)), flush=True)
        for label, (ops, out, H, sd) in timed:
            makers = {n: (lambda n=n: launcher(built[runs[n][1]][1], kernel, ops, out, H, sd))
                      for n in names}
            times = {n: [] for n in names}
            graphs = {n: [] for n in names}
            for rnd in range(ROUNDS):
                for n in names[::-1 if rnd % 2 else 1]:
                    times[n].append(events_ms(makers[n]()))
                    graphs[n].append(graph_ms(makers[n]))
            for n in names:
                loop = chain_of(built[runs[n][1]][1], kernel, sd, lat)
                print(f"{kernel} {label} H={H} {n}: launches from the host "
                      f"{' / '.join(f'{t:.4f}' for t in times[n])} ms, in a graph "
                      f"{' / '.join(f'{t:.4f}' for t in graphs[n])} ms; chain "
                      f"{sass_chain.chain_ms(H, loop['cycles'], clock_mhz):.4f} ms: "
                      f"{sass_chain.describe(loop)}", flush=True)


def cases_at(kernel: str, dev, sd: int):
    """The timed operands: (ops, out, H, sd) at H = 32 (K2 on the sin table)."""
    if kernel == "sens_chain":
        J = chain_j(sd, H_MAIN, dev)
        return (J,), torch.empty(H_MAIN, sd + 4, 4 * H_MAIN, device=dev), H_MAIN, sd
    _, _, x0, scal, a, dist = primal_operands(H_MAIN, dev, "sin")
    return ((x0, scal, a.reshape(-1).contiguous(), dist.reshape(-1).contiguous()),
            torch.empty(H_MAIN, 13, device=dev), H_MAIN, 13)


if __name__ == "__main__":
    main()
