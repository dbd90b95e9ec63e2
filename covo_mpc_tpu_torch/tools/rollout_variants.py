"""Variants of the rollout-costs kernels (``csrc/rollout.cu``, K4 and K6),
side by side on one card with the kernel they replaced
(``tools/earlier/rollout.cu``): register use and spills, blocks an SM
holds, agreement bit for bit, time, and each step loop's instructions,
stall counts and critical path from its SASS, by part of the step.

Each variant is a source with a few lines replaced (``VARIANTS``: the
committed kernel at S = 32, 64 and 128 samples a block, a ring of 2 steps
in place of 4, either kernel at every grid size in place of the launch's
choice). The ablations' results are wrong, and only their times mean
anything, as the cost of what they leave out (``ABLATIONS``). Of the
earlier kernel: the state chain alone (no reward, termination or cost),
the reward alone on given states (each step's state read from its
actions), the actions at a fixed address (their loads leave the loop), the
division by m as a multiply, one disturbance mode compiled (the shared
mode's branch taken at compile time) and the targets at a fixed address.
Of the committed kernel: the split kernel's reward warp idle (it waits on
the ring and tallies nothing) and its actions at a fixed address; the step
kernel without the reward. The earlier kernel also runs at S = 64 (its
default is 128), a variant of its grid.

Every source is built with ``nvcc -Xptxas -v`` (and the port's flags) into its own
library under ``build/rollout_variants/`` (all builds at once) and launched
through ctypes. Every variant that is not an ablation is held against the
earlier kernel bit for bit on the costs at B in {1, 16}, N in {8192, 1000}
(ragged), H in {8, 32}, in every disturbance mode (shared, table, drag,
mixed) and reward (penyaw, realworld), with the rollover check on and off,
on domain-randomized scenarios from seed 21 whose even scenarios start at
p_x = 2.9 moving out (so samples pass |p| > 3 mid-horizon) and actions
0.8 N(0, 1) from numpy seed 0 (so others roll over). Times: CUDA events
around 20 launches after 3, in four rounds whose order alternates, at B =
1 and 16, N = 8192, H = 32, shared mode, penyaw, rollover off. The SASS:
``sass_chain.lined_sass`` of each library, each kernel's outermost loops
walked along the fast path (``sass_chain.step_loops``): instructions
(``count``), stall counts (``issue``), critical path and longest
recurrence (``chain_ms`` from it), with the
latencies ``sass_chain.measure_latencies`` reads on this card, at the SM
clock ``clocks.max.sm``; and the instructions by part (``PARTS``, by the
source line each came from). ``--loop-steps`` (default 300) also runs one
episode of MPPI with fast rng (K4) on the main path's env and replays each
K4 launch through the earlier kernel, counting launches that differ. Run on
a machine with an NVIDIA GPU, from the root of a checkout::

    python -m covo_mpc_tpu_torch.tools.rollout_variants [--loop-steps 300]
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv, pack_state
from covo_mpc_tpu_torch.models.structs import stack_params
from covo_mpc_tpu_torch.ops import kernels, rollout_cuda
from covo_mpc_tpu_torch.tools import sass_chain
from covo_mpc_tpu_torch.tools.joint_rollout_variants import CASES, build_all, edited

N_MAIN, H_MAIN = 8192, 32
BITS = [(b, n, h) for b in (1, 16) for n in (8192, 1000) for h in (8, 32)]
TIMED_B = (1, 16)
ROUNDS = 4
OUT = kernels.BUILD_DIR.parent / "rollout_variants"
EARLIER = Path(__file__).resolve().parent / "earlier" / "rollout.cu"
ENTRIES = ("rollout_costs", "rollout_costs_batched", "rollout_costs_info")
ENV_KW = dict(task="tracking_zigzag", enable_randomizer=False, disturb_type="gaussian",
              disable_rollover_terminate=True, generate_noisy_state=True)
T0 = 47  # a mixed redraw falls inside the horizon
F0 = (0.02, -0.01, 0.015)  # a start force
# the kernels whose step loops are counted: a name in the SASS -> label
SASS_KERNELS = {"rollout_kernelILi0E": "earlier kernel",
                "rollout_split_kernelILi0ELi0E": "split kernel",
                "rollout_step_kernelILi0ELi0E": "step kernel"}

EARLIER_NAME = "earlier (tools/earlier/rollout.cu)"
COMMITTED = "as committed"

_RING = "constexpr int kRing = 4;"
_CHOICE = "  const bool split = static_cast<long long>(grid.x) * B <= sms;"
_STEP_ADD = ("    c.add(reward<kReward>(s, tgt + 8 * h, tgt + 8 * h + 3),\n"
             "          done_at(s, t0 + h, max_steps, rollover), discount);\n")
_EMPTY_WAIT = "    if (h >= kRing) bar_wait(&r.empty[slot], (h / kRing - 1) & 1);\n"
_ROLES = "  if (role == 0) {\n"
_ACT_NEXT = "    a += h + 1 < H ? stride : 0;\n    load_actions(next, a, N);\n"
_DIV = "  return __double2float_rn(__dmul_rn(static_cast<double>(v), r));\n"
_SQRT = "  if (__float_as_uint(s) - 0x0d000000u > 0x727fffffu) return __fsqrt_rn(s);\n"
_ATT_MATH = ("    normalize(q, first_sum_sq<kReward>(q));\n", "    rotate(q, w, u.wt, k);\n")
_TR_MATH = "    translate(s, q, thrust, fd, k);\n"
# the earlier kernel's lines
_E_STEP = "    quad::rollout_step<kReward>(c, sh, h, a);\n"
_E_STORE = "  costs[(size_t)b * N + n] = c.cost;\n"
_E_ACTS = "    const float* a_h = acts + (size_t)(4 * h) * N + n;\n"
_INCLUDE = '#include "quad_core.cuh"\n'
_H_DIV_M = ("  s.vx = s.vx + (bzx * thrust + fdx) / m * dt;\n"
            "  s.vy = s.vy + (bzy * thrust + fdy) / m * dt;\n"
            "  s.vz = s.vz + (-g + (bzz * thrust + fdz) / m) * dt;\n")
_H_MODE = "  if (sh.mode == kShared) {\n"
_H_TARGETS = ("  const float* pt = sh.ptar + 3 * h;\n"
              "  const float* vt = sh.vtar + 3 * h;\n")


def header_edit(old: str, new: str) -> tuple:
    """An edit that pastes quad_core.cuh into the source with ``old``
    replaced by ``new`` there."""
    text = (kernels.CSRC / "quad_core.cuh").read_text()
    if old not in text:
        raise ValueError(f"quad_core.cuh no longer holds {old!r}")
    return (_INCLUDE, text.replace("#pragma once\n", "").replace(old, new))


# name -> (edits of the committed source, samples a block)
VARIANTS = {
    f"{COMMITTED}, S=64": ([], 64),
    f"{COMMITTED}, S=32": ([], 32),
    f"{COMMITTED}, S=128": ([], 128),
    "S=64, a ring of 2 steps": ([(_RING, _RING.replace("4", "2"))], 64),
    "S=64, the split kernel at every grid size": ([(_CHOICE, "  const bool split = true;")], 64),
    "S=64, the step kernel at every grid size": ([(_CHOICE, "  const bool split = false;")], 64),
    "S=64, the IEEE divisions and square roots": ([(_DIV, "  return __fdiv_rn(v, d);\n"),
                                                    (_SQRT, "  return __fsqrt_rn(s);\n")], 64),
    "S=64, the step kernel's targets from global memory": ([(_STEP_ADD, _STEP_ADD.replace(
        "tgt + 8 * h, tgt + 8 * h + 3", "t.ptar + 3 * h, t.vtar + 3 * h"))], 64),
}
# name -> (source: "earlier" or "committed", edits, samples a block)
ABLATIONS = {
    "earlier: the state chain alone": ("earlier", [
        (_E_STEP, "    quad::dyn_step(c.s, a, sh.fx, sh.fy, sh.fz, sh.scal);\n"),
        (_E_STORE, "  costs[(size_t)b * N + n] = c.s.px + c.s.qw + c.s.vz;\n")], 128),
    "earlier: the reward alone on given states": ("earlier", [
        (_E_STEP, "    c.s.px = a[0]; c.s.qy = a[1]; c.s.vx = a[2]; c.s.wz = a[3];\n"
                  "    quad::rollout_step<kReward>(c, sh, h, a);\n"),
        header_edit("  dyn_step(c.s, a, fdx, fdy, fdz, sh.scal);\n", "")], 128),
    "earlier: the actions at a fixed address": ("earlier", [
        (_E_ACTS, "    const float* a_h = acts + n;\n")], 128),
    "earlier: the division by m as a multiply": ("earlier", [
        header_edit(_H_DIV_M, _H_DIV_M.replace("/ m", "* m"))], 128),
    "earlier: one mode compiled (shared)": ("earlier", [
        header_edit(_H_MODE, "  if (true) {\n")], 128),
    "earlier: the targets at a fixed address": ("earlier", [
        header_edit(_H_TARGETS, "  const float* pt = sh.ptar;\n  const float* vt = sh.vtar;\n")],
        128),
    "split kernel: the attitude warp alone": ("committed", [
        (_EMPTY_WAIT, ""), (_ROLES, "  if (role != 0) return;\n" + _ROLES),
        (_CHOICE, "  const bool split = true;")], 64),
    "split kernel: the attitude and translation warps alone": ("committed", [
        (_EMPTY_WAIT, ""), (_ROLES, "  if (role > 1) return;\n" + _ROLES),
        (_CHOICE, "  const bool split = true;")], 64),
    "split kernel: the attitude warp's actions at a fixed address": ("committed", [
        (_ACT_NEXT, "    load_actions(next, a, N);\n"),
        (_CHOICE, "  const bool split = true;")], 64),
    "split kernel: the reward warps, the others' arithmetic left out": ("committed", [
        (_ATT_MATH[0], ""), (_ATT_MATH[1], ""), (_TR_MATH, ""),
        (_CHOICE, "  const bool split = true;")], 64),
    "step kernel: without the reward": ("committed", [
        (_STEP_ADD, "    c.add(s.px, done_at(s, t0 + h, max_steps, rollover), discount);\n"),
        (_CHOICE, "  const bool split = false;")], 64),
}

# parts of a step: by the function an instruction's source line lies in
# (the innermost, after inlining), else by the first pattern its line matches
FUNCTION_PARTS = {
    **dict.fromkeys(("load_actions",), "loads"),
    **dict.fromkeys(("reward_part", "yaw_of", "reward_finish", "reward", "penyaw_reward",
                     "realworld_reward", "log_pos_penalty", "step_reward", "clip01"), "reward"),
    **dict.fromkeys(("done_at", "add"), "termination and cost"),
    **dict.fromkeys(("force",), "force"),
    **dict.fromkeys(("action_map", "dyn_step", "clip1"), "action map"),
    **dict.fromkeys(("normalize", "rotate", "first_sum_sq"), "attitude"),
    **dict.fromkeys(("translate",), "translation"),
    **dict.fromkeys(("sqrt_exact", "rcp_d", "div_exact", "quat_normalize"),
                    "division and square root"),
    **dict.fromkeys(("bar_wait", "bar_arrive", "smem_addr"), "ring and barriers"),
}
PARTS = (
    ("ring and barriers", r"bar_wait|bar_arrive|\bsl\.|make_float4|\bu[0-3]\b"),
    ("loads", r"load_actions|__ldg|a_h|acts|a \+=|next\[|ptar|vtar|pt\[|vt\[|dh\["),
    ("termination and cost", r"d_now|d_prev|r_prev|cost|disc|max_steps|rollover"),
    ("translation", r"\bbz[xyz]\b|s\.p[xyz] =|s\.v[xyz] =|\bg\b|/ m\b"),
    ("attitude", r"\bqd[xyzw]\b|\bq[xyzw] =|s\.w[xyz] =|alpha"),
    ("force", r"\bfd|\brel|redraw|carry|c\.f[xyz]|f0[xyz]"),
)


def part_of(sources: dict):
    """``census``'s classifier over the source texts (file name -> lines)."""
    pats = [(name, re.compile(p)) for name, p in PARTS]

    def classify(ins) -> str:
        if ins.base in ("SYNCS", "BAR"):
            return "ring and barriers"
        if ins.base in ("LDG", "LD", "LDC"):
            return "loads"
        if ins.line is None:
            return "other"
        if ins.line[0].startswith("sm_32_intrinsics"):  # __ldg
            return "loads"
        part = FUNCTION_PARTS.get(_function_of(sources, ins.line))
        if part:
            return part
        lines = sources.get(ins.line[0])
        text = lines[ins.line[1] - 1] if lines and ins.line[1] <= len(lines) else ""
        return next((name for name, pat in pats if pat.search(text)), "other")
    return classify


def operands(kind: str, task: str, B: int, H: int, dev):
    """Packed rollout operands of B domain-randomized scenarios of ``task``
    under the disturbance ``kind`` (reset states from seed 21 at t0 = 47 ..
    50 with a start force; the even scenarios moved to p_x = 2.9, v_x = 0.6;
    stochastic draws), with the mode and reward."""
    env = QuadEnv(EnvConfig(task=task, enable_randomizer=True, disturb_type=kind,
                            disable_rollover_terminate=True,
                            generate_noisy_state=True), device=dev)
    gen = torch.Generator(dev).manual_seed(21)
    params = [env.sample_params(gen) for _ in range(B)]
    sts = [env.reset(gen, p)[1]["noisy_state"] for p in params]
    x0 = torch.stack([pack_state(s) for s in sts])
    x0[:, 13:16] = torch.tensor(F0, device=dev)
    x0[0::2, 0], x0[0::2, 7] = 2.9, 0.6
    t0 = T0 + torch.arange(B, device=dev, dtype=torch.int32) % 4
    ops = rollout_cuda._launch_operands(
        env, x0, t0, torch.stack([s.pos_traj for s in sts]),
        torch.stack([s.vel_traj for s in sts]), stack_params(params),
        env.draw_disturb(gen, B), False, 1.0, H)
    return ops, rollout_cuda.MODES[rollout_cuda.disturb_mode(env)], \
        rollout_cuda.REWARDS[env.reward_name]


def launcher(cdll, ops, acts, costs, B, N, H, rollover, mode, reward, block):
    """A closure launching ``cdll``'s K4 (B = 1) or K6 entry point on the
    stream current when it is made."""
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in ops]
    if B == 1:
        fn, args = cdll.rollout_costs, (N, H)
    else:
        fn, args = cdll.rollout_costs_batched, (B, N, H)
    call = (*ptrs, acts.data_ptr(), costs.data_ptr(), *args, rollover, mode, reward, block,
            stream)

    def launch():
        err = fn(*call)
        if err != 0:
            raise RuntimeError(f"rollout kernel: CUDA launch failed, cudaError {err}")
    return launch


def build_earlier(out: Path = OUT) -> tuple:
    """The earlier K4 / K6 (``tools/earlier/rollout.cu``) built: (ptxas
    lines, library)."""
    text = EARLIER.read_text()
    return build_all({"earlier": text}, out / "earlier", ENTRIES)[text]


def loop_bits(earlier, dev, steps: int = 300) -> tuple:
    """K4 on every input one eager episode of MPPI with fast rng gives it
    (the main path's env, ``steps`` steps from seed 1), each launch also run
    through the earlier kernel (``build_earlier``'s library, its default
    block of 128) on the same operands: (launches, launches that differ,
    max abs difference)."""
    from covo_mpc_tpu_torch.runtime.episode import eager_episode
    from covo_mpc_tpu_torch.solvers import get_solver

    env = QuadEnv(EnvConfig(**ENV_KW), device=dev)
    solver, _ = get_solver(env, "mppi", f"N{N_MAIN}_H{H_MAIN}_lam0.01", rng_mode="fast",
                           engine="cuda", collect_debug=False, seed=0)
    stats = [0, 0, 0.0]
    call = rollout_cuda.RolloutCosts.__call__

    def twice(self, x0, t0, pos_traj, vel_traj, actions, params, draw=None,
              deterministic=False, discount=1.0, layout="nhd"):
        costs = call(self, x0, t0, pos_traj, vel_traj, actions, params, draw, deterministic,
                     discount, layout)
        acts = (actions.permute(1, 2, 0) if layout == "nhd"
                else actions.reshape(-1, 4, actions.shape[-1])).contiguous()
        H, _, N = acts.shape
        ops = rollout_cuda._launch_operands(self.env, x0, t0, pos_traj, vel_traj, params,
                                            draw, deterministic, discount, H)
        ref = torch.empty(N, device=x0.device)
        launcher(earlier, ops, acts, ref, 1, N, H, self._check_rollover, self.mode,
                 self.reward, 128)()
        stats[0] += 1
        stats[1] += int(not torch.equal(costs, ref))
        stats[2] = max(stats[2], float((costs - ref).abs().max()))
        return costs

    rollout_cuda.RolloutCosts.__call__ = twice
    try:
        # eager: each launch is compared on the host as it runs
        solver.seed(1)
        eager_episode(env, solver, steps, torch.Generator(dev).manual_seed(1),
                      torch.Generator(dev).manual_seed(2))
    finally:
        rollout_cuda.RolloutCosts.__call__ = call
    return tuple(stats)


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def occupancy(cdll, block: int) -> str:
    if not hasattr(cdll, "rollout_costs_info"):
        return "no info entry point"
    rows = []
    for name, split in (("split", 1), ("step", 0)):
        g = (ctypes.c_int * 8)()
        if cdll.rollout_costs_info(block, H_MAIN, split, g) != 0:
            raise RuntimeError("rollout_costs_info failed")
        rows.append(f"{name} T={g[0]}, {g[1]} B shared, {g[2]} / {g[5]} blocks/SM, "
                    f"{g[3]} / {g[6]} registers, {g[4]} / {g[7]} local bytes")
    return "; ".join(rows) + " (penyaw / realworld)"


_FUNCTION = re.compile(r"^\s*(?:__global__|__device__)\b")


def _is_step_back(sources: dict):
    """Whether a backward branch closes a loop over the steps (its source
    line opens one), for ``sass_chain.step_loops``."""
    def is_back(ins) -> bool:
        lines = sources.get(ins.line[0]) if ins.line else None
        return bool(lines) and "for (int h" in lines[ins.line[1] - 1]
    return is_back


def _function_of(sources: dict, line) -> str:
    """The name of the function whose body holds the source ``line``."""
    lines = sources.get(line[0], [])
    for k in range(min(line[1], len(lines)) - 1, -1, -1):
        if _FUNCTION.match(lines[k]):
            names = [n for n in re.findall(r"(\w+)\(", lines[k]) if n != "__launch_bounds__"]
            return names[-1] if names else "?"
    return "?"


def _sources(source_dir: Path) -> dict:
    return {p.name: p.read_text().splitlines()
            for p in [*source_dir.glob("*.cu"), *kernels.CSRC.glob("*.cu*")]}


def kernel_loops(lib: Path, out_dir: Path, lat: dict, names=None) -> dict:
    """The step loops of the penyaw / shared-mode kernels ``lib`` holds, by
    kernel and the function holding the loop (``"split kernel, attitude"``,
    ... ``"step kernel"``, ``"earlier kernel"``): ``sass_chain.walk`` dicts,
    with ``parts``, the instructions by part (``PARTS``)."""
    sass = sass_chain.lined_sass(lib, out_dir)
    sources = _sources(Path(lib).parent)
    classify, is_back = part_of(sources), _is_step_back(sources)
    out = {}
    for key, label in (names or SASS_KERNELS).items():
        found = [text for fn, text in sass.items() if key in fn]
        if len(found) != 1:
            continue
        for loop in sass_chain.step_loops(found[0], lat, is_back):
            where = _function_of(sources, loop["path"][-1].line)
            name = label if where.endswith("kernel") else f"{label}, {where}"
            out[name] = dict(loop, parts=sass_chain.census(loop["path"], classify))
    return out


def loops_of(lib: Path, source_dir: Path, lat: dict, clock_mhz: float, sms: int) -> list:
    """Lines describing the step loops of each kernel of ``SASS_KERNELS``
    ``lib`` holds (``kernel_loops``): instructions, stall counts, critical
    path (cycles and ms over H_MAIN steps), issue_ms at B = 1 and 16,
    N_MAIN, and the instructions by part."""
    out = []
    for label, loop in kernel_loops(lib, OUT / "sass", lat).items():
        warps = [b * -(-N_MAIN // 32) for b in TIMED_B]
        out.append(
            f"  {label}: {loop['count']} instructions a step, stall counts "
            f"{loop['issue']} cycles, critical path {loop['cycles']:.1f} cycles, longest "
            f"recurrence {loop['recurrence']:.1f} (chain_ms "
            f"{sass_chain.chain_ms(H_MAIN, loop['recurrence'], clock_mhz):.4f}); "
            f"issue_ms " + ", ".join(
                f"B={b} {sass_chain.issue_ms(loop['count'], H_MAIN, w, sms, clock_mhz):.4f}"
                for b, w in zip(TIMED_B, warps))
            + "; by part: " + ", ".join(f"{k} {v}" for k, v in sorted(
                loop["parts"].items(), key=lambda kv: -kv[1])))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--loop-steps", type=int, default=300,
                    help="steps of the MPPI fast closed loop whose K4 launches are replayed "
                         "through the earlier kernel (0: none)")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    print(smi("name,power.limit"), flush=True)
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    committed, earlier = (kernels.CSRC / "rollout.cu").read_text(), EARLIER.read_text()
    # name -> (source text, samples a block, ablation)
    runs = {EARLIER_NAME: (earlier, 128, False),
            "earlier at S=64": (earlier, 64, False)}
    runs.update({name: (edited(committed, name, edits), block, False)
                 for name, (edits, block) in VARIANTS.items()})
    runs.update({name: (edited(earlier if src == "earlier" else committed, name, edits),
                        block, True)
                 for name, (src, edits, block) in ABLATIONS.items()})
    built = build_all({name: text for name, (text, _, _) in runs.items()}, OUT, ENTRIES)
    for text, (info, _) in built.items():
        names = [n for n, (t, _, _) in runs.items() if t == text]
        print(f"{' | '.join(names)}: ptxas {'; '.join(info)}", flush=True)
    for name, (text, block, _) in runs.items():
        print(f"{name}: {occupancy(built[text][1], block)}", flush=True)

    probe = sass_chain.load_probe(sass_chain.build_probe(OUT))
    lat = sass_chain.measure_latencies(probe)
    print("latencies, cycles: " + ", ".join(f"{k} {v:.2f}" for k, v in lat.items())
          + f"; SM clock {clock_mhz:.0f} MHz (clocks.max.sm), {sms} SMs", flush=True)
    for text in built:
        names = [n for n, (t, _, _) in runs.items() if t == text]
        lib = Path(built[text][1]._name)
        print(f"{names[0]}: step loops from the SASS", flush=True)
        for line in loops_of(lib, lib.parent, lat, clock_mhz, sms):
            print(line, flush=True)

    # bits against the earlier kernel
    rng = np.random.default_rng(0)
    acts = {(n, h): torch.from_numpy((0.8 * rng.standard_normal((16, h, 4, n))).astype(
        np.float32)).to(dev) for n in (8192, 1000) for h in (8, 32)}
    same = {name: True for name, (_, _, abl) in runs.items() if not abl}
    checked = 0
    for (mode_name, reward_name), (kind, task) in CASES.items():
        for H in (8, 32):
            ops16, mode, reward = operands(kind, task, 16, H, dev)
            for B, N, h in BITS:
                if h != H:
                    continue
                first = 0 if N == 8192 or B > 1 else 1  # B = 1: scenario 0 or 1
                ops = [t[first:first + B].contiguous() for t in ops16]
                a = acts[(N, H)][first:first + B].contiguous()
                for rollover in (0, 1):
                    ref = torch.empty(B, N, device=dev)
                    launcher(built[earlier][1], ops, a, ref, B, N, H, rollover, mode, reward,
                             128)()
                    torch.cuda.synchronize()
                    for name, (text, block, abl) in runs.items():
                        if abl:
                            continue
                        got = torch.full((B, N), float("nan"), device=dev)
                        launcher(built[text][1], ops, a, got, B, N, H, rollover, mode,
                                 reward, block)()
                        torch.cuda.synchronize()
                        if not torch.equal(got, ref):
                            same[name] = False
                            print(f"  {name}: differs from the earlier kernel in {mode_name}/"
                                  f"{reward_name}, B={B} N={N} H={H} rollover={rollover}: "
                                  f"{int((got != ref).sum())} of {got.numel()} costs (max "
                                  f"{float((got - ref).abs().max()):.3e})", flush=True)
                    checked += 1
    for name, ok in same.items():
        print(f"{name}: costs {'equal' if ok else 'NOT equal'} to the earlier kernel's bit "
              f"for bit in all {checked} cases (every mode, reward, B, N, H, rollover)",
              flush=True)

    # times: shared mode, penyaw, rollover off
    ops16, mode, reward = operands("gaussian", "tracking_zigzag", 16, H_MAIN, dev)
    for B in TIMED_B:
        ops = [t[:B].contiguous() for t in ops16]
        a = acts[(N_MAIN, H_MAIN)][:B].contiguous()
        out = torch.empty(B, N_MAIN, device=dev)
        launchers = {name: launcher(built[text][1], ops, a, out, B, N_MAIN, H_MAIN, 0, mode,
                                    reward, block)
                     for name, (text, block, _) in runs.items()}
        times = {name: [] for name in runs}
        for rnd in range(ROUNDS):
            for name in list(launchers)[::-1 if rnd % 2 else 1]:
                for _ in range(3):
                    launchers[name]()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(20):
                    launchers[name]()
                e1.record()
                torch.cuda.synchronize()
                times[name].append(e0.elapsed_time(e1) / 20)
        for name, ms in times.items():
            print(f"B={B} {name}{' (ablation)' if runs[name][2] else ''}: "
                  f"{' / '.join(f'{t:.4f}' for t in ms)} ms", flush=True)

    if args.loop_steps:
        n, bad, diff = loop_bits(built[earlier][1], dev, args.loop_steps)
        print(f"K4 in one {args.loop_steps}-step MPPI fast episode: {bad} of {n} launches "
              f"differ from the earlier kernel, max |diff| {diff:.3e}", flush=True)


if __name__ == "__main__":
    main()
