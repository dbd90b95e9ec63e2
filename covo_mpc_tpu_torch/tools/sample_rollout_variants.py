"""Variants of the per-step sample + rollout kernel (``csrc/sample_rollout.cu``,
K5 and K7 per-step), side by side on one card: register use and spills,
blocks an SM holds, agreement with the committed kernel bit for bit, and
time.

Each variant is the kernel's source with a few lines replaced, launched
at S samples a block (the wrappers' ``block``): S = 32, 64 and 128 as
committed, and at the wrappers' default S: the tile kernel on 256 or 1024
threads a block (``kTileThreads``, committed 512), either kernel at every
grid size (in place of the launch's choice: the tile kernel when the grid
has no more blocks than the card has SMs), the tile kernel's rollout
inlined (in place of its out-of-line ``rollout_cost``) or reading its
tables through the reference (in place of its copy in registers), and the
step kernel reading its factors and means from global memory (in place of
shared memory) or drawing each step in its turn (in place of one step
ahead). The ablations skip the draw (z = 0), the correlate (a = clip(z)),
the rollout (costs 0) or the action stores, of the tile kernel or of the
step kernel, each run at every grid size; their results are wrong, and
only their times mean anything, as the cost of the part they skip. Other
sources with the same C entry points, given on the command line (an
earlier kernel, from ``git show
<commit>:covo_mpc_tpu_torch/csrc/sample_rollout.cu``), join the comparison
under their file names, launched with ``--other-block`` as their block.

Every source is built with ``nvcc -Xptxas -v`` into its own library under
``build/sample_rollout_variants/`` (all builds at once) and launched
through ctypes at N=8192, H=32: through the K5 entry point at B=1 and the
batched one at B=4 and 16, on domain-randomized reset states, means and
factors from numpy seed 0. Every variant that is not an ablation is held against
the committed kernel bit for bit on costs and actions at B=1 and B=16 with
in-kernel draws in each disturbance mode (shared, table, drag, mixed) and
reward (penyaw, realworld), on given normals in the shared mode, and with
the in-kernel shared disturbance draw ("krng", B=1, both rewards; its
draw_out too). Times: CUDA events around 20 launches after 3, in four
rounds whose order alternates, all printed. Run on a machine with an
NVIDIA GPU, from the root of a checkout::

    python -m covo_mpc_tpu_torch.tools.sample_rollout_variants [other.cu ...]
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

from covo_mpc_tpu_torch.ops import kernels, rollout_cuda
from covo_mpc_tpu_torch.tools.joint_rollout_variants import (
    CASES,
    build_all,
    edited,
    operands,
    offset_operand,
    seed_operand,
)

N, H = 8192, 32
BATCHES = (1, 16)  # the bits are held at these, the times taken at TIMED
TIMED = (1, 4, 16)
ROUNDS = 4
OUT = kernels.BUILD_DIR.parent / "sample_rollout_variants"
ENTRIES = ("sample_rollout", "sample_rollout_batched", "sample_rollout_info")

_TILE_T = "constexpr int kTileThreads = 512;"
_CHOICE = "  if (static_cast<long long>(grid.x) * B > sms) {"
_OUTLINE = "__device__ __noinline__ float rollout_cost("
_COPY = "  const quad::RolloutShared sh = shared;\n"
_DRAW = """        zh = rng::normals4(
            make_uint4(static_cast<uint32_t>(h), static_cast<uint32_t>(n), 0u, slot),
            seed);
"""
_CORRELATE = """      a[0] = quad::clip1(m[0] + L[0] * zh.x);
      a[kS] = quad::clip1(m[1] + L[4] * zh.x + L[5] * zh.y);
      a[2 * kS] = quad::clip1(m[2] + L[8] * zh.x + L[9] * zh.y + L[10] * zh.z);
      a[3 * kS] = quad::clip1(m[3] + L[12] * zh.x + L[13] * zh.y + L[14] * zh.z +
                              L[15] * zh.w);
"""
_ROLL = "    quad::rollout_step<kReward>(c, sh, h, a4);\n"
_STORE = "    store_tile<kS>(actions + off, a_s, H, N, n0, tid - kS, kT - kS);\n"
_STEP_FACTORS = """    const float* m = m_s + 4 * h;
    const float* L = L_s + 16 * h;
"""
_STEP_AHEAD = ("  float4 znext = draw(0);\n",
               "    const float4 zh = znext;\n    if (h + 1 < H) znext = draw(h + 1);\n")
_STEP_DRAW = """    return rng::normals4(
        make_uint4(static_cast<uint32_t>(h), static_cast<uint32_t>(n), 0u, slot),
        seed);
"""
_STEP_CORRELATE = """        quad::clip1(m[0] + L[0] * zh.x),
        quad::clip1(m[1] + L[4] * zh.x + L[5] * zh.y),
        quad::clip1(m[2] + L[8] * zh.x + L[9] * zh.y + L[10] * zh.z),
        quad::clip1(m[3] + L[12] * zh.x + L[13] * zh.y + L[14] * zh.z +
                    L[15] * zh.w)};
"""
_STEP_ROLL = "    quad::rollout_step<kReward>(c, sh, h, a);\n"
_STEP_STORE = ("    for (int k = 0; k < 4; ++k) actions[off + (size_t)(4 * h + k) * N + n] = "
               "a[k];\n")

COMMITTED = "as committed"


def always(kernel: str) -> list:
    """The edit that runs ``kernel`` ("tile" or "step") at every grid size."""
    return [(_CHOICE, f"  if ({str(kernel == 'step').lower()}) {{")]


def variants(default: int) -> dict:
    """name -> (edits of the committed source, samples a block); the
    committed kernel at the default S first."""
    out = {f"{COMMITTED}, S={s}": ([], s)
           for s in sorted(rollout_cuda.SAMPLE_BLOCKS, key=lambda s: s != default)}
    for t in (256, 1024):
        out[f"S={default}, tile kernel on {t} threads a block"] = (
            [(_TILE_T, _TILE_T.replace("512", str(t)))], default)
    for k in ("tile", "step"):
        out[f"S={default}, the {k} kernel at every grid size"] = (always(k), default)
    out[f"S={default}, tile kernel's rollout inlined"] = (
        [(_OUTLINE, _OUTLINE.replace("noinline", "forceinline"))], default)
    out[f"S={default}, tile kernel's rollout reading its tables by reference"] = (
        [(_COPY, _COPY.replace("RolloutShared sh", "RolloutShared& sh"))], default)
    out[f"S={default}, step kernel reading its factors from global memory"] = (
        [(_STEP_FACTORS, "    const float* m = mean + 4 * (b * H + h);\n"
                         "    const float* L = chol + 16 * (b * H + h);\n")], default)
    out[f"S={default}, step kernel drawing each step in its turn"] = (
        [(_STEP_AHEAD[0], ""), (_STEP_AHEAD[1], "    const float4 zh = draw(h);\n")], default)
    return out


ABLATIONS = {
    "tile kernel without the draw": always("tile") + [
        (_DRAW, "        zh = make_float4(0.0f, 0.0f, 0.0f, 0.0f);\n")],
    "tile kernel without the correlate": always("tile") + [(_CORRELATE, "".join(
        f"      a[{k}] = quad::clip1(zh.{c});\n"
        for k, c in (("0", "x"), ("kS", "y"), ("2 * kS", "z"), ("3 * kS", "w"))))],
    "tile kernel without the rollout": always("tile") + [(_ROLL, "")],
    "tile kernel without the action stores": always("tile") + [(_STORE, "")],
    "step kernel without the draw": always("step") + [
        (_STEP_DRAW, "    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);\n")],
    "step kernel without the correlate": always("step") + [(_STEP_CORRELATE, """        quad::clip1(zh.x), quad::clip1(zh.y), quad::clip1(zh.z),
        quad::clip1(zh.w)};
""")],
    "step kernel without the rollout": always("step") + [(_STEP_ROLL, "")],
    "step kernel without the action stores": always("step") + [(_STEP_STORE, "")],
}


def occupancy(cdll, block: int) -> str:
    """Threads, shared memory, blocks an SM, registers and local memory of
    each geometry, from the source's info entry point where it has one."""
    if not hasattr(cdll, "sample_rollout_info"):
        return "no info entry point"
    rows = []
    for name, tile in (("tile", 1), ("step", 0)):
        out = (ctypes.c_int * 8)()
        if cdll.sample_rollout_info(block, H, tile, out) != 0:
            raise RuntimeError("sample_rollout_info failed")
        rows.append(f"{name} T={out[0]}, {out[1]} B shared, {out[2]} / {out[5]} blocks/SM, "
                    f"{out[3]} / {out[6]} registers, {out[4]} / {out[7]} local bytes")
    return "; ".join(rows) + " (penyaw / realworld)"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("others", nargs="*", help="other K5 / K7 per-step sources to compare")
    ap.add_argument("--other-block", type=int, default=128,
                    help="the block argument the other sources are launched with")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    source = (kernels.CSRC / "sample_rollout.cu").read_text()
    default = rollout_cuda.SAMPLE_BLOCK
    # name -> (source text, samples a block, ablation)
    runs = {name: (edited(source, name, edits), block, False)
            for name, (edits, block) in variants(default).items()}
    runs.update({name: (edited(source, name, edits), default, True)
                 for name, edits in ABLATIONS.items()})
    runs.update({Path(p).name: (Path(p).read_text(), args.other_block, False)
                 for p in args.others})
    built = build_all({name: text for name, (text, _, _) in runs.items()}, OUT, ENTRIES)
    for text, (info, _) in built.items():
        names = [n for n, (t, _, _) in runs.items() if t == text]
        print(f"{' | '.join(names)}: ptxas {'; '.join(info)}", flush=True)

    rng = np.random.default_rng(0)
    B = max(BATCHES)
    means = torch.from_numpy((rng.normal(size=(B, H, 4)) * 0.2).astype(np.float32)).to(dev)
    A = rng.normal(size=(B, H, 4, 4)) * 0.2
    chols = torch.from_numpy(np.linalg.cholesky(
        A @ A.swapaxes(-1, -2) + 0.05 * np.eye(4)).astype(np.float32)).to(dev)
    z = torch.from_numpy(rng.standard_normal((B, H, 4, N)).astype(np.float32)).to(dev)
    out = {b: (torch.empty(b, N, device=dev), torch.empty(b, 4 * H, N, device=dev))
           for b in TIMED}
    draw_out = torch.zeros(3, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    words = [torch.full((), v, dtype=torch.int64, device=dev) for v in (7, 8)]

    def launcher(name, ops, mode, reward, b, given_z=False, krng=False):
        text, block, _ = runs[name]
        cdll = built[text][1]
        ptrs = [t.data_ptr() for t in ops]
        costs, acts = out[b]
        zp = z.data_ptr() if given_z else None
        seed, disturb_seed = (seed_operand(text, w) for w in words)
        if b == 1:
            fn = cdll.sample_rollout
            rest = (disturb_seed, int(krng), draw_out.data_ptr() if krng else None,
                    costs.data_ptr(), acts.data_ptr(), N)
        else:
            fn = cdll.sample_rollout_batched
            rest = (*offset_operand(text), costs.data_ptr(), acts.data_ptr(), b, N)

        def launch():
            err = fn(*ptrs, means.data_ptr(), chols.data_ptr(), zp, seed, *rest, H, 0, mode,
                     reward, block, stream)
            if err != 0:
                raise RuntimeError(f"{name!r}: CUDA launch failed, cudaError {err}")
        return launch

    committed = next(iter(runs))
    for name, (text, block, _) in runs.items():
        print(f"{name}: {occupancy(built[text][1], block)}", flush=True)
    # bits against the committed kernel: every mode and reward at B = 1 and
    # 16, given z (shared, penyaw), krng (shared, B = 1, both rewards)
    checks = [(case, b, False, False) for case in CASES for b in BATCHES]
    checks += [(("shared", "penyaw"), b, True, False) for b in BATCHES]
    checks += [(("shared", reward), 1, False, True) for reward in ("penyaw", "realworld")]
    same = {name: True for name, (_, _, abl) in runs.items() if not abl}
    diffs = {name: 0.0 for name in runs}
    for (mode_name, reward_name), b, given_z, krng in checks:
        kind, task = CASES[(mode_name, reward_name)]
        ops16, mode, reward = operands(kind, task, B, dev, kernel_draw=krng)
        ops = [t[:b].contiguous() for t in ops16]
        launcher(committed, ops, mode, reward, b, given_z, krng)()
        torch.cuda.synchronize()
        ref = tuple(t.clone() for t in out[b]) + (draw_out.clone(),)
        for name, (_, _, abl) in runs.items():
            draw_out.zero_()
            launcher(name, ops, mode, reward, b, given_z, krng)()
            torch.cuda.synchronize()
            got = tuple(out[b]) + (draw_out,)
            if abl:
                if (mode_name, reward_name, given_z, krng) == ("shared", "penyaw", False, False):
                    diffs[name] = max(diffs[name], *(
                        float((x - y).abs().max()) for x, y in zip(got[:2], ref)))
                continue
            equal = all(torch.equal(x, y) for x, y in zip(got, ref))
            if not equal:
                (c, a, d), (c_r, a_r, d_r) = got, ref
                share = float((c != c_r).float().mean())
                print(f"  {name}: differs from {committed!r} in {mode_name}/{reward_name}, "
                      f"B={b}{', given z' if given_z else ''}{', krng' if krng else ''}: "
                      f"actions {int((a != a_r).sum())} differ (max "
                      f"{float((a - a_r).abs().max()):.3e}), costs {int((c != c_r).sum())} "
                      f"of {c.numel()} differ ({100 * share:.2f}%, max "
                      f"{float((c - c_r).abs().max()):.3e}), draw_out equal "
                      f"{torch.equal(d, d_r)}", flush=True)
            same[name] = same[name] and equal
    for name, ok in same.items():
        print(f"{name}: costs and actions {'equal' if ok else 'NOT equal'} to "
              f"{committed!r} bit for bit in every mode and reward, B = 1 and {B}, "
              "given z and krng", flush=True)
    for name, d in diffs.items():
        if runs[name][2]:
            print(f"{name}: max |difference| from {committed!r} {d:.3e} "
                  "(an ablation: wrong by design)", flush=True)

    ops16, mode, reward = operands("gaussian", "tracking_zigzag", B, dev)
    for b in TIMED:
        ops = [t[:b].contiguous() for t in ops16]
        launchers = {name: launcher(name, ops, mode, reward, b) for name in runs}
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
            print(f"B={b} {name}: {' / '.join(f'{t:.4f}' for t in ms)} ms", flush=True)


if __name__ == "__main__":
    main()
