"""Variants of the joint sample + rollout kernel (``csrc/joint_sample_rollout.cu``,
K1 and K7 joint), side by side on one card: register use and spills,
blocks an SM holds, agreement with the committed kernel bit for bit, and
time.

Each variant is the kernel's source with a few lines replaced, launched
at S samples a block (the wrappers' ``block``): S = 64 and 128 on the
committed threads (128 and 256), the same S on T = S threads, F staged
32 columns at a time or held whole in shared memory in place of its
16-column stages, and the rollout inlined into the kernel (the compiler
then contracts two of the step's products otherwise, and the costs'
last bits move: that variant is expected to differ). The ablations of
the committed kernel at the wrappers' default S skip the draw (z = 0), the
correlate (a = clip(mean)), the rollout (costs 0) or the action stores;
their results are wrong, and only their times mean anything, as the cost
of the part they skip. Other sources with the same C entry points, given
on the command line (an earlier kernel, from ``git show
<commit>:covo_mpc_tpu_torch/csrc/joint_sample_rollout.cu``), join the
comparison under their file names, launched at ``--other-block`` samples a
block.

Every source is built with ``nvcc -Xptxas -v`` into its own library under
``build/joint_rollout_variants/`` (all builds at once) and launched
through ctypes at N=8192, H=32 with in-kernel draws: through the K1 entry
point at B=1 and the batched one at B=16, on domain-randomized reset
states, means and factors from numpy seed 0. Every variant that is not an
ablation is held against the committed kernel bit for bit on costs and
actions at B=1 and B=16 in each disturbance mode (shared, table, drag,
mixed) and reward (penyaw, realworld), and on given normals in the shared
mode. Times: CUDA events around 20 launches after 3, in four rounds whose
order alternates, all printed. Run on a machine with an NVIDIA GPU, from
the root of a checkout::

    python -m covo_mpc_tpu_torch.tools.joint_rollout_variants [other.cu ...]
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

N, H = 8192, 32
D = 4 * H
BATCHES = (1, 16)
ROUNDS = 4
OUT = kernels.BUILD_DIR.parent / "joint_rollout_variants"
# the disturbance type and task of each (mode, reward) the bits are held in
CASES = {("shared", "penyaw"): ("gaussian", "tracking_zigzag"),
         ("table", "penyaw"): ("sin", "tracking_zigzag"),
         ("drag", "penyaw"): ("drag", "tracking_zigzag"),
         ("mixed", "penyaw"): ("mixed", "tracking_zigzag"),
         ("shared", "realworld"): ("gaussian", "tracking_slow"),
         ("table", "realworld"): ("sin", "tracking_slow"),
         ("drag", "realworld"): ("drag", "tracking_slow"),
         ("mixed", "realworld"): ("mixed", "tracking_slow")}
T0 = 47  # a mixed redraw falls inside the horizon
F0 = (0.02, -0.01, 0.015)  # a start force

_T64 = "constexpr int kThreads64 = 128;"
_T128 = "constexpr int kThreads128 = 256;"
_KC = "constexpr int kKC = 16;"
_DRAW = "      if (n0 + s < N) {\n        r = rng::normals4("
_CHUNKS = "const int nchunks = (D + kKC - 1) / kKC;"
_FIRST = "  load_stage<kT>(F_s, F, D, 0, tid);\n"
_STORE = "  store_actions<kS, kT>(actions + off, z_s, D, N, n0, tid);\n"
_ROLL = "for (int h = 0; h < H; ++h) {"
_OUTLINE = "__device__ __noinline__ float rollout_cost("

COMMITTED = "as committed"
# name -> (edits of the committed source, samples a block or None: the
# wrappers' default)
VARIANTS = {
    f"{COMMITTED}, S=64 T=128": ([], 64),
    f"{COMMITTED}, S=128 T=256": ([], 128),
    "S=64 T=64": ([(_T64, _T64.replace("128", "64"))], 64),
    "S=128 T=128": ([(_T128, _T128.replace("256", "128"))], 128),
    "S=64 T=128, F in 32-column stages": ([(_KC, _KC.replace("16", "32"))], 64),
    "S=128 T=256, F in 32-column stages": ([(_KC, _KC.replace("16", "32"))], 128),
    "S=64 T=128, F whole": ([(_KC, _KC.replace("16", "128"))], 64),
    "S=128 T=256, F whole": ([(_KC, _KC.replace("16", "128"))], 128),
    "S=64 T=128, rollout inlined": ([(_OUTLINE, _OUTLINE.replace("noinline", "forceinline"))],
                                    64),
}
ABLATIONS = {
    "without the draw": [(_DRAW, _DRAW.replace("n0 + s < N", "false"))],
    "without the correlate": [(_CHUNKS, "const int nchunks = 0;"), (_FIRST, "")],
    "without the rollout": [(_ROLL, _ROLL.replace("h < H", "h < 0"))],
    "without the action stores": [(_STORE, "")],
}


def edited(source: str, name: str, edits) -> str:
    for old, new in edits:
        if old not in source or old == new:
            raise ValueError(f"{name!r}: the source no longer holds {old!r}, or the "
                             "edit changes nothing")
        source = source.replace(old, new)
    return source


def build_all(texts: dict, out: Path = OUT,
              entries=("joint_sample_rollout", "joint_sample_rollout_batched")) -> dict:
    """Compile every distinct source into its own library under ``out``,
    all nvcc runs at once, and bind those of its C ``entries`` it has;
    returns text -> (ptxas lines, the loaded library)."""
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, text in enumerate(dict.fromkeys(texts.values())):
        src, lib = out / f"v{i}.cu", out / f"v{i}.so"
        src.write_text(text)
        jobs[text] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-Xptxas", "-v",
             "-I", str(kernels.CSRC), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for text, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib.stem}:\n{log}")
        info, entry = [], ""
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '\S*?\d([a-z_]*kernel)I((?:Li\d+E)+)",
                          line)
            if m:
                entry = m.group(1) + "<" + ",".join(re.findall(r"Li(\d+)E", m.group(2))) + ">"
            elif "registers" in line or "spill" in line:
                info.append(f"{entry} {line.split('ptxas info    : ', 1)[-1].strip()}")
        cdll = ctypes.CDLL(str(lib))
        for name in entries:
            if not hasattr(cdll, name):
                continue
            fn = getattr(cdll, name)
            sig = kernels._SIGNATURES[name]
            if name in K7_ENTRIES and not offset_operand(text):
                sig = sig[1:]  # an earlier K7 source: no offset pointer
            fn.argtypes, fn.restype = sig, ctypes.c_int
        built[text] = (info, cdll)
    return built


# K7's entry points, which take the episode offset's pointer
K7_ENTRIES = ("sample_rollout_batched", "joint_sample_rollout_batched")


def offset_operand(text: str) -> tuple:
    """The episode-offset operand of a source's batched C entry point: a
    null pointer (offset 0) where the entry point takes one, none where an
    earlier source's does not."""
    return (None,) if "const int* offset" in text else ()


def seed_operand(text: str, word: torch.Tensor) -> int:
    """The Philox key operand for a source's C entry point: the address of
    the device word ``word`` where the source reads its key from device
    memory, the word's value where an earlier source takes it by value (the
    ctypes pointer type carries either as one 64-bit argument)."""
    if "const uint64_t* seed" in text:
        return word.data_ptr()
    return int(word.cpu())


def occupancy(cdll, block: int) -> str:
    """Threads, shared memory and blocks an SM of the penyaw
    instantiation, from the source's info entry point where it has one."""
    if not hasattr(cdll, "joint_sample_rollout_info"):
        return "no info entry point"
    fn = cdll.joint_sample_rollout_info
    fn.argtypes, fn.restype = kernels._SIGNATURES["joint_sample_rollout_info"], ctypes.c_int
    out = (ctypes.c_int * 8)()
    if fn(block, H, out) != 0:
        raise RuntimeError("joint_sample_rollout_info failed")
    return (f"T={out[0]}, {out[1]} B shared, {out[2]} blocks/SM, "
            f"{out[3]} / {out[6]} registers (penyaw / realworld)")


def operands(kind: str, task: str, B: int, dev, kernel_draw: bool = False):
    """Packed rollout operands of B domain-randomized scenarios of ``task``
    under the disturbance ``kind`` (reset states from seed 21, at t0 = 47
    with a start force, stochastic draws; with ``kernel_draw`` none, packed
    for K5's in-kernel draw, "krng"), with the mode and reward."""
    env = QuadEnv(EnvConfig(task=task, enable_randomizer=True, disturb_type=kind,
                            disable_rollover_terminate=True,
                            generate_noisy_state=True), device=dev)
    gen = torch.Generator(dev).manual_seed(21)
    params = [env.sample_params(gen) for _ in range(B)]
    sts = [env.reset(gen, p)[1]["noisy_state"] for p in params]
    x0 = torch.stack([pack_state(s) for s in sts])
    x0[:, 13:16] = torch.tensor(F0, device=dev)
    t0 = T0 + torch.arange(B, device=dev, dtype=torch.int32) % 4
    ops = rollout_cuda._launch_operands(
        env, x0, t0, torch.stack([s.pos_traj for s in sts]),
        torch.stack([s.vel_traj for s in sts]), stack_params(params),
        None if kernel_draw else env.draw_disturb(gen, B), False, 1.0, H, kernel_draw)
    return ops, rollout_cuda.MODES[rollout_cuda.disturb_mode(env)], \
        rollout_cuda.REWARDS[env.reward_name]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("others", nargs="*", help="other K1 / K7 joint sources to compare")
    ap.add_argument("--other-block", type=int, default=128,
                    help="samples a block the other sources are launched at")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    source = (kernels.CSRC / "joint_sample_rollout.cu").read_text()
    default = rollout_cuda.JOINT_BLOCK
    # name -> (source text, samples a block, ablation)
    runs = {name: (edited(source, name, edits), block, False)
            for name, (edits, block) in VARIANTS.items()}
    runs.update({name: (edited(source, name, edits), default, True)
                 for name, edits in ABLATIONS.items()})
    runs.update({Path(p).name: (Path(p).read_text(), args.other_block, False)
                 for p in args.others})
    built = build_all({name: text for name, (text, _, _) in runs.items()})
    for text, (info, _) in built.items():
        names = [n for n, (t, _, _) in runs.items() if t == text]
        print(f"{' | '.join(names)}: ptxas {'; '.join(info)}", flush=True)

    rng = np.random.default_rng(0)
    B = max(BATCHES)
    means = torch.from_numpy((rng.normal(size=(B, D)) * 0.2).astype(np.float32)).to(dev)
    factors = torch.from_numpy((rng.normal(size=(B, D, D)) * 0.05).astype(np.float32)).to(dev)
    z = torch.from_numpy(rng.standard_normal((B, D, N)).astype(np.float32)).to(dev)
    out = {b: (torch.empty(b, N, device=dev), torch.empty(b, D, N, device=dev))
           for b in BATCHES}
    stream = torch.cuda.current_stream().cuda_stream
    word = torch.full((), 7, dtype=torch.int64, device=dev)

    def key(text):
        return seed_operand(text, word)

    def launcher(name, ops, mode, reward, b, given_z=False):
        text, block, _ = runs[name]
        cdll = built[text][1]
        ptrs = [t.data_ptr() for t in ops]
        costs, acts = out[b]
        zp = z.data_ptr() if given_z else None
        if b == 1:
            fn, shape = cdll.joint_sample_rollout, ()
        else:
            fn, shape = cdll.joint_sample_rollout_batched, (b,)

        extra = offset_operand(text) if b > 1 else ()

        def launch():
            err = fn(*ptrs, means.data_ptr(), factors.data_ptr(), zp, key(text), *extra,
                     costs.data_ptr(),
                     acts.data_ptr(), *shape, N, H, 0, mode, reward, block, stream)
            if err != 0:
                raise RuntimeError(f"{name!r}: CUDA launch failed, cudaError {err}")
        return launch

    committed = next(iter(runs))
    for name, (text, block, _) in runs.items():
        print(f"{name}: {occupancy(built[text][1], block)}", flush=True)
    # bits against the committed kernel, every mode and reward, B = 1 and 16
    same = {name: True for name, (_, _, abl) in runs.items() if not abl}
    diffs = {name: 0.0 for name in runs}
    for (mode_name, reward_name), (kind, task) in CASES.items():
        ops16, mode, reward = operands(kind, task, B, dev)
        for b in BATCHES:
            ops = [t[:b].contiguous() for t in ops16]
            for given_z in ((False, True) if (mode_name, reward_name) ==
                            ("shared", "penyaw") else (False,)):
                launcher(committed, ops, mode, reward, b, given_z)()
                torch.cuda.synchronize()
                ref = tuple(t.clone() for t in out[b])
                for name, (_, _, abl) in runs.items():
                    launcher(name, ops, mode, reward, b, given_z)()
                    torch.cuda.synchronize()
                    if abl:
                        if mode_name == "shared" and reward_name == "penyaw" and not given_z:
                            diffs[name] = max(diffs[name], *(
                                float((x - y).abs().max()) for x, y in zip(out[b], ref)))
                        continue
                    equal = all(torch.equal(x, y) for x, y in zip(out[b], ref))
                    if not equal:
                        (c, a), (c_r, a_r) = out[b], ref
                        print(f"  {name}: differs from {committed!r} in {mode_name}/"
                              f"{reward_name}, B={b}{', given z' if given_z else ''}: "
                              f"actions {int((a != a_r).sum())} differ (max "
                              f"{float((a - a_r).abs().max()):.3e}), costs "
                              f"{int((c != c_r).sum())} of {c.numel()} differ (max "
                              f"{float((c - c_r).abs().max()):.3e})", flush=True)
                    same[name] = same[name] and equal
    for name, ok in same.items():
        print(f"{name}: costs and actions {'equal' if ok else 'NOT equal'} to "
              f"{committed!r} bit for bit in every mode and reward, B = 1 and {B}",
              flush=True)
    for name, d in diffs.items():
        if runs[name][2]:
            print(f"{name}: max |difference| from {committed!r} {d:.3e} "
                  "(an ablation: wrong by design)", flush=True)

    ops16, mode, reward = operands("gaussian", "tracking_zigzag", B, dev)
    for b in BATCHES:
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
