"""Variants of the Sigma-designer kernel (``csrc/sigma_ns.cu``, K8), side by
side on one card: register use and spills, agreement with the plain
designer and with the committed kernel, repeatability, and time.

Each variant is the kernel's source with a few lines replaced: clusters of
4, 8 (as committed) and 16 CTAs, and ablations of the cluster-8 kernel that
skip the Cholesky, the copies of B's rows over distributed shared memory,
the products' FMA loops, or the cluster barriers inside the chain (their
results are wrong; only their times mean anything, as the cost of the part
they skip). The barrier ablation keeps one cluster barrier at the start and
the one before the CTAs exit, so that no CTA reads the shared memory of a
CTA that has not started or has exited. Other K8 sources with the same C
entry point, given on the command line, join the comparison under their
file names (an A/B of designs). Every variant is built with ``nvcc -Xptxas
-v`` into its own library under ``build/sigma_ns_variants/`` (all builds at
once) and launched through ctypes on the JAX kernel test's R at D=128 (numpy
seed 0). Times: CUDA events around 20 launches after 3, in four rounds
whose order alternates, all printed. Run on a machine with an NVIDIA GPU,
from the root of a checkout::

    python -m covo_mpc_tpu_torch.tools.sigma_ns_variants [other.cu ...]
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

from covo_mpc_tpu_torch.ops import covariance, kernels

D = 128
ROUNDS = 4
OUT = kernels.BUILD_DIR.parent / "sigma_ns_variants"
COMMITTED = "as committed (cluster of 8)"
_CLUSTER = "constexpr int kCluster = 8;"
_BARRIER = "void cluster_barrier() { cg::this_cluster().sync(); }"
_START = "  const int rank = static_cast<int>(cluster.block_rank());"
_CHOLESKY = "for (int j = 0; j < D; ++j) {\n    const float* cur"
_FETCH = "      if (f < n4) st[n][s] = src[f];"
_PUT = "      if (f < n4) dst[f] = st[n][s];"
_FMA = "for (int kk = 0; kk < D; kk += 4) {"


def _cluster(n: int):
    return [(_CLUSTER, f"constexpr int kCluster = {n};")]


VARIANTS = {
    COMMITTED: [],
    "cluster of 4": _cluster(4),
    "cluster of 16": _cluster(16),
    "without the Cholesky": [(_CHOLESKY, _CHOLESKY.replace("j < D", "j < 0"))],
    "without the DSMEM copies": [(_FETCH, _FETCH.replace("f < n4", "f < 0")),
                                 (_PUT, _PUT.replace("f < n4", "f < 0"))],
    "without the FMA loops": [(_FMA, _FMA.replace("kk < D", "kk < 0"))],
    "without the cluster barriers": [
        (_BARRIER, "void cluster_barrier() { __syncthreads(); }"),
        (_START, "  cluster.sync();\n" + _START)],
}
_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_float] * 4 + \
    [ctypes.c_int] * 5 + [ctypes.c_void_p]


def sources(others) -> dict:
    """Name -> source text: the variants of the committed kernel, then the
    given files."""
    source = (Path(kernels.CSRC) / "sigma_ns.cu").read_text()
    out = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise ValueError(f"{name!r}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        out[name] = text
    for path in others:
        out[Path(path).name] = Path(path).read_text()
    return out


def build_all(texts: dict) -> dict:
    """Compile every source into its own library, all nvcc runs at once;
    returns name -> (ptxas lines, the library's sigma_ns)."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, text) in enumerate(texts.items()):
        src, lib = OUT / f"v{i}.cu", OUT / f"v{i}.so"
        src.write_text(text)
        jobs[name] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-Xptxas", "-v",
             "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        info = [line.split("ptxas info    : ", 1)[-1].strip()
                for line in log.splitlines() if "registers" in line or "spill" in line]
        fn = ctypes.CDLL(str(lib)).sigma_ns
        fn.argtypes, fn.restype = _ARGS, ctypes.c_int
        built[name] = (info, fn)
    return built


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("others", nargs="*", help="other K8 sources to compare")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    A = np.random.default_rng(0).standard_normal((D, D))
    R = torch.from_numpy((A @ A.T / D - 0.3 * np.eye(D)).astype(np.float32)).to(dev)
    c_ref, _ = covariance.optimize_sigma_ns(R, 0.5, D)
    a_cov, factor = torch.empty(D, D, device=dev), torch.empty(D, D, device=dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    launchers, committed = {}, None
    for name, (info, fn) in build_all(sources(args.others)).items():

        def launch(fn=fn, name=name):
            err = fn(R.data_ptr(), a_cov.data_ptr(), factor.data_ptr(), D, 0.5,
                     covariance._LIFT_A, covariance._LIFT_B, covariance._LIFT_C,
                     14, 3, 4, 8, 5, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"{name!r}: CUDA launch failed, cudaError {err}")

        launch()
        torch.cuda.synchronize()
        first = (a_cov.clone(), factor.clone())
        committed = committed or first
        rel = float(torch.linalg.norm((first[0] - c_ref).double())
                    / torch.linalg.norm(c_ref.double()))
        launch()
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(first, committed))
        print(f"{name}: a_cov relative error {rel:.3e}, second launch "
              f"{'bit-identical' if torch.equal(first[0], a_cov) else 'differs'}, "
              f"{'equal' if same else 'not equal'} to the committed kernel's bits; "
              f"ptxas: {' | '.join(info)}", flush=True)
        launchers[name] = launch
    times = {name: [] for name in launchers}
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
        print(f"{name}: {' / '.join(f'{t:.4f}' for t in ms)} ms", flush=True)


if __name__ == "__main__":
    main()
