"""Variants of the Sigma-designer kernel (``csrc/sigma_ns.cu``, K8), side by
side on one card: register use and spills, agreement with the plain
designer, and time.

Each variant is the kernel's source with a few lines replaced: the
1024-thread 4x4-tile layout, an inlined ``matmul``, and ablations that skip
the Cholesky, the operand staging or the products' FMA loops (their results
are wrong; only their times mean anything, as the cost of the part they
skip). Each is built with ``nvcc -Xptxas -v`` into its own library under
``build/sigma_ns_variants/`` and launched through ctypes on the JAX kernel
test's R at D=128 (numpy seed 0). Times: CUDA events around 20 launches
after 3. Run on a machine with an NVIDIA GPU, from the root of a checkout::

    python -m covo_mpc_tpu_torch.tools.sigma_ns_variants
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

from covo_mpc_tpu_torch.ops import covariance, kernels

D = 128
OUT = kernels.BUILD_DIR.parent / "sigma_ns_variants"
_MATMUL = "__device__ __noinline__ void matmul("
_STAGE_A = "      if (e < D * kn) {"
_STAGE_B = "      if (e < kn * D) {"
_FMA = "    if (active) {\n      for (int kk = 0; kk < kn; ++kk) {"
_CHOLESKY = "  for (int j = 0; j < D; ++j) {\n    const float piv"
_T1024 = [
    ("constexpr int kThreads = 512;", "constexpr int kThreads = 1024;"),
    ("constexpr int kRows = 8, kCols = 4;", "constexpr int kRows = 4, kCols = 4;"),
    ("        const float4 a1 = *reinterpret_cast<const float4*>"
     "(c.As + kk * kAStride + row + 4);\n", ""),
    ("{a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w}", "{a0.x, a0.y, a0.z, a0.w}"),
]
_INLINE = [(_MATMUL, "__device__ void matmul(")]
_NO_STAGING = [(_STAGE_A, "      if (e < 0) {"), (_STAGE_B, "      if (e < 0) {")]
_NO_FMA = [(_FMA, _FMA.replace("kk < kn", "kk < 0"))]
VARIANTS = {
    "as committed (512 threads, 8x4 tiles)": [],
    "matmul inlined": _INLINE,
    "1024 threads, 4x4 tiles": _T1024,
    "1024 threads, 4x4 tiles, matmul inlined": _T1024 + _INLINE,
    "without the Cholesky": [(_CHOLESKY, _CHOLESKY.replace("j < D", "j < 0"))],
    "without operand staging": _NO_STAGING,
    "without the FMA loops": _NO_FMA,
    "without staging and FMA loops": _NO_STAGING + _NO_FMA,
}
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_float] * 4 + \
    [ctypes.c_int] * 5 + [ctypes.c_void_p]


def build(name: str, source: str):
    """Compile one variant into its own library; returns (ptxas lines, the
    library)."""
    OUT.mkdir(parents=True, exist_ok=True)
    stem = "".join(ch if ch.isalnum() else "_" for ch in name)
    src, lib = OUT / f"{stem}.cu", OUT / f"{stem}.so"
    src.write_text(source)
    proc = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-Xptxas", "-v",
         "-o", str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name!r}:\n{proc.stdout}{proc.stderr}")
    info = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
            if "registers" in line or "spill" in line]
    fn = ctypes.CDLL(str(lib)).sigma_ns
    fn.argtypes, fn.restype = _ARGS, ctypes.c_int
    return info, fn


def main() -> None:
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    A = np.random.default_rng(0).standard_normal((D, D))
    R = torch.from_numpy((A @ A.T / D - 0.3 * np.eye(D)).astype(np.float32)).to(dev)
    c_ref, _ = covariance.optimize_sigma_ns(R, 0.5, D)
    a_cov, factor = torch.empty(D, D, device=dev), torch.empty(D, D, device=dev)
    ws = torch.empty(7, D, D, device=dev)
    source = (Path(kernels.CSRC) / "sigma_ns.cu").read_text()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise ValueError(f"{name!r}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        info, fn = build(name, text)
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            err = fn(R.data_ptr(), a_cov.data_ptr(), factor.data_ptr(), ws.data_ptr(),
                     D, 0.5, covariance._LIFT_A, covariance._LIFT_B,
                     covariance._LIFT_C, 14, 3, 4, 8, 5, stream)
            if err != 0:
                raise RuntimeError(f"{name!r}: CUDA launch failed, cudaError {err}")

        launch()
        torch.cuda.synchronize()
        rel = float(torch.linalg.norm((a_cov - c_ref).double())
                    / torch.linalg.norm(c_ref.double()))
        for _ in range(3):
            launch()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(20):
            launch()
        e1.record()
        torch.cuda.synchronize()
        print(f"{name}: {e0.elapsed_time(e1) / 20:.4f} ms, a_cov relative error "
              f"{rel:.3e}; ptxas: {' | '.join(info)}", flush=True)


if __name__ == "__main__":
    main()
