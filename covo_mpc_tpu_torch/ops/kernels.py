"""Build, load and launch the hand-written CUDA kernels in ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and links the objects into one
shared library with a plain C interface, under ``build/kernels/`` beside
the package, named by a hash of the sources (a rebuilt source gets a new
library; an unchanged one is reused). The library is loaded with
``ctypes``. Nothing here runs at import: the CPU tests import every module
of the package on machines without ``nvcc``.

Each C entry point launches on the stream it is given (PyTorch's current
stream) and returns ``cudaGetLastError()``; :meth:`Kernel.launch` raises if
that is not 0 and counts the launch. A build or launch failure raises.
Nothing falls back to the plain PyTorch versions: those are taken only for
tensors that lie on the CPU, by the wrappers in the ops modules.

Every operand is a device pointer or a value fixed for the solver's life,
so a launch can be captured into a CUDA graph (``runtime/graphs.py``): the
sampling kernels' Philox keys too are device words (``seed`` pointers,
written by :class:`~covo_mpc_tpu_torch.ops.sampling.SeedStream`), and so is
K7's episode offset (``offset``). A launch
made while the stream captures is recorded, not run: it goes to the
capture's tally (:func:`recording`), and the graph adds it to the count at
each replay.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -lineinfo: the SASS keeps its source lines (tools/sass_chain.py reads them);
# it does not change the code
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-lineinfo", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the entry points (csrc/*.cu); every one returns cudaError_t
_SIGNATURES = {
    "joint_sample_rollout": [*[_P] * 12, *[_I] * 6, _P],
    "primal": [_P, _P, _P, _P, _P, _I, _P],
    "sens_chain": [_P, _P, _I, _I, _I, _P],
    "rollout_costs": [*[_P] * 8, *[_I] * 6, _P],
    "sample_rollout": [*[_P] * 11, _I, _P, _P, _P, *[_I] * 6, _P],
    "rollout_costs_batched": [*[_P] * 8, *[_I] * 7, _P],
    "sample_rollout_batched": [*[_P] * 13, *[_I] * 7, _P],
    "joint_sample_rollout_batched": [*[_P] * 13, *[_I] * 7, _P],
    "joint_sample_rollout_info": [_I, _I, _P],
    "sample_rollout_info": [_I, _I, _I, _P],
    "rollout_costs_info": [_I, _I, _I, _P],
    "sigma_ns": [_P, _P, _P, _I, _F, _F, _F, _F, _I, _I, _I, _I, _I, _P],
    "sigma_ns_info": [_P],
}


# the ``__global__`` functions of csrc/*.cu: a profiler trace names a launch
# by its device function (K1 / K7 joint, K2, K3, K4 / K6 by the grid, K5 /
# K7 per-step by the grid, K8)
DEVICE_KERNELS = (
    "joint_sample_rollout_kernel",  # joint_sample_rollout.cu:183
    "primal_kernel",  # primal.cu:172
    "sens_chain_kernel",  # sens_chain.cu:104
    "rollout_step_kernel",  # rollout.cu:351
    "rollout_split_kernel",  # rollout.cu:539
    "sample_rollout_tile_kernel",  # sample_rollout.cu:147
    "sample_rollout_step_kernel",  # sample_rollout.cu:239
    "sigma_ns_kernel",  # sigma_ns.cu:326
)


def device_kernel(name: str):
    """The ``__global__`` function of ``csrc/`` that a trace's kernel name
    (demangled: ``void (anonymous namespace)::f<64, 128, 0>(float const*,
    ...)``) launches, or None for any other kernel. Matched by whole
    identifier: ``rollout_step_kernel`` is not ``sample_rollout_step_kernel``."""
    for token in re.findall(r"[A-Za-z_]\w*", name):
        if token in DEVICE_KERNELS:
            return token
    return None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _run_nvcc(args) -> None:
    proc = subprocess.run([_nvcc(), *args], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")


def _compile_all(obj_dir: Path) -> list:
    """One ``nvcc -c`` per ``csrc/*.cu``, all running at once; waits for
    every one, then raises if any failed. Returns the object paths."""
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = obj_dir / f"{src.stem}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return [str(obj) for _, obj, _ in jobs]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Compile (if the sources changed) and load the kernel library. Its
    ``build_seconds`` attribute is the nvcc time of this process (0.0 when
    the library was already built)."""
    build_seconds = 0.0
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libcovo_kernels_{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as obj_dir:
            objs = _compile_all(Path(obj_dir))
            _run_nvcc([*ARCH_FLAGS, "-shared", "-o", str(tmp), *objs])
        build_seconds = time.perf_counter() - t0
        os.replace(tmp, lib_path)  # atomic: concurrent builds agree
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.build_seconds = build_seconds
    return lib


# the launches recorded by the capture under way (None outside one)
_tally: "collections.Counter | None" = None


@contextlib.contextmanager
def recording():
    """Collect the launches recorded while a CUDA graph captures: yields a
    Counter of Kernel -> launches the graph holds."""
    global _tally
    if _tally is not None:
        raise RuntimeError("a capture is already recording launches")
    _tally = collections.Counter()
    try:
        yield _tally
    finally:
        _tally = None


class Kernel:
    """One C entry point of the library, with its launch count (counted
    only where the kernel is launched: a launch recorded into a CUDA graph
    counts at each replay of the graph)."""

    def __init__(self, symbol: str, source: str, replaces: str):
        self.symbol = symbol
        self.source = source  # the .cu file, path in the repository
        self.replaces = replaces  # file:line of the Pallas kernel it ports
        self.launches = 0

    def launch(self, *args) -> None:
        fn = getattr(library(), self.symbol)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA launch failed, cudaError {err}")
        if torch.cuda.is_current_stream_capturing():
            if _tally is None:
                raise RuntimeError(f"{self.symbol}: captured outside "
                                   "runtime.graphs, its launches would go uncounted")
            _tally[self] += 1
        else:
            self.launches += 1


def check_cuda(name: str, t: torch.Tensor, shape, dtype=torch.float32,
               device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``shape``/``dtype``
    (on ``device`` when given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def route(*tensors: torch.Tensor) -> str:
    """"plain" when every tensor lies on the CPU, "cuda" when every one
    lies on a CUDA device; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return "plain"
    if kinds == {"cuda"}:
        return "cuda"
    raise ValueError(f"kernel inputs on devices {sorted(kinds)}: need all "
                     "CPU (plain version) or all CUDA (kernel)")
