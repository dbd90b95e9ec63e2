"""Registers, spills and shared memory of every kernel in ``csrc/``.

Compiles each ``csrc/*.cu`` once more with the port's flags and
``-Xptxas -v`` (object files in a temporary directory) and prints ptxas's
lines for each kernel: registers per thread, spill stores and loads, static
shared memory. Needs ``nvcc``; run on the machine with the card:
``python -m covo_mpc_tpu_torch.tools.ptxas_report``.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

from covo_mpc_tpu_torch.ops import kernels


def report(src: Path, out_dir: Path) -> list:
    proc = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         str(out_dir / f"{src.stem}.o"), str(src)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}{proc.stderr}")
    return [line.split("ptxas info    : ", 1)[-1].strip()
            for line in (proc.stdout + proc.stderr).splitlines()
            if "Compiling entry function" in line or "Used" in line
            or "spill" in line]


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        for src in sorted(kernels.CSRC.glob("*.cu")):
            print(f"{src.name}:")
            for line in report(src, Path(tmp)):
                print(f"  {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
