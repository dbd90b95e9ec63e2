"""Entry point: ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout (or ``python
-m benchmark.run``). See ``benchmark/harness.py``."""

import os
import time

T0 = time.monotonic()


def _age() -> float:
    """Seconds from this process's start to T0 (/proc; 0.0 where unreadable)."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK") - (time.monotonic() - T0), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


AGE0 = _age()

import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t0=T0, age0=AGE0))
