"""Spreads of sets of runs and the bounds they suggest.

    python -m benchmark.tools.spread set_a/*.out -- set_b/*.out

Each file holds one run's output, the result line last. For each metric,
each set's spread (the quartile distance over the median,
``statistics.quantiles(n=4)``), the wider one, and about five times it,
never under 1%: the bound the benchmark's rules ask for."""

from __future__ import annotations

import json
import sys

from benchmark import yardstick


def load(paths) -> dict:
    out: dict = {}
    for path in paths:
        with open(path) as fh:
            line = json.loads(fh.read().strip().splitlines()[-1])
        for name, m in line["metrics"].items():
            out.setdefault(name, []).append(m["value"])
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cut = argv.index("--") if "--" in argv else len(argv)
    sets = [load(argv[:cut])] + ([load(argv[cut + 1:])] if cut < len(argv) else [])
    for name in sets[0]:
        spreads = [yardstick.spread(s[name]) for s in sets if len(s.get(name, [])) >= 2]
        medians = [yardstick.quartiles(s[name])[1] for s in sets if len(s.get(name, [])) >= 2]
        widest = max(spreads)
        print(f"{name}: medians {medians} spreads {[round(x, 5) for x in spreads]} "
              f"bound ~{max(0.01, 5 * widest):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
