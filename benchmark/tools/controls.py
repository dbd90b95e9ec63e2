"""Readings that the limits are set from, on the card: for one cell and a
list of seeds, in one process, each seed's checked replays (chosen as a
run chooses them, the restart among them; those past the short window
replayed after it) judged twice against the float64 reference: the
program's answers (the lower readings) and the control's, the reference
itself one precision down (the upper readings).

    python -m benchmark.tools.controls --workload covo.fleet --seconds 3 \
        --seeds 2147483711 2147483712 ... [--json readings.json]

Prints one line a seed and the largest program reading and smallest
control reading of each number; beside it the smallest of the control's
largest finite readings and how many of its answers were not finite."""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import check, harness, system, window


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    spec = harness.cell_spec(args.workload)
    cfg, traffic, limits = spec["config"], spec["traffic"], spec["limits"]
    card = harness.card()
    print(f"{args.workload} on {card['kind']}, power limit {card['power_limit']}", flush=True)
    sut = system.build(cfg, traffic, args.seeds[0])
    rows = []
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        if i:
            sut.start(seed)
        for _ in range(int(traffic["warmup_steps"])):
            sut.step()
        w = window.run(sut, args.seconds,
                       harness.check_steps(seed, traffic, sut.to_restart()))
        window.catch_up(sut, w)
        prog = check.judge(cfg, w["records"], limits)
        ctrl = check.judge(cfg, w["records"], limits, control=True)
        rows.append(dict(seed=seed, program=prog["numbers"], control=ctrl["numbers"],
                         control_finite=ctrl["finite"],
                         program_correct=prog["correct"], control_correct=ctrl["correct"],
                         worst=prog["worst"],
                         steps=w["steps"], seconds=time.perf_counter() - t0))
        print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for name in rows[0]["program"]:
        finite = [r["control_finite"][name]["largest"] for r in rows]
        summary[name] = dict(lower=max(r["program"][name] for r in rows),
                             upper=min(r["control"][name] for r in rows),
                             upper_finite=min((x for x in finite if x is not None),
                                              default=None),
                             control_nonfinite=sum(r["control_finite"][name]["nonfinite"]
                                                   for r in rows))
    print(json.dumps(dict(workload=args.workload, card=card, summary=summary)))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(dict(workload=args.workload, card=card, rows=rows, summary=summary),
                      fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
