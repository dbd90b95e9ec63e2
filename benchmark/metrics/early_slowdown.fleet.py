"""The window's first fifth's time a step over the remaining four fifths'
(untraced; host clock in a closed loop, CUDA events between replays in a
fleet)."""

from benchmark import yardstick


def read(run):
    return yardstick.early_slowdown(run["step_s"]) if len(run["step_s"]) >= 5 else None
