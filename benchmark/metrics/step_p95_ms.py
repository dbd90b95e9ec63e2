"""The 95th percentile of every step's host wall ms in the window (launch
to action on the host)."""

from benchmark import yardstick


def read(run):
    return yardstick.percentile(run["step_s"], 95.0) * 1e3
