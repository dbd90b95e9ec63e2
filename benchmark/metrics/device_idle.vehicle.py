"""The device's idle share of a step: traced busy time a replay over the
untraced window's ms a step (readers.device_idle)."""

from benchmark import readers


def read(run):
    return readers.device_idle(run)
