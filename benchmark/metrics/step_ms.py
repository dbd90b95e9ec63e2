"""The window's wall ms over the control steps completed in it."""

from benchmark import readers


def read(run):
    return readers.ms_a_step(run)
