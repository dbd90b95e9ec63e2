"""The sample + rollout kernels' share of their roofline in a traced
replay (readers.rollout_roofline)."""

from benchmark import readers


def read(run):
    return readers.rollout_roofline(run)
