"""Device ms a step of the kernels launched inside the bench.env span (the
env step with its auto-reset and, in a fleet, the per-vehicle draws)."""

from benchmark import readers


def read(run):
    return readers.span_ms(run, "bench.env")
