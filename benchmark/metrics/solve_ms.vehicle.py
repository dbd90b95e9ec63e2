"""Device ms a step of the kernels launched inside the bench.solve span
(the solve, or the fleet's batched twin), over a few eager steps."""

from benchmark import readers


def read(run):
    return readers.span_ms(run, "bench.solve")
