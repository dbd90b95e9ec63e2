"""What the metric readers (``benchmark/metrics/<metric>.py``) share: each
reads one number from a run's measurements, or returns None where the run
has nothing to read (the harness then leaves the metric out)."""

from __future__ import annotations

from benchmark import tracing, yardstick


def ms_a_step(run: dict) -> float:
    """The untraced window's wall ms a step."""
    return run["window_s"] / run["steps"] * 1e3


def span_ms(run: dict, name: str):
    spans = run.get("spans")
    if not spans or not spans["matched"]:
        return None
    return spans["seconds"][name] * 1e3


def rollout_roofline(run: dict):
    """Least time of the step's sample + rollout work (copied counts at the
    cell's B, N, H; published fp32 peak and memory rate) over the device
    time of the kernels that do it in a traced replay, in percent."""
    trace = run.get("trace")
    if not trace:
        return None
    seconds = tracing.kernel_seconds(trace["kernel_s"], run["rollout"]["kernels"])
    if seconds <= 0:
        return None
    counts = yardstick.COUNTS[run["rollout"]["counts"]](run["vehicles"], run["N"], run["H"])
    return yardstick.bound_ms(*counts) / (seconds / run["trace_reps"] * 1e3) * 100.0


def device_idle(run: dict):
    """1 - (traced device-busy ms a replay) / (untraced wall ms a step), %."""
    trace = run.get("trace")
    if not trace or not trace["busy_s"]:
        return None
    return (1.0 - trace["busy_s"] / run["trace_reps"] * 1e3 / ms_a_step(run)) * 100.0
