"""The benchmark's fixed arithmetic: the card's published peaks, what each
sampling kernel must compute and move (from shapes, never from a kernel's
code), the static memory of a fleet, and the statistics of timings.

The operation and byte counts are copied from the program's own
accounting (``covo_mpc_tpu_torch/ops/counts.py``: ``k1_counts``,
``k5_counts``, ``rollout_bytes``, ``step_flops``) and the memory rows from
``covo_mpc_tpu_torch/scripts/pod_scale.py::hbm_arithmetic``, so that a
change to the program cannot move the yardstick.
"""

from __future__ import annotations

import math
import statistics

# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores and HBM3 rate
FP32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# fp32 operations of one sample's rollout step (the action map, the
# body-rate step and the penyaw reward, a transcendental counted as one)
STEP_FLOPS = 190
BOX_MULLER_FLOPS = 5  # per normal: log, sqrt, sin/cos and scaling per pair


def rollout_bytes(B: int, N: int, H: int) -> int:
    """Per-vehicle tables of a rollout kernel (shared force, penyaw): x0
    (16), position and velocity targets (6H), scalar pack (17), int pack
    (3) and the costs (N), fp32."""
    return 4 * B * (16 + 6 * H + 17 + 3 + N)


def joint_counts(B: int, N: int, H: int):
    """CoVO's joint sample + rollout (K1, K7 joint): the factor (D, D) and
    mean in, the actions (D, N) out; the correlate 2 N D^2, the draws and
    the H steps."""
    D = 4 * H
    flops = B * N * (2 * D * D + BOX_MULLER_FLOPS * D + H * STEP_FLOPS)
    return flops, rollout_bytes(B, N, H) + 4 * B * (D * D + D + D * N)


def per_step_counts(B: int, N: int, H: int):
    """MPPI's per-step sample + rollout (K5, K7 per-step): the means and
    4x4 factors in, the actions (4H, N) out; a lower 4x4 correlate and the
    mean (24) a step."""
    flops = B * N * H * (24 + 4 * BOX_MULLER_FLOPS + STEP_FLOPS)
    return flops, rollout_bytes(B, N, H) + 4 * B * (4 * H + 16 * H + 4 * H * N)


COUNTS = {"joint": joint_counts, "per_step": per_step_counts}


def bound_ms(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the fp32 peak and bytes over the memory rate, in ms."""
    return max(flops / FP32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3


def fleet_bytes(B: int, N: int, H: int, T: int = 300) -> int:
    """Static memory of a batched CoVO step (the rows of pod_scale's
    hbm_arithmetic): actions and draws (B, N, D) each, costs and weights,
    Hessian, Sigma and factor (B, D, D) each, packed states and tables."""
    f, D = 4, 4 * H
    return (2 * B * N * D * f + 2 * B * N * f + 3 * B * D * D * f
            + B * (16 + 6 * T) * f)


# --- statistics ----------------------------------------------------------------


def quartiles(values):
    """(q1, median, q3) as ``statistics.quantiles(values, n=4)`` gives them."""
    q = statistics.quantiles(values, n=4)
    return q[0], q[1], q[2]


def spread(values) -> float:
    """Interquartile distance as a share of the median."""
    q1, med, q3 = quartiles(values)
    return (q3 - q1) / med


def percentile(values, pct: float) -> float:
    """The ``pct`` percentile of ``values``, linear between order statistics."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * pct / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def early_slowdown(step_s) -> float:
    """Mean time a step over the first fifth of the steps, divided by the
    mean over the remaining four fifths."""
    k = len(step_s) // 5
    if k < 1 or len(step_s) - k < 1:
        raise ValueError("early_slowdown needs five steps or more")
    return (sum(step_s[:k]) / k) / (sum(step_s[k:]) / (len(step_s) - k))
