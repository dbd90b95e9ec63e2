"""What each kernel of ``csrc/`` must compute and move, and the least time
the card could take for it.

A kernel's bound is the larger of two times: its fp32 operations over the
card's fp32 peak outside the tensor cores, and its bytes (each input read
once, each output written once) over the memory rate. ``k*_counts`` give
(fp32 operations, bytes) of one launch at the launch's shapes; ``k*_bound``
the bound dict of :func:`bound`. The operation counts are by hand from the
CUDA sources (a transcendental counted as one operation).
"""

from __future__ import annotations

import functools

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA's data sheet)
# fp32 operations of one sample's rollout step (csrc/quad_core.cuh
# rollout_step, counted by hand, a transcendental as one): dyn_step ~124
# (the action map 18, bodyrate_step 106), penyaw_reward ~57, bookkeeping ~10
STEP_FLOPS = 190
# what a disturbance mode adds to a sample's step: "drag" the next force
# from the pre-step velocity, 3 x (v - wind/2, -|s| rel, x |rel|, / 2.25:
# 6 with the abs and the scaling) = 18; "mixed" adds 3 x (two adds, the
# redraw select, / 3) = 12 more; "table" reads its force, "shared" as before
MODE_FLOPS = {"shared": 0, "table": 0, "drag": 18, "mixed": 30}
# the reward's operations against penyaw's ~57 (two norms, the log barrier,
# atan2) in STEP_FLOPS: realworld counts 16 (three differences, their
# squares and sum, / 3, 1 - q_w^2, the two weights, the sum and the scale)
REWARD_FLOPS = {"penyaw": 0, "realworld": 16 - 57}
DYN_FLOPS = 124
BOX_MULLER_FLOPS = 5  # per normal: log, sqrt, sin/cos and scaling per pair
K8_MATMULS = 104  # optimize_sigma_ns: 2 x 16 (power squaring) + 24 + 1 + 47 (NS)


@functools.lru_cache(maxsize=None)
def fp32_peak() -> float:
    """fp32 FLOP/s of card 0 outside the tensor cores: 128 fp32 lanes an
    SM, an FMA counted as two operations, at the SM's maximum clock
    (``nvidia-smi --query-gpu=clocks.max.sm``)."""
    import subprocess

    import torch

    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 128 * 2 * clock_mhz * 1e6


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take for work of ``flops`` fp32
    operations moving ``nbytes`` (each input read once, each output written
    once): the larger of the two times, with the one that bounds named."""
    t_ops = flops / fp32_peak() * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None)


def rollout_bytes(B: int, N: int, H: int, mode: str = "shared",
                  reward: str = "penyaw") -> int:
    """Bytes of a rollout kernel's small per-scenario tables: x0 (16), the
    position targets (3H) and the velocity targets (3H, which realworld does
    not read), scalar pack (17), int pack (3), the dist table (3H, read in
    the "table" and "mixed" modes), and its costs (N)."""
    dist = 3 * H if mode in ("table", "mixed") else 0
    targets = 3 * H if reward == "realworld" else 6 * H
    return 4 * B * (16 + targets + dist + 17 + 3 + N)


def step_flops(mode: str, reward: str = "penyaw") -> int:
    return STEP_FLOPS + MODE_FLOPS[mode] + REWARD_FLOPS[reward]


def k1_counts(B: int, N: int, H: int, mode: str = "shared", reward: str = "penyaw"):
    """K1 / K7 joint with in-kernel draws: F (D, D) and the mean in, the
    actions (D, N) out; the correlate 2 N D^2, the draws and the steps."""
    D = 4 * H
    flops = B * N * (2 * D * D + BOX_MULLER_FLOPS * D + H * step_flops(mode, reward))
    return flops, rollout_bytes(B, N, H, mode, reward) + 4 * B * (D * D + D + D * N)


def k2_counts(H: int):
    """K2: x0 and the means in, the (H, 17) trajectory out; a model step a
    step."""
    return H * DYN_FLOPS, 4 * (16 + 7 * H + 17 + 13 * H)


def k3_counts(H: int, sd: int = 13):
    """K3 at a sensitivity state of ``sd`` (13; 16 under drag / mixed): the
    Jacobians in and T out, 4 H (sd + 4) (sd + D) bytes; an (sd, sd + 4) by
    (sd + 4, D) product a step."""
    D = 4 * H
    return H * sd * (sd + 4) * D * 2, 4 * H * (sd + 4) * (sd + D)


def k4_counts(B: int, N: int, H: int, mode: str = "shared", reward: str = "penyaw"):
    """K4 / K6: the actions (4H, N) in, the costs out."""
    return (B * N * H * step_flops(mode, reward),
            rollout_bytes(B, N, H, mode, reward) + 4 * B * 4 * H * N)


def k5_counts(B: int, N: int, H: int, mode: str = "shared", reward: str = "penyaw"):
    """K5 / K7 per-step with in-kernel draws: the means and 4x4 factors in,
    the actions (4H, N) out; a lower 4x4 correlate (20) + mean (4) a step."""
    flops = B * N * H * (24 + 4 * BOX_MULLER_FLOPS + step_flops(mode, reward))
    return flops, (rollout_bytes(B, N, H, mode, reward)
                   + 4 * B * (4 * H + 16 * H + 4 * H * N))


def k8_counts(D: int):
    """K8: R in, a_cov and the factor out; 104 (D, D) products and a
    Cholesky (D^3 / 3)."""
    return K8_MATMULS * 2 * D**3 + D**3 / 3, 4 * 3 * D * D


def k1_bound(*args, **kw) -> dict:
    return bound(*k1_counts(*args, **kw))


def k2_bound(H: int) -> dict:
    return bound(*k2_counts(H))


def k3_bound(H: int, sd: int = 13) -> dict:
    return bound(*k3_counts(H, sd))


def k4_bound(*args, **kw) -> dict:
    return bound(*k4_counts(*args, **kw))


def k5_bound(*args, **kw) -> dict:
    return bound(*k5_counts(*args, **kw))


def k8_bound(D: int) -> dict:
    return bound(*k8_counts(D))


def trace_counts(B: int, N: int, H: int, mode: str = "shared",
                 reward: str = "penyaw", sd: int = 13) -> dict:
    """The counts of one launch of each device function of ``csrc/``
    (``kernels.DEVICE_KERNELS``) at a solve's shapes, ``{name: {"flops",
    "bytes"}}``: what ``profiling.load_device_trace`` attaches to a trace's
    kernels. The rollout kernels at B scenarios (B = 1: K1, K4, K5), K2, K3
    and K8 at the solve's H and D."""
    pairs = {
        "joint_sample_rollout_kernel": k1_counts(B, N, H, mode, reward),
        "primal_kernel": k2_counts(H),
        "sens_chain_kernel": k3_counts(H, sd),
        "rollout_step_kernel": k4_counts(B, N, H, mode, reward),
        "rollout_split_kernel": k4_counts(B, N, H, mode, reward),
        "sample_rollout_tile_kernel": k5_counts(B, N, H, mode, reward),
        "sample_rollout_step_kernel": k5_counts(B, N, H, mode, reward),
        "sigma_ns_kernel": k8_counts(4 * H),
    }
    return {name: {"flops": f, "bytes": b} for name, (f, b) in pairs.items()}
