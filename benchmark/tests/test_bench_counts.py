"""The yardstick's copied counts and memory rows against the program's own
accounting at the cells' shapes (they are copies: a change to either shows
here)."""

import io

import pytest

from benchmark import yardstick


@pytest.mark.parametrize("B", [1, 40, 1024])
def test_counts_match_the_ports(B):
    from covo_mpc_tpu_torch.ops import counts

    assert yardstick.joint_counts(B, 8192, 32) == counts.k1_counts(B, 8192, 32)
    assert yardstick.per_step_counts(B, 8192, 32) == counts.k5_counts(B, 8192, 32)


def test_fleet_memory_matches_pod_scale():
    from covo_mpc_tpu_torch.scripts.pod_scale import hbm_arithmetic

    for B in (128, 1024):
        assert yardstick.fleet_bytes(B, 8192, 32) == hbm_arithmetic(B, 8192, 32, out=io.StringIO())


def test_bounds_at_the_cells():
    """K7 joint at B=1024 is bound by operations, K7 per-step by bytes."""
    f, b = yardstick.joint_counts(1024, 8192, 32)
    assert f / yardstick.FP32_PEAK_FLOPS > b / yardstick.HBM_BYTES_PER_S
    f, b = yardstick.per_step_counts(1024, 8192, 32)
    assert f / yardstick.FP32_PEAK_FLOPS < b / yardstick.HBM_BYTES_PER_S
    assert yardstick.bound_ms(67e9, 0) == pytest.approx(1.0)
