"""The CPU half of ``covo_mpc_tpu_torch.tools.clock_probe``: reading
``nvidia-smi``'s samples, placing them in a timed window, and summing up
chains and profiled ops. The probe itself needs the card."""

import datetime

import pytest

from covo_mpc_tpu_torch.tools import clock_probe

FIELDS = clock_probe.FIELDS + ("clocks_event_reasons.active",)


def _line(t: datetime.datetime, sm: float, power: float, reasons: str = "0x0") -> str:
    return (f"{t.strftime('%Y/%m/%d %H:%M:%S.%f')[:-3]}, {sm}, 2619, {power}, 36, "
            f"{reasons}\n")


def test_parse_samples_reads_the_csv_and_skips_what_it_cannot(tmp_path):
    t0 = datetime.datetime(2026, 10, 18, 5, 30, 1, 123000)
    path = tmp_path / "smi.csv"
    path.write_text(_line(t0, 1980, 120.5) + "[N/A], 1980\n"
                    + _line(t0 + datetime.timedelta(milliseconds=20), 1755, 300.25, "0x4"))
    rows = clock_probe.parse_samples(str(path), FIELDS)
    assert [r["sm_mhz"] for r in rows] == [1980.0, 1755.0]
    assert rows[1]["t"] - rows[0]["t"] == pytest.approx(0.02)
    assert rows[0]["t"] == pytest.approx(t0.timestamp())
    assert rows[1] == {**rows[1], "mem_mhz": 2619.0, "power_w": 300.25, "temp_c": 36.0,
                       "reasons": "0x4"}


def test_window_clock_means_inside_else_the_nearest_sample():
    samples = [{"t": float(t), "sm_mhz": sm, "mem_mhz": 2619.0, "temp_c": 36.0,
                "power_w": w, "reasons": r}
               for t, sm, w, r in ((0, 1980.0, 100.0, "0x0"), (1, 1755.0, 200.0, "0x4"),
                                   (5, 1980.0, 150.0, "0x0"))]
    inside = clock_probe.window_clock(samples, 0.0, 1.0)
    assert inside["samples"] == 2 and inside["sm_mhz"] == pytest.approx(1867.5)
    assert inside["power_w"] == pytest.approx(150.0) and inside["reasons"] == ["0x0", "0x4"]
    nearest = clock_probe.window_clock(samples, 4.0, 4.5)
    assert nearest["samples"] == 1 and nearest["power_w"] == 150.0
    assert clock_probe.window_clock([], 0.0, 1.0)["sm_mhz"] is None


def test_summary_and_moved():
    rows = [{"ms": 2.0, "sm_mhz": 1000.0}, {"ms": 1.0, "sm_mhz": 2000.0},
            {"ms": 3.0, "sm_mhz": None}]
    got = clock_probe.summary(rows)
    assert got["n"] == 2 and got["kcycles_rel_std"] == 0.0
    assert got["ms_min"] == 1.0 and got["ms_max"] == 2.0
    assert got["corr_ms_inverse_clock"] == pytest.approx(1.0)
    first = {"by_op": {"a": 1.0, "b": 5.0}}
    last = {"by_op": {"a": 1.5, "c": 2.0}}
    assert [m["op"] for m in clock_probe.moved(first, last)] == ["b", "c", "a"]
    assert clock_probe.moved(first, last, top=1) == [{"op": "b", "first_us": 5.0,
                                                      "last_us": 0.0}]


def test_the_probe_needs_the_card(monkeypatch):
    monkeypatch.setattr(clock_probe.torch.cuda, "is_available", lambda: False)
    assert clock_probe.main(["--triggers", "--trigger-set", "sixth"]) == 2
    assert set(clock_probe.TRIGGER_SETS) == {"first", "second", "third", "fourth", "fifth",
                                             "sixth"}
