"""The metric arithmetic on synthetic timings, and the window's loop on a
stand-in system (CUDA events and synchronise replaced by host stubs)."""

import statistics

import numpy as np
import pytest

from benchmark import harness, readers, window, yardstick


def _run(**kw):
    run = dict(vehicles=1024, steps=240, window_s=30.0, step_s=[0.125] * 240, setup_s=20.0,
               N=8192, H=32, rollout=dict(counts="joint", kernels=["joint_sample_rollout_kernel"]))
    run.update(kw)
    return run


def test_rate_is_all_work_over_all_time():
    run = _run(window_s=30.7)
    assert harness.reader("solves_per_s")(run) == pytest.approx(1024 * 240 / 30.7)
    assert harness.reader("step_ms")(dict(run, vehicles=1)) == pytest.approx(30.7 / 240 * 1e3)


def test_p95_of_every_step():
    rng = np.random.default_rng(3)
    steps = list(rng.gamma(4.0, 1e-3, size=7001))
    got = harness.reader("step_p95_ms")(_run(step_s=steps))
    assert got == pytest.approx(np.percentile(steps, 95) * 1e3)
    assert yardstick.percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.5


def test_early_slowdown():
    steps = [1.1e-3] * 20 + [1.0e-3] * 80
    assert yardstick.early_slowdown(steps) == pytest.approx(1.1)
    assert harness.reader("early_slowdown.vehicle")(_run(step_s=steps)) == pytest.approx(1.1)
    assert harness.reader("early_slowdown.fleet")(_run(step_s=[1.0] * 3)) is None


def test_device_idle_and_roofline():
    trace = dict(busy_s=0.3, kernel_s={"void k::joint_sample_rollout_kernel<64, 128>(x)": 0.06,
                                       "elementwise": 0.2})
    run = _run(trace=trace, trace_reps=3)  # 100 ms busy a replay, 125 ms a step
    assert readers.device_idle(run) == pytest.approx(20.0)
    bound = yardstick.bound_ms(*yardstick.joint_counts(1024, 8192, 32))
    assert readers.rollout_roofline(run) == pytest.approx(bound / 20.0 * 100.0)
    assert readers.device_idle(_run()) is None and readers.rollout_roofline(_run()) is None


def test_spans_read_as_ms():
    run = _run(spans=dict(seconds={"bench.solve": 0.002, "bench.env": 0.0005}, matched=9,
                          enqueued=9))
    assert harness.reader("solve_ms.fleet")(run) == pytest.approx(2.0)
    assert harness.reader("env_ms.vehicle")(run) == pytest.approx(0.5)
    assert harness.reader("env_ms.vehicle")(_run()) is None


def test_spread_uses_python_quartiles():
    vals = [10.0, 10.2, 9.9, 10.4, 10.1, 9.8]
    q = statistics.quantiles(vals, n=4)
    assert yardstick.spread(vals) == pytest.approx((q[2] - q[0]) / q[1])


class _Event:
    clock = [0.0]

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        _Event.clock[0] += 1.0
        self.t = _Event.clock[0]

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


class _System:
    def __init__(self, closed_loop):
        self.replays, self.closed_loop = 0, closed_loop

    def snapshot(self):
        return {"r": self.replays}

    def replay(self):
        self.replays += 1

    step = replay

    def record(self, pre):
        return dict(pre=pre, replay=self.replays)


@pytest.mark.parametrize("closed", [True, False])
def test_window_counts_steps_and_records(monkeypatch, closed):
    import torch

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"synchronize": lambda self: None})())
    sut = _System(closed)
    w = window.run(sut, 0.05, [2, 5, 10**9])
    assert w["steps"] == sut.replays and w["steps"] >= 6
    assert [r["replay"] for r in w["records"]] == [3, 6]
    assert [r["pre"]["r"] for r in w["records"]] == [2, 5]
    assert w["missed"] == [10**9] and len(w["step_s"]) == w["steps"]
    if not closed:
        assert w["step_s"] == [1.0] * w["steps"]


def test_check_steps_take_the_restart():
    traffic = dict(check_within=1000, check_steps=8)
    drawn = harness.check_steps(2147483659, traffic, 10**6)
    assert drawn[-1] == 10**6 and len(drawn) == 9 and drawn == sorted(drawn)
    assert drawn == harness.check_steps(2147483659, traffic, 10**6)
    assert drawn[:-1] != harness.check_steps(2147483660, traffic, 10**6)[:-1]
    assert harness.check_steps(2147483659, traffic, drawn[0]) == drawn[:-1]


def test_to_restart_counts_to_the_shared_last_step():
    import types

    import torch

    from benchmark import system

    env = types.SimpleNamespace(default_params=types.SimpleNamespace(max_steps_in_episode=300))
    times = torch.tensor([17] * 6 + [250, 3], dtype=torch.int32)
    assert system._to_restart(env, types.SimpleNamespace(time=times)) == 283
    one = types.SimpleNamespace(time=torch.tensor(300, dtype=torch.int32))
    assert system._to_restart(env, one) == 0


def test_catch_up_records_the_replays_drawn_past_the_window(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    sut = _System(True)
    for _ in range(4):
        sut.replay()
    w = dict(steps=4, missed=[6, 9], records=[])
    window.catch_up(sut, w)
    assert [r["pre"]["r"] for r in w["records"]] == [6, 9] and sut.replays == 10
