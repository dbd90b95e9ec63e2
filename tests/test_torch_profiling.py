"""The port's trace readers (``covo_mpc_tpu_torch/runtime/profiling.py``)
against JAX's (``covo_mpc_tpu/runtime/profiling.py``) on the same inputs.

A synthetic device trace made from a numpy seed (chains of once-per-solve
kernels with known starts, one slow solve at 3x the median, a 25 ms gap
between chains) goes through both packages' ``step_durations``,
``per_solve_distribution`` and ``hlo_summary``: for JAX the records carry
``category="custom-call"`` on the repo's own kernels (a Pallas kernel's
place), "fusion" / "copy" on the rest, and every op's flops and bytes (0
where unknown); for the port the trace's categories and the counts of its
own kernels only. Results agree to 1e-12 (the same arithmetic on the same
float64 timestamps; the tolerance only absorbs a reordering). Also: the
Chrome-trace parser on a file in ``export_chrome_trace``'s layout, the
kernel-name matcher against the ``__global__`` functions of ``csrc/``,
``time_slope`` against JAX's with one fake clock in both modules, and the
completeness rule of ``trace_chains`` / ``time_trace`` on synthetic traces.
The card's side (a captured MPPI solve, the auto marker on the main path)
is in ``tests/test_torch_cuda.py``.
"""

import contextlib
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from covo_mpc_tpu.runtime import profiling as jprof
from covo_mpc_tpu_torch.ops import counts, kernels
from covo_mpc_tpu_torch.runtime import profiling

TOL = 1e-12
K1 = ("void (anonymous namespace)::joint_sample_rollout_kernel<64, 128, 0>"
      "(float const*, float const*, float*, int)")
K2 = "void primal_kernel(float const*, float const*, float*, int)"
K3 = "void sens_chain_kernel<13>(float const*, float*, int)"
LIB = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>()"
COPY = "Memcpy DtoD (Device -> Device)"
JAX_CATEGORY = {K1: "custom-call", K2: "custom-call", K3: "custom-call", LIB: "fusion",
                COPY: "copy"}
PORT_CATEGORY = {K1: "kernel", K2: "kernel", K3: "kernel", LIB: "kernel", COPY: "gpu_memcpy"}
OWN_COUNTS = {K1: (3_000_000, 40_000), K2: (3_968, 2_692), K3: (1_810_432, 1_000_000)}


def synthetic_solves(seed=0, chains=3, per_chain=40):
    """Device records of ``chains`` chains of ``per_chain`` solves: each
    solve runs K2, K3, a library fill (the largest op, once a solve), a
    copy and K1 (the largest of the repo's kernels), at jittered starts; one
    solve takes 3x the median; 25 ms of idle time between chains. Returns
    (the port's records, JAX's records, the solves' start times in µs)."""
    rng = np.random.default_rng(seed)
    median = 2000.0
    port, jax_recs, starts = [], [], []
    t = 1.0e9
    slow = per_chain + 7  # a solve of the second chain
    for c in range(chains):
        for s in range(per_chain):
            starts.append(t)
            length = median * (3.0 if c * per_chain + s == slow else 1.0)
            length += rng.uniform(-20.0, 20.0)
            offset = 0.0
            for name, dur in ((K2, 8.0), (K3, 6.0), (LIB, 900.0), (COPY, 3.0), (K1, 100.0)):
                dur = dur + rng.uniform(0.0, 1.0)
                rec = {"name": name, "ts_us": t + offset, "dur_us": dur}
                offset += dur + rng.uniform(1.0, 5.0)
                p = {**rec, "category": PORT_CATEGORY[name], "stream": 7}
                j = {**rec, "category": JAX_CATEGORY[name], "flops": 0, "bytes": 0}
                if name in OWN_COUNTS:
                    p["flops"], p["bytes"] = j["flops"], j["bytes"] = OWN_COUNTS[name]
                port.append(p)
                jax_recs.append(j)
            t += length
        t += 25_000.0
    return port, jax_recs, np.array(starts)


def test_step_durations_equal_jax():
    port, jax_recs, _ = synthetic_solves()
    for marker in ("joint_sample_rollout_kernel", K2, "sens_chain"):
        got = profiling.step_durations(port, marker)
        ref = jprof.step_durations(jax_recs, marker)
        assert got.shape == ref.shape == (3 * 39,)
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    # the slow solve stays in, the gaps between chains do not
    got = profiling.step_durations(port, K1)
    assert got.max() == pytest.approx(3 * 2000e-6, rel=0.03)
    assert (got > 0.01).sum() == 0
    with pytest.raises(ValueError, match="need >= 3"):
        profiling.step_durations(port[:10], K1)


def test_per_solve_distribution_equal_jax():
    port, jax_recs, _ = synthetic_solves()
    got = profiling.per_solve_distribution(port, 120)
    ref = jprof.per_solve_distribution(jax_recs, 120)
    # the library fill is larger and fires once a solve too: auto takes the
    # largest of the repo's kernels, as JAX takes the largest custom call
    assert got["marker"] == ref["marker"] == K1
    assert kernels.device_kernel(got["marker"]) == "joint_sample_rollout_kernel"
    assert got["n"] == ref["n"] == 117
    for q in ("p50", "p90", "p99", "max"):
        assert abs(got[q] - ref[q]) <= TOL
    given = profiling.per_solve_distribution(port, 120, marker=K2)
    assert given == jprof.per_solve_distribution(jax_recs, 120, marker=K2)
    with pytest.raises(ValueError):
        profiling.per_solve_distribution(port, 121)


def test_hlo_summary_equal_jax():
    port, jax_recs, _ = synthetic_solves()
    got = profiling.hlo_summary(port)
    ref = jprof.hlo_summary(jax_recs)
    assert [r["name"] for r in got] == [r["name"] for r in ref]
    for g, r in zip(got, ref):
        assert g["category"] == PORT_CATEGORY[g["name"]]
        assert g["count"] == r["count"] == 120
        for key in ("total_us", "mean_us"):
            assert abs(g[key] - r[key]) <= TOL * max(1.0, abs(r[key]))
        keys = ("flops_per_call", "bytes_per_call", "tflops_per_s", "gbytes_per_s")
        if g["name"] in OWN_COUNTS:
            assert g["flops_per_call"] == r["flops_per_call"] == OWN_COUNTS[g["name"]][0]
            assert g["bytes_per_call"] == r["bytes_per_call"]
            for key in keys[2:]:
                assert abs(g[key] - r[key]) <= TOL * max(1.0, abs(r[key]))
        else:
            # JAX writes 0 for an unknown count; the port writes None
            assert all(g[k] is None for k in keys)
            assert all(r[k] == 0 for k in keys)
    assert len(profiling.hlo_summary(port, top=2)) == 2


def chrome_trace(events):
    """A Chrome trace in the layout ``export_chrome_trace`` writes."""
    meta = [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
             "args": {"name": "python"}}]
    return {"schemaVersion": 1, "deviceProperties": [], "displayTimeUnit": "ms",
            "traceEvents": meta + events, "traceName": "x"}


def x_event(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts,
            "dur": dur, "args": args}


def test_load_device_trace_parses_the_chrome_trace(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.load_device_trace(str(tmp_path))
    old = chrome_trace([x_event("kernel", K1, 1.0, 1.0, stream=7)])
    (tmp_path / "trace_1000.json").write_text(json.dumps(old))
    events = [
        x_event("user_annotation", profiling.CHAIN_RANGE, 100.0, 50.0),
        x_event("cpu_op", "aten::copy_", 101.0, 2.0),
        x_event("cuda_runtime", "cudaGraphLaunch", 103.5, 4.0, correlation=5),
        x_event("cuda_runtime", "cudaMemcpyAsync", 102.0, 1.0, correlation=4),
        x_event("kernel", K1, 120.25, 30.5, stream=7, correlation=5),
        x_event("kernel", LIB, 110.0, 3.0, stream=7),
        x_event("gpu_memcpy", COPY, 105.0, 1.5, stream=7, bytes=64),
        x_event("gpu_memset", "Memset (Device)", 108.0, 0.5, stream=7),
        x_event("gpu_user_annotation", profiling.CHAIN_RANGE, 105.0, 46.0),
        {"ph": "s", "id": 5, "pid": 0, "tid": 7, "ts": 103.5, "cat": "ac2g", "name": "ac2g"},
    ]
    (tmp_path / "trace_2000.json").write_text(json.dumps(chrome_trace(events)))
    c = counts.trace_counts(1, 8192, 32)
    device, host = profiling.load_device_trace(str(tmp_path), c)
    assert [r["name"] for r in device] == [COPY, "Memset (Device)", LIB, K1]
    assert [r["category"] for r in device] == ["gpu_memcpy", "gpu_memset", "kernel", "kernel"]
    assert all(r["stream"] == 7 for r in device)
    k1 = device[-1]
    assert (k1["ts_us"], k1["dur_us"]) == (120.25, 30.5)
    assert k1["flops"] == c["joint_sample_rollout_kernel"]["flops"]
    assert k1["bytes"] == c["joint_sample_rollout_kernel"]["bytes"]
    assert all("flops" not in r for r in device[:-1])
    assert [r["name"] for r in host] == [profiling.CHAIN_RANGE, "cudaMemcpyAsync",
                                         "cudaGraphLaunch"]
    assert profiling.chain_windows(host) == [(100.0, 150.0)]
    assert profiling.load_device_trace(str(tmp_path))[0][-1].get("flops") is None


def test_device_kernels_are_the_global_functions_of_csrc():
    csrc = Path(kernels.CSRC)
    found = set()
    for src in csrc.glob("*.cu"):
        text = re.sub(r"__launch_bounds__\([^)]*\)", "", src.read_text())
        found |= set(re.findall(r"__global__[^(]*?(\w+)\s*\(", text))
    assert found == set(kernels.DEVICE_KERNELS)
    assert kernels.device_kernel(K1) == "joint_sample_rollout_kernel"
    assert kernels.device_kernel("void sample_rollout_step_kernel<0>(float const*)") == (
        "sample_rollout_step_kernel")
    assert kernels.device_kernel("void rollout_step_kernel<0, 1>(float const*)") == (
        "rollout_step_kernel")
    assert kernels.device_kernel(LIB) is None
    assert kernels.device_kernel("_Z13primal_kernelPKfS0_Pfi") is None
    assert set(counts.trace_counts(16, 8192, 32)) == set(kernels.DEVICE_KERNELS)


def test_time_slope_equal_jax(monkeypatch):
    """The same fake clock, advanced only by the runs, in both modules."""

    class Clock:
        t = 100.0

        def __call__(self):
            return self.t

    def make_runner(clock, result):
        def make_run(length):
            def run(i):
                clock.t += 1e-4 * length + 0.02 + 1e-3 * ((7 * i + length) % 5)
                return result
            return run
        return make_run

    jclock, pclock = Clock(), Clock()
    monkeypatch.setattr(jprof.time, "perf_counter", jclock)
    ref = jprof.time_slope(make_runner(jclock, np.float32(1.0)), k=8, reps=5)
    monkeypatch.undo()
    monkeypatch.setattr(profiling, "_clock", pclock)
    got = profiling.time_slope(make_runner(pclock, torch.ones(3)), k=8, reps=5)
    assert abs(got[0] - ref[0]) <= TOL and abs(got[1] - ref[1]) <= TOL
    assert got[0] == pytest.approx(1e-4, rel=0.2)


@contextlib.contextmanager
def fake_session(trace_dir, events):
    """Stands in for ``profiling.trace``: writes ``events`` as the session's
    Chrome trace."""
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    yield None
    (Path(trace_dir) / "trace_1.json").write_text(json.dumps(chrome_trace(events)))


def chained_trace(chains, replays, nodes, replay_us=2000.0):
    """Host and device events of ``chains`` chains of ``replays`` graph
    replays of ``nodes`` kernels, a copy in before each replay and a copy to
    the host at the end of a chain, as a captured solve's chain records."""
    events, t = [], 1.0e6
    for _ in range(chains):
        start = t
        host_t, dev_t = t + 1.0, t + 5.0
        for _ in range(replays):
            events.append(x_event("cuda_runtime", "cudaMemcpyAsync", host_t, 2.0))
            events.append(x_event("cuda_runtime", "cudaGraphLaunch", host_t + 3.0, 5.0))
            host_t += 10.0
            events.append(x_event("gpu_memcpy", COPY, dev_t, 1.0))
            for n in range(nodes):
                events.append(x_event("kernel", K1 if n == nodes - 1 else LIB,
                                      dev_t + 2.0 + n * replay_us / nodes, 5.0))
            dev_t += replay_us
        events.append(x_event("cuda_runtime", "cudaMemcpyAsync", host_t, 2.0))
        events.append(x_event("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", dev_t, 1.0))
        end = dev_t + 10.0
        events.append(x_event("user_annotation", profiling.CHAIN_RANGE, start, end - start))
        t = end + 25_000.0
    return events


def test_time_trace_reads_complete_sessions_only(monkeypatch, tmp_path):
    nodes, replays, iters = 5, 6, 3
    events = chained_trace(iters, replays, nodes)
    monkeypatch.setattr(profiling, "trace", lambda d: fake_session(d, events))

    def make_run(length):
        return lambda i: torch.zeros(1)

    per = profiling.time_trace(make_run, chain=replays, iters=iters,
                               trace_dir=str(tmp_path / "t"), nodes=nodes)
    # a chain's wall: its first op (the copy in) to its last op's end (the
    # copy to the host), over the replays
    assert per == pytest.approx((replays * 2000.0 + 1.0) * 1e-6 / replays, rel=1e-12)
    chains = profiling.trace_chains(make_run(replays), iters, nodes, str(tmp_path / "c"))
    assert [len(c) for c in chains] == [replays * (nodes + 1) + 1] * iters
    # one kernel lost: the session is not read
    first_k1 = next(i for i, e in enumerate(events) if e["name"] == K1)
    lost = events[:first_k1] + events[first_k1 + 1:]
    monkeypatch.setattr(profiling, "trace", lambda d: fake_session(d, lost))
    with pytest.raises(profiling.LostEvents, match="device ops recorded"):
        profiling.time_trace(make_run, chain=replays, iters=iters,
                             trace_dir=str(tmp_path / "t"), nodes=nodes)


def test_time_trace_raises_on_the_cpu(tmp_path):
    """No device activity is traced on the CPU: time_trace raises, as JAX's
    does off the TPU, so a caller falls back."""

    def make_run(length):
        def run(i):
            return torch.ones(4) * i
        return run

    with pytest.raises(profiling.LostEvents):
        profiling.time_trace(make_run, chain=4, iters=2, trace_dir=str(tmp_path), nodes=0)


def test_per_solve_events_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: per_solve_events measures there")
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.per_solve_events(lambda c: c, torch.ones(1), chains=1, chain=2)
