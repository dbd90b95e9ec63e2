"""Nothing the benchmark runs loads JAX or the JAX package, a run in
which something did (a metric's reader too) prints no result, and so does
a run without a card (or without the program)."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from benchmark import check, harness, system, window

PROBE = r"""
import sys
sys.path.insert(0, {root!r})
from benchmark import check, harness, readers, system, tracing, window, yardstick
from benchmark.reference import covo, mppi, quad
import covo_mpc_tpu_torch.models, covo_mpc_tpu_torch.solvers, covo_mpc_tpu_torch.runtime
import covo_mpc_tpu_torch.runtime.profiling
for cell in harness.load_json("BENCHMARK.json")["workloads"]:
    spec = harness.cell_spec(cell["name"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        harness.reader(m["name"])
tops = {{m.split(".")[0] for m in sys.modules}}
print(sorted(tops & set(harness.FORBIDDEN)), "covo_mpc_tpu_torch" in tops)
"""


def test_import_path_loads_no_jax():
    env = dict(os.environ, USE_FLAX="0")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=harness.ROOT)],
                         capture_output=True, text=True, env=env, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_compare_whole():
    tops = {m.split(".")[0] for m in ("covo_mpc_tpu_torch.ops", "jaxtyping", "flaxen")}
    assert not tops & set(harness.FORBIDDEN)


def _run(cwd, extra_env=None):
    env = dict(os.environ, **(extra_env or {}))
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "covo.vehicle",
                           "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, env=env, timeout=600)


def test_no_card_no_result():
    out = _run(harness.ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, {"PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


class _Sut:
    closed_loop = True

    def step(self):
        pass

    def to_restart(self):
        return 0


@pytest.mark.parametrize("reader_loads_jax", [False, True])
def test_forbidden_modules_looked_for_after_the_readers(monkeypatch, capsys,
                                                        reader_loads_jax):
    """The look at ``sys.modules`` comes after every reader has run: a
    reader that loads JAX leaves the run without a result."""
    import torch

    for name in [m for m in sys.modules if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    query = types.SimpleNamespace(communicate=lambda timeout: ("H100, 700.00 W\n", None))
    for name, value in [("is_available", lambda: True), ("device_count", lambda: 1),
                        ("get_device_name", lambda i: "NVIDIA H100 80GB HBM3"),
                        ("synchronize", lambda: None), ("empty_cache", lambda: None),
                        ("max_memory_allocated", lambda: 1)]:
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(harness, "power_query", lambda: query)
    monkeypatch.setattr(system, "build", lambda *a, **k: _Sut())
    monkeypatch.setattr(window, "run", lambda *a: dict(
        steps=10, window_s=1.0, step_s=[0.1] * 10, host_s=[], records=[], missed=[]))
    monkeypatch.setattr(check, "judge", lambda *a: dict(
        correct=True, failed=0, answers=0, numbers={"mean_gap": 1.0}))

    def read(run):
        if reader_loads_jax:
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return 1.0
    monkeypatch.setattr(harness, "reader", lambda name: read)
    rc = harness.main(["--workload", "covo.vehicle", "--seed", "2147483659",
                       "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    if reader_loads_jax:
        assert rc != 0 and out.out == "" and "['jax']" in out.err
    else:
        assert rc == 0 and json.loads(out.out.splitlines()[-1])["correct"] is True
