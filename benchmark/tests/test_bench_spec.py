"""BENCHMARK.json against the contract's shape, and every cell, mix,
configuration, limit and metric found by name."""

import json
import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][0] == "python3" and len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entries():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["source"]) <= 200
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    """Each cell's configuration, traffic, limits and metric readers load,
    and it reports setup_s, another end-to-end metric and a per-layer one."""
    spec = harness.cell_spec(cell)
    assert spec["traffic"]["vehicles"] >= 1 and spec["limits"]
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and spec["per_layer"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.reader(m["name"]))
    assert set(spec["limits"]) <= {"mean_gap", "sigma_gap", "env_gap"}


def test_per_layer_metrics_name_their_cells():
    vehicle = {m["name"] for m in harness.cell_spec("covo.vehicle")["per_layer"]}
    fleet = {m["name"] for m in harness.cell_spec("covo.fleet")["per_layer"]}
    assert all(n.endswith(".vehicle") for n in vehicle)
    assert all(n.endswith(".fleet") for n in fleet)
    assert fleet == {m["name"] for m in harness.cell_spec("mppi.fleet")["per_layer"]}


def test_result_line_schema():
    run = dict(vehicles=1024, steps=200, window_s=30.5, step_s=[0.15] * 200, setup_s=22.0,
               N=8192, H=32, rollout=dict(counts="joint", kernels=["k"]))
    spec = harness.cell_spec("covo.fleet")
    metrics = harness.measure(spec["end_to_end"], run)
    verdict = dict(correct=True, failed=0, numbers={"mean_gap": 1e-4, "env_gap": 1e-7})
    device = dict(platform="gpu", kind="NVIDIA H100 80GB HBM3", count=1,
                  memory_peak_bytes=1, power_limit="700.00 W")
    line = harness.result_line(verdict, 204800, metrics, device, spec["limits"])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(metrics) == {"solves_per_s", "setup_s"}
    assert metrics["solves_per_s"] == {"value": 1024 * 200 / 30.5, "unit": "solves/s"}
    assert line["checks"]["mean_gap"]["limit"] == spec["limits"]["mean_gap"]
    json.loads(json.dumps(line))


def test_configs_state_the_ports_defaults():
    """The plant constants each configuration states (which the reference
    reads) are the port's defaults, which the program runs."""
    from covo_mpc_tpu_torch.models.structs import _DEFAULTS

    for c in BENCH["configs"]:
        env = json.load(open(os.path.join(ROOT, c["file"])))["env"]
        for k in ("m", "g", "dt", "max_thrust", "max_torque", "max_omega", "action_scale",
                  "alpha_bodyrate", "dyn_noise_scale", "obs_noise_scale",
                  "max_steps_in_episode"):
            assert env[k] == _DEFAULTS[k], k
