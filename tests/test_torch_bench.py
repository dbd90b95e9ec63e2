"""The port's bench (``python -m covo_mpc_tpu_torch.bench``) on the CPU, at
N=16, H=4: the JSON line has the root ``bench.py``'s record keys (read from
``BENCH_r05.json``'s ``parsed``) less those of the latency pass, plus
``device`` and ``method``; ``bench_latency`` returns JAX's dict shape with
no device per-solve distribution on the CPU; each row function runs and
gives a positive rate; what the port does not run is refused. The card's
run is ``chip_smoke.py``'s phase 11.
"""

import json
import math
from pathlib import Path

import pytest
import torch

from covo_mpc_tpu_torch import bench

ROOT = Path(__file__).resolve().parent.parent
SMALL = ["--device", "cpu", "--n", "16", "--h", "4", "--k", "2", "--engine", "torch",
         "--rng", "fast"]
# the keys bench.py's latency pass adds (bench.py:693-719)
LATENCY_KEYS = {"per_solve_p99_ms", "per_solve_p50_ms", "chain_mean_p99_ms",
                "chain_mean_p50_ms", "act_per_solve_p99_ms", "act_per_solve_p50_ms",
                "act_chain_mean_p99_ms", "act_chain_mean_p50_ms", "act_solves_per_s",
                "host_dispatch_p99_ms", "rtt_p50_ms"}


def jax_record_keys() -> set:
    return set(json.loads((ROOT / "BENCH_r05.json").read_text())["parsed"])


def small_args(*extra):
    args = bench.build_parser().parse_args([*SMALL, *extra])
    bench.check_args(args)
    return args


def test_bench_line_has_the_record_keys(capsys):
    assert bench.main([*SMALL, "--no-latency"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    record = json.loads(line)
    assert LATENCY_KEYS <= jax_record_keys()
    assert set(record) == (jax_record_keys() - LATENCY_KEYS) | {"device", "method"}
    assert record["metric"] == "covo_online_solves_per_s_chip_N16_H4"
    assert record["mode"] == "torch+gn" and record["unit"] == "solves/s"
    assert record["device"] == {"name": "cpu", "power_limit": None}
    assert record["method"] == "host_slope"
    assert record["value"] > 0
    assert record["vs_baseline"] == round(record["value"] / 500.0, 3)
    assert all(math.isfinite(v) for v in record.values() if isinstance(v, float))


def test_bench_latency_returns_jax_shape():
    args = small_args()
    env = bench.make_env("gaussian", "cpu")
    out = bench.bench_latency(env, args, iters=3, chain=4)
    assert set(out) == {"covo_online", "covo_speculative_act"}
    for row in out.values():
        assert set(row) == {"per_solve", "chain_mean", "host_dispatch", "rtt"}
        assert row["per_solve"] is None  # no device trace on the CPU
        assert set(row["chain_mean"]) == {"p50", "p90", "p99"}
        assert set(row["rtt"]) == {"p50", "p99"}
        assert {"p50", "p90", "p99", "mean", "iters"} == set(row["host_dispatch"])
        for d in (row["chain_mean"], row["rtt"], row["host_dispatch"]):
            assert all(math.isfinite(v) and v >= 0 for v in d.values())
        assert row["chain_mean"]["p50"] > 0


@pytest.mark.parametrize("row", ["one", "speculative", "offline", "pid", "scenarios"])
def test_rows_give_a_positive_rate(row):
    args = small_args("--scenarios", "2")
    env = bench.make_env("gaussian", "cpu")
    rate = {
        "one": lambda: bench.bench_one(env, args, "mppi", "torch"),
        "speculative": lambda: bench.bench_speculative(env, args, k=1),
        "offline": lambda: bench.bench_covo_offline(env, args, k=1),
        "pid": lambda: bench.bench_pid(env, args, k=1),
        "scenarios": lambda: bench.bench_scenarios(env, args, k=1),
    }[row]()
    assert math.isfinite(rate) and rate > 0


@pytest.mark.parametrize("argv, error, match", [
    (["--all"], ValueError, "--device cuda"),
    (["--engine", "cuda"], ValueError, "--device cuda"),
    (["--engine", "pallas"], ValueError, "--engine cuda"),
    (["--engine", "jnp"], ValueError, "--engine torch"),
])
def test_refuses_what_the_port_does_not_run(argv, error, match):
    with pytest.raises(error, match=match):
        bench.main([*SMALL, *argv])


@pytest.mark.parametrize("rng", ["invariant", "parity"])
def test_key_drawing_headline_rows_run(rng, capsys):
    """The key-drawing samplers, which the bench once refused, run its
    headline row (the key carried through the chain, split once a solve;
    parity designs with eigh); every Hessian estimator is held against JAX
    in tests/test_torch_parity.py."""
    bench.main([*SMALL, "--rng", rng, "--no-latency"])
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["mode"] == f"torch+{rng}+gn" and record["value"] > 0


def test_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--no-latency"])
