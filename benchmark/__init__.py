"""The benchmark of covo_mpc_tpu_torch (see BENCHMARK.json and PERF.md)."""
