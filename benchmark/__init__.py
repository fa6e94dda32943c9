"""The benchmark of salva_tpu_torch (see BENCHMARK.json and PERF.md)."""
