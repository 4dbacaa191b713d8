"""The benchmark of spherharm_tpu_torch (see run.py and BENCHMARK.json)."""
