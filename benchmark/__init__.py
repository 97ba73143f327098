"""The benchmark of benerf_tpu_torch: `python3 benchmark/run.py` runs one
cell of BENCHMARK.json once (run.py), from pieces found by name
(harness.py)."""
