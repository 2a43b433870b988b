"""The benchmark of `instantvnr_torch` (BENCHMARK.json): `run.py` runs one
cell once; everything a cell needs is found by name under this folder."""
