"""Benchmark of tritd_tpu_torch on the H100 (see run.py)."""
