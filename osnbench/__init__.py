"""The benchmark of repro_torch (see run.py)."""
