"""The benchmark of gqx_torch (see run.py)."""
