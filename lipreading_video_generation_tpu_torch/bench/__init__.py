"""Microbenchmarks of the port's kernels, run with ``python -m``."""
