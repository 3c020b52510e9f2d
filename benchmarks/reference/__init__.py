"""Plain PyTorch references of the benchmark's configurations (no code of the program)."""
