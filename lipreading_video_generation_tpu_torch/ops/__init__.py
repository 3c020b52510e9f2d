"""Tensor ops of the port: plain torch versions and the CUDA kernel wrappers."""
