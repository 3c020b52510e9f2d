"""Published dense peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's data
sheet, without sparsity, at the full 700 W power limit)."""

PEAK_OPS = {
    "bf16": 989e12,      # FLOP/s, tensor cores
    "int8": 1979e12,     # OP/s, tensor cores
    "float32": 67e12,    # FLOP/s, CUDA cores (TF32 off)
}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(ops: float, nbytes: float, precision: str) -> float:
    """The roofline's least time: the larger of the operations over the
    precision's peak and the bytes over the memory bandwidth."""
    return max(ops / PEAK_OPS[precision], nbytes / HBM_BYTES_PER_S)
