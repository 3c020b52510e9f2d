"""Integer and bf16 matrix products: the hand-written CUDA kernel K6
(``csrc/int8_mm.cu``) and its plain torch version.

Port of ``scripts/microbench_int8_pallas.py``'s ``mm_kernel`` / ``make_mm``:
C(M, N) = A(M, K) · B(K, N) with int8 operands and an int32 result, or bf16
operands and a float32 result (the accumulator, unrounded). The TPU script
runs it at 4096³ only; here it takes any M, N, K and reads A and B through
their strides, because it carries every integer product of int8 serving
(``ops/quant.py``): PyTorch has no integer ``matmul`` and no int8
convolution on a CUDA device.

``int8_matmul`` and ``bf16_matmul`` launch the kernel for CUDA tensors (or
raise) and use ``matmul_reference`` for CPU tensors. ``matmul_reference`` is
the plain version the tests and ``chip_smoke.py`` hold the kernel against.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["matmul_reference", "int8_matmul", "bf16_matmul"]

_ACC = {torch.int8: torch.int32, torch.bfloat16: torch.float32}
_ENTRY = {torch.int8: "lvg_mm_int8", torch.bfloat16: "lvg_mm_bf16"}
_BN = 64             # csrc/int8_mm.cu: columns of C per block (grid.y <= 65535)
_INT_MAX = 2**31 - 1


def _check(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype, who: str) -> None:
    if a.dtype != dtype or b.dtype != dtype:
        raise ValueError(f"{who} takes {dtype} operands, got {a.dtype} and {b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{who} takes (M, K) and (K, N), got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"{who}: operands on {a.device} and {b.device}")


def matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain ``a @ b``: int8 → int32, exactly (on the CPU an int32
    ``matmul``; on a CUDA device, where torch has no integer ``matmul``,
    through float64, which is exact while K·127² < 2^53); bf16 → float32
    ``matmul`` of the upcast operands (the caller turns TF32 off)."""
    _check(a, b, a.dtype, "matmul_reference")
    if a.dtype == torch.int8:
        if a.is_cuda:
            return (a.double() @ b.double()).to(torch.int32)
        return a.to(torch.int32) @ b.to(torch.int32)
    if a.dtype == torch.bfloat16:
        return a.float() @ b.float()
    raise ValueError(f"matmul_reference takes int8 or bfloat16, got {a.dtype}")


def _launch(a: torch.Tensor, b: torch.Tensor, wrapper) -> torch.Tensor:
    """K6 on CUDA tensors for the public ``wrapper`` (which carries the
    launch count): launches on the current stream without synchronising;
    raises on what the kernel does not take."""
    who = wrapper.__name__
    if a.device.index != torch.cuda.current_device():
        raise ValueError(f"{who}: {a.device} is not the current CUDA device")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=_ACC[a.dtype], device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    if max(m, n, k) > _INT_MAX or -(-n // _BN) > 65535:
        raise ValueError(f"{who} does not take M={m} N={n} K={k}")
    fn = _build.kernel(_ENTRY[a.dtype], [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p])
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, a.stride(0), a.stride(1),
            b.stride(0), b.stride(1), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, who)
    wrapper.launch_count += 1
    return out


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 · (K, N) int8 → (M, N) int32, any strides. A CUDA pair goes
    through K6 or raises; a CPU pair through ``matmul_reference``."""
    _check(a, b, torch.int8, "int8_matmul")
    return _launch(a, b, int8_matmul) if a.is_cuda else matmul_reference(a, b)


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) bf16 · (K, N) bf16 → (M, N) float32 (the accumulator, not
    rounded back), any strides. CUDA: K6 or raises; CPU: ``matmul_reference``."""
    _check(a, b, torch.bfloat16, "bf16_matmul")
    return _launch(a, b, bf16_matmul) if a.is_cuda else matmul_reference(a, b)


int8_matmul.launch_count = 0
bf16_matmul.launch_count = 0
