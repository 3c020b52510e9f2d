"""Integer and bf16 matrix products: the hand-written CUDA kernel K6
(``csrc/int8_mm_sm90.cu`` on the tensor cores' ``wgmma`` for aligned
operands, ``csrc/int8_mm.cu`` on ``mma.sync`` for the rest; ``matmul_route``
picks) and its plain torch version.

Port of ``scripts/microbench_int8_pallas.py``'s ``mm_kernel`` / ``make_mm``:
C(M, N) = A(M, K) · B(K, N) with int8 operands and an int32 result, or bf16
operands and a float32 result (the accumulator, unrounded). The TPU script
runs it at 4096³ only; here it takes any M, N, K and reads A and B through
their strides, because it carries every integer product of int8 serving
(``ops/quant.py``): PyTorch has no integer ``matmul`` and no int8
convolution on a CUDA device.

``int8_matmul`` and ``bf16_matmul`` launch the kernel for CUDA tensors (or
raise; ``launch_count`` counts the launches, ``route_counts`` those of each
route) and use ``matmul_reference`` for CPU tensors. ``matmul_reference`` is
the plain version the tests and ``chip_smoke.py`` hold the kernel against.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["matmul_reference", "matmul_route", "int8_matmul", "bf16_matmul"]

_ACC = {torch.int8: torch.int32, torch.bfloat16: torch.float32}
_ENTRY = {torch.int8: "lvg_mm_int8", torch.bfloat16: "lvg_mm_bf16"}
_ENTRY_SM90 = {torch.int8: "lvg_mm_sm90_int8", torch.bfloat16: "lvg_mm_sm90_bf16"}
_ROUTES = ("sm90", "mma_sync")
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


def matmul_route(dtype: torch.dtype, m: int, n: int, k: int, a_strides, b_strides,
                 a_ptr: int, b_ptr: int) -> str:
    """Which kernel K6 launches for (m, k) · (k, n) operands with the given
    element strides and base addresses (bytes, or any offsets congruent to
    them modulo 16): "sm90" (``csrc/int8_mm_sm90.cu``: wgmma on swizzled
    tiles filled by TMA) where A has K contiguous, B
    has K contiguous (an (N, K) weight taken as its transpose) or, bf16 only,
    N contiguous (integer wgmma takes no transposed operand), and every row
    of both starts on a 16-byte boundary and rows do not overlap; "mma_sync"
    (``csrc/int8_mm.cu``) for anything else: a row-major int8 B, row strides
    that are no multiple of 16 bytes (odd K), element strides, unaligned,
    broadcast or overlapping views."""
    size = 1 if dtype == torch.int8 else 2

    def rows_ok(ptr, row_stride, rows, length):
        # 16-byte row starts; rows that do not overlap (a tensor map's rule)
        return (ptr % 16 == 0 and (row_stride * size) % 16 == 0
                and (row_stride >= length or rows == 1))

    if a_strides[1] != 1 or not rows_ok(a_ptr, a_strides[0], m, k):
        return "mma_sync"
    if b_strides[0] == 1 and rows_ok(b_ptr, b_strides[1], n, k):
        return "sm90"
    if size == 2 and b_strides[1] == 1 and rows_ok(b_ptr, b_strides[0], k, n):
        return "sm90"
    return "mma_sync"


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
    if max(m, n, k) > _INT_MAX:
        raise ValueError(f"{who} does not take M={m} N={n} K={k}")
    route = matmul_route(a.dtype, m, n, k, a.stride(), b.stride(), a.data_ptr(), b.data_ptr())
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    stream = torch.cuda.current_stream().cuda_stream
    if route == "sm90":
        fn = _build.kernel(_ENTRY_SM90[a.dtype], [vp, vp, vp, i32, i32, i32, i64, i64, i64, vp])
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, a.stride(0), b.stride(0),
                b.stride(1), stream)
    else:
        if -(-n // _BN) > 65535:
            raise ValueError(f"{who} (mma.sync route) does not take N={n}")
        fn = _build.kernel(_ENTRY[a.dtype], [vp, vp, vp, i32, i32, i32, i64, i64, i64, i64, vp])
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, a.stride(0), a.stride(1),
                b.stride(0), b.stride(1), stream)
    _build.check(rc, f"{who} ({route})")
    wrapper.launch_count += 1
    wrapper.route_counts[route] += 1
    return out


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 · (K, N) int8 → (M, N) int32, any strides. A CUDA pair goes
    through K6 (by the route ``matmul_route`` names) or raises; a CPU pair
    through ``matmul_reference``."""
    _check(a, b, torch.int8, "int8_matmul")
    return _launch(a, b, int8_matmul) if a.is_cuda else matmul_reference(a, b)


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) bf16 · (K, N) bf16 → (M, N) float32 (the accumulator, not
    rounded back), any strides. CUDA: K6 or raises; CPU: ``matmul_reference``."""
    _check(a, b, torch.bfloat16, "bf16_matmul")
    return _launch(a, b, bf16_matmul) if a.is_cuda else matmul_reference(a, b)


int8_matmul.launch_count = 0
bf16_matmul.launch_count = 0
int8_matmul.route_counts = dict.fromkeys(_ROUTES, 0)
bf16_matmul.route_counts = dict.fromkeys(_ROUTES, 0)
