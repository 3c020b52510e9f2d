"""Integer and bf16 matrix products: the hand-written CUDA kernel K6 and its
plain torch version.

Port of ``scripts/microbench_int8_pallas.py``'s ``mm_kernel`` / ``make_mm``:
C(M, N) = A(M, K) · B(K, N) with int8 operands and an int32 result, or bf16
operands and a float32 result (the accumulator, unrounded). The TPU script
runs it at 4096³ only; here it takes any M, N, K and reads A and B through
their strides, because it carries every integer product of int8 serving
(``ops/quant.py``): PyTorch has no integer ``matmul`` and no int8
convolution on a CUDA device.

Every product runs ``csrc/int8_mm_sm90.cu`` (``wgmma`` on swizzled tiles
that TMA fills). Its tensor maps read rows that start on 16-byte boundaries
and do not overlap, with K contiguous (N contiguous also serves a bf16 B);
integer ``wgmma`` takes K-major operands only. ``matmul_route`` names the
route: "sm90" where both operands are read as they are, "packed" where one
or both are first copied by ``pack_k_major`` (``csrc/int8_mm.cu``) to rows
of K contiguous elements, ``pad16(K·size)`` bytes apart: the TPU kernel's
own row-major int8 B, ``int8_dense``'s (in, out) weight, odd K, element
strides, unaligned, broadcast or overlapping views.

``int8_matmul`` and ``bf16_matmul`` launch the kernels for CUDA tensors (or
raise; ``launch_count`` counts the products, ``route_counts`` those of each
route, ``pack_launch_count`` the packs made for them) and use
``matmul_reference`` for CPU tensors. ``pack_k_major`` counts every pack it
launches (``launch_count``, ``path_counts``) and uses ``pack_reference`` for
a CPU tensor. The plain versions are what the tests and ``chip_smoke.py``
hold the kernels against.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utils import flops as _flops
from . import _build

__all__ = ["matmul_reference", "matmul_route", "int8_matmul", "bf16_matmul", "pack_reference",
           "pack_path", "pack_k_major", "product_flops"]

_ACC = {torch.int8: torch.int32, torch.bfloat16: torch.float32}
_ENTRY_SM90 = {torch.int8: "lvg_mm_sm90_int8", torch.bfloat16: "lvg_mm_sm90_bf16"}
_ENTRY_PACK = {torch.int8: "lvg_pack_int8", torch.bfloat16: "lvg_pack_bf16"}
_ROUTES = ("sm90", "packed")
# csrc/int8_mm.cu's paths, passed to its entry points by index
_PACK_PATHS = ("rows", "transpose", "gather")
_INT_MAX = 2**31 - 1
# csrc/int8_mm_sm90.cu's tiles: kBM rows of C, 128 bytes of depth a k-step
_MM_BM = 128
_MM_K_BYTES = 128
_H100_SMS = 132      # the SMs its tile width is chosen for, where no card is asked


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


def _size(dtype: torch.dtype) -> int:
    return 1 if dtype == torch.int8 else 2


def _mappable(size: int, ptr: int, row_stride: int, rows: int, length: int) -> bool:
    """A tensor map reads the rows as they lie: each starts on a 16-byte
    boundary and none overlaps the next."""
    return (ptr % 16 == 0 and (row_stride * size) % 16 == 0
            and (row_stride >= length or rows == 1))


def _packs(dtype: torch.dtype, m: int, n: int, k: int, a_strides, b_strides, a_ptr: int,
           b_ptr: int) -> Tuple[bool, bool]:
    """Whether A and whether B must be packed before the wgmma kernel reads
    them: A unless K is contiguous in mappable rows; B unless it is K-major
    in mappable rows or, bf16 only, N-major (integer wgmma takes no
    transposed operand)."""
    size = _size(dtype)
    a_ok = a_strides[1] == 1 and _mappable(size, a_ptr, a_strides[0], m, k)
    b_ok = ((b_strides[0] == 1 and _mappable(size, b_ptr, b_strides[1], n, k))
            or (size == 2 and b_strides[1] == 1 and _mappable(size, b_ptr, b_strides[0], k, n)))
    return not a_ok, not b_ok


def matmul_route(dtype: torch.dtype, m: int, n: int, k: int, a_strides, b_strides,
                 a_ptr: int, b_ptr: int) -> str:
    """How K6 runs (m, k) · (k, n) operands with the given element strides
    and base addresses (bytes, or any offsets congruent to them modulo 16).
    "sm90": ``csrc/int8_mm_sm90.cu`` reads both as they are, where A has K
    contiguous, B has K contiguous (an (N, K) weight taken as its transpose)
    or, bf16 only, N contiguous, and every row of both starts on a 16-byte
    boundary and rows do not overlap. "packed": ``pack_k_major`` first copies
    each operand that fails that (a row-major int8 B, row strides that are
    no multiple of 16 bytes, element strides, unaligned, broadcast or
    overlapping views) to K-major rows, then the same kernel multiplies."""
    return "packed" if any(_packs(dtype, m, n, k, a_strides, b_strides, a_ptr, b_ptr)) else "sm90"


def _packed_row(k: int, dtype: torch.dtype) -> int:
    """Elements between rows of a packed copy: ``pad16(K·size)`` bytes."""
    per = 16 // _size(dtype)
    return -(-k // per) * per


def _check_pack(x: torch.Tensor, who: str) -> None:
    if x.ndim != 2 or x.dtype not in _ACC:
        raise ValueError(f"{who} takes a 2-D int8 or bfloat16 tensor, got {tuple(x.shape)} "
                         f"{x.dtype}")


def pack_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``pack_k_major``: the (rows, K) values of ``x`` in a
    zeroed buffer of rows ``pad16(K·size)`` bytes apart, returned as its
    (rows, K) view."""
    _check_pack(x, "pack_reference")
    rows, k = x.shape
    out = torch.zeros((rows, _packed_row(k, x.dtype)), dtype=x.dtype, device=x.device)
    out[:, :k] = x
    return out[:, :k]


def pack_path(dtype: torch.dtype, strides, ptr: int) -> str:
    """Which path of ``csrc/int8_mm.cu`` packs a (rows, K) operand with the
    given element strides (row, K) and base address: "rows" where K is
    contiguous (any row start; aligned 16-byte words shifted into place),
    "transpose" where rows are contiguous and every depth starts on a
    16-byte boundary (a row-major (K, N) B read as (N, K): 16-byte loads, a
    byte transpose in registers), "gather" for the rest (element loads)."""
    rs, ks = strides
    if ks == 1:
        return "rows"
    if rs == 1 and ptr % 16 == 0 and (ks * _size(dtype)) % 16 == 0:
        return "transpose"
    return "gather"


def _tile_n(m: int, n: int, b_k_major: bool, sms: int) -> int:
    """The wgmma kernel's tile width (its ``launch_tb``): N rounded up to 8,
    16, 32 or 64 where that covers it (8-32 for a K-major B only), else the
    widest of 256, 128 and 64 that still gives each of ``sms`` SMs a tile."""
    if b_k_major:
        for bn in (8, 16, 32):
            if n <= bn:
                return bn
    if n <= 64:
        return 64
    tiles_m = -(-m // _MM_BM)
    if n > 128 and tiles_m * -(-n // 256) >= sms:
        return 256
    return 128 if tiles_m * -(-n // 128) >= sms else 64


def product_flops(a: torch.Tensor, b: torch.Tensor, depth: Optional[int] = None):
    """(model, hw) FLOPs of K6's product of (M, K) ``a`` and (K, N) ``b``.
    model: 2·M·N·depth, ``depth`` the product's logical depth (an im2col's
    kh·kw·Cin before its padding to 16; default K). hw: the kernel's whole
    tiles, 2·pad(M, 128)·pad(N, BN)·pad(K, 128 bytes), BN by ``_tile_n``
    for the operands as the kernel reads them (after any pack) and the
    card's SM count (the H100's 132 on the CPU)."""
    m, k = a.shape
    n = b.shape[1]
    _, pack_b = _packs(a.dtype, m, n, k, a.stride(), b.stride(), a.data_ptr(), b.data_ptr())
    sms = (torch.cuda.get_device_properties(a.device).multi_processor_count if a.is_cuda
           else _H100_SMS)
    bn = _tile_n(m, n, pack_b or b.stride(0) == 1, sms)
    per = _MM_K_BYTES // _size(a.dtype)
    hw = 2 * -(-m // _MM_BM) * _MM_BM * -(-n // bn) * bn * -(-k // per) * per
    return 2 * m * n * (k if depth is None else depth), hw


def _check_device(x: torch.Tensor, who: str) -> None:
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{who}: {x.device} is not the current CUDA device")


def pack_k_major(x: torch.Tensor) -> torch.Tensor:
    """A copy of the (rows, K) int8 or bf16 ``x`` (any strides, any
    alignment) with K contiguous and rows ``pad16(K·size)`` bytes apart, as
    its (rows, K) view: what a tensor map of the wgmma kernel reads. CUDA:
    the hand-written kernel ``csrc/int8_mm.cu`` by ``pack_path``'s path (the
    bytes past K in a row are left unwritten; nothing reads them), or
    raises; CPU: ``pack_reference``."""
    _check_pack(x, "pack_k_major")
    if not x.is_cuda:
        return pack_reference(x)
    _check_device(x, "pack_k_major")
    rows, k = x.shape
    if max(rows, k) > _INT_MAX:
        raise ValueError(f"pack_k_major does not take {rows} rows of K={k}")
    ld = _packed_row(k, x.dtype)
    out = torch.empty((rows, ld), dtype=x.dtype, device=x.device)
    if rows == 0 or k == 0:
        return out[:, :k]
    path = pack_path(x.dtype, x.stride(), x.data_ptr())
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = _build.kernel(_ENTRY_PACK[x.dtype], [vp, vp, i64, i32, i64, i64, i64, i32, vp])
    rc = fn(x.data_ptr(), out.data_ptr(), rows, k, x.stride(0), x.stride(1), ld,
            _PACK_PATHS.index(path), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"pack_k_major ({path})")
    if _flops.running:
        _flops.record("pack_k_major", 0, 0)       # a copy: no products
    pack_k_major.launch_count += 1
    pack_k_major.path_counts[path] += 1
    return out[:, :k]


def _launch(a: torch.Tensor, b: torch.Tensor, wrapper, depth: Optional[int]) -> torch.Tensor:
    """K6 on CUDA tensors for the public ``wrapper`` (which carries the
    counts): the packs ``matmul_route`` asks for, then the wgmma kernel, on
    the current stream without synchronising; raises on what the kernels do
    not take. ``depth``: as for ``product_flops``."""
    who = wrapper.__name__
    _check_device(a, who)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=_ACC[a.dtype], device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    if max(m, n, k) > _INT_MAX:
        raise ValueError(f"{who} does not take M={m} N={n} K={k}")
    pack_a, pack_b = _packs(a.dtype, m, n, k, a.stride(), b.stride(), a.data_ptr(),
                            b.data_ptr())
    flops = product_flops(a, b, depth) if _flops.running else None
    # the packed copies live until the product, queued behind them, has read them
    if pack_a:
        a = pack_k_major(a)
    if pack_b:
        b = pack_k_major(b.t()).t()       # (N, K) rows, taken as a K-major B
    route = "packed" if pack_a or pack_b else "sm90"
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = _build.kernel(_ENTRY_SM90[a.dtype], [vp, vp, vp, i32, i32, i32, i64, i64, i64, vp])
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, a.stride(0), b.stride(0),
            b.stride(1), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"{who} ({route})")
    if flops is not None:
        _flops.record(who, *flops)
    wrapper.launch_count += 1
    wrapper.route_counts[route] += 1
    wrapper.pack_launch_count += int(pack_a) + int(pack_b)
    return out


def _plain(a: torch.Tensor, b: torch.Tensor, who: str, depth: Optional[int]) -> torch.Tensor:
    """``matmul_reference`` in K6's place: a count sees the kernel's FLOPs."""
    with _flops.plain_version(lambda: {who: product_flops(a, b, depth)}):
        return matmul_reference(a, b)


def int8_matmul(a: torch.Tensor, b: torch.Tensor, depth: Optional[int] = None) -> torch.Tensor:
    """(M, K) int8 · (K, N) int8 → (M, N) int32, any strides. A CUDA pair goes
    through K6 (by the route ``matmul_route`` names: packs, then the wgmma
    kernel) or raises; a CPU pair through ``matmul_reference``. ``depth``,
    the product's logical depth where K is padded (``product_flops``), only
    enters a FLOP count."""
    _check(a, b, torch.int8, "int8_matmul")
    if a.is_cuda:
        return _launch(a, b, int8_matmul, depth)
    return _plain(a, b, "int8_matmul", depth)


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) bf16 · (K, N) bf16 → (M, N) float32 (the accumulator, not
    rounded back), any strides. CUDA: K6 or raises; CPU: ``matmul_reference``."""
    _check(a, b, torch.bfloat16, "bf16_matmul")
    if a.is_cuda:
        return _launch(a, b, bf16_matmul, None)
    return _plain(a, b, "bf16_matmul", None)


for _wrapper in (int8_matmul, bf16_matmul):
    _wrapper.launch_count = 0
    _wrapper.pack_launch_count = 0
    _wrapper.route_counts = dict.fromkeys(_ROUTES, 0)
pack_k_major.launch_count = 0
pack_k_major.path_counts = dict.fromkeys(_PACK_PATHS, 0)
