"""Multi-head attention of the port: the hand-written small-MHA CUDA kernel
K2 (``csrc/small_mha.cu``) and its plain torch versions.

Port of ``lipreading_video_generation_tpu/ops/attention.py``'s
``attention_reference``, ``_mha_einsum``, ``small_mha_viable`` and ``mha``
and of the fused small-MHA Pallas kernel. Dispatch in ``mha``:

- ``s_q·s_k > 128²`` needs the flash kernel (ROADMAP K3), which is not
  ported yet: ``NotImplementedError`` on any device;
- a CUDA tensor that ``small_mha_viable`` accepts → K2 (``small_mha``);
  any other CUDA shape raises;
- a CPU tensor → ``_mha_einsum``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

__all__ = ["attention_reference", "mha", "small_mha", "small_mha_viable"]

_NEG_INF = float(torch.finfo(torch.float32).min) / 2
_SMALL_MHA_MAX_HS = 768     # the JAX package's bound on H·pad(S)
_KERNEL_WARPS = 8           # csrc/small_mha.cu's kWarps


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain softmax attention on (B, H, S, D): float32 scores, probabilities
    cast to V's dtype before P·V."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        s_q, s_k = logits.shape[-2:]
        mask = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril(s_k - s_q)
        logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def _mha_einsum(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                causal: bool) -> torch.Tensor:
    """Plain multi-head attention on (B, S, E) — the plain version of K2 and
    its backward: float32 scores at 1/sqrt(d), probabilities cast to V's
    dtype, P·V in V's dtype."""
    b, s_q, e = q.shape
    s_k = k.shape[1]
    hd = e // num_heads
    qh = q.reshape(b, s_q, num_heads, hd)
    kh = k.reshape(b, s_k, num_heads, hd)
    vh = v.reshape(b, s_k, num_heads, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) * (1.0 / math.sqrt(hd))
    if causal:
        mask = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril(s_k - s_q)
        logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(vh.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(b, s_q, e)


def _small_mha_pad(num_heads: int, s: int) -> int:
    """The JAX kernel's padded per-head length (its viability rule)."""
    step = 128 // math.gcd(num_heads, 128)
    step *= 8 // math.gcd(step, 8)
    return -(-s // step) * step


def _small_mha_smem_bytes(s: int, d: int) -> int:
    """Shared memory of one csrc/small_mha.cu block: K (padded rows) and V
    of one head, plus a query row and a score row per warp, as float."""
    return (s * (2 * d + 1) + _KERNEL_WARPS * (d + s)) * 4


def small_mha_viable(num_heads: int, s_q: int, s_k: int, e: int) -> bool:
    """The JAX package's rule (self-attention, H·pad(S) ≤ 768), plus the
    kernel's own bound: one head's K and V fit a block's shared memory."""
    return (s_q == s_k and e % num_heads == 0
            and num_heads * _small_mha_pad(num_heads, s_q) <= _SMALL_MHA_MAX_HS
            and _small_mha_smem_bytes(s_q, e // num_heads) <= _build.SMEM_PER_BLOCK)


_ENTRY_POINTS = {torch.bfloat16: "lvg_small_mha_bf16", torch.float32: "lvg_small_mha_f32"}


def _small_mha_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      num_heads: int, causal: bool) -> torch.Tensor:
    """Launch K2 on CUDA (B, S, E) q/k/v (bf16 or float32, unit column
    stride); returns a contiguous (B, S, E). Raises on anything else."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("small_mha kernel takes CUDA tensors")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"small_mha: {q.device} is not the current CUDA device")
    if not (q.device == k.device == v.device):
        raise ValueError("small_mha: q, k, v on different devices")
    if q.dtype not in _ENTRY_POINTS or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"small_mha takes bf16 or float32 q/k/v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.ndim == k.ndim == v.ndim == 3 and q.shape == k.shape == v.shape):
        raise ValueError(f"small_mha takes equal (B, S, E) shapes, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, e = q.shape
    if not small_mha_viable(num_heads, s, s, e):
        raise ValueError(f"small_mha kernel does not take S={s} E={e} heads={num_heads}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("small_mha needs unit stride along E")
    out = torch.empty(b, s, e, dtype=q.dtype, device=q.device)
    if b == 0 or s == 0:
        return out
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = _build.kernel(_ENTRY_POINTS[q.dtype],
                       [vp, vp, vp, vp, i32, i64, i64, i64, i64, i64, i64,
                        i32, i32, i32, ctypes.c_float, i32, vp])
    d = e // num_heads
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            s, num_heads, d, 1.0 / math.sqrt(d), int(causal),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "small_mha")
    small_mha.launch_count += 1
    return out


class _SmallMHA(torch.autograd.Function):
    """K2 forward; the backward recomputes through ``_mha_einsum`` under
    autograd, as the JAX kernel's custom VJP does (attention.py:661-668)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, causal):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads, ctx.causal = num_heads, causal
        return _small_mha_launch(q, k, v, num_heads, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = _mha_einsum(q, k, v, ctx.num_heads, ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None


def small_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
              causal: bool = False) -> torch.Tensor:
    """Small-sequence self-attention over (B, S, E): K2 for CUDA tensors
    (``launch_count`` counts its launches), ``_mha_einsum`` for CPU ones."""
    if not q.is_cuda:
        return _mha_einsum(q, k, v, num_heads, causal)
    return _SmallMHA.apply(q, k, v, num_heads, causal)


small_mha.launch_count = 0


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
        causal: bool = False) -> torch.Tensor:
    """Multi-head attention over (B, S, E) inputs; see the module docstring
    for the dispatch."""
    s_q, s_k, e = q.shape[1], k.shape[1], q.shape[2]
    if s_q * s_k > 128 * 128:
        raise NotImplementedError(
            f"mha: s_q·s_k = {s_q * s_k} > 128² needs the flash-attention kernel "
            "(ROADMAP K3), which is not ported yet")
    if not q.is_cuda:
        return _mha_einsum(q, k, v, num_heads, causal)
    if not small_mha_viable(num_heads, s_q, s_k, e):
        raise ValueError(f"mha: no CUDA kernel takes s_q={s_q} s_k={s_k} e={e} "
                         f"heads={num_heads}")
    return small_mha(q, k, v, num_heads, causal)
