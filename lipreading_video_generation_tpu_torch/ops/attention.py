"""Multi-head attention of the port: the hand-written CUDA kernels K2
(small MHA: ``csrc/small_mha_sm90.cu`` on the tensor cores for aligned bf16
inputs of up to 128 tokens, ``csrc/small_mha.cu`` on CUDA cores for the rest;
``small_mha_route`` picks, and ``small_mha_variant`` picks the CUDA-core
kernel's variant), K3 (flash-attention forward:
``csrc/flash_fwd_sm90.cu`` on the tensor cores for aligned bf16 inputs,
``csrc/flash_fwd.cu`` on CUDA cores for the rest) and K4/K5 (its backward:
``csrc/flash_bwd_sm90.cu`` and ``csrc/flash_bwd.cu`` likewise; one rule,
``flash_route``, picks the route of all three, and ``flash_bwd_variant`` the
variant of ``csrc/flash_bwd.cu``) and their plain torch versions.

Port of ``lipreading_video_generation_tpu/ops/attention.py``'s
``attention_reference``, ``flash_attention`` (with its custom VJP),
``_mha_einsum``, ``small_mha_viable`` and ``mha``, and of the fused
small-MHA, flash forward and flash backward Pallas kernels. ``mha_route`` decides, by shape, dtype and device,
where ``mha`` goes; the split between flash and small shapes is the JAX
package's:

- ``s_q·s_k > 128²`` → ``flash_attention``: K3 for a CUDA tensor,
  ``flash_reference`` for a CPU one;
- a CUDA tensor that ``small_mha_viable`` accepts (bf16 or float32) → K2;
- anything else (other small shapes, CPU tensors) → ``_mha_einsum``, the
  JAX package's default small-shape path.

A CUDA tensor never falls back from a kernel to a plain version: a failed
build or launch raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

__all__ = ["attention_reference", "flash_attention", "flash_backward_reference",
           "flash_bwd_dkv", "flash_bwd_dq", "flash_bwd_route", "flash_bwd_variant",
           "flash_reference", "flash_route",
           "mha", "mha_route", "small_mha", "small_mha_route", "small_mha_variant",
           "small_mha_viable"]

_NEG_INF = float(torch.finfo(torch.float32).min) / 2
_SMALL_MHA_MAX_HS = 768     # the JAX package's bound on H·pad(S)
_KERNEL_WARPS = 8           # csrc/small_mha.cu's kGenWarps (its general variants)
_SMALL_MHA_ROUTES = ("sm90", "cuda_core")
# csrc/small_mha.cu's Variant, in its order (the C entry points take the index)
_SMALL_MHA_VARIANTS = ("general", "general_vec4", "rows", "rows_vec4")
_SMALL_MHA_ROWS_MAX_S = 64          # its kRowsMaxS: a row's scores are registers
_SMALL_MHA_ROWS_MAX_CHUNKS = 128    # its kRowsMaxChunks: 32 lanes x 4 loads of a row
_SMALL_MHA_MAX_S_SM90 = 128     # csrc/small_mha_sm90.cu: the score strip of a warp, 16 x 128
_SMALL_MHA_MAX_D_SM90 = 128     # and its O strip, 16 x 128, both in registers


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
    """Shared memory of one block of csrc/small_mha.cu's general variants:
    K (padded rows) and V of one head, plus a query row and a score row per
    warp, as float. (Its rows variants hold K and V alone, 8·s·d bytes a
    head, which is less: every shape this bound lets through fits them.)"""
    return (s * (2 * d + 1) + _KERNEL_WARPS * (d + s)) * 4


def _aligned(strides, offsets, elems: int, nbytes: int) -> bool:
    """Every stride (elements, one tuple per tensor) a multiple of ``elems``
    and every base offset a multiple of ``nbytes`` bytes. (Plain loops: the
    wrapper asks on every launch, and generators cost it microseconds.)"""
    for t in strides:
        for st in t:
            if st % elems:
                return False
    for o in offsets:
        if o % nbytes:
            return False
    return True


def small_mha_route(dtype: torch.dtype, s: int, d: int, strides, offsets) -> str:
    """Which kernel K2 launches: "sm90" (``csrc/small_mha_sm90.cu``:
    ``mma.sync`` on bf16 tiles filled by 16-byte asynchronous copies, a warp a
    head) for bf16 tensors of 1 to 128 tokens with ``d`` a multiple of 8 up to
    128 (the score and output strips of a warp are registers) whose every
    (batch, row) stride (in elements, ``strides``: one tuple per tensor) is a
    multiple of 8 and whose base address (in bytes, or any offset congruent
    to it modulo 16, ``offsets``: one per tensor) is a multiple of 16;
    "cuda_core" (``csrc/small_mha.cu``) for float32 (tensor cores would mean
    TF32), longer sequences, other head dims and anything unaligned."""
    if (dtype != torch.bfloat16 or d % 8 or d > _SMALL_MHA_MAX_D_SM90
            or not 1 <= s <= _SMALL_MHA_MAX_S_SM90):
        return "cuda_core"
    return "sm90" if _aligned(strides, offsets, 8, 16) else "cuda_core"


def small_mha_variant(dtype: torch.dtype, s: int, d: int, strides, offsets) -> str:
    """Which kernel of ``csrc/small_mha.cu`` the "cuda_core" route launches
    (``strides`` and ``offsets`` as for ``small_mha_route``):

    - "rows" (S ≤ 64 and d ≤ 128): a group of lanes a query row, its lanes
      over d; a block's K and V staged in shared memory, the row's scores,
      softmax and P in registers; an element a load;
    - "rows_vec4": the same, 16 bytes a load, for float32 whose d and every
      (batch, row) stride are multiples of 4 elements and whose bases lie on
      16 bytes, up to d 512 (four loads a lane of 32);
    - "general" / "general_vec4": everything else, S up to what
      ``small_mha_viable`` takes: a block a (batch, head), K and V staged in
      shared memory, a warp a query row with its lanes over keys.

    The causal mask does not enter the choice: every variant takes it."""
    vec4 = dtype == torch.float32 and d % 4 == 0 and _aligned(strides, offsets, 4, 16)
    chunks = d // 4 if vec4 else d
    rows = 1 <= s <= _SMALL_MHA_ROWS_MAX_S and chunks <= _SMALL_MHA_ROWS_MAX_CHUNKS
    return ("rows" if rows else "general") + ("_vec4" if vec4 else "")


def small_mha_viable(num_heads: int, s_q: int, s_k: int, e: int,
                     route: str = "cuda_core") -> bool:
    """The JAX package's rule (self-attention, H·pad(S) ≤ 768), plus the
    bound of the kernel ``route`` names: on "cuda_core" one head's K and V as
    float fit a block's shared memory; "sm90" takes every shape
    ``small_mha_route`` sends it."""
    if not (s_q == s_k and e % num_heads == 0
            and num_heads * _small_mha_pad(num_heads, s_q) <= _SMALL_MHA_MAX_HS):
        return False
    return (route == "sm90"
            or _small_mha_smem_bytes(s_q, e // num_heads) <= _build.SMEM_PER_BLOCK)


_ENTRY_POINTS = {torch.bfloat16: "lvg_small_mha_bf16", torch.float32: "lvg_small_mha_f32"}
# q, k, v, o, batch, the (batch, row) strides of q, k, v, s, heads, d, scale,
# causal, then the stream (sm90) or the variant and the stream (cuda_core)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 3 \
    + [ctypes.c_float, ctypes.c_int]
_SM90_ARGTYPES = _ARGTYPES + [ctypes.c_void_p]
_CUDA_CORE_ARGTYPES = _ARGTYPES + [ctypes.c_int, ctypes.c_void_p]


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
    if e % num_heads:
        raise ValueError(f"small_mha: E={e} is not a multiple of heads={num_heads}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("small_mha needs unit stride along E")
    d = e // num_heads
    strides = (q.stride()[:2], k.stride()[:2], v.stride()[:2])
    offsets = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    route = small_mha_route(q.dtype, s, d, strides, offsets)
    if not small_mha_viable(num_heads, s, s, e, route):
        raise ValueError(f"small_mha kernel does not take S={s} E={e} heads={num_heads}")
    out = torch.empty(b, s, e, dtype=q.dtype, device=q.device)
    if b == 0 or s == 0:
        return out
    args = (*offsets, out.data_ptr(), b, *strides[0], *strides[1], *strides[2], s, num_heads, d,
            1.0 / math.sqrt(d), int(causal))
    if route == "sm90":
        fn = _build.kernel("lvg_small_mha_sm90", _SM90_ARGTYPES)
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        variant = small_mha_variant(q.dtype, s, d, strides, offsets)
        fn = _build.kernel(_ENTRY_POINTS[q.dtype], _CUDA_CORE_ARGTYPES)
        rc = fn(*args, _SMALL_MHA_VARIANTS.index(variant),
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"small_mha ({route})")
    small_mha.launch_count += 1
    small_mha.route_counts[route] += 1
    if route == "cuda_core":
        small_mha.variant_counts[variant] += 1
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
    (``launch_count`` counts its launches, ``route_counts`` those of each
    route of ``small_mha_route``, ``variant_counts`` those of the "cuda_core"
    route by ``small_mha_variant``), ``_mha_einsum`` for CPU ones."""
    if not q.is_cuda:
        return _mha_einsum(q, k, v, num_heads, causal)
    return _SmallMHA.apply(q, k, v, num_heads, causal)


small_mha.launch_count = 0
small_mha.route_counts = dict.fromkeys(_SMALL_MHA_ROUTES, 0)
small_mha.variant_counts = dict.fromkeys(_SMALL_MHA_VARIANTS, 0)


_FLASH_BQ = _FLASH_BK = 64          # csrc/flash_fwd.cu's tile (Layout::BQ, BK)
_FLASH_PAD = 4                      # its kPad
_FLASH_SLICE = 256                  # the CUDA-core kernels walk larger head dims in slices of 256
_FLASH_MAX_D_SM90 = 256             # the tensor-core kernels' largest head dim
_FLASH_ROUTES = ("sm90", "cuda_core")
_FLASH_ENTRY_POINTS = {torch.bfloat16: "lvg_flash_fwd_bf16", torch.float32: "lvg_flash_fwd_f32"}
# past this many scores a plain-version call walks its queries in chunks
_FLASH_REF_CHUNK = 1 << 26


def flash_head_dim_pad(d: int) -> int:
    """The head dim K3, K4 and K5 pad d to: 64, 128 or 256, and above 256
    (the CUDA-core kernels only) the next multiple of 256, which they walk
    in slices of 256 columns (the JAX package pads to a multiple of 128
    there)."""
    if d < 1:
        raise ValueError(f"flash_attention: head dim {d}")
    if d > _FLASH_SLICE:
        return -(-d // _FLASH_SLICE) * _FLASH_SLICE
    return next(dp for dp in (64, 128, 256) if d <= dp)


def _flash_tile_dim(d: int) -> int:
    """The head dim of the CUDA-core kernels' shared-memory tiles: the padded
    head dim, or one slice of 256 columns above 256."""
    return min(flash_head_dim_pad(d), _FLASH_SLICE)


def flash_route(dtype: torch.dtype, d: int, strides, offsets) -> str:
    """Which kernels K3, K4 and K5 launch: "sm90" (``csrc/flash_fwd_sm90.cu``,
    ``csrc/flash_bwd_sm90.cu``: wgmma on bf16 tiles filled by 16-byte
    asynchronous copies) for bf16 tensors with ``d`` a multiple of 8 up to
    256 whose every (batch, head, row) stride (in elements, ``strides``: one
    tuple per tensor) is a multiple of 8 and whose base address (in bytes,
    or any byte offset congruent to it modulo 16, ``offsets``: one per
    tensor) is a multiple of 16; "cuda_core" (``csrc/flash_fwd.cu``,
    ``csrc/flash_bwd.cu``) for float32 (tensor cores would mean TF32), for
    head dims above 256 and for anything unaligned."""
    if dtype != torch.bfloat16 or d % 8 or d > _FLASH_MAX_D_SM90:
        return "cuda_core"
    if any(st % 8 for t in strides for st in t) or any(o % 16 for o in offsets):
        return "cuda_core"
    return "sm90"


flash_bwd_route = flash_route       # the name the rule had when only K4/K5 followed it


def flash_smem_bytes(d: int, route: str = "cuda_core") -> int:
    """Dynamic shared memory of one K3 block. CUDA-core route
    (``csrc/flash_fwd.cu``'s Layout): Qᵀ, Kᵀ, V and P tiles as float, 64
    rows and 64 keys; above head dim 256 the tiles of 256 hold one slice of
    d at a time. "sm90"
    (``csrc/flash_fwd_sm90.cu``'s FwdCfg): bf16 tiles; Q of the block's
    queries (128, 64 at head dim 256), two stages each of K and V (64 keys,
    128 at head dim 128), plus 1 KB to align the tiles to the swizzle's 1024
    bytes."""
    dp = flash_head_dim_pad(d)
    if route == "cuda_core":
        dp = _flash_tile_dim(d)
        bq, bk = _FLASH_BQ, _FLASH_BK
        floats = (dp * (bq + _FLASH_PAD) + dp * (bk + _FLASH_PAD)
                  + bk * (dp + _FLASH_PAD) + bq * (bk + _FLASH_PAD))
        return floats * 4
    if dp > _FLASH_MAX_D_SM90:
        raise ValueError(f"flash_attention: the tensor-core kernel takes no head dim {d}")
    bq, bk = 64 if dp == 256 else 128, 128 if dp == 128 else 64
    return bq * dp * 2 + 4 * bk * dp * 2 + 1024


def flash_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
                    sm_scale: Optional[float] = None, p_dtype: Optional[torch.dtype] = None):
    """Plain version of K3 on (B, H, S, D): the CUDA-core K3's numerics
    exactly — q scaled in float32, float32 scores, masked scores set to
    finfo.min/2, float32 probabilities (not rounded to V's dtype) and P·V,
    output in q's dtype; returns (O, lse) with lse (B, H, S_q) float32. Rows
    with no visible key (causal with s_q > s_k) average V over the s_k keys,
    as ``attention_reference`` does. Long inputs are walked in query chunks,
    which changes no number. ``p_dtype`` rounds P to that type before P·V
    and nowhere else, which is where the tensor-core kernel rounds (to
    bf16): the row sum, and so lse, still come from the float32 P; the
    default keeps P float32."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s_q, s_k = q.shape[2], k.shape[2]
    kf, vf = k.float(), v.float()
    step = max(1, _FLASH_REF_CHUNK // max(1, q.shape[0] * q.shape[1] * s_k))
    outs, lses = [], []
    for r0 in range(0, s_q, step):
        qf = q[:, :, r0:r0 + step].float() * sm_scale
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
        if causal:
            rows = torch.arange(r0, r0 + qf.shape[2], device=q.device)[:, None]
            keys = torch.arange(s_k, device=q.device)[None, :]
            s = s.masked_fill(keys > rows + (s_k - s_q), _NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        pv = p if p_dtype is None else p.to(p_dtype).float()
        outs.append((torch.einsum("bhqk,bhkd->bhqd", pv, vf) / denom).to(q.dtype))
        lses.append((m + torch.log(denom))[..., 0])
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def _flash_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                  sm_scale: float):
    """Launch K3 on CUDA (B, H, S, D) q/k/v of one dtype (bf16 or float32,
    unit stride along D, any D). Returns (O as a (B, H, S_q, D) view of a
    contiguous (B, S_q, H, D) tensor, lse (B, H, S_q) float32). The kernel
    is the one ``flash_route`` names. Raises on anything else."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention kernel takes CUDA tensors")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"flash_attention: {q.device} is not the current CUDA device")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.dtype not in _FLASH_ENTRY_POINTS or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention takes bf16 or float32 q/k/v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention takes (B, H, S, D) q and equal k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    flash_head_dim_pad(d)
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs unit stride along D")
    out = torch.empty(b, s_q, h, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty(b, h, s_q, dtype=torch.float32, device=q.device)
    if b == 0 or h == 0 or s_q == 0:
        return out, lse
    if s_k == 0:
        raise ValueError("flash_attention: no keys")
    tensors = (q, k, v, out)
    route = flash_route(q.dtype, d, [t.stride()[:3] for t in tensors],
                        [t.data_ptr() for t in tensors])
    strides = (ctypes.c_longlong * 12)(*(st for t in tensors for st in t.stride()[:3]))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn = _build.kernel("lvg_flash_fwd_sm90" if route == "sm90" else _FLASH_ENTRY_POINTS[q.dtype],
                       [vp, vp, vp, vp, vp, i32, i32, i32, i32, i32,
                        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i32, vp])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, h, s_q, s_k, d, strides, sm_scale, int(causal),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"flash_attention ({route})")
    flash_attention.launch_count += 1
    flash_attention.route_counts[route] += 1
    return out, lse


def flash_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                             causal: bool = False, sm_scale: Optional[float] = None,
                             dq: bool = True, dkv: bool = True,
                             p_dtype: Optional[torch.dtype] = None):
    """Plain version of K4 (dK, dV) and K5 (dQ) on (B, H, S, D): the JAX
    backward kernels' numerics — float32 scores scaled after Q·Kᵀ,
    P = exp(s − lse) from the forward's ``lse``, dP = dO·Vᵀ,
    dS = P∘(dP − Δ)·scale with ``delta`` = Σ_d dO·O, dV = Pᵀ·dO, dK = dSᵀ·Q,
    dQ = dS·K, all in float32 (P too), outputs in q/k/v's dtypes. Masked
    pairs get dS = 0. A row that sees no key (causal, s_q > s_k) follows
    autograd through ``attention_reference``: P = 1/s_k over the real keys
    (``lse`` has absorbed log s_k there, so exp(s − lse) would give 1), and
    no dS. Long inputs are walked in query chunks, dK/dV summed over them.
    ``dq``/``dkv`` pick the passes; the other outputs are None. ``p_dtype``
    rounds P and dS to that type before the three products that consume
    them, which is where the tensor-core kernels round (to bf16); the
    default keeps them float32."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s_q, s_k = q.shape[2], k.shape[2]
    kf, vf = k.float(), v.float()
    gdk = torch.zeros(kf.shape, device=k.device) if dkv else None
    gdv = torch.zeros(vf.shape, device=v.device) if dkv else None
    gdq = []
    step = max(1, _FLASH_REF_CHUNK // max(1, q.shape[0] * q.shape[1] * s_k))
    for r0 in range(0, s_q, step):
        qf = q[:, :, r0:r0 + step].float()
        dof = do[:, :, r0:r0 + step].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
        p = torch.exp(s - lse[:, :, r0:r0 + step, None])
        if causal:
            rows = torch.arange(r0, r0 + qf.shape[2], device=q.device)[:, None]
            keys = torch.arange(s_k, device=q.device)[None, :]
            visible = keys <= rows + (s_k - s_q)
            p = torch.where(visible, p, 0.0)
            p = torch.where(rows + (s_k - s_q) < 0, 1.0 / s_k, p)     # rows that see no key
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
        ds = p * (dp - delta[:, :, r0:r0 + step, None]) * sm_scale
        if causal:
            ds = torch.where(visible, ds, 0.0)
        if p_dtype is not None:
            p, ds = p.to(p_dtype).float(), ds.to(p_dtype).float()
        if dkv:
            gdv += torch.einsum("bhqk,bhqd->bhkd", p, dof)
            gdk += torch.einsum("bhqk,bhqd->bhkd", ds, qf)
        if dq:
            gdq.append(torch.einsum("bhqk,bhkd->bhqd", ds, kf))
    return (torch.cat(gdq, dim=2).to(q.dtype) if dq else None,
            gdk.to(k.dtype) if dkv else None, gdv.to(v.dtype) if dkv else None)


_BWD_DTYPE_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}   # the CUDA-core entry points
# csrc/flash_bwd.cu's variants, in its order (its C entry points take the index)
_FLASH_BWD_VARIANTS = ("general", "tiled")
_FLASH_BWD_TILED_MAX_D = 256


def flash_bwd_variant(dtype: torch.dtype, d: int, strides, offsets) -> str:
    """Which kernels of ``csrc/flash_bwd.cu`` the "cuda_core" route of K4
    and K5 launches (``strides`` and ``offsets`` as for ``flash_route``, over
    q, k, v, dO and the gradients):

    - "tiled": float32 with ``d`` a multiple of 4 up to 256 whose every
      (batch, head, row) stride is a multiple of 4 elements and whose every
      base lies on 16 bytes: 128-thread blocks, two an SM, the streamed
      tiles copied by 16-byte ``cp.async`` into two stages;
    - "general": everything else (bf16 views the tensor-core kernels cannot
      read, unaligned float32, ``d`` not a multiple of 4, and head dims above
      256, walked in slices of 256 columns).

    The causal mask and the lengths do not enter the choice."""
    if (dtype == torch.float32 and d % 4 == 0 and d <= _FLASH_BWD_TILED_MAX_D
            and _aligned(strides, offsets, 4, 16)):
        return "tiled"
    return "general"


def _flash_bwd_tiled_tiles(d: int, kernel: str):
    """(query rows, keys) of a tile of the "tiled" kernels
    (``csrc/flash_bwd.cu``'s DkvTiles / DqTiles) at head dim ``d``: K4 a
    block of 32 keys (16 at head dim 256) over query tiles of 64 rows (32
    above head dim 64); K5 a block of 32 queries over key tiles of 64, 32
    or 16 keys at head dims 64, 128, 256."""
    dp = flash_head_dim_pad(d)
    if dp > _FLASH_BWD_TILED_MAX_D:
        raise ValueError(f"flash backward: the tiled kernels take no head dim {d}")
    if kernel == "dkv":
        return (64 if dp == 64 else 32), (16 if dp == 256 else 32)
    return 32, {64: 64, 128: 32, 256: 16}[dp]


def flash_bwd_block_q(d: int, route: str = "cuda_core", kernel: str = "dkv",
                      variant: str = "general") -> int:
    """Query rows per tile (K4) or per block (K5). CUDA-core route
    (``csrc/flash_bwd.cu``'s BQ), ``variant`` "general": 32 from head dim 256
    on, where larger tiles would not fit a block's shared memory (above 256
    the tiles of 256 hold one slice of d), else 64; "tiled": see
    ``_flash_bwd_tiled_tiles``. "sm90"
    (``csrc/flash_bwd_sm90.cu``'s DkvCfg / DqCfg): K4 walks 128-query tiles
    at head dim 64 and 64-query tiles above; a K5 block owns 128 queries
    (two warpgroups), 64 at head dim 256."""
    dp = flash_head_dim_pad(d)
    if route == "cuda_core":
        if variant == "tiled":
            return _flash_bwd_tiled_tiles(d, kernel)[0]
        return 32 if _flash_tile_dim(d) == 256 else 64
    if dp > _FLASH_MAX_D_SM90:
        raise ValueError(f"flash backward: the tensor-core kernels take no head dim {d}")
    if kernel == "dkv":
        return 128 if dp == 64 else 64
    return 64 if dp == 256 else 128


def flash_bwd_smem_bytes(d: int, kernel: str, route: str = "cuda_core",
                         variant: str = "general") -> int:
    """Dynamic shared memory of one K4 ("dkv") or K5 ("dq") block.
    CUDA-core route, ``variant`` "general": Q, dO, K, V tiles row-major as
    float (rows padded by 4; 64 keys; above head dim 256 those of 256, one
    slice of d at a time), plus the P and dS tiles (K4) or the dS
    tile (K5), plus lse and Δ of the query tile (K4); "tiled": as float,
    rows padded by 4, K4 Kᵀ and Vᵀ of its keys, two stages of Q and dO, P
    and dS; K5 Q and dO of its queries, two stages of K and V, dSᵀ. "sm90":
    bf16 tiles; the outer tile pair (K4: K, V
    of 128 keys, 64 at head dim 256; K5: Q, dO of the block's queries) and
    two stages of the inner pair (K4: Q, dO and 1 KB of lse and Δ; K5: K, V
    of 128 keys at head dim 64, else 64), plus 1 KB to align the tiles to
    the swizzle's 1024 bytes."""
    dp = flash_head_dim_pad(d)
    if route == "cuda_core" and variant == "tiled":
        bq, bk = _flash_bwd_tiled_tiles(d, kernel)
        pad = _FLASH_PAD
        if kernel == "dkv":
            floats = 2 * dp * (bk + pad) + 4 * bq * (dp + pad) + 2 * bq * (bk + pad)
        else:
            floats = 2 * bq * (dp + pad) + 4 * bk * (dp + pad) + bk * (bq + pad)
        return floats * 4
    if route == "cuda_core":
        dp = _flash_tile_dim(d)
        bq, bk = flash_bwd_block_q(d), _FLASH_BK
        ld, ldp = dp + _FLASH_PAD, bk + _FLASH_PAD
        floats = 2 * bq * ld + 2 * bk * ld
        floats += 2 * bq * ldp + 2 * bq if kernel == "dkv" else bq * ldp
        return floats * 4
    bq = flash_bwd_block_q(d, route, kernel)
    if kernel == "dkv":
        keys = 64 if dp == 256 else 128
        return 2 * keys * dp * 2 + 2 * (2 * bq * dp * 2 + 1024) + 1024
    bk = 128 if dp == 64 else 64
    return 2 * bq * dp * 2 + 2 * (2 * bk * dp * 2) + 1024


def _flash_bwd_launch(kernel: str, q, k, v, do, lse, delta, causal: bool, sm_scale: float):
    """Launch K4 (``kernel`` "dkv": returns dK, dV) or K5 ("dq": returns dQ)
    on CUDA (B, H, S, D) q/k/v/dO of one dtype with unit stride along D;
    ``lse`` and ``delta`` (B, H, S_q) float32. Each gradient comes out as a
    (B, H, S, D) view of a contiguous (B, S, H, D) tensor. The kernels are
    those ``flash_route`` names, on the "cuda_core" route the variant
    ``flash_bwd_variant`` names. Raises on anything else."""
    if not all(t.is_cuda for t in (q, k, v, do, lse, delta)):
        raise ValueError("flash backward kernels take CUDA tensors")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"flash backward: {q.device} is not the current CUDA device")
    if not all(t.device == q.device for t in (k, v, do, lse, delta)):
        raise ValueError("flash backward: tensors on different devices")
    if q.dtype not in _BWD_DTYPE_SUFFIX or not (q.dtype == k.dtype == v.dtype == do.dtype):
        raise ValueError(f"flash backward takes bf16 or float32 q/k/v/dO of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}, {do.dtype}")
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    if (k.shape != (b, h, s_k, d) or v.shape != k.shape or do.shape != q.shape
            or lse.shape != (b, h, s_q) or delta.shape != lse.shape):
        raise ValueError(f"flash backward: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} dO{tuple(do.shape)} lse{tuple(lse.shape)} "
                         f"delta{tuple(delta.shape)} do not fit")
    flash_head_dim_pad(d)
    if any(t.stride(-1) != 1 for t in (q, k, v, do)):
        raise ValueError("flash backward needs unit stride along D")
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError("flash backward takes float32 lse and delta")
    if s_k == 0:
        raise ValueError("flash backward: no keys")
    lse, delta = lse.contiguous(), delta.contiguous()

    def grad_like(x):
        return torch.empty(x.shape[0], x.shape[2], x.shape[1], x.shape[3], dtype=x.dtype,
                           device=x.device).transpose(1, 2)

    outs = (grad_like(k), grad_like(v)) if kernel == "dkv" else (grad_like(q),)
    if b == 0 or h == 0 or s_q == 0:
        for o in outs:
            o.zero_()
        return outs
    tensors = (q, k, v, do) + outs
    t_strides = [t.stride()[:3] for t in tensors]
    offsets = [t.data_ptr() for t in tensors]
    route = flash_route(q.dtype, d, t_strides, offsets)
    strides = (ctypes.c_longlong * (3 * len(tensors)))(*(st for t in t_strides for st in t))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    args = [*(t.data_ptr() for t in (q, k, v, do, lse, delta) + outs),
            b, h, s_q, s_k, d, strides, sm_scale, int(causal)]
    argtypes = ([vp] * (6 + len(outs)) + [i32] * 5
                + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i32])
    if route == "sm90":
        fn = _build.kernel(f"lvg_flash_bwd_{kernel}_sm90", argtypes + [vp])
    else:
        variant = flash_bwd_variant(q.dtype, d, t_strides, offsets)
        fn = _build.kernel(f"lvg_flash_bwd_{kernel}_{_BWD_DTYPE_SUFFIX[q.dtype]}",
                           argtypes + [i32, vp])
        args.append(_FLASH_BWD_VARIANTS.index(variant))
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"flash backward ({kernel}, {route})")
    wrapper = flash_bwd_dkv if kernel == "dkv" else flash_bwd_dq
    wrapper.launch_count += 1
    wrapper.route_counts[route] += 1
    if route == "cuda_core":
        wrapper.variant_counts[variant] += 1
    return outs


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False,
                  sm_scale: Optional[float] = None):
    """K4: (dK, dV) of flash attention; ``launch_count`` counts its launches,
    ``route_counts`` those of each route of ``flash_route``,
    ``variant_counts`` those of the "cuda_core" route by
    ``flash_bwd_variant``."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _flash_bwd_launch("dkv", q, k, v, do, lse, delta, causal, sm_scale)


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = False,
                 sm_scale: Optional[float] = None):
    """K5: dQ of flash attention; ``launch_count`` counts its launches,
    ``route_counts`` those of each route of ``flash_route``,
    ``variant_counts`` those of the "cuda_core" route by
    ``flash_bwd_variant``."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _flash_bwd_launch("dq", q, k, v, do, lse, delta, causal, sm_scale)[0]


flash_bwd_dkv.launch_count = 0
flash_bwd_dq.launch_count = 0
flash_bwd_dkv.route_counts = dict.fromkeys(_FLASH_ROUTES, 0)
flash_bwd_dq.route_counts = dict.fromkeys(_FLASH_ROUTES, 0)
flash_bwd_dkv.variant_counts = dict.fromkeys(_FLASH_BWD_VARIANTS, 0)
flash_bwd_dq.variant_counts = dict.fromkeys(_FLASH_BWD_VARIANTS, 0)


class _Flash(torch.autograd.Function):
    """Flash attention with its FlashAttention-2 backward, as the JAX
    package's ``_flash`` custom VJP: the forward (K3, or ``flash_reference``
    on the CPU) saves q, k, v, O and lse; the backward forms Δ = Σ_d dO·O
    with torch ops (as JAX does with XLA), then runs K4 and K5 on CUDA
    tensors, ``flash_backward_reference`` on CPU ones."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        if q.is_cuda:
            o, lse = _flash_launch(q, k, v, causal, sm_scale)
        else:
            o, lse = flash_reference(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do.to(q.dtype), lse, delta, ctx.causal, ctx.sm_scale)
        if q.is_cuda:
            dk, dv = flash_bwd_dkv(*args)
            dq = flash_bwd_dq(*args)
        else:
            dq, dk, dv = flash_backward_reference(*args)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
                    sm_scale: Optional[float] = None, return_lse: bool = False):
    """Flash attention over (B, H, S, D), as the JAX package's
    ``flash_attention``: up to 128² scores it is ``attention_reference``;
    above, K3 for CUDA tensors (``launch_count`` counts its launches,
    ``route_counts`` those of each route of ``flash_route``) and
    ``flash_reference`` for CPU ones, differentiable through ``_Flash``
    (K4/K5 on CUDA). ``return_lse`` also returns the per-row logsumexp
    (B, H, S_q) float32 (above 128² only; not differentiable)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s_q, s_k = q.shape[2], k.shape[2]
    if s_q * s_k <= 128 * 128:
        if return_lse:
            raise ValueError("flash_attention: up to 128² scores it is attention_reference, "
                             "which has no lse (as in the JAX package)")
        return attention_reference(q, k, v, causal, sm_scale)
    o, lse = _Flash.apply(q, k, v, causal, sm_scale)
    return (o, lse) if return_lse else o


flash_attention.launch_count = 0
flash_attention.route_counts = dict.fromkeys(_FLASH_ROUTES, 0)


def mha_route(num_heads: int, s_q: int, s_k: int, e: int, dtype: torch.dtype,
              device: torch.device) -> str:
    """Where ``mha`` sends (B, S, E) inputs: "flash", "small_mha" or
    "einsum" (see the module docstring). Raises if ``e % num_heads``."""
    if e % num_heads:
        raise ValueError(f"mha: e={e} is not a multiple of num_heads={num_heads}")
    if s_q * s_k > 128 * 128:
        return "flash"
    if (torch.device(device).type == "cuda" and dtype in _ENTRY_POINTS
            and small_mha_viable(num_heads, s_q, s_k, e)):
        return "small_mha"
    return "einsum"


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
        causal: bool = False) -> torch.Tensor:
    """Multi-head attention over (B, S, E) inputs, dispatched by
    ``mha_route``."""
    b, s_q, e = q.shape
    s_k = k.shape[1]
    route = mha_route(num_heads, s_q, s_k, e, q.dtype, q.device)
    if route == "small_mha":
        return small_mha(q, k, v, num_heads, causal)
    if route == "einsum":
        return _mha_einsum(q, k, v, num_heads, causal)
    hd = e // num_heads

    def split(x, s):
        return x.reshape(b, s, num_heads, hd).transpose(1, 2)

    out = flash_attention(split(q, s_q), split(k, s_k), split(v, s_k), causal=causal)
    return out.transpose(1, 2).reshape(b, s_q, e)
