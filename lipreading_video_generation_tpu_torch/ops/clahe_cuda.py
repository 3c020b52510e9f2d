"""CLAHE: the hand-written CUDA kernel K1 and its plain torch version.

Port of ``lipreading_video_generation_tpu/ops/clahe_pallas.py`` (the Pallas
kernel) and ``ops/image.py::clahe_xla`` (its XLA reference). Same algorithm
as OpenCV's ``createCLAHE``: edge-pad to tile multiples, per-tile
``nbins``-bin histograms, clip at ``max(1, clip·tile_area/nbins)`` and
spread the excess uniformly, CDF → LUT ``round(cdf·(nbins−1)/area)``, then
a half-pixel, edge-clamped bilinear blend of the four neighbouring tile
LUTs at each pixel's own bin.

K1 has two routes, picked by ``clahe_route``, both hand-written CUDA:
"packed" (``csrc/clahe_packed.cu``: one block an image, 8-bit counters
packed in shared memory, the LUT scan in integers; what the ViViT path
gives K1, see ``clahe_packed_layout``) and "tiled" (``csrc/clahe.cu``: a
block a tile writes its LUT to a device workspace, a block a row blends;
every other shape).

Both versions blend in float32; the JAX package blends in bf16, so they
differ from it by at most ~2 gray levels (the tests hold that bound).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils import flops as _flops
from . import _build

__all__ = ["clahe_reference", "clahe_luts_reference", "clahe_cuda", "clahe_supported",
           "clahe_route", "clahe_packed_layout"]

_NBINS = 256
_ROUTES = ("packed", "tiled")
_PACKED_THREADS = 256     # csrc/clahe_packed.cu's kThreads
_PACKED_MAX_AREA = 255    # pixels a tile: its 8-bit counters


def _clip_limit(clip_limit: float, tile_area: int, nbins: int) -> float:
    return max(1.0, clip_limit * tile_area / nbins)


def _tile_coords(n: int, g: int, n_pad: int, device) -> Tuple[torch.Tensor, ...]:
    """Neighbouring tiles (edge-clamped) and the second one's weight for
    pixels 0..n-1 of an axis padded to n_pad and cut into g tiles — the
    weights ``jax.image.resize(..., 'linear')`` gives when upsampling the
    (g,) LUT grid to n_pad (and csrc/clahe_common.cuh's ``tile_coord``)."""
    src = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * g / n_pad - 0.5
    fl = torch.floor(src)
    i0 = fl.long()
    return i0.clamp(0, g - 1), (i0 + 1).clamp(0, g - 1), src - fl


def _pad_and_tile(x: torch.Tensor, grid: Tuple[int, int]):
    """(N, H, W) float32 → the edge-padded (N, Hp, Wp) image, tile sizes."""
    gh, gw = grid
    h, w = x.shape[-2:]
    th, tw = -(-h // gh), -(-w // gw)
    xp = F.pad(x[:, None], (0, tw * gw - w, 0, th * gh - h), mode="replicate")[:, 0]
    return xp, th, tw


def clahe_luts_reference(
    img: torch.Tensor,
    clip_limit: float = 0.2,
    grid: Tuple[int, int] = (8, 8),
    nbins: int = _NBINS,
) -> torch.Tensor:
    """The tile LUTs of (N, H, W) images in [0, 255]: (N, gh·gw, nbins)
    float32 levels, tiles in row-major order."""
    gh, gw = grid
    x = img.to(torch.float32)
    n = x.shape[0]
    xp, th, tw = _pad_and_tile(x, grid)
    hp, wp = xp.shape[-2:]
    bins = torch.clamp(torch.round(xp), 0, nbins - 1).long()
    tile = ((torch.arange(hp, device=x.device) // th)[:, None] * gw
            + (torch.arange(wp, device=x.device) // tw)[None, :])
    hist = torch.zeros(n, gh * gw * nbins, dtype=torch.float32, device=x.device)
    hist.scatter_add_(1, (tile * nbins + bins).reshape(n, -1),
                      torch.ones(n, hp * wp, dtype=torch.float32, device=x.device))
    hist = hist.reshape(n, gh * gw, nbins)

    area = th * tw
    clipped = torch.clamp(hist, max=_clip_limit(clip_limit, area, nbins))
    excess = (hist - clipped).sum(-1, keepdim=True)
    cdf = torch.cumsum(clipped + excess / nbins, -1)
    # divide by a device tensor: CUDA evaluates `tensor / python scalar` as a
    # multiply by the reciprocal, which can move a .5 tie and flip a LUT entry
    area_t = torch.full((), float(area), dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(cdf * (nbins - 1) / area_t), 0, nbins - 1)


def clahe_reference(
    img: torch.Tensor,
    clip_limit: float = 0.2,
    grid: Tuple[int, int] = (8, 8),
    nbins: int = _NBINS,
) -> torch.Tensor:
    """Plain torch CLAHE on (..., H, W) uint8/float [0, 255] images; float
    in → float32 out, integer in → same integer dtype out."""
    gh, gw = grid
    x = img.to(torch.float32)
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    x = x.reshape(-1, h, w)
    n = x.shape[0]
    lut = clahe_luts_reference(x, clip_limit, grid, nbins).reshape(n, gh * gw * nbins)
    th, tw = -(-h // gh), -(-w // gw)
    r0, r1, fy = _tile_coords(h, gh, th * gh, x.device)
    c0, c1, fx = _tile_coords(w, gw, tw * gw, x.device)
    pix = torch.clamp(torch.round(x), 0, nbins - 1).long()

    def at(r, c):
        idx = (r[:, None] * gw + c[None, :]) * nbins + pix
        return torch.gather(lut, 1, idx.reshape(n, -1)).reshape(n, h, w)

    fy, fx = fy[:, None], fx[None, :]
    out = ((1 - fy) * ((1 - fx) * at(r0, c0) + fx * at(r0, c1))
           + fy * ((1 - fx) * at(r1, c0) + fx * at(r1, c1)))
    out = out.reshape(lead + (h, w))
    if not img.dtype.is_floating_point:
        return torch.clamp(torch.round(out), 0, 255).to(img.dtype)
    return out


# lvg_clahe_packed_f32(in, out, luts, n, h, w, gh, gw, nbins, limit, group,
# lane_words, tile_words, smem, stream)
_PACKED_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float]
                    + [ctypes.c_int] * 4 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=256)   # a pure rule, asked twice a launch
def clahe_packed_layout(h: int, w: int, grid: Tuple[int, int], nbins: int = _NBINS,
                        clip_limit: float = 0.2) -> Optional[Dict[str, int]]:
    """How ``csrc/clahe_packed.cu`` holds one (H, W) image, or None if it
    does not take the shape. It takes what the ViViT path gives K1: L = 1
    (clip·area ≤ nbins), ``nbins`` a power of two from 4 to 256, tiles of at
    most 255 pixels (8-bit counters) with area·nbins² < 2²³ (its integer
    LUT scan is exact there), rows of whole float4s (W a multiple of 4),
    the edge padding in the last tile row and column, and a block that
    fits.

    ``group``: lanes a tile in the LUT scan (the largest power of two up to
    32 with ``group``·tiles ≤ 256 that gives each lane a power-of-two run of
    words, else 1); ``lane_words``: that run (four counters a word);
    ``tile_words``: a tile's stride in 32-bit words (each lane's run padded
    by a word when ``group`` > 1, the stride rounded up to ``group`` modulo
    32, so that the scan's 32 lanes read 32 banks); ``smem``: dynamic shared
    memory (counters, 16 bytes a row and a column, a byte a pixel's bin)."""
    gh, gw = grid
    if min(h, w, gh, gw) < 1 or w % 4 or nbins & (nbins - 1) or not 4 <= nbins <= 256:
        return None
    th, tw = -(-h // gh), -(-w // gw)
    tiles, area = gh * gw, th * tw
    if (area > _PACKED_MAX_AREA or area * nbins * nbins >= 1 << 23
            or _clip_limit(clip_limit, area, nbins) != 1.0
            or (gh - 1) * th >= h or (gw - 1) * tw >= w):
        return None
    words = nbins // 4
    group = 32
    while group > 1 and (tiles * group > _PACKED_THREADS or words % group
                         or (words // group) & (words // group - 1)):
        group //= 2
    lane_words = words // group
    tile_words = group * (lane_words + (group > 1))
    tile_words += (group - tile_words) % 32
    smem = 4 * (-(-tiles * tile_words // 4) * 4) + 16 * (h + w) + h * w
    if smem > _build.SMEM_PER_BLOCK:
        return None
    return {"group": group, "lane_words": lane_words, "tile_words": tile_words, "smem": smem}


def clahe_route(h: int, w: int, grid: Tuple[int, int], nbins: int = _NBINS,
                clip_limit: float = 0.2, ptr: int = 0) -> str:
    """Which route of K1 takes (N, H, W) images at address ``ptr`` (bytes,
    or any offset congruent to it modulo 16): "packed" where
    ``clahe_packed_layout`` holds and ``ptr`` is a multiple of 16 (the
    kernel moves pixels as float4s), else "tiled". Raises on a shape no
    route takes (``clahe_supported``)."""
    if not clahe_supported(h, w, grid, nbins):
        raise ValueError(f"clahe_cuda does not take H={h} W={w} grid={grid} nbins={nbins}")
    packed = (clahe_packed_layout(h, w, tuple(grid), nbins, clip_limit) is not None
              and ptr % 16 == 0)
    return "packed" if packed else "tiled"


def clahe_supported(h: int, w: int, grid: Tuple[int, int], nbins: int = _NBINS) -> bool:
    """True if K1 takes (N, H, W) images: every shape the JAX package's
    ``clahe`` takes (H, W, gh, gw ≥ 1, nbins ≥ 2)."""
    gh, gw = grid
    return min(h, w, gh, gw) >= 1 and nbins >= 2


def clahe_cuda(
    img: torch.Tensor,
    clip_limit: float = 0.2,
    grid: Tuple[int, int] = (8, 8),
    nbins: int = _NBINS,
    luts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch K1 on (N, H, W) float32 contiguous CUDA images in [0, 255];
    returns float32 (N, H, W). ``luts``, if given, is a contiguous
    (N, gh·gw, nbins) float32 CUDA tensor that receives the tile LUTs (for
    checks against ``clahe_luts_reference``). Launches on the current
    stream without synchronising, by the route ``clahe_route`` names
    (``launch_count`` counts the calls, ``route_counts`` those of each
    route), and raises on any input the kernel does not take."""
    if not img.is_cuda:
        raise ValueError("clahe_cuda takes CUDA tensors; use clahe_reference on the CPU")
    if img.device.index != torch.cuda.current_device():
        raise ValueError(f"clahe_cuda: {img.device} is not the current CUDA device")
    if img.dtype != torch.float32 or img.ndim != 3 or not img.is_contiguous():
        raise ValueError(
            f"clahe_cuda takes contiguous (N, H, W) float32, got {tuple(img.shape)} "
            f"{img.dtype} contiguous={img.is_contiguous()}")
    n, h, w = img.shape
    gh, gw = grid
    route = clahe_route(h, w, grid, nbins, clip_limit, img.data_ptr())
    if luts is not None and (luts.shape != (n, gh * gw, nbins) or luts.dtype != torch.float32
                             or not luts.is_contiguous() or luts.device != img.device):
        raise ValueError(f"clahe_cuda: luts must be contiguous ({n}, {gh * gw}, {nbins}) "
                         f"float32 on {img.device}, got {tuple(luts.shape)} {luts.dtype}")
    out = torch.empty_like(img)
    if n == 0:
        return out
    limit = _clip_limit(clip_limit, -(-h // gh) * -(-w // gw), nbins)
    stream = torch.cuda.current_stream().cuda_stream
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    if route == "packed":
        lay = clahe_packed_layout(h, w, tuple(grid), nbins, clip_limit)
        fn = _build.kernel("lvg_clahe_packed_f32", _PACKED_ARGTYPES)
        rc = fn(img.data_ptr(), out.data_ptr(), None if luts is None else luts.data_ptr(), n, h,
                w, gh, gw, nbins, limit, lay["group"], lay["lane_words"], lay["tile_words"],
                lay["smem"], stream)
    else:
        work = luts if luts is not None else torch.empty(
            n, gh * gw, nbins, dtype=torch.float32, device=img.device)
        fn = _build.kernel("lvg_clahe_tiled_f32", [vp, vp, vp] + [i32] * 6 + [ctypes.c_float, vp])
        rc = fn(img.data_ptr(), out.data_ptr(), work.data_ptr(), n, h, w, gh, gw, nbins, limit,
                stream)
    _build.check(rc, f"clahe_cuda ({route})")
    if _flops.running:
        # histograms, a clip and scan, a lookup: integer work, no products
        _flops.record("clahe_cuda", 0, 0)
    clahe_cuda.launch_count += 1
    clahe_cuda.route_counts[route] += 1
    return out


clahe_cuda.launch_count = 0
clahe_cuda.route_counts = dict.fromkeys(_ROUTES, 0)
