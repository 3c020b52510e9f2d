"""CLAHE: the hand-written CUDA kernel K1 (``csrc/clahe.cu``) and its plain
torch version.

Port of ``lipreading_video_generation_tpu/ops/clahe_pallas.py`` (the Pallas
kernel) and ``ops/image.py::clahe_xla`` (its XLA reference). Same algorithm
as OpenCV's ``createCLAHE``: edge-pad to tile multiples, per-tile 256-bin
histograms, clip at ``max(1, clip·tile_area/nbins)`` and spread the excess
uniformly, CDF → LUT ``round(cdf·255/area)``, then a half-pixel,
edge-clamped bilinear blend of the four neighbouring tile LUTs at each
pixel's own bin.

Both versions blend in float32; the JAX package blends in bf16, so they
differ from it by at most ~2 gray levels (the tests hold that bound).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["clahe_reference", "clahe_cuda", "clahe_supported"]

_NBINS = 256


def _clip_limit(clip_limit: float, tile_area: int, nbins: int) -> float:
    return max(1.0, clip_limit * tile_area / nbins)


def _tile_coords(n: int, g: int, n_pad: int, device) -> Tuple[torch.Tensor, ...]:
    """Neighbouring tiles (edge-clamped) and the second one's weight for
    pixels 0..n-1 of an axis padded to n_pad and cut into g tiles — the
    weights ``jax.image.resize(..., 'linear')`` gives when upsampling the
    (g,) LUT grid to n_pad (and csrc/clahe.cu's ``tile_coord``)."""
    src = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * g / n_pad - 0.5
    fl = torch.floor(src)
    i0 = fl.long()
    return i0.clamp(0, g - 1), (i0 + 1).clamp(0, g - 1), src - fl


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
    th, tw = -(-h // gh), -(-w // gw)
    hp, wp = th * gh, tw * gw
    xp = F.pad(x[:, None], (0, wp - w, 0, hp - h), mode="replicate")[:, 0]

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
    lut = torch.clamp(torch.round(cdf * (nbins - 1) / area_t), 0, nbins - 1)
    lut = lut.reshape(n, gh * gw * nbins)

    r0, r1, fy = _tile_coords(h, gh, hp, x.device)
    c0, c1, fx = _tile_coords(w, gw, wp, x.device)
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


def clahe_supported(h: int, w: int, grid: Tuple[int, int], nbins: int = _NBINS) -> bool:
    """True if csrc/clahe.cu takes this shape: 256 bins, and the gh·gw tile
    histograms fit one block's shared memory."""
    gh, gw = grid
    return (nbins == _NBINS and h > 0 and w > 0 and gh > 0 and gw > 0
            and gh * gw * nbins * 4 <= _build.SMEM_PER_BLOCK)


def clahe_cuda(
    img: torch.Tensor,
    clip_limit: float = 0.2,
    grid: Tuple[int, int] = (8, 8),
    nbins: int = _NBINS,
) -> torch.Tensor:
    """Launch K1 on (N, H, W) float32 contiguous CUDA images in [0, 255];
    returns float32 (N, H, W). Launches on the current stream without
    synchronising, and raises on any input the kernel does not take."""
    if not img.is_cuda:
        raise ValueError("clahe_cuda takes CUDA tensors; use clahe_reference on the CPU")
    if img.device.index != torch.cuda.current_device():
        raise ValueError(f"clahe_cuda: {img.device} is not the current CUDA device")
    if img.dtype != torch.float32 or img.ndim != 3 or not img.is_contiguous():
        raise ValueError(
            f"clahe_cuda takes contiguous (N, H, W) float32, got {tuple(img.shape)} "
            f"{img.dtype} contiguous={img.is_contiguous()}")
    n, h, w = img.shape
    if not clahe_supported(h, w, grid, nbins):
        raise ValueError(f"clahe_cuda does not take H={h} W={w} grid={grid} nbins={nbins}")
    out = torch.empty_like(img)
    if n == 0:
        return out
    gh, gw = grid
    area = -(-h // gh) * -(-w // gw)
    fn = _build.kernel("lvg_clahe_f32", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    rc = fn(img.data_ptr(), out.data_ptr(), n, h, w, gh, gw,
            _clip_limit(clip_limit, area, nbins), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "clahe_cuda")
    clahe_cuda.launch_count += 1
    return out


clahe_cuda.launch_count = 0
