"""Batched image ops of the mouth-ROI, diffusion and lip-sync paths, in
plain torch.

Port of the ops ``lipreading_video_generation_tpu/pipelines/preprocess.py``
calls from ``ops/image.py``: ``expand_box_to_min_size``, ``rgb_to_gray``,
``crop_and_resize``, ``resize`` and the ``clahe`` dispatch; and of the
diffusion path's ``normalize_uint8``, ``denormalize_to_uint8`` and the
U-Net's nearest 2× upsample (``models/unet.py:142``); and of the lip-sync
path's ``mask_lower_half``, ``concat_reference``, ``_bilinear_sample`` and
``smooth_boxes``. Layouts are the JAX package's: (..., H, W, C) images and
y1y2x1x2 boxes.

Resampling reproduces ``jax.image.scale_and_translate`` (which both
``crop_and_resize`` and ``jax.image.resize`` use): separable per-axis
weight matrices, built exactly as ``jax._src.image.scale.compute_weight_mat``
builds them, applied with two batched matmuls. That differs from
``F.interpolate`` in three ways that matter here: the cubic kernel is Keys
a=-0.5 (torch uses -0.75); ``resize`` is antialiased (the kernel widens by
the downscale factor); and taps that fall outside the input are dropped
and the remaining weights renormalised, which is not an edge clamp (output
samples whose centre lies outside the input are zero).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from .clahe_cuda import clahe_cuda, clahe_reference

__all__ = [
    "resize",
    "rgb_to_gray",
    "crop_and_resize",
    "expand_box_to_min_size",
    "clahe",
    "normalize_uint8",
    "denormalize_to_uint8",
    "upsample_nearest2x",
    "mask_lower_half",
    "concat_reference",
    "smooth_boxes",
]

_F32_EPS = float(torch.finfo(torch.float32).eps)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys (a=-0.5) cubic kernel, ``_fill_keys_cubic_kernel``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


_KERNELS = {"linear": _triangle, "bilinear": _triangle,
            "cubic": _keys_cubic, "bicubic": _keys_cubic}


def _weight_mat(in_size: int, out_size: int, inv_scale: torch.Tensor,
                translation: torch.Tensor, kernel: Callable, antialias: bool) -> torch.Tensor:
    """(..., in_size, out_size) resampling weights along one axis for
    float32 ``inv_scale`` (1/scale) and ``translation`` of shape (...): the
    port of ``compute_weight_mat`` (jax/_src/image/scale.py), op for op."""
    device = inv_scale.device
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=device) + 0.5)
                * inv_scale[..., None] - (translation * inv_scale)[..., None] - 0.5)
    x = torch.abs(sample_f[..., None, :]
                  - torch.arange(in_size, dtype=torch.float32, device=device)[:, None])
    if antialias:
        x = x / torch.clamp(inv_scale, min=1.0)[..., None, None]
    weights = kernel(x)
    total = weights.sum(dim=-2, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * _F32_EPS,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[..., None, :], weights, torch.zeros_like(weights))


def _resample(img: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) float32 through per-image (N, H, oh) and (N, W, ow)
    weights → (N, oh, ow, C)."""
    rows = torch.einsum("nhy,nhwc->nywc", wy, img)
    return torch.einsum("nwx,nywc->nyxc", wx, rows)


def resize(img: torch.Tensor, size: Tuple[int, int], method: str = "bilinear") -> torch.Tensor:
    """Resize (..., H, W, C) → (..., h, w, C) like ``jax.image.resize``
    (half-pixel centres, antialiased when downscaling). ``method``:
    'bilinear' | 'cubic'. Integer images are rounded and clipped back."""
    if method not in _KERNELS:
        raise ValueError(f"resize: method {method!r} is not ported (bilinear, cubic)")
    h, w = size
    lead, (H, W, C) = img.shape[:-3], img.shape[-3:]
    x = img.to(torch.float32).reshape(-1, H, W, C)
    n = x.shape[0]

    def weights(n_in: int, n_out: int) -> torch.Tensor:
        # jax.image.resize: scale n_out/n_in and 1/scale in float64, then f32.
        # (It skips equal-sized axes; their weights here are the identity.)
        inv = torch.full((n,), 1.0 / (n_out / n_in), dtype=torch.float32, device=x.device)
        return _weight_mat(n_in, n_out, inv, torch.zeros_like(inv),
                           _KERNELS[method], antialias=True)

    out = _resample(x, weights(H, h), weights(W, w)).reshape(lead + (h, w, C))
    if not img.dtype.is_floating_point:
        out = torch.clamp(torch.round(out), 0, 255)
    return out.to(img.dtype)


def normalize_uint8(img: torch.Tensor, symmetric: bool = False) -> torch.Tensor:
    """uint8 [0,255] → float32 [0,1], or [-1,1] with ``symmetric``."""
    x = img.to(torch.float32) / 255.0
    return x * 2.0 - 1.0 if symmetric else x


def denormalize_to_uint8(x: torch.Tensor, symmetric: bool = False) -> torch.Tensor:
    """[0,1] (or [-1,1] with ``symmetric``) float → uint8, rounding half to even."""
    if symmetric:
        x = (x + 1.0) / 2.0
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, C, 2H, 2W) nearest, as ``jax.image.resize(...,
    "nearest")`` at exactly 2× (half-pixel centres pick source floor(i/2))."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.601 luma; (..., H, W, 3) → (..., H, W, 1) float32."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32, device=img.device)
    return (img.to(torch.float32) @ w)[..., None]


def crop_and_resize(img: torch.Tensor, box: torch.Tensor, out_size: Tuple[int, int],
                    method: str = "linear") -> torch.Tensor:
    """Crop y1y2x1x2 ``box`` (..., 4) from images (..., H, W, C) and resample
    to ``out_size`` → (..., oh, ow, C) float32, one box per image, as
    ``jax.image.scale_and_translate`` without antialiasing: samples whose
    centre lies outside the image are zero, and taps outside it are dropped
    with the remaining weights renormalised."""
    if method not in _KERNELS:
        raise ValueError(f"crop_and_resize: method {method!r} is not ported (linear, cubic)")
    lead, (H, W, C) = img.shape[:-3], img.shape[-3:]
    x = img.to(torch.float32).reshape(-1, H, W, C)
    b = box.to(torch.float32).reshape(-1, 4)
    y1, y2, x1, x2 = b.unbind(-1)
    oh, ow = out_size
    # True divisions, as in JAX: torch evaluates `scalar / tensor` as
    # tensor.reciprocal() * scalar, one rounding more.
    sy = torch.full_like(y1, oh) / torch.clamp(y2 - y1, min=1e-3)
    sx = torch.full_like(x1, ow) / torch.clamp(x2 - x1, min=1e-3)
    kernel = _KERNELS[method]
    wy = _weight_mat(H, oh, 1.0 / sy, -y1 * sy, kernel, antialias=False)
    wx = _weight_mat(W, ow, 1.0 / sx, -x1 * sx, kernel, antialias=False)
    return _resample(x, wy, wx).reshape(lead + (oh, ow, C))


def expand_box_to_min_size(box: torch.Tensor, min_h: int = 48, min_w: int = 48) -> torch.Tensor:
    """Symmetrically expand y1y2x1x2 boxes (..., 4) to at least
    (min_h, min_w). Float boxes floor-divide as floats, like ``hd // 2`` on
    the JAX side (lipreading/preprocess.py:70-78 semantics)."""
    y1, y2, x1, x2 = box.unbind(-1)
    hd = torch.clamp(min_h - (y2 - y1 + 1), min=0)
    wd = torch.clamp(min_w - (x2 - x1 + 1), min=0)

    def half(d, up):
        return torch.div(d + 1 if up else d, 2, rounding_mode="floor")

    return torch.stack([y1 - half(hd, False), y2 + half(hd, True),
                        x1 - half(wd, False), x2 + half(wd, True)], dim=-1)


def clahe(img: torch.Tensor, clip_limit: float = 0.2, grid: Tuple[int, int] = (8, 8),
          nbins: int = 256) -> torch.Tensor:
    """CLAHE on (..., H, W) uint8/float [0, 255] images. A CUDA tensor goes
    through the kernel K1 (``clahe_cuda``, by the route ``clahe_route``
    names: it takes every shape the JAX package's ``clahe`` takes); a CPU
    tensor goes through ``clahe_reference``."""
    if not img.is_cuda:
        return clahe_reference(img, clip_limit, grid, nbins)
    h, w = img.shape[-2:]
    x = img.to(torch.float32).reshape(-1, h, w).contiguous()
    out = clahe_cuda(x, clip_limit, grid, nbins).reshape(img.shape)
    if not img.dtype.is_floating_point:
        return torch.clamp(torch.round(out), 0, 255).to(img.dtype)
    return out


def mask_lower_half(img: torch.Tensor) -> torch.Tensor:
    """Zero the lower half (rows >= H // 2) of (..., H, W, C) frames: the
    masked target window fed to the generator."""
    h = img.shape[-3]
    keep = (torch.arange(h, device=img.device) < h // 2)[:, None, None]
    return torch.where(keep, img, torch.zeros_like(img))


def concat_reference(masked: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
    """Channel-concat the masked target window with the reference window →
    the generator's 6-channel input."""
    return torch.cat([masked, reference], dim=-1)


def _bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample (..., H, W, C) at the outer product of ``ys`` (..., M) and
    ``xs`` (..., N) with zero padding → (..., M, N, C) float32. The bilinear
    weight of input row i at coordinate y is the triangle max(0, 1 − |y − i|),
    zero outside the image, so the sampling is two small float32 matmuls
    (exact, and no gather)."""
    h, w = img.shape[-3], img.shape[-2]
    x = img.to(torch.float32)
    wy = torch.clamp(1.0 - torch.abs(
        ys[..., :, None] - torch.arange(h, dtype=torch.float32, device=img.device)), min=0.0)
    wx = torch.clamp(1.0 - torch.abs(
        xs[..., :, None] - torch.arange(w, dtype=torch.float32, device=img.device)), min=0.0)
    rows = torch.einsum("...mh,...hwc->...mwc", wy, x)
    return torch.einsum("...nw,...mwc->...mnc", wx, rows)


def smooth_boxes(boxes: torch.Tensor, T: int = 5) -> torch.Tensor:
    """Temporal moving average of (N, 4) face boxes: box[i] =
    mean(boxes[i : i + T]), the window shifted back near the end."""
    n = boxes.shape[0]
    idx = torch.arange(n, device=boxes.device)
    start = torch.where(idx + T > n, torch.full_like(idx, max(0, n - T)), idx)
    gather = torch.clamp(start[:, None] + torch.arange(T, device=boxes.device), 0, n - 1)
    return boxes[gather].mean(dim=1)
