"""Plain image operations of the lip-sync and diffusion requests, in float32.

Frozen copies of what the served paths do to pixels, written from the
resampling rules they follow (``jax.image.scale_and_translate``: separable
per-axis weight matrices, half-pixel centres, taps outside the image
dropped and the rest renormalised, antialiasing when downscaling):

- ``crop_and_resize``: a y1y2x1x2 box of each frame to the generator's
  96x96 input, bilinear, no antialiasing;
- ``resize``: a whole image, bilinear and antialiased, integer images
  rounded back (the diffusion condition frame, 160 -> 128);
- ``mask_lower_half`` / ``concat_reference``: the generator's 6 channels;
- ``paste_back``: each generated face resized bilinearly (zero padded) into
  its box of the full frame;
- ``nearest_index``: the nearest resize of the generator's decoder.

Layouts are (..., H, W, C). Nothing here imports the program.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

_F32_EPS = float(torch.finfo(torch.float32).eps)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


def _weight_mat(in_size: int, out_size: int, inv_scale: torch.Tensor,
                translation: torch.Tensor, kernel: Callable, antialias: bool) -> torch.Tensor:
    """(..., in_size, out_size) resampling weights along one axis."""
    device = inv_scale.device
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=device) + 0.5)
                * inv_scale[..., None] - (translation * inv_scale)[..., None] - 0.5)
    x = torch.abs(sample_f[..., None, :]
                  - torch.arange(in_size, dtype=torch.float32, device=device)[:, None])
    if antialias:
        x = x / torch.clamp(inv_scale, min=1.0)[..., None, None]
    weights = kernel(x)
    total = weights.sum(dim=-2, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * _F32_EPS,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[..., None, :], weights, torch.zeros_like(weights))


def _resample(img: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    rows = torch.einsum("nhy,nhwc->nywc", wy, img)
    return torch.einsum("nwx,nywc->nyxc", wx, rows)


def crop_and_resize(img: torch.Tensor, box: torch.Tensor, out_size: Tuple[int, int]) -> torch.Tensor:
    """Frames (N, H, W, C) and y1y2x1x2 boxes (N, 4) → (N, oh, ow, C) float32."""
    n, H, W, C = img.shape
    x = img.to(torch.float32)
    y1, y2, x1, x2 = box.to(torch.float32).unbind(-1)
    oh, ow = out_size
    sy = torch.full_like(y1, oh) / torch.clamp(y2 - y1, min=1e-3)
    sx = torch.full_like(x1, ow) / torch.clamp(x2 - x1, min=1e-3)
    wy = _weight_mat(H, oh, 1.0 / sy, -y1 * sy, _triangle, antialias=False)
    wx = _weight_mat(W, ow, 1.0 / sx, -x1 * sx, _triangle, antialias=False)
    return _resample(x, wy, wx)


def resize(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(N, H, W, C) → (N, h, w, C), bilinear and antialiased; integer
    images are rounded and clipped back to their type."""
    n, H, W, C = img.shape
    h, w = size
    x = img.to(torch.float32)

    def weights(n_in: int, n_out: int) -> torch.Tensor:
        inv = torch.full((n,), 1.0 / (n_out / n_in), dtype=torch.float32, device=x.device)
        return _weight_mat(n_in, n_out, inv, torch.zeros_like(inv), _triangle, antialias=True)

    out = _resample(x, weights(H, h), weights(W, w))
    if not img.dtype.is_floating_point:
        out = torch.clamp(torch.round(out), 0, 255)
    return out.to(img.dtype)


def nearest_index(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """Source row of each output row of a nearest resize: floor((i + 0.5)·n_in/n_out)."""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * n_in / n_out
    return torch.floor(pos).long()


def mask_lower_half(img: torch.Tensor) -> torch.Tensor:
    h = img.shape[-3]
    keep = (torch.arange(h, device=img.device) < h // 2)[:, None, None]
    return torch.where(keep, img, torch.zeros_like(img))


def concat_reference(masked: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
    return torch.cat([masked, reference], dim=-1)


def _bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample (N, h, w, C) at the outer product of ys (N, M) and xs (N, K),
    zero padded → (N, M, K, C)."""
    h, w = img.shape[-3], img.shape[-2]
    wy = torch.clamp(1.0 - torch.abs(
        ys[..., :, None] - torch.arange(h, dtype=torch.float32, device=img.device)), min=0.0)
    wx = torch.clamp(1.0 - torch.abs(
        xs[..., :, None] - torch.arange(w, dtype=torch.float32, device=img.device)), min=0.0)
    rows = torch.einsum("...mh,...hwc->...mwc", wy, img.to(torch.float32))
    return torch.einsum("...nw,...mwc->...mnc", wx, rows)


def paste_back(frame: torch.Tensor, roi: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Generated faces (N, h, w, C) resized into their boxes (N, 4) of the
    float frames (N, H, W, C); pixels outside a box keep the frame's value."""
    H, W = frame.shape[-3], frame.shape[-2]
    y1, y2, x1, x2 = (box[..., i, None].to(torch.float32) for i in range(4))
    rows = torch.arange(H, dtype=torch.float32, device=frame.device)
    cols = torch.arange(W, dtype=torch.float32, device=frame.device)
    ys = (rows - y1) / torch.clamp(y2 - y1, min=1.0) * roi.shape[-3] - 0.5
    xs = (cols - x1) / torch.clamp(x2 - x1, min=1.0) * roi.shape[-2] - 0.5
    resized = _bilinear_sample(roi, ys, xs)
    inside = (((rows >= y1) & (rows < y2))[..., :, None, None]
              & ((cols >= x1) & (cols < x2))[..., None, :, None])
    return torch.where(inside, resized, frame.to(torch.float32))


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] floats → uint8, rounding half to even."""
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)
