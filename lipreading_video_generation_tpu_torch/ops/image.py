"""Batched image ops of the mouth-ROI, diffusion and lip-sync paths, in
plain torch.

Port of the ops ``lipreading_video_generation_tpu/pipelines/preprocess.py``
calls from ``ops/image.py``: ``expand_box_to_min_size``, ``rgb_to_gray``,
``crop_and_resize``, ``resize`` and the ``clahe`` dispatch; and of the
diffusion path's ``normalize_uint8``, ``denormalize_to_uint8`` and the
U-Net's nearest 2× upsample (``models/unet.py:142``); and of the lip-sync
path's ``mask_lower_half``, ``concat_reference``, ``_bilinear_sample`` and
``smooth_boxes``; and of the lip expert's ``bgr_to_gray`` and
``center_crop``; and of the Wav2Lip image utilities ``resize_batch``,
``apply_mask``, ``random_crop``, ``rgb_to_lab`` / ``lab_to_rgb`` and
``contrast_boost`` (CLAHE of the LAB L channel: on a CUDA tensor the kernel
K1 on whole frames); and ``map_coordinates``, the counterpart of
``jax.scipy.ndimage.map_coordinates(order=1, mode="nearest")`` that the
lip-landmark renderers and augmentations warp with; and the reference's
two remaining OpenCV stand-ins, ``canny_edges`` (with ``_sobel``) and
``lucas_kanade_flow``, which no path calls (as in the JAX package). Layouts
are the JAX package's: (..., H, W, C) images and y1y2x1x2 boxes.

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

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .clahe_cuda import clahe_cuda, clahe_reference

__all__ = [
    "resize",
    "resize_batch",
    "rgb_to_gray",
    "bgr_to_gray",
    "center_crop",
    "rgb_to_lab",
    "lab_to_rgb",
    "contrast_boost",
    "apply_mask",
    "random_crop",
    "crop_and_resize",
    "expand_box_to_min_size",
    "clahe",
    "normalize_uint8",
    "denormalize_to_uint8",
    "upsample_nearest2x",
    "mask_lower_half",
    "concat_reference",
    "smooth_boxes",
    "map_coordinates",
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


def nearest_index(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """Source index of each of ``n_out`` samples of an axis of ``n_in`` in
    ``jax.image.resize(..., "nearest")``: floor((i + 0.5)·n_in/n_out),
    computed in float32 as there. (``F.interpolate(mode="nearest")`` takes
    floor(i·n_in/n_out), the same only at integer factors.)"""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * n_in / n_out
    return torch.floor(pos).long()


def resize(img: torch.Tensor, size: Tuple[int, int], method: str = "bilinear") -> torch.Tensor:
    """Resize (..., H, W, C) → (..., h, w, C) like ``jax.image.resize``
    (half-pixel centres, antialiased when downscaling). ``method``:
    'bilinear' | 'cubic' | 'nearest' (``nearest_index``, no antialiasing).
    Integer images are rounded and clipped back."""
    if method != "nearest" and method not in _KERNELS:
        raise ValueError(f"resize: unknown method {method!r} (bilinear, cubic, nearest)")
    h, w = size
    lead, (H, W, C) = img.shape[:-3], img.shape[-3:]
    if method == "nearest":
        out = img
        for dim, n_in, n_out in ((-3, H, h), (-2, W, w)):
            if n_in != n_out:
                out = out.index_select(dim, nearest_index(n_in, n_out, img.device))
        return out
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


def resize_batch(imgs: torch.Tensor, size: Tuple[int, int], method: str = "bilinear") -> torch.Tensor:
    """``resize`` of a batch (..., H, W, C)."""
    return resize(imgs, size, method)


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


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    """BT.601 luma with the weights in BGR order (AV-HuBERT's transform);
    (..., H, W, 3) → (..., H, W, 1) float32."""
    w = torch.tensor([0.114, 0.587, 0.299], dtype=torch.float32, device=img.device)
    return (img.to(torch.float32) @ w)[..., None]


def center_crop(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Center crop (..., H, W, C) → (..., h, w, C), the top-left corner at
    ((H − h) // 2, (W − w) // 2)."""
    h, w = size
    top, left = (img.shape[-3] - h) // 2, (img.shape[-2] - w) // 2
    return img[..., top:top + h, left:left + w, :]


def apply_mask(frames: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Frames (..., H, W, C) times a (H, W) mask taken as mask > 0 (a {0,
    255} or bool mask: OpenCV's ``bitwise_and`` with it)."""
    return frames * (mask > 0).to(frames.dtype)[..., None]


def random_crop(img: torch.Tensor, size: int, generator: Optional[torch.Generator] = None,
                offset: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """A ``size`` × ``size`` crop of (..., H, W, C) at the top-left ``offset``
    (y, x), or at one drawn uniformly from ``generator`` (the default one
    when None), y then x, as the JAX package draws them from its key."""
    h, w = img.shape[-3], img.shape[-2]
    if offset is None:
        y = int(torch.randint(0, h - size + 1, (), generator=generator))
        x = int(torch.randint(0, w - size + 1, (), generator=generator))
    else:
        y, x = (int(v) for v in offset)
    if not (0 <= y <= h - size and 0 <= x <= w - size):
        raise ValueError(f"random_crop: offset {(y, x)} puts a {size}x{size} crop outside "
                         f"{h}x{w}")
    return img[..., y:y + size, x:x + size, :]


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


# sRGB (D65) → XYZ, as OpenCV's LAB conversion
_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]], dtype=np.float32)
_XYZ2RGB = np.linalg.inv(_RGB2XYZ).astype(np.float32)
_D65 = np.array([0.950456, 1.0, 1.088754], dtype=np.float32)


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    # the real cube root (torch.pow of a negative base is NaN)
    cbrt = torch.sign(t) * torch.abs(t) ** (1.0 / 3.0)
    return torch.where(t > 0.008856, cbrt, 7.787 * t + 16.0 / 116.0)


def _lab_f_inv(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > 0.206893, t ** 3, (t - 16.0 / 116.0) / 7.787)


def rgb_to_lab(img: torch.Tensor) -> torch.Tensor:
    """RGB (..., 3) in [0, 255] → LAB in OpenCV's 8-bit scaling (L·255/100,
    a + 128, b + 128), float32, with the sRGB linearisation first."""
    c = img.to(torch.float32) / 255.0
    rgb = torch.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)
    xyz = rgb @ torch.from_numpy(_RGB2XYZ).to(img.device).T / torch.from_numpy(_D65).to(img.device)
    f = _lab_f(xyz)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return torch.stack([L * 255.0 / 100.0, a + 128.0, b + 128.0], dim=-1)


def lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    """The inverse of ``rgb_to_lab`` → RGB float32 clipped to [0, 255]."""
    L = lab[..., 0] * 100.0 / 255.0
    fy = (L + 16.0) / 116.0
    fx = fy + (lab[..., 1] - 128.0) / 500.0
    fz = fy - (lab[..., 2] - 128.0) / 200.0
    xyz = torch.stack([_lab_f_inv(fx), _lab_f_inv(fy), _lab_f_inv(fz)], dim=-1)
    xyz = xyz * torch.from_numpy(_D65).to(lab.device)
    rgb = torch.clamp(xyz @ torch.from_numpy(_XYZ2RGB).to(lab.device).T, min=0.0)
    srgb = torch.where(rgb > 0.0031308, 1.055 * rgb ** (1.0 / 2.4) - 0.055, 12.92 * rgb)
    return torch.clamp(srgb * 255.0, 0.0, 255.0)


def contrast_boost(img: torch.Tensor, clip_limit: float = 0.2,
                   grid: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """CLAHE (``clahe``: on a CUDA tensor the kernel K1, one launch for the
    whole batch) of the LAB L channel of RGB frames (..., H, W, 3); integer
    frames come back rounded in their dtype, float ones as float32."""
    lab = rgb_to_lab(img)
    L = clahe(lab[..., 0], clip_limit, grid)
    out = lab_to_rgb(torch.stack([L, lab[..., 1], lab[..., 2]], dim=-1))
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


def map_coordinates(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample float images (..., H, W) at float pixel coordinates ``ys``,
    ``xs`` (..., h, w) → (..., h, w): ``jax.scipy.ndimage.map_coordinates(img,
    [ys, xs], order=1, mode="nearest")`` per image. The four taps sit at the
    integer pixels around each coordinate, clamped to the edge, and are
    summed in JAX's order (y-tap major, weights ``w_y·w_x``)."""
    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    flat = img.reshape(lead + (h * w,))
    y0f, x0f = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = ys - y0f, xs - x0f
    wy0, wx0 = 1 - wy1, 1 - wx1
    y0, x0 = y0f.long(), x0f.long()
    out = None
    for yi, wy in ((y0, wy0), (y0 + 1, wy1)):
        for xi, wx in ((x0, wx0), (x0 + 1, wx1)):
            idx = (torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1))
            tap = torch.gather(flat, -1, idx.reshape(lead + (-1,))).reshape(idx.shape)
            term = wy * wx * tap
            out = term if out is None else out + term
    return out


def _sobel(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3×3 Sobel x and y gradients of float (..., H, W) images, edges
    replicated (cv2's BORDER_REPLICATE)."""
    kx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], device=img.device)
    h, w = img.shape[-2:]
    xp = torch.nn.functional.pad(img.reshape(-1, 1, h, w), (1, 1, 1, 1), mode="replicate")
    return tuple(torch.nn.functional.conv2d(xp, k[None, None]).reshape(img.shape)
                 for k in (kx, kx.T))


def canny_edges(img: torch.Tensor, low: float = 200.0, high: float = 400.0,
                hysteresis_iters: int = 8) -> torch.Tensor:
    """Canny edge map of (..., H, W) grayscale in [0, 255]: Sobel gradients
    (L1 magnitude, as cv2's default), non-maximum suppression across one of
    four direction sectors, a double threshold, and hysteresis as
    ``hysteresis_iters`` masked dilations. Neighbours wrap around the border
    (``roll``), as in the JAX package. {0, 255} uint8, like cv2.Canny."""
    x = img.to(torch.float32)
    gx, gy = _sobel(x)
    mag = gx.abs() + gy.abs()
    a = torch.remainder(torch.atan2(gy, gx), np.pi)
    sector = torch.remainder(torch.floor((a + np.pi / 8) / (np.pi / 4)).to(torch.int32), 4)

    def shift(arr, dy, dx):
        return torch.roll(torch.roll(arr, dy, dims=-2), dx, dims=-1)

    na = torch.where(sector == 0, shift(mag, 0, 1), torch.where(
        sector == 1, shift(mag, 1, 1), torch.where(sector == 2, shift(mag, 1, 0),
                                                   shift(mag, 1, -1))))
    nb = torch.where(sector == 0, shift(mag, 0, -1), torch.where(
        sector == 1, shift(mag, -1, -1), torch.where(sector == 2, shift(mag, -1, 0),
                                                     shift(mag, -1, 1))))
    mag = torch.where((mag >= na) & (mag >= nb), mag, 0.0)
    strong = mag >= high
    weak = (mag >= low) & ~strong

    def dilate(m):
        out = m
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    out = out | shift(m, dy, dx)
        return out

    edges = strong
    for _ in range(hysteresis_iters):
        edges = edges | (dilate(edges) & weak)
    return edges.to(torch.uint8) * 255


def lucas_kanade_flow(prev: torch.Tensor, curr: torch.Tensor, points: torch.Tensor,
                      win: int = 5, levels: int = 2, iters: int = 10
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pyramidal Lucas-Kanade tracking of (N, 2) (x, y) ``points`` from the
    (H, W) grayscale ``prev`` to ``curr``: ``levels`` 2×2 average-pooled
    halvings, a ``win``×``win`` patch a point sampled bilinearly (indices
    clamped to the edge), ``iters`` Newton steps a level from the coarsest
    down. Returns (new points (N, 2), in-bounds status (N,) bool); cv2's
    ``calcOpticalFlowPyrLK`` is the reference's."""
    prev, curr = prev.to(torch.float32), curr.to(torch.float32)
    pts = points.to(torch.float32)
    pyr_prev, pyr_curr = [prev], [curr]
    for _ in range(levels):
        pyr_prev.append(torch.nn.functional.avg_pool2d(pyr_prev[-1][None, None], 2, 2)[0, 0])
        pyr_curr.append(torch.nn.functional.avg_pool2d(pyr_curr[-1][None, None], 2, 2)[0, 0])
    half = win // 2
    r = torch.arange(-half, half + 1, dtype=torch.float32, device=prev.device)
    oy, ox = (o.reshape(-1) for o in torch.meshgrid(r, r, indexing="ij"))

    def sample_patch(img, cy, cx):
        """(N,) centres → (N, win·win) bilinear samples."""
        h, w = img.shape
        ys, xs = cy[:, None] + oy, cx[:, None] + ox
        y0f, x0f = torch.floor(ys), torch.floor(xs)
        wy, wx = ys - y0f, xs - x0f
        y0, x0 = y0f.long(), x0f.long()

        def g(yi, xi):
            return img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]

        return (g(y0, x0) * (1 - wy) * (1 - wx) + g(y0, x0 + 1) * (1 - wy) * wx
                + g(y0 + 1, x0) * wy * (1 - wx) + g(y0 + 1, x0 + 1) * wy * wx)

    g = torch.zeros_like(pts)              # flow (x, y) at the finest scale
    eye = 1e-6 * torch.eye(2, device=prev.device)
    for lvl in range(levels, -1, -1):
        scale = 2.0 ** lvl
        ip, ic = pyr_prev[lvl], pyr_curr[lvl]
        cx, cy = pts[:, 0] / scale, pts[:, 1] / scale
        p = sample_patch(ip, cy, cx)
        ix = (sample_patch(ip, cy, cx + 1.0) - sample_patch(ip, cy, cx - 1.0)) / 2.0
        iy = (sample_patch(ip, cy + 1.0, cx) - sample_patch(ip, cy - 1.0, cx)) / 2.0
        sxy = (ix * iy).sum(-1)
        a = torch.stack([torch.stack([(ix * ix).sum(-1), sxy], -1),
                         torch.stack([sxy, (iy * iy).sum(-1)], -1)], -2)
        a_inv = torch.linalg.inv(a + eye)
        gl = g / scale
        for _ in range(iters):
            diff = p - sample_patch(ic, cy + gl[:, 1], cx + gl[:, 0])
            b = torch.stack([(diff * ix).sum(-1), (diff * iy).sum(-1)], -1)
            gl = gl + (a_inv @ b[:, :, None])[:, :, 0]
        g = gl * scale
    new = pts + g
    h, w = prev.shape
    ok = (new[:, 0] >= 0) & (new[:, 0] < w) & (new[:, 1] >= 0) & (new[:, 1] < h)
    return new, ok
