"""Lip-landmark regressor: face crop → 4 lip points → mouth box.

Port of ``lipreading_video_generation_tpu/models/lip_landmark.py``. The four
points keep the reference's MediaPipe semantics (landmarks 57, 287, 164, 18):
points 0/1 are the mouth corners, points 2/3 the upper and lower lip, and
``mouth_box_from_landmarks`` turns them into a y1y2x1x2 box of at least
``min_size`` per side. ``predict_mouth_boxes`` crops the faces, regresses the
points and maps them back, for all frames of a clip at once.

``LipLandmarkNet`` is a small U-shaped encoder/decoder with a soft-argmax
readout of 16×16 heatmaps. What keeps it equal to the Flax module:
- the stride-2 convs pad as Flax's ``padding="SAME"`` does, (0, 1) on a
  64×64 input rather than (1, 1);
- ``GroupNorm(num_groups=8)``, eps 1e-6;
- the decoder's bilinear upsample is ``ops.image.resize`` (no antialias when
  upsampling, as in ``jax.image.resize``).

The synthetic renderers (``synthetic_face_batch``, ``_render_faces``,
``shifted_face_batch``) draw from a ``torch.Generator``; they give other
faces than the JAX package's from the same seed, and ``_render_faces`` gives
the same images from the same parameters. Public tensors keep the JAX
layouts: (B, 64, 64, 1) crops, (B, 4, 2) (x, y) points in [0, 1].
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ..core.prng import seeded
from ..ops import image as image_ops
from .layers import Conv2d, GroupNorm

CROP_SIZE = 64   # input resolution of the regressor (square gray face crop)
NUM_POINTS = 4   # left corner, right corner, upper lip, lower lip


def _same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """Flax/XLA ``padding="SAME"`` along an axis of ``n``: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class LipLandmarkNet(nn.Module):
    """(B, 64, 64, 1) gray face crops in [0, 1] → (B, 4, 2) normalised (x, y)
    lip points in face-crop coordinates."""

    def __init__(self, width: int = 32, softmax_temp: float = 10.0):
        super().__init__()
        self.width = width
        self.softmax_temp = softmax_temp
        cin = 1
        for i, mult in enumerate((1, 2, 4, 8)):
            self.add_module(f"conv{i}", Conv2d(cin, width * mult, 3, 2, 0))
            self.add_module(f"norm{i}", GroupNorm(width * mult, num_groups=8))
            cin = width * mult
        for i, mult in ((2, 4), (1, 2)):
            self.add_module(f"up{i}", Conv2d(cin + width * mult, width * mult, 3, 1, 1))
            self.add_module(f"upnorm{i}", GroupNorm(width * mult, num_groups=8))
            cin = width * mult
        self.heat = Conv2d(cin, NUM_POINTS, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        skips = {}
        for i in range(4):
            (t, b), (l, r) = _same_pad(h.shape[2], 3, 2), _same_pad(h.shape[3], 3, 2)
            h = getattr(self, f"conv{i}")(F.pad(h, (l, r, t, b)))
            h = F.silu(getattr(self, f"norm{i}")(h))
            skips[i] = h                                       # 32, 16, 8, 4
        for i in (2, 1):                                       # back to 16×16
            hh, ww = skips[i].shape[2:]
            up = image_ops.resize(h.permute(0, 2, 3, 1), (hh, ww), "bilinear")
            h = torch.cat([up.permute(0, 3, 1, 2), skips[i]], dim=1)
            h = F.silu(getattr(self, f"upnorm{i}")(getattr(self, f"up{i}")(h)))
        maps = self.heat(h)                                    # (B, 4, 16, 16)
        b, _, mh, mw = maps.shape
        probs = torch.softmax(self.softmax_temp * maps.reshape(b, NUM_POINTS, mh * mw), dim=-1)
        probs = probs.reshape(b, NUM_POINTS, mh, mw)
        ys = (torch.arange(mh, dtype=torch.float32, device=x.device) + 0.5) / mh
        xs = (torch.arange(mw, dtype=torch.float32, device=x.device) + 0.5) / mw
        ey = torch.einsum("bphw,h->bp", probs, ys)
        ex = torch.einsum("bphw,w->bp", probs, xs)
        return torch.stack([ex, ey], dim=-1)


def mouth_box_from_landmarks(points: torch.Tensor, face_box: torch.Tensor,
                             min_size: int = 48) -> torch.Tensor:
    """(..., 4, 2) normalised points in face-crop coordinates and (..., 4)
    y1y2x1x2 face boxes → (..., 4) float32 mouth boxes: x from the corners,
    y from the lips, expanded to at least ``min_size`` per side."""
    y1, y2, x1, x2 = face_box.to(torch.float32).unbind(-1)
    h, w = y2 - y1, x2 - x1
    xs = x1[..., None] + points[..., :2, 0] * w[..., None]
    ys = y1[..., None] + points[..., 2:, 1] * h[..., None]
    box = torch.stack([torch.minimum(ys[..., 0], ys[..., 1]), torch.maximum(ys[..., 0], ys[..., 1]),
                       torch.minimum(xs[..., 0], xs[..., 1]), torch.maximum(xs[..., 0], xs[..., 1])],
                      dim=-1)
    return image_ops.expand_box_to_min_size(box, min_size, min_size).to(torch.float32)


def face_crops_for_landmarks(frames: torch.Tensor, face_boxes: torch.Tensor) -> torch.Tensor:
    """(T, H, W, 3) uint8/float frames + (T, 4) face boxes → (T, 64, 64, 1)
    gray crops in [0, 1], the regressor's input."""
    crops = image_ops.crop_and_resize(frames, face_boxes, (CROP_SIZE, CROP_SIZE), "bilinear")
    return image_ops.rgb_to_gray(crops) / 255.0


@torch.no_grad()
def predict_mouth_boxes(model: LipLandmarkNet, frames: torch.Tensor, face_boxes: torch.Tensor,
                        min_size: int = 48) -> torch.Tensor:
    """Crop the faces, regress their points with ``model``, return (T, 4)
    float32 mouth boxes, on the frames' device (the model's)."""
    pts = model(face_crops_for_landmarks(frames, face_boxes))
    return mouth_box_from_landmarks(pts, face_boxes.to(torch.float32), min_size)


def init_params(seed: int = 0, width: int = 32) -> Dict[str, torch.Tensor]:
    """A ``LipLandmarkNet(width)`` ``state_dict`` drawn from ``seed`` (Flax's
    init rules)."""
    return seeded(lambda: LipLandmarkNet(width=width), seed).state_dict()


# ---------------------------------------------------------------------------
# Synthetic supervision: a parametric face renderer with oracle lip points:
# an ellipse head, two eyes and a dark mouth ellipse whose centre and size
# vary per sample; the oracle points are the mouth ellipse's extremes.
# ---------------------------------------------------------------------------


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


def _grid(size: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(yy, xx) pixel centres in [0, 1], (size, size) each."""
    c = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size
    return torch.meshgrid(c, c, indexing="ij")


def synthetic_face_batch(gen: torch.Generator, n: int, size: int = CROP_SIZE
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render n synthetic faces from ``gen`` (on its device) → ((n, size,
    size, 1) float images in [0, 1], (n, 4, 2) oracle normalised lip points)."""
    cx = _uniform(gen, (n,), 0.35, 0.65)
    cy = _uniform(gen, (n,), 0.55, 0.8)
    mw = _uniform(gen, (n,), 0.08, 0.2)    # half-width
    mh = _uniform(gen, (n,), 0.03, 0.09)   # half-height
    skin = _uniform(gen, (n,), 0.55, 0.85)
    noise = 0.03 * torch.randn((n, size, size), generator=gen, device=gen.device)
    return _render_faces(cx, cy, mw, mh, skin, noise, size)


def _render_faces(cx, cy, mw, mh, skin, noise, size: int):
    """Faces of the given per-sample (n,) parameters and (n, size, size)
    noise → ((n, size, size, 1) images, (n, 4, 2) points)."""
    yy, xx = _grid(size, cx.device)
    col = lambda v: v[:, None, None]   # noqa: E731
    head = ((xx - 0.5) / 0.42) ** 2 + ((yy - 0.45) / 0.5) ** 2 <= 1.0
    img = torch.where(head, col(skin), torch.full_like(col(skin), 0.12))
    for ex in (0.35, 0.65):
        eye = ((xx - ex) / 0.07) ** 2 + ((yy - 0.3) / 0.045) ** 2 <= 1.0
        img = torch.where(eye, torch.full_like(img, 0.15), img)
    mouth = ((xx - col(cx)) / col(mw)) ** 2 + ((yy - col(cy)) / col(mh)) ** 2 <= 1.0
    img = torch.where(mouth, torch.full_like(img, 0.08), img)
    imgs = torch.clamp(img + noise, 0.0, 1.0)[..., None]
    pts = torch.stack([torch.stack([cx - mw, cy], dim=-1),     # left corner
                       torch.stack([cx + mw, cy], dim=-1),     # right corner
                       torch.stack([cx, cy - mh], dim=-1),     # upper lip
                       torch.stack([cx, cy + mh], dim=-1)],    # lower lip
                      dim=1)
    return imgs, pts


def gaussian_blur(img: torch.Tensor, sigma: torch.Tensor, radius: int) -> torch.Tensor:
    """(n, H, W, 1) images, each blurred by its own σ (n,) with a
    (2·radius + 1)² kernel of normalised Gaussian taps, zero padded ("SAME")."""
    taps = torch.arange(-radius, radius + 1, dtype=torch.float32, device=img.device)
    w = torch.exp(-(taps ** 2) / (2.0 * sigma[:, None] ** 2))
    w = w / w.sum(dim=-1, keepdim=True)
    k = (w[:, :, None] * w[:, None, :])[:, None]                # (n, 1, k, k)
    out = F.conv2d(img.permute(3, 0, 1, 2), k, padding=radius, groups=img.shape[0])
    return out.permute(1, 2, 3, 0)


def shifted_face_batch(gen: torch.Generator, n: int, size: int = CROP_SIZE
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Held-out, distribution-shifted faces for evaluation: mouth geometry
    outside the training ranges, a teeth band, a ±15° head tilt (points
    rotated with it), an illumination ramp, an occlusion bar, a Gaussian
    blur σ ∈ [0, 1.5] and twice the sensor noise. None of these is used in
    training, so IoU on them measures generalisation."""
    cx = _uniform(gen, (n,), 0.3, 0.7)
    cy = _uniform(gen, (n,), 0.5, 0.85)
    mw = _uniform(gen, (n,), 0.06, 0.24)
    mh = _uniform(gen, (n,), 0.02, 0.11)
    skin = _uniform(gen, (n,), 0.45, 0.9)
    noise = 0.06 * torch.randn((n, size, size), generator=gen, device=gen.device)
    imgs, pts = _render_faces(cx, cy, mw, mh, skin, noise, size)
    img = imgs[..., 0]
    yy, xx = _grid(size, gen.device)
    col = lambda v: v[:, None, None]   # noqa: E731

    # teeth: a bright band across the middle of the mouth opening
    show_teeth = col(_uniform(gen, (n,), 0.0, 1.0) > 0.4)
    teeth = ((((xx - col(cx)) / (col(mw) * 0.8)) ** 2 <= 1.0)
             & (torch.abs(yy - col(cy)) <= col(mh) * 0.35))
    img = torch.where(teeth & show_teeth, torch.full_like(img, 0.85), img)
    # illumination ramp along a random direction, 0.7..1.3
    phi = col(_uniform(gen, (n,), 0.0, 2 * math.pi))
    img = img * (1.0 + 0.6 * ((xx - 0.5) * torch.cos(phi) + (yy - 0.5) * torch.sin(phi)))
    # occlusion bar: a dark horizontal band of height ~8% at a random row
    occ_y = col(_uniform(gen, (n,), 0.05, 0.95))
    occ_on = col(_uniform(gen, (n,), 0.0, 1.0) > 0.5)
    img = torch.where((torch.abs(yy - occ_y) <= 0.04) & occ_on, torch.full_like(img, 0.05), img)
    # head tilt: inverse-mapped bilinear resample of the image, points rotated
    theta = _uniform(gen, (n,), -0.26, 0.26)
    cos, sin = col(torch.cos(theta)), col(torch.sin(theta))
    gy, gx = torch.meshgrid(*(torch.arange(size, dtype=torch.float32, device=gen.device),) * 2,
                            indexing="ij")
    c = (size - 1) / 2.0
    sx = cos * (gx - c) + sin * (gy - c) + c
    sy = -sin * (gx - c) + cos * (gy - c) + c
    img = image_ops.map_coordinates(img, sy, sx)
    rel = pts - 0.5
    cos, sin = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    pts = torch.stack([0.5 + cos * rel[..., 0] - sin * rel[..., 1],
                       0.5 + sin * rel[..., 0] + cos * rel[..., 1]], dim=-1)
    # Gaussian blur σ ∈ [0, 1.5], 7×7
    img = gaussian_blur(img[..., None], _uniform(gen, (n,), 1e-3, 1.5), 3)
    return torch.clamp(img, 0.0, 1.0), torch.clamp(pts, 0.0, 1.0)
