"""Plain mouth-ROI preprocessing and ViViT word classifier, for the
benchmark's comparison of a lipreading request.

The classifier is ViViT (Arnab et al., arXiv:2103.15691) as the reference
repo builds it with HuggingFace's ``VivitModel`` (lipreading/main.py:57-60,
lipreading/huggingface_vivit_model.py:18-33): 32x32 single-channel clips,
hidden 256, 8 heads, 12 pre-LN encoder blocks of qkv with bias,
``softmax(QKᵀ/√d)·V``, an output projection and a tanh-GELU MLP,
LayerNorm eps 1e-6, then a mean over the tokens and a linear head.
Departures from the published model, as the served model has them:

- tubelets of (1, 8, 8) pixels (80 tokens a 5-frame clip) where the
  published model has (2, 16, 16);
- no CLS token: the mean over the tokens is the clip's feature, where the
  source's pooler reads the CLS token and its head then means over tokens;
- LayerNorm's variance as E[x²]−E[x]² clipped at 0 (``nn.layer_norm``);
- ``log_softmax`` of the logits is the answer.

``request`` is one request end to end: the geometric mouth box of each face
box, expanded to at least 48x48; a cubic crop-resize to 48x48 (Keys' kernel
with a = -0.5, half-pixel centres, taps outside the frame dropped and the
rest renormalised, as ``jax.image.scale_and_translate`` resamples); ITU-R
601 luma; CLAHE with clip 0.2 on an 8x8 grid; an antialiased bilinear
resize to 32x32, rounded half to even to uint8; the clips of five frames
through the classifier. CLAHE follows OpenCV's ``createCLAHE``: edge-pad to
whole tiles, 256-bin histograms of the rounded levels, clip at max(1,
clip·area/256) with the excess spread evenly, LUT round(cdf·255/area), and
a half-pixel, edge-clamped bilinear blend of the four nearest tiles' LUTs
at each pixel's own bin.

The preprocessing is float32 in every mode; the classifier's products go
through ``Numerics``. Parameters are read from a state dict under the
served model's key names. Nothing here imports the program.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .image import _resample, _weight_mat, resize
from .nn import Numerics, layer_norm

NBINS = 256


def keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = -0.5 at distances ``x`` ≥ 0."""
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x >= 2.0, torch.zeros_like(x), torch.where(x >= 1.0, far, near))


def mouth_boxes(face: torch.Tensor, min_size: int = 48) -> torch.Tensor:
    """Rows [0.62, 0.92] and columns [0.22, 0.78] of y1y2x1x2 face boxes
    (N, 4), grown about their centre to at least ``min_size`` (a shortfall
    d split floor(d/2) before, the rest after)."""
    y1, y2, x1, x2 = face.to(torch.float32).unbind(-1)
    h, w = y2 - y1, x2 - x1
    y1, y2, x1, x2 = y1 + 0.62 * h, y1 + 0.92 * h, x1 + 0.22 * w, x1 + 0.78 * w
    dh = torch.clamp(min_size - (y2 - y1 + 1), min=0)
    dw = torch.clamp(min_size - (x2 - x1 + 1), min=0)
    before = lambda d: torch.floor(d / 2)
    after = lambda d: torch.floor((d + 1) / 2)
    return torch.stack([y1 - before(dh), y2 + after(dh), x1 - before(dw), x2 + after(dw)], -1)


def crop_cubic(frames: torch.Tensor, box: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Frames (N, H, W, C) and y1y2x1x2 boxes (N, 4) → (N, oh, ow, C)
    float32, each box resampled by Keys' cubic without antialiasing."""
    n, H, W, C = frames.shape
    y1, y2, x1, x2 = box.to(torch.float32).unbind(-1)
    oh, ow = size
    sy = torch.full_like(y1, oh) / torch.clamp(y2 - y1, min=1e-3)
    sx = torch.full_like(x1, ow) / torch.clamp(x2 - x1, min=1e-3)
    wy = _weight_mat(H, oh, 1.0 / sy, -y1 * sy, keys_cubic, antialias=False)
    wx = _weight_mat(W, ow, 1.0 / sx, -x1 * sx, keys_cubic, antialias=False)
    return _resample(frames.to(torch.float32), wy, wx)


def luma(rgb: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.601 luma of (..., 3) → (...) float32."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32, device=rgb.device)
    return rgb.to(torch.float32) @ w


def _blend_coords(n: int, tiles: int, padded: int, device):
    """For pixels 0..n-1 of an axis padded to ``padded`` and cut into
    ``tiles``: the nearer and the farther tile (edge-clamped) and the
    farther one's weight, at the pixel's centre."""
    pos = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * tiles / padded - 0.5
    low = torch.floor(pos)
    i = low.long()
    return i.clamp(0, tiles - 1), (i + 1).clamp(0, tiles - 1), pos - low


def clahe(img: torch.Tensor, clip: float = 0.2, grid: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """CLAHE of (N, H, W) float levels in [0, 255] → (N, H, W) float32."""
    n, h, w = img.shape
    gh, gw = grid
    th, tw = -(-h // gh), -(-w // gw)
    area = th * tw
    padded = F.pad(img.to(torch.float32)[:, None], (0, gw * tw - w, 0, gh * th - h),
                   mode="replicate")[:, 0]
    bins = torch.clamp(torch.round(padded), 0, NBINS - 1).long()
    # (N, gh, th, gw, tw) → (N, tile, pixel of the tile)
    per_tile = bins.reshape(n, gh, th, gw, tw).permute(0, 1, 3, 2, 4).reshape(n, gh * gw, area)
    flat = (torch.arange(n * gh * gw, device=img.device).reshape(n, gh * gw, 1) * NBINS
            + per_tile)
    hist = torch.bincount(flat.reshape(-1), minlength=n * gh * gw * NBINS)
    hist = hist.reshape(n, gh * gw, NBINS).to(torch.float32)
    limit = max(1.0, clip * area / NBINS)
    kept = torch.clamp(hist, max=limit)
    excess = (hist - kept).sum(-1, keepdim=True)
    cdf = torch.cumsum(kept + excess / NBINS, -1)
    area_t = torch.tensor(float(area), device=img.device)
    lut = torch.clamp(torch.round(cdf * (NBINS - 1) / area_t), 0, NBINS - 1)

    r0, r1, fy = _blend_coords(h, gh, gh * th, img.device)
    c0, c1, fx = _blend_coords(w, gw, gw * tw, img.device)
    level = bins[:, :h, :w].reshape(n, h * w)
    luts = lut.reshape(n, gh * gw * NBINS)

    def at(rows, cols):
        tile = rows[:, None] * gw + cols[None, :]
        return torch.gather(luts, 1, tile.reshape(1, h * w) * NBINS + level).reshape(n, h, w)

    fy, fx = fy[:, None], fx[None, :]
    top = (1 - fx) * at(r0, c0) + fx * at(r0, c1)
    bottom = (1 - fx) * at(r1, c0) + fx * at(r1, c1)
    return (1 - fy) * top + fy * bottom


def mouth_roi(frames: torch.Tensor, face: torch.Tensor, crop: Tuple[int, int] = (48, 48),
              out: Tuple[int, int] = (32, 32), clip: float = 0.2,
              grid: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """RGB uint8 frames (N, H, W, 3) and face boxes (N, 4) → the uint8 ROI
    (N, out_h, out_w)."""
    crops = crop_cubic(frames, mouth_boxes(face, crop[0]), crop)
    boosted = clahe(luma(crops), clip, grid)
    return torch.clamp(torch.round(resize(boosted[..., None], out)[..., 0]), 0,
                       255).to(torch.uint8)


class ViViT:
    """The classifier over (B, T, H, W, C) clips in [0, 1] → float32 logits,
    from a state dict with the served model's keys (``tubelet.proj``,
    ``pos_embedding``, ``blocks.{i}.norm1|qkv|proj|norm2|mlp.fc1|mlp.fc2``,
    ``norm``, ``head``)."""

    def __init__(self, p: Dict[str, torch.Tensor], cfg: dict, numerics: Numerics):
        self.p, self.cfg, self.num = p, cfg, numerics

    def _lin(self, key: str, x: torch.Tensor) -> torch.Tensor:
        return self.num.linear(x, self.p[f"{key}.weight"], self.p[f"{key}.bias"])

    def _norm(self, key: str, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.p[f"{key}.weight"], self.p[f"{key}.bias"])

    def __call__(self, clips: torch.Tensor) -> torch.Tensor:
        tt, th, tw = self.cfg["tubelet_size"]
        b, t, h, w, c = clips.shape
        x = clips.to(torch.float32).reshape(b, t // tt, tt, h // th, th, w // tw, tw, c)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, -1, tt * th * tw * c)
        with self.num.context():
            x = self._lin("tubelet.proj", x) + self.p["pos_embedding"].float()
            for i in range(self.cfg["num_layers"]):
                blk = f"blocks.{i}"
                q, k, v = self._lin(f"{blk}.qkv", self._norm(f"{blk}.norm1", x)).chunk(3, dim=-1)
                x = x + self._lin(f"{blk}.proj", self.num.attention(q, k, v, self.cfg["num_heads"]))
                hid = F.gelu(self._lin(f"{blk}.mlp.fc1", self._norm(f"{blk}.norm2", x)),
                             approximate="tanh")
                x = x + self._lin(f"{blk}.mlp.fc2", hid)
            return self._lin("head", self._norm("norm", x).mean(dim=1))


def request(model: ViViT, frames: torch.Tensor, face: torch.Tensor, block: int = 128,
            crop: Tuple[int, int] = (48, 48), clip: float = 0.2,
            grid: Tuple[int, int] = (8, 8)) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-probs (B, classes) of the B clips of a request's frames
    (B·T, H, W, 3) uint8 and face boxes (B·T, 4), ``block`` clips at a time,
    and the uint8 ROI (B·T, s, s) they were computed from."""
    t, s = model.cfg["num_frames"], model.cfg["image_size"]
    out, rois = [], []
    for i in range(0, frames.shape[0], block * t):
        rois.append(mouth_roi(frames[i:i + block * t], face[i:i + block * t], crop, (s, s), clip,
                              grid))
        clips = rois[-1].reshape(-1, t, s, s, 1).to(torch.float32) / 255.0
        out.append(torch.log_softmax(model(clips), dim=-1))
    return torch.cat(out), torch.cat(rois)
