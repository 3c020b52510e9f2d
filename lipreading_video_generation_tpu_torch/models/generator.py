"""Talking-face generator: audio-conditioned U-Net over face windows.

Port of ``lipreading_video_generation_tpu/models/generator.py``
(``AudioEncoder``, ``FaceEncoder``, ``FaceDecoder``,
``TalkingFaceGenerator``): 6-channel input (masked target ⊕ reference), 7
face-encoder stages 16→32→64→128→256→512→512 with skips, a mel encoder to
a 512-d 1×1 embedding, 7 decoder stages (nearest resize + conv) with skip
concatenation, sigmoid RGB output; 13 + 18 + 20 = 51 convolutions, all
channel counts scaled by ``width``.

The public layout is the JAX package's, NHWC: mel (B, T, 80, 16, 1) or
(B, 80, 16, 1), faces (B, T, 96, 96, 6) or (B, 96, 96, 6) → (B, [T,] 96,
96, 3) in [0, 1], float32. Inside, the modules run NCHW. Each sub-network
keeps its blocks in one ``layers`` list in call order; the plans below give
that order, and ``models.convert.generator_state_dict_from_flax`` walks the
same plans to find each block's Flax name.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from .layers import (Conv2d, ConvBlock, ResConvBlock, UpsampleConv, fold_time, scale_channels,
                     unfold_time)

# ("conv", channels, kernel, stride, padding) | ("res", channels), in call
# order; channels at width 1.0.
AUDIO_PLAN = (
    ("conv", 32, 3, 1, 1), ("res", 32), ("res", 32),
    ("conv", 64, 3, (3, 1), 1), ("res", 64), ("res", 64),          # 80x16 → 27x16
    ("conv", 128, 3, 3, 1), ("res", 128), ("res", 128),            # → 9x6
    ("conv", 256, 3, (3, 2), 1), ("res", 256),                     # → 3x3
    ("conv", 512, 3, 1, 0), ("conv", 512, 1, 1, 0),                # → 1x1
)
# ("skip",) marks the features the decoder takes, shallowest first.
FACE_PLAN = (
    ("conv", 16, 7, 1, 3), ("skip",),                                            # 96
    ("conv", 32, 3, 2, 1), ("res", 32), ("res", 32), ("skip",),                  # 48
    ("conv", 64, 3, 2, 1), ("res", 64), ("res", 64), ("res", 64), ("skip",),     # 24
    ("conv", 128, 3, 2, 1), ("res", 128), ("res", 128), ("skip",),               # 12
    ("conv", 256, 3, 2, 1), ("res", 256), ("res", 256), ("skip",),               # 6
    ("conv", 512, 3, 2, 1), ("res", 512), ("skip",),                             # 3
    ("conv", 512, 3, 1, 0), ("conv", 512, 1, 1, 0), ("skip",),                   # 1
)
# ("cat",) concatenates the next-deepest skip; ("up", channels, size).
DECODER_PLAN = (
    ("conv", 512, 1, 1, 0), ("cat",),
    ("up", 512, 3), ("res", 512), ("cat",),
    ("up", 512, 6), ("res", 512), ("res", 512), ("cat",),
    ("up", 384, 12), ("res", 384), ("res", 384), ("cat",),
    ("up", 256, 24), ("res", 256), ("res", 256), ("cat",),
    ("up", 128, 48), ("res", 128), ("res", 128), ("cat",),
    ("up", 64, 96), ("res", 64), ("res", 64), ("cat",),
    ("conv", 32, 3, 1, 1),
)


def skip_channels(width: float) -> List[int]:
    """Channels of the face encoder's seven skip features, shallowest first."""
    out, ch = [], 0
    for step in FACE_PLAN:
        if step[0] == "skip":
            out.append(ch)
        else:
            ch = scale_channels(step[1], width)
    return out


def _build(plan, in_channels: int, width: float, norm: str, dtype: torch.dtype,
           skips: List[int] = ()) -> nn.ModuleList:
    """The blocks of ``plan`` in call order (the steps that create none,
    "skip" and "cat", only change the channel count)."""
    layers, ch, skips = [], in_channels, list(skips)
    for step in plan:
        if step[0] == "cat":
            ch += skips.pop()
            continue
        if step[0] == "skip":
            continue
        out = scale_channels(step[1], width)
        if step[0] == "conv":
            layers.append(ConvBlock(ch, out, step[2], step[3], step[4], norm=norm, dtype=dtype))
        elif step[0] == "res":
            layers.append(ResConvBlock(out, norm, dtype))
        else:
            layers.append(UpsampleConv(ch, out, (step[2], step[2]), norm, dtype))
        ch = out
    return nn.ModuleList(layers)


class AudioEncoder(nn.Module):
    """(B, 1, 80, 16) mel window → (B, 512·width, 1, 1) embedding."""

    def __init__(self, norm: str = "group", dtype: torch.dtype = torch.float32,
                 width: float = 1.0):
        super().__init__()
        self.layers = _build(AUDIO_PLAN, 1, width, norm, dtype)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            mel = layer(mel)
        return mel


class FaceEncoder(nn.Module):
    """(B, 6, 96, 96) → the 7 skip features, deepest last."""

    def __init__(self, norm: str = "group", dtype: torch.dtype = torch.float32,
                 width: float = 1.0):
        super().__init__()
        self.layers = _build(FACE_PLAN, 6, width, norm, dtype)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats, layers = [], iter(self.layers)
        for step in FACE_PLAN:
            if step[0] == "skip":
                feats.append(x)
            else:
                x = next(layers)(x)
        return feats


class FaceDecoder(nn.Module):
    """Audio embedding + skips → (B, 3, 96, 96) sigmoid RGB, float32."""

    def __init__(self, norm: str = "group", dtype: torch.dtype = torch.float32,
                 width: float = 1.0):
        super().__init__()
        emb = scale_channels(512, width)
        self.layers = _build(DECODER_PLAN, emb, width, norm, dtype, skip_channels(width))
        self.out_conv = Conv2d(scale_channels(32, width), 3, 1, dtype=dtype)

    def forward(self, audio_emb: torch.Tensor, feats: List[torch.Tensor]) -> torch.Tensor:
        feats, layers, x = list(feats), iter(self.layers), audio_emb
        for step in DECODER_PLAN:
            if step[0] == "cat":
                x = torch.cat([x, feats.pop()], dim=1)
            else:
                x = next(layers)(x)
        return torch.sigmoid(self.out_conv(x).to(torch.float32))


class TalkingFaceGenerator(nn.Module):
    def __init__(self, norm: str = "group", dtype: torch.dtype = torch.float32,
                 width: float = 1.0):
        super().__init__()
        self.audio = AudioEncoder(norm, dtype, width)
        self.face = FaceEncoder(norm, dtype, width)
        self.decoder = FaceDecoder(norm, dtype, width)

    def forward(self, mel: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
        """mel (B, T, 80, 16, 1) or (B, 80, 16, 1); faces (B, T, 96, 96, 6)
        or (B, 96, 96, 6), NHWC. Returns the faces' layout with 3 channels."""
        folded = faces.ndim == 5
        if folded:
            mel, b = fold_time(mel)
            faces, _ = fold_time(faces)
        emb = self.audio(mel.permute(0, 3, 1, 2))
        feats = self.face(faces.permute(0, 3, 1, 2))
        out = self.decoder(emb, feats).permute(0, 2, 3, 1)
        return unfold_time(out, b) if folded else out
