"""SyncNet: the audio↔lip-motion sync expert, paired 512-d embeddings.

Port of ``lipreading_video_generation_tpu/models/syncnet.py`` (``SyncNet``,
``stack_window_lower_half``): a face tower of 17 ``ConvBlock``s over the
lower halves of a ``syncnet_T``-frame window stacked on channels (15 input
channels) and a mel tower of 14, both with GroupNorm and ReLU (residual
blocks add their input), each flattened and L2-normalised in float32. The
public layout is the JAX package's, NHWC: mel (B, 80, 16, 1), faces (B, 48,
96, 15); inside, NCHW. Each tower flattens in NHWC order, so that a size
whose towers do not end at 1×1 gives JAX's embedding too. The blocks sit in
``face_blocks`` and ``audio_blocks`` (Flax: ``face_blocks_i``,
``audio_blocks_i``; ``models.convert.syncnet_state_dict_from_flax``).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .layers import ConvBlock, l2_normalize, scale_channels

# (channels at width 1.0, kernel, stride, padding, residual), in call order
FACE_PLAN = (
    (32, 7, 1, 3, False),
    (64, 5, (1, 2), 1, False),
    (64, 3, 1, 1, True), (64, 3, 1, 1, True),
    (128, 3, 2, 1, False),
    (128, 3, 1, 1, True), (128, 3, 1, 1, True), (128, 3, 1, 1, True),
    (256, 3, 2, 1, False),
    (256, 3, 1, 1, True), (256, 3, 1, 1, True),
    (512, 3, 2, 1, False),
    (512, 3, 1, 1, True), (512, 3, 1, 1, True),
    (512, 3, 2, 1, False),
    (512, 3, 1, 0, False),
    (512, 1, 1, 0, False),
)
AUDIO_PLAN = (
    (32, 3, 1, 1, False),
    (32, 3, 1, 1, True), (32, 3, 1, 1, True),
    (64, 3, (3, 1), 1, False),
    (64, 3, 1, 1, True), (64, 3, 1, 1, True),
    (128, 3, 3, 1, False),
    (128, 3, 1, 1, True), (128, 3, 1, 1, True),
    (256, 3, (3, 2), 1, False),
    (256, 3, 1, 1, True), (256, 3, 1, 1, True),
    (512, 3, 1, 0, False),
    (512, 1, 1, 0, False),
)


def _tower(plan, in_channels: int, width: float, dtype: torch.dtype) -> nn.ModuleList:
    blocks, ch = [], in_channels
    for channels, k, s, p, residual in plan:
        out = scale_channels(channels, width)
        blocks.append(ConvBlock(ch, out, k, s, p, norm="group", residual=residual, dtype=dtype))
        ch = out
    return nn.ModuleList(blocks)


def _embed(x: torch.Tensor, blocks: nn.ModuleList) -> torch.Tensor:
    """NHWC input through ``blocks`` → (B, features) float32, L2-normalised,
    flattened in NHWC order."""
    x = x.permute(0, 3, 1, 2)
    for block in blocks:
        x = block(x)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).to(torch.float32)
    return l2_normalize(x)


class SyncNet(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32, width: float = 1.0,
                 syncnet_T: int = 5):
        super().__init__()
        self.face_blocks = _tower(FACE_PLAN, 3 * syncnet_T, width, dtype)
        self.audio_blocks = _tower(AUDIO_PLAN, 1, width, dtype)

    def forward(self, mel: torch.Tensor, faces: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """mel (B, 80, 16, 1); faces (B, 48, 96, 3·T), the lower halves of a
        window stacked on channels → (audio_emb, face_emb), each (B, 512·width)
        float32 and of unit norm."""
        return _embed(mel, self.audio_blocks), _embed(faces, self.face_blocks)


def stack_window_lower_half(window: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, 3) face window → (B, H/2, W, 3·T) SyncNet face input: the
    lower halves, frame t's channel c at t·3 + c."""
    b, t, h, w, c = window.shape
    lower = window[:, :, h // 2:]
    return lower.permute(0, 2, 3, 1, 4).reshape(b, h - h // 2, w, t * c)
