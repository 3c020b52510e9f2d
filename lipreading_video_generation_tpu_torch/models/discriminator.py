"""Visual-quality discriminator over lower-half faces.

Port of ``lipreading_video_generation_tpu/models/discriminator.py``
(``lower_half``, ``Discriminator``): the lower half of each frame through
13 unnormed ``ConvBlock``s with LeakyReLU(0.01), T folded into the batch,
then a 1×1 conv and a sigmoid in float32 → one real probability per folded
frame. The public layout is the JAX package's, NHWC; inside, NCHW. The
blocks sit in one ``blocks`` list in call order (Flax: ``ConvBlock_0…12``,
then ``Conv_0``; ``models.convert.discriminator_state_dict_from_flax``).
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import Conv2d, ConvBlock, fold_time, scale_channels

# (channels at width 1.0, kernel, stride, padding), in call order
PLAN = (
    (32, 7, 1, 3),                        # 48x96
    (64, 5, (1, 2), 2),                   # 48x48
    (64, 5, 1, 2),
    (128, 5, 2, 2),                       # 24x24
    (128, 5, 1, 2),
    (256, 5, 2, 2),                       # 12x12
    (256, 5, 1, 2),
    (512, 3, 2, 1),                       # 6x6
    (512, 3, 1, 1),
    (512, 3, 2, 1),                       # 3x3
    (512, 3, 1, 1),
    (512, 3, 1, 0),                       # 1x1
    (512, 1, 1, 0),
)


def lower_half(faces: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) → the rows from H // 2 on."""
    h = faces.shape[-3]
    return faces[..., h // 2:, :, :]


class Discriminator(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32, width: float = 1.0):
        super().__init__()
        blocks, ch = [], 3
        for channels, k, s, p in PLAN:
            out = scale_channels(channels, width)
            blocks.append(ConvBlock(ch, out, k, s, p, norm="none", act="leaky", dtype=dtype))
            ch = out
        self.blocks = nn.ModuleList(blocks)
        self.out_conv = Conv2d(ch, 1, 1, dtype=dtype)

    def forward(self, faces: torch.Tensor) -> torch.Tensor:
        """faces (B, T, H, W, 3) or (B, H, W, 3) in [0, 1], NHWC → the real
        probability of each folded frame, (B·T, 1) float32."""
        if faces.ndim == 5:
            faces, _ = fold_time(faces)
        x = lower_half(faces).permute(0, 3, 1, 2)
        for block in self.blocks:
            x = block(x)
        logit = self.out_conv(x).to(torch.float32)
        return torch.sigmoid(logit).reshape(x.shape[0], 1)
