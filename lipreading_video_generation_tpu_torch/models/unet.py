"""Diffusion U-Net (inference), in NCHW.

Port of ``lipreading_video_generation_tpu/models/unet.py``'s
``timestep_embedding``, ``_group_norm``, ``ResBlock``, ``AttentionBlock``,
``Downsample``, ``Upsample`` and ``UNetModel``. What keeps them equal to the
Flax modules:

- ``GroupNorm``: Flax's — groups ``min(32, c)`` lowered until they divide
  c, eps 1e-6, float32 statistics with the fast variance E[x²]−E[x]²
  (clipped at 0), float32 scale and bias and float32 output.
- Convolutions and the attention projections compute in the model dtype
  (bf16 by default); the time MLP, the ResBlocks' embedding projection, all
  GroupNorms and the output convolution run in float32.
- ResBlocks condition by scale-shift, ``GN(h)·(1+scale)+shift`` with
  (scale, shift) in that order; the 1×1 skip conv exists only when the
  channel count changes.
- ``AttentionBlock`` attends over the H·W tokens in row-major (h, w) order
  through ``ops.attention.mha``: past 128² scores that is the flash kernel
  K3 on CUDA.
- Skips concatenate on the channel axis (dim 1), where Flax concatenates on
  the last axis.

``UNetModel`` keeps its submodules in one ``ModuleList`` in the order Flax
creates them (``plan`` below), which is what ``models.convert`` walks.
Rematerialisation and ring attention are training and multi-GPU options
and are not ported; dropout is not applied (inference).
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.attention import mha
from ..ops.image import upsample_nearest2x


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding (B,) → (B, dim) float32, [cos, sin] in that order."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def num_groups(c: int) -> int:
    g = min(32, c)
    while c % g:
        g -= 1
    return g


class GroupNorm(nn.Module):
    """Flax ``nn.GroupNorm(dtype=float32)`` over (B, C, ...) inputs."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.groups = num_groups(channels)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        x32 = x.to(torch.float32)
        xg = x32.reshape(b, self.groups, -1)
        mean = xg.mean(-1)
        var = torch.clamp((xg * xg).mean(-1) - mean * mean, min=0.0)
        per_group = c // self.groups
        shape = (b, c) + (1,) * (x.ndim - 2)
        mean = mean.repeat_interleave(per_group, dim=1).reshape(shape)
        mul = (torch.rsqrt(var + self.eps).repeat_interleave(per_group, dim=1).reshape(shape)
               * self.weight.reshape((1, c) + (1,) * (x.ndim - 2)))
        return (x32 - mean) * mul + self.bias.reshape((1, c) + (1,) * (x.ndim - 2))


class ResBlock(nn.Module):
    """GN→SiLU→conv, scale-shift time conditioning, GN→SiLU→conv, skip."""

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.norm1 = GroupNorm(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, dtype=dtype)
        self.emb = nn.Linear(emb_dim, 2 * out_channels, dtype=torch.float32)
        self.norm2 = GroupNorm(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, dtype=dtype)
        self.skip = (nn.Conv2d(in_channels, out_channels, 1, dtype=dtype)
                     if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)).to(self.dtype))
        scale, shift = self.emb(F.silu(emb))[:, :, None, None].chunk(2, dim=1)
        h = self.norm2(h) * (1 + scale) + shift
        h = self.conv2(F.silu(h).to(self.dtype))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class AttentionBlock(nn.Module):
    """Spatial self-attention over the H·W tokens with a residual."""

    def __init__(self, channels: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.norm = GroupNorm(channels)
        self.qkv = nn.Linear(channels, 3 * channels, dtype=dtype)
        self.proj = nn.Linear(channels, channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        flat = self.norm(x).to(self.dtype).reshape(b, c, h * w).transpose(1, 2)
        q, k, v = self.qkv(flat).chunk(3, dim=-1)
        out = self.proj(mha(q, k, v, self.num_heads))            # (B, H·W, C)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class Downsample(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_nearest2x(x))


def plan(base_channels: int, channel_mult: Sequence[int], num_res_blocks: int,
         attention_resolutions: Sequence[int]) -> List[Tuple]:
    """The steps of Flax ``UNetModel.__call__`` after the stem, in order:
    ("res", c_in, c_out), ("attn", c), ("down", c), ("up", c), ("push",)
    (keep h as a skip) and ("cat",) (concatenate the last skip)."""
    steps: List[Tuple] = []
    ch, skip_ch, ds = base_channels, [base_channels], 1
    for level, mult in enumerate(channel_mult):
        for _ in range(num_res_blocks):
            steps.append(("res", ch, base_channels * mult))
            ch = base_channels * mult
            if ds in attention_resolutions:
                steps.append(("attn", ch))
            steps.append(("push",))
            skip_ch.append(ch)
        if level != len(channel_mult) - 1:
            steps += [("down", ch), ("push",)]
            skip_ch.append(ch)
            ds *= 2
    steps += [("res", ch, ch), ("attn", ch), ("res", ch, ch)]
    for level, mult in reversed(list(enumerate(channel_mult))):
        for _ in range(num_res_blocks + 1):
            steps += [("cat",), ("res", ch + skip_ch.pop(), base_channels * mult)]
            ch = base_channels * mult
            if ds in attention_resolutions:
                steps.append(("attn", ch))
        if level != 0:
            steps.append(("up", ch))
            ds //= 2
    return steps


class UNetModel(nn.Module):
    """(B, C_in, H, W) + (B,) timesteps → (B, out_channels, H, W) float32."""

    def __init__(self, in_channels: int, out_channels: int = 3, base_channels: int = 64,
                 channel_mult: Sequence[int] = (1, 2, 4, 8), num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (1, 2, 4), num_heads: int = 4,
                 time_embed_dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.base_channels = base_channels
        self.time1 = nn.Linear(base_channels, time_embed_dim, dtype=torch.float32)
        self.time2 = nn.Linear(time_embed_dim, time_embed_dim, dtype=torch.float32)
        self.stem = nn.Conv2d(in_channels, base_channels, 3, padding=1, dtype=dtype)
        self.steps = plan(base_channels, channel_mult, num_res_blocks, attention_resolutions)
        self.layers = nn.ModuleList()
        for step in self.steps:
            if step[0] == "res":
                self.layers.append(ResBlock(step[1], step[2], time_embed_dim, dtype))
            elif step[0] == "attn":
                self.layers.append(AttentionBlock(step[1], num_heads, dtype))
            elif step[0] == "down":
                self.layers.append(Downsample(step[1], dtype))
            elif step[0] == "up":
                self.layers.append(Upsample(step[1], dtype))
        ch = base_channels * channel_mult[0]
        self.out_norm = GroupNorm(ch)
        self.out_conv = nn.Conv2d(ch, out_channels, 3, padding=1, dtype=torch.float32)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        emb = self.time2(F.silu(self.time1(timestep_embedding(t, self.base_channels))))
        h = self.stem(x.to(self.dtype))
        skips = [h]
        layers = iter(self.layers)
        for step in self.steps:
            if step[0] == "push":
                skips.append(h)
            elif step[0] == "cat":
                h = torch.cat([h, skips.pop()], dim=1)
            elif step[0] == "res":
                h = next(layers)(h, emb)
            else:
                h = next(layers)(h)
        return self.out_conv(F.silu(self.out_norm(h)))
