"""Diffusion U-Nets, in NCHW: ``UNetModel``, its classifier half
``EncoderUNetModel`` and the super-resolution wrapper ``SuperResModel``.

Port of ``lipreading_video_generation_tpu/models/unet.py``'s
``timestep_embedding``, ``_group_norm``, ``ResBlock``, ``AttentionBlock``,
``Downsample``, ``Upsample``, ``EncoderUNetModel``, ``UNetModel`` and
``SuperResModel``. What keeps them equal to the Flax modules:

- ``GroupNorm``: Flax's — groups ``min(32, c)`` lowered until they divide
  c, eps 1e-6, float32 statistics with the fast variance E[x²]−E[x]²
  (clipped at 0), float32 scale and bias and float32 output.
- Parameters are float32 (``models.layers``); convolutions and the
  attention projections compute in the model dtype (bf16 by default); the
  time MLP, the ResBlocks' embedding projection, all GroupNorms and the
  output convolution run in float32.
- ResBlocks condition by scale-shift, ``GN(h)·(1+scale)+shift`` with
  (scale, shift) in that order; the 1×1 skip conv exists only when the
  channel count changes. In ``train()`` mode dropout acts between the
  second SiLU and the second conv: kept values are scaled by 1/keep, as
  Flax's ``nn.Dropout`` does. The model draws each ResBlock's mask with
  ``dropout_mask`` from the generator it is given, before the block runs,
  so a rematerialised block (``remat=True``: ``torch.utils.checkpoint``,
  Flax's ``nn.remat``) recomputes with the same mask. Attention is not
  rematerialised, as in JAX.
- The layers Flax zero-initialises start at zero here too: each ResBlock's
  second conv, each attention output projection, the U-Net's output conv.
- ``AttentionBlock`` attends over the H·W tokens in row-major (h, w) order
  through ``ops.attention.mha``: past 128² scores that is the flash kernel
  K3 on CUDA, and its backward K4/K5.
- Skips concatenate on the channel axis (dim 1), where Flax concatenates on
  the last axis.

The models keep their submodules in one ``ModuleList`` in the order Flax
creates them (``plan`` and ``encoder_plan`` below), which is what
``models.convert`` walks. Ring attention is a multi-GPU option and is not
ported.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import mha
from ..ops.image import resize, upsample_nearest2x
from .layers import Conv2d, GroupNorm, Linear


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


def dropout_mask(shape, rate: float, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """Keep-mask of ``shape`` (True with probability 1 − rate), drawn from
    ``generator`` (the default one when None) on ``device``."""
    return torch.empty(shape, dtype=torch.bool, device=device).bernoulli_(
        1.0 - rate, generator=generator)


class ResBlock(nn.Module):
    """GN→SiLU→conv, scale-shift time conditioning, GN→SiLU→(dropout)→conv,
    skip."""

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int, dtype: torch.dtype,
                 dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.out_channels = out_channels
        self.dropout = dropout
        self.norm1 = GroupNorm(in_channels)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1, dtype=dtype)
        self.emb = Linear(emb_dim, 2 * out_channels)
        self.norm2 = GroupNorm(out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1, dtype=dtype)
        nn.init.zeros_(self.conv2.weight)
        self.skip = (Conv2d(in_channels, out_channels, 1, dtype=dtype)
                     if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep``: the dropout keep-mask (B, out_channels, H, W), or None
        for no dropout."""
        h = self.conv1(F.silu(self.norm1(x)).to(self.dtype))
        scale, shift = self.emb(F.silu(emb))[:, :, None, None].chunk(2, dim=1)
        h = self.norm2(h) * (1 + scale) + shift
        h = F.silu(h).to(self.dtype)
        if keep is not None:
            h = torch.where(keep, h / (1.0 - self.dropout), 0.0)
        h = self.conv2(h)
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
        self.qkv = Linear(channels, 3 * channels, dtype)
        self.proj = Linear(channels, channels, dtype)
        nn.init.zeros_(self.proj.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        flat = self.norm(x).to(self.dtype).reshape(b, c, h * w).transpose(1, 2)
        q, k, v = self.qkv(flat).chunk(3, dim=-1)
        out = self.proj(mha(q, k, v, self.num_heads))            # (B, H·W, C)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class Downsample(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, dtype=dtype)

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


def encoder_plan(base_channels: int, channel_mult: Sequence[int], num_res_blocks: int,
                 attention_resolutions: Sequence[int]) -> List[Tuple]:
    """The steps of Flax ``EncoderUNetModel.__call__`` after the stem: the
    down path and the middle of ``plan``, without skips."""
    steps = plan(base_channels, channel_mult, num_res_blocks, attention_resolutions)
    return [s for s in steps[:steps.index(("cat",))] if s != ("push",)]


class _UNetBase(nn.Module):
    """Time MLP, stem and the ``steps`` of a plan, shared by both U-Nets."""

    def __init__(self, in_channels: int, steps: List[Tuple], base_channels: int, num_heads: int,
                 time_embed_dim: int, dropout: float, dtype: torch.dtype, remat: bool):
        super().__init__()
        self.dtype = dtype
        self.base_channels = base_channels
        self.dropout = dropout
        self.remat = remat
        self.time1 = Linear(base_channels, time_embed_dim)
        self.time2 = Linear(time_embed_dim, time_embed_dim)
        self.stem = Conv2d(in_channels, base_channels, 3, padding=1, dtype=dtype)
        self.steps = steps
        self.layers = nn.ModuleList()
        for step in steps:
            if step[0] == "res":
                self.layers.append(ResBlock(step[1], step[2], time_embed_dim, dtype, dropout))
            elif step[0] == "attn":
                self.layers.append(AttentionBlock(step[1], num_heads, dtype))
            elif step[0] == "down":
                self.layers.append(Downsample(step[1], dtype))
            elif step[0] == "up":
                self.layers.append(Upsample(step[1], dtype))

    def run_steps(self, x: torch.Tensor, t: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
        emb = self.time2(F.silu(self.time1(timestep_embedding(t, self.base_channels))))
        h = self.stem(x.to(self.dtype))
        skips = [h]
        layers = iter(self.layers)
        drop = self.training and self.dropout > 0
        remat = self.remat and torch.is_grad_enabled()
        for step in self.steps:
            if step[0] == "push":
                skips.append(h)
            elif step[0] == "cat":
                h = torch.cat([h, skips.pop()], dim=1)
            elif step[0] == "res":
                block = next(layers)
                keep = (dropout_mask((h.shape[0], block.out_channels) + h.shape[2:],
                                     self.dropout, generator, h.device) if drop else None)
                h = (checkpoint(block, h, emb, keep, use_reentrant=False) if remat
                     else block(h, emb, keep))
            else:
                h = next(layers)(h)
        return h


class UNetModel(_UNetBase):
    """(B, C_in, H, W) + (B,) timesteps → (B, out_channels, H, W) float32.
    ``generator`` draws the dropout masks in ``train()`` mode."""

    def __init__(self, in_channels: int, out_channels: int = 3, base_channels: int = 64,
                 channel_mult: Sequence[int] = (1, 2, 4, 8), num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (1, 2, 4), num_heads: int = 4,
                 time_embed_dim: int = 256, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0, remat: bool = False):
        super().__init__(in_channels, plan(base_channels, channel_mult, num_res_blocks,
                                           attention_resolutions),
                         base_channels, num_heads, time_embed_dim, dropout, dtype, remat)
        ch = base_channels * channel_mult[0]
        self.out_norm = GroupNorm(ch)
        self.out_conv = Conv2d(ch, out_channels, 3, padding=1)
        nn.init.zeros_(self.out_conv.weight)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.run_steps(x, t, generator)
        return self.out_conv(F.silu(self.out_norm(h)))


class EncoderUNetModel(_UNetBase):
    """The down path and middle of the U-Net with a pooled head — the
    classifier for guidance: (B, C_in, H, W) + (B,) t → (B, num_out) float32
    logits (GN → SiLU → spatial mean → float32 Dense)."""

    def __init__(self, in_channels: int, num_out: int = 1000, base_channels: int = 64,
                 channel_mult: Sequence[int] = (1, 2, 4, 8), num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (2, 4), num_heads: int = 4,
                 time_embed_dim: int = 256, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, encoder_plan(base_channels, channel_mult, num_res_blocks,
                                                   attention_resolutions),
                         base_channels, num_heads, time_embed_dim, dropout, dtype, False)
        ch = base_channels * channel_mult[-1]
        self.out_norm = GroupNorm(ch)
        self.head = Linear(ch, num_out)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = F.silu(self.out_norm(self.run_steps(x, t, generator)))
        return self.head(h.mean(dim=(2, 3)))


class SuperResModel(nn.Module):
    """Denoises a high-res (B, C, H, W) frame conditioned on a low-res
    (B, C, h, w) one, bilinearly upsampled in float32 (``jax.image.resize``;
    ``ops.image.resize`` reproduces it) and concatenated on channels."""

    def __init__(self, unet: UNetModel):
        super().__init__()
        self.unet = unet

    def forward(self, x: torch.Tensor, low_res: torch.Tensor, t: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        up = resize(low_res.to(torch.float32).permute(0, 2, 3, 1), tuple(x.shape[-2:]))
        return self.unet(torch.cat([x, up.permute(0, 3, 1, 2).to(x.dtype)], dim=1), t, generator)
