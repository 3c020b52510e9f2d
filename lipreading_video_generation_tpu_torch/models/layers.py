"""Building blocks of the port, with Flax numerics.

Port of ``lipreading_video_generation_tpu/models/layers.py``'s ``MLP`` and
``TransformerBlock`` (with their dropout), ``l2_normalize``, and the lip-sync
GAN's conv blocks (``scale_channels``, ``fold_time``, ``unfold_time``,
``ConvBlock``, ``ResConvBlock``, ``UpsampleConv``; NCHW here, NHWC there), plus the parameter-holding layers
every model of the port is built from. What keeps them equal to the Flax
modules:

- ``Linear``, ``Conv1d``, ``Conv2d``, ``Conv3d`` keep their parameters in float32 and
  cast input, weight and bias to their compute dtype (bf16 by default)
  inside ``forward``, as Flax's ``Dense``/``Conv(dtype=...)`` with float32
  ``param_dtype`` do: an optimizer step updates the float32 master copy.
  Their own init is Flax's: lecun-normal kernels, zero biases.
- ``LayerNorm``: eps 1e-6, statistics in float32 with the fast variance
  E[x²]−E[x]² (clipped at 0), float32 scale and bias, output cast to the
  compute dtype (flax/linen/normalization.py).
- ``GroupNorm``: groups ``min(32, c)`` lowered until they divide c (or as
  many as its ``num_groups`` argument says), eps 1e-6, statistics in float32
  with the same fast variance.
- ``nn.gelu`` is the tanh approximation.
- ``UpsampleConv`` resizes with ``jax.image.resize(..., "nearest")``'s
  index rule, floor((i + 0.5)·in/out).
- Dropout is Flax's ``nn.Dropout``: kept values scaled by 1/(1 − rate) in
  the input's dtype, the rest zero. It acts only in ``train()`` mode at a
  rate above 0, with masks (``dropout_mask``) drawn from the generator the
  caller passes; Flax draws from its own key tree, so the two frameworks'
  masks differ. In a data-parallel step a mask is drawn for the global
  batch and sliced to this rank's rows (``parallel.mesh.draw_batch``).

Inside ``ops.quant.int8_serving`` a ``Linear`` and a rerouted ``Conv2d``
compute their product in int8 (see ``ops/quant.py``).

``TransformerBlock(ring_axis=...)`` runs its attention through the ring
(``ops/ring_attention.py``) when a mesh with that axis is live; the TP
activation constraints of the JAX modules are dropped (tensor parallelism
is not ported).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
from torch import nn
import torch.nn.functional as F

from ..ops import quant
from ..ops.attention import mha
from ..ops.image import nearest_index
from ..ops.ring_attention import live_ring_mesh, model_ring_attention
from ..parallel.mesh import draw_batch

Pair = Union[int, Tuple[int, int]]


def _flax_init(layer: nn.Module) -> None:
    """Flax's default init: lecun-normal kernel (a normal truncated at two
    standard deviations, rescaled to variance 1/fan_in), zero bias."""
    fan_in = layer.weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)


class Linear(nn.Linear):
    """Dense layer: float32 params, computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def reset_parameters(self) -> None:
        _flax_init(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        serving = quant.active()
        if serving is not None:
            out = serving.linear(self, x)
            if out is not None:
                return out
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class _CastConv:
    """Mixin for ``nn.ConvNd``: float32 params, computed in ``dtype``."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def reset_parameters(self) -> None:
        _flax_init(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        serving = quant.active()
        if serving is not None:
            out = serving.conv(self, x)
            if out is not None:
                return out
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Conv1d(_CastConv, nn.Conv1d):
    """1-D conv over (B, C, W)."""


class Conv2d(_CastConv, nn.Conv2d):
    """2-D conv over (B, C, H, W)."""


class Conv3d(_CastConv, nn.Conv3d):
    """3-D conv over (B, C, T, H, W)."""


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm`` over the last axis (float32 params)."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean, min=0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


def default_groups(c: int) -> int:
    g = min(32, c)
    while c % g:
        g -= 1
    return g


class GroupNorm(nn.Module):
    """Flax ``nn.GroupNorm(dtype=float32)`` over (B, C, ...) inputs, in
    ``num_groups`` groups (None: ``default_groups(channels)``, as most of
    the JAX package's models pick them; ``nn.GroupNorm(num_groups=8)``
    there is ``num_groups=8`` here)."""

    def __init__(self, channels: int, eps: float = 1e-6, num_groups: Optional[int] = None):
        super().__init__()
        if num_groups is not None and channels % num_groups:
            raise ValueError(f"GroupNorm: {channels} channels do not split into "
                             f"{num_groups} groups")
        self.groups = default_groups(channels) if num_groups is None else num_groups
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


def dropout_mask(shape, rate: float, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """Keep-mask of ``shape`` (True with probability 1 − rate), drawn from
    ``generator`` (the default one when None) on ``device``. Axis 0 of
    ``shape`` is the batch: in a data-parallel step the mask is drawn for
    the global batch and sliced (``parallel.mesh.draw_batch``)."""
    return draw_batch(lambda s: torch.empty(s, dtype=torch.bool, device=device).bernoulli_(
        1.0 - rate, generator=generator), shape)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax's ``nn.Dropout(rate)(x, deterministic=not training)``, with the
    mask drawn from ``generator``; ``x`` itself when not training or at rate
    0. ``ValueError`` when a mask is due and no generator is given."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs the generator to draw its masks from")
    keep = dropout_mask(x.shape, rate, generator, x.device)
    return torch.where(keep, x / (1.0 - rate), 0.0)


class MLP(nn.Module):
    """Dense → tanh-GELU → dropout → Dense → dropout (``Dense_0``/``Dense_1``
    in Flax)."""

    def __init__(self, features: int, hidden: int, out: int, dtype: torch.dtype,
                 dropout: float = 0.0):
        super().__init__()
        self.fc1 = Linear(features, hidden, dtype)
        self.fc2 = Linear(hidden, out, dtype)
        self.dropout = dropout

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(F.gelu(self.fc1(x), approximate="tanh"), self.dropout, self.training,
                    generator)
        return dropout(self.fc2(x), self.dropout, self.training, generator)


class TransformerBlock(nn.Module):
    """Pre-LN encoder block over (B, S, E): fused qkv projection, ``mha``
    (the small-MHA kernel K2 on CUDA), output projection, dropout, MLP.
    ``generator`` draws the dropout masks in ``train()`` mode. With
    ``ring_axis``, attention runs through the sequence-parallel ring
    (``ops/ring_attention.py``) while a mesh with that axis (more than one
    rank) is live; elsewhere the same block runs ``mha``."""

    def __init__(self, features: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 ring_axis: str = None):
        super().__init__()
        self.ring_axis = ring_axis
        self.num_heads = num_heads
        self.dropout = dropout
        self.norm1 = LayerNorm(features)
        self.qkv = Linear(features, 3 * features, dtype)
        self.proj = Linear(features, features, dtype)
        self.norm2 = LayerNorm(features)
        self.mlp = MLP(features, mlp_dim, features, dtype, dropout)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        q, k, v = self.qkv(self.norm1(x)).chunk(3, dim=-1)
        ring = live_ring_mesh(self.ring_axis)
        if ring is not None:
            attn = self.proj(model_ring_attention(q, k, v, self.num_heads, ring, self.ring_axis))
        else:
            attn = self.proj(mha(q, k, v, self.num_heads))
        x = x + dropout(attn, self.dropout, self.training, generator)
        return x + self.mlp(self.norm2(x), generator)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / sqrt(Σ x² + eps) along ``dim`` (eps inside the root, as the JAX
    package has it; ``F.normalize`` clamps the norm instead)."""
    return x / torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps)


def _pair(v: Pair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def scale_channels(ch: int, width: float) -> int:
    """A channel count scaled by a width multiplier: at least 8 and a
    multiple of 8 (Python's ``round``, half to even, as in the JAX package)."""
    return max(8, int(round(ch * width / 8)) * 8)


def fold_time(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(B, T, ...) → (B·T, ...); returns (folded, B)."""
    b, t = x.shape[0], x.shape[1]
    return x.reshape((b * t,) + x.shape[2:]), b


def unfold_time(x: torch.Tensor, b: int) -> torch.Tensor:
    """(B·T, ...) → (B, T, ...)."""
    return x.reshape((b, -1) + x.shape[1:])


def _norm(name: str, channels: int):
    if name == "group":
        return GroupNorm(channels)
    if name == "none":
        return None
    raise ValueError(f"unknown norm {name!r}")


_ACTS = {"relu": F.relu, "leaky": lambda x: F.leaky_relu(x, 0.01), "silu": F.silu,
         "none": lambda x: x}


class ConvBlock(nn.Module):
    """Conv → norm → activation over (B, C, H, W), with explicit symmetric
    padding (Flax: ``Conv_0`` and ``GroupNorm_0``)."""

    def __init__(self, in_channels: int, features: int, kernel: Pair = 3, stride: Pair = 1,
                 padding: Pair = 1, norm: str = "group", act: str = "relu",
                 residual: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if act not in _ACTS:
            raise ValueError(f"unknown act {act!r}")
        self.conv = Conv2d(in_channels, features, _pair(kernel), _pair(stride), _pair(padding),
                           dtype=dtype)
        self.norm = _norm(norm, features)
        self.act = act
        self.residual = residual
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv(x)
        if self.norm is not None:
            out = self.norm(out).to(self.compute_dtype)
        if self.residual:
            out = out + x
        return _ACTS[self.act](out)


class ResConvBlock(nn.Module):
    """x + (conv → norm → relu)(x) (Flax: ``ConvBlock_0``)."""

    def __init__(self, features: int, norm: str = "group", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block = ConvBlock(features, features, 3, 1, 1, norm=norm, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x) + x


def resize_nearest(x: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, C, H, W) → (B, C, th, tw) with ``jax.image.resize(...,
    "nearest")``'s source index (``ops.image.nearest_index``)."""
    for dim, n in ((2, target_hw[0]), (3, target_hw[1])):
        m = x.shape[dim]
        if n != m:
            x = x.index_select(dim, nearest_index(m, n, x.device))
    return x


class UpsampleConv(nn.Module):
    """Nearest resize to ``target_hw``, then a ``ConvBlock``: the decoder's
    stand-in for a transposed conv (Flax: ``ConvBlock_0``)."""

    def __init__(self, in_channels: int, features: int, target_hw: Tuple[int, int],
                 norm: str = "group", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.target_hw = tuple(target_hw)
        self.block = ConvBlock(in_channels, features, 3, 1, 1, norm=norm, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(resize_nearest(x, self.target_hw))
