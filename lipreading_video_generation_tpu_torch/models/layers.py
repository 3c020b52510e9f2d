"""Building blocks of the port, with Flax numerics.

Port of ``lipreading_video_generation_tpu/models/layers.py``'s ``MLP`` and
``TransformerBlock``, plus the parameter-holding layers every model of the
port is built from. What keeps them equal to the Flax modules:

- ``Linear``, ``Conv1d``, ``Conv2d`` keep their parameters in float32 and
  cast input, weight and bias to their compute dtype (bf16 by default)
  inside ``forward``, as Flax's ``Dense``/``Conv(dtype=...)`` with float32
  ``param_dtype`` do: an optimizer step updates the float32 master copy.
  Their own init is Flax's: lecun-normal kernels, zero biases.
- ``LayerNorm``: eps 1e-6, statistics in float32 with the fast variance
  E[x²]−E[x]² (clipped at 0), float32 scale and bias, output cast to the
  compute dtype (flax/linen/normalization.py).
- ``nn.gelu`` is the tanh approximation.

Ring attention (``ring_axis``) needs a device mesh and is not ported; the
TP activation constraints of the JAX modules are no-ops off-mesh and are
dropped.
"""
from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.attention import mha


def _flax_init(layer: nn.Module) -> None:
    """Flax's default init: lecun-normal kernel (a normal truncated at two
    standard deviations, rescaled to variance 1/fan_in), zero bias."""
    fan_in = layer.weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std)
    nn.init.zeros_(layer.bias)


class Linear(nn.Linear):
    """Dense layer: float32 params, computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def reset_parameters(self) -> None:
        _flax_init(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv1d(_CastConv, nn.Conv1d):
    """1-D conv over (B, C, W)."""


class Conv2d(_CastConv, nn.Conv2d):
    """2-D conv over (B, C, H, W)."""


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


class MLP(nn.Module):
    """Dense → tanh-GELU → Dense (``Dense_0``/``Dense_1`` in Flax)."""

    def __init__(self, features: int, hidden: int, out: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Linear(features, hidden, dtype)
        self.fc2 = Linear(hidden, out, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class TransformerBlock(nn.Module):
    """Pre-LN encoder block over (B, S, E): fused qkv projection, ``mha``
    (the small-MHA kernel K2 on CUDA), output projection, MLP."""

    def __init__(self, features: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype = torch.float32, ring_axis: str = None):
        super().__init__()
        if ring_axis is not None:
            raise NotImplementedError(
                "TransformerBlock: ring attention is not ported yet "
                "(ROADMAP: multi-GPU parallelism)")
        self.num_heads = num_heads
        self.norm1 = LayerNorm(features)
        self.qkv = Linear(features, 3 * features, dtype)
        self.proj = Linear(features, features, dtype)
        self.norm2 = LayerNorm(features)
        self.mlp = MLP(features, mlp_dim, features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(self.norm1(x)).chunk(3, dim=-1)
        x = x + self.proj(mha(q, k, v, self.num_heads))
        return x + self.mlp(self.norm2(x))
