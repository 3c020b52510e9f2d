"""Transformer building blocks of the port (inference), with Flax numerics.

Port of ``lipreading_video_generation_tpu/models/layers.py``'s ``MLP`` and
``TransformerBlock``. What keeps them equal to the Flax modules:

- ``LayerNorm``: eps 1e-6, statistics in float32 with the fast variance
  E[x²]−E[x]² (clipped at 0), float32 scale and bias, output cast to the
  compute dtype (flax/linen/normalization.py).
- ``nn.gelu`` is the tanh approximation.
- Dense layers compute in the module dtype (bf16 by default): input and
  weights are both in that dtype.

Ring attention (``ring_axis``) needs a device mesh and is not ported; the
TP activation constraints of the JAX modules are no-ops off-mesh and are
dropped.
"""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.attention import mha


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
        self.fc1 = nn.Linear(features, hidden, dtype=dtype)
        self.fc2 = nn.Linear(hidden, out, dtype=dtype)

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
        self.qkv = nn.Linear(features, 3 * features, dtype=dtype)
        self.proj = nn.Linear(features, features, dtype=dtype)
        self.norm2 = LayerNorm(features)
        self.mlp = MLP(features, mlp_dim, features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(self.norm1(x)).chunk(3, dim=-1)
        x = x + self.proj(mha(q, k, v, self.num_heads))
        return x + self.mlp(self.norm2(x))
