"""ViViT word-level lipreading classifier, and the classifier over
per-frame CNN features.

Port of ``lipreading_video_generation_tpu/models/vivit.py``'s
``TubeletEmbed`` and ``ViViT``: tubelet embedding (a block reshape and one
matmul), learned position embedding, dropout, pre-LN encoder blocks, final
LayerNorm, mean-pool over tokens, float32 head. Input: (B, T, H, W, C)
normalised float clips (NTHWC, as in the JAX package). And of its
``FeatureTransformer``: a learned per-frame position embedding over
(B, T, num_features) DenseNet features, encoder blocks, a max over time,
dropout, float32 head.

In ``train()`` mode dropout (``cfg.dropout``; 0.0 in the default config)
acts after the position embedding and inside each block, with masks drawn
from the generator passed to ``forward``; in ``eval()`` mode it does not
act (Flax's ``deterministic=True``). Pipeline parallelism needs several
GPUs and is not ported. Weights come from the Flax params through
``models.convert``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..core.config import ViViTConfig
from .layers import LayerNorm, Linear, TransformerBlock, dropout


class TubeletEmbed(nn.Module):
    """(B, T, H, W, C) → (B, N_tokens, hidden). Tokens are ordered
    (nt, nh, nw) and each token's features (tt, th, tw, C), as in Flax."""

    def __init__(self, num_channels: int, hidden_size: int,
                 tubelet: Tuple[int, int, int], dtype: torch.dtype):
        super().__init__()
        self.tubelet = tuple(tubelet)
        tt, th, tw = self.tubelet
        self.proj = Linear(tt * th * tw * num_channels, hidden_size, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tt, th, tw = self.tubelet
        b, t, h, w, c = x.shape
        if t % tt or h % th or w % tw:
            raise ValueError(f"tubelet {self.tubelet} must tile input {tuple(x.shape)}")
        x = x.reshape(b, t // tt, tt, h // th, th, w // tw, tw, c)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
        x = x.reshape(b, (t // tt) * (h // th) * (w // tw), tt * th * tw * c)
        return self.proj(x)


class ViViT(nn.Module):
    def __init__(self, cfg: ViViTConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        tt, th, tw = cfg.tubelet_size
        n_tokens = (cfg.num_frames // tt) * (cfg.image_size // th) * (cfg.image_size // tw)
        e = cfg.hidden_size
        self.tubelet = TubeletEmbed(cfg.num_channels, e, cfg.tubelet_size, self.dtype)
        self.pos_embedding = nn.Parameter(torch.zeros(1, n_tokens, e))   # float32
        nn.init.normal_(self.pos_embedding, std=0.02)   # Flax: initializers.normal(0.02)
        self.blocks = nn.ModuleList(
            TransformerBlock(e, cfg.num_heads, cfg.mlp_dim, self.dtype, cfg.dropout)
            for _ in range(cfg.num_layers))
        self.norm = LayerNorm(e)
        self.head = Linear(e, cfg.num_classes)

    def forward(self, clips: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """clips (B, T, H, W, C) → logits (B, num_classes) float32.
        ``generator`` draws the dropout masks in ``train()`` mode (needed
        there when ``cfg.dropout`` > 0)."""
        x = self.tubelet(clips.to(self.dtype)) + self.pos_embedding.to(self.dtype)
        x = dropout(x, self.cfg.dropout, self.training, generator)
        for block in self.blocks:
            x = block(x, generator)
        x = self.norm(x).mean(dim=1)
        return self.head(x.float())


class FeatureTransformer(nn.Module):
    """(B, T, num_features) per-frame features → logits (B, num_classes)
    float32: position embedding, ``num_layers`` ``TransformerBlock``s (MLP
    width ``dense_dim``), the max over time, ``head_dropout``, the head.

    The max over time is ``amax``: its gradient is shared equally among
    tied frames, as JAX's ``max`` shares it (``torch.max(dim)`` would send
    all of it to one index)."""

    def __init__(self, num_classes: int, num_features: int = 1024, max_seq_length: int = 5,
                 dense_dim: int = 4, num_heads: int = 2, num_layers: int = 2,
                 dropout: float = 0.3, head_dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.head_dropout = head_dropout
        self.pos_embedding = nn.Parameter(torch.zeros(1, max_seq_length, num_features))
        nn.init.normal_(self.pos_embedding, std=0.02)   # Flax: initializers.normal(0.02)
        self.blocks = nn.ModuleList(
            TransformerBlock(num_features, num_heads, dense_dim, dtype, dropout)
            for _ in range(num_layers))
        self.head = Linear(num_features, num_classes)

    def forward(self, feats: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the dropout masks in ``train()`` mode (needed
        there when a dropout rate is above 0)."""
        t = feats.shape[1]
        if t != self.pos_embedding.shape[1]:
            raise ValueError(f"FeatureTransformer: {t} frames, the position embedding has "
                             f"{self.pos_embedding.shape[1]}")
        x = feats.to(self.dtype) + self.pos_embedding.to(self.dtype)
        for block in self.blocks:
            x = block(x, generator)
        x = dropout(x.amax(dim=1), self.head_dropout, self.training, generator)
        return self.head(x.float())
