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
act (Flax's ``deterministic=True``). ``cfg.sequence_parallel`` routes each
block's attention through the ring over ``cfg.sequence_axis`` while such a
mesh is live. Pipeline parallelism: ``pp_params`` / ``pp_params_to_canonical``
convert the ``state_dict`` to the stacked layout and back, ``ViViT(cfg,
spec)`` holds one stage's blocks and runs the encoder through
``parallel.pipeline.pipeline_blocks``, ``apply_pipelined`` is the JAX
package's function on a stacked ``state_dict``. Weights come from the Flax
params through ``models.convert``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..core.config import ViViTConfig
from ..parallel import pipeline as pipe
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
    """clips (B, T, H, W, C) → logits (B, num_classes) float32.

    With ``spec`` the encoder is pipeline-parallel over its model axis:
    this rank holds the embedding, the final LayerNorm and the head
    (replicated, as in the JAX package) and its stage's blocks only
    (``blocks.j`` is layer ``stage_layers(...)[j]``), and the blocks run
    through ``parallel.pipeline.pipeline_blocks``; without it (or on a
    mesh with one stage) that is the plain loop over every block.
    ``ValueError`` when the stages do not split the layers or
    ``cfg.sequence_parallel`` also claims the model axis."""

    def __init__(self, cfg: ViViTConfig, spec=None):
        super().__init__()
        if spec is not None:
            check_pipeline_config(cfg)
        self.cfg, self.spec = cfg, spec
        self.layers = pipe.stage_layers(cfg.num_layers, spec)
        self.dtype = getattr(torch, cfg.dtype)
        tt, th, tw = cfg.tubelet_size
        n_tokens = (cfg.num_frames // tt) * (cfg.image_size // th) * (cfg.image_size // tw)
        e = cfg.hidden_size
        self.tubelet = TubeletEmbed(cfg.num_channels, e, cfg.tubelet_size, self.dtype)
        self.pos_embedding = nn.Parameter(torch.zeros(1, n_tokens, e))   # float32
        nn.init.normal_(self.pos_embedding, std=0.02)   # Flax: initializers.normal(0.02)
        self.blocks = nn.ModuleList(
            TransformerBlock(e, cfg.num_heads, cfg.mlp_dim, self.dtype, cfg.dropout,
                             ring_axis=cfg.sequence_axis if cfg.sequence_parallel else None)
            for _ in self.layers)
        self.norm = LayerNorm(e)
        self.head = Linear(e, cfg.num_classes)

    def forward(self, clips: torch.Tensor, generator: Optional[torch.Generator] = None,
                n_micro: Optional[int] = None) -> torch.Tensor:
        """``generator`` draws the dropout masks in ``train()`` mode (needed
        there when ``cfg.dropout`` > 0); ``n_micro``: the pipeline's
        microbatches (``pipeline_blocks``)."""
        x = self.tubelet(clips.to(self.dtype)) + self.pos_embedding.to(self.dtype)
        x = dropout(x, self.cfg.dropout, self.training, generator)

        def stage(h: torch.Tensor) -> torch.Tensor:
            return pipe.scan_blocks(lambda block, z: block(z, generator), self.blocks, h)

        x = pipe.pipeline_blocks(stage, x, self.spec, n_micro=n_micro)
        x = self.norm(x).mean(dim=1)
        return self.head(x.float())

    def load_pp_state_dict(self, params: Dict[str, torch.Tensor]) -> None:
        """Load this stage's part of a pipeline-layout ``state_dict`` (all
        the layers, stacked: ``pp_params``)."""
        mine = pipe.shard_pp_state(self.spec, params)
        n = len(self.layers)
        if any(v.shape[0] != n for k, v in mine.items() if k.startswith(pipe.BLOCKS_KEY + ".")):
            raise ValueError(f"stacked blocks do not split into stages of {n} layers")
        self.load_state_dict(pipe.unstack_blocks(mine, n))

    def pp_state_dict(self) -> Dict[str, torch.Tensor]:
        """This stage's parameters in the pipeline layout (its layers only)."""
        return pipe.stack_blocks(self.state_dict(), len(self.layers))


def pp_params(params: Dict[str, torch.Tensor], cfg: ViViTConfig) -> Dict[str, torch.Tensor]:
    """A ``ViViT`` ``state_dict`` → the pipeline layout: the ``blocks.{i}.*``
    entries stacked into ``blocks.*`` with a leading layer axis."""
    return pipe.stack_blocks(params, cfg.num_layers)


def pp_params_to_canonical(params: Dict[str, torch.Tensor],
                           cfg: ViViTConfig) -> Dict[str, torch.Tensor]:
    """Inverse of ``pp_params``: a pipeline-layout ``state_dict`` loads in
    the canonical ``ViViT`` again."""
    return pipe.unstack_blocks(params, cfg.num_layers)


def check_pipeline_config(cfg: ViViTConfig) -> None:
    """``ValueError`` when ``cfg`` cannot run pipeline-parallel."""
    if cfg.sequence_parallel:
        raise ValueError("pipeline parallelism and sequence_parallel both "
                         "claim the model axis — enable one")


def apply_pipelined(cfg: ViViTConfig, params: Dict[str, torch.Tensor], clips: torch.Tensor,
                    spec, n_micro: Optional[int] = None) -> torch.Tensor:
    """``ViViT.forward`` (eval mode) with the encoder blocks pipeline-parallel
    over ``spec``'s model axis; ``params`` is the ``pp_params`` layout of
    every layer (each rank keeps its stage's), ``clips`` this data rank's
    rows. Logits on every rank of the model axis."""
    check_pipeline_config(cfg)
    with torch.device(clips.device):
        model = ViViT(cfg, spec)
    model.load_pp_state_dict({k: v.to(clips.device) for k, v in params.items()})
    return model.eval()(clips, n_micro=n_micro)


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
