"""Native audio feature encoder of the diffusion model.

Port of ``lipreading_video_generation_tpu/models/audio_encoder.py``'s
``AudioFeatureEncoder``: raw waveform (B, samples) → log-mel (B, 80, T) →
two 1-D convs over time (5 taps stride 2, then 3 taps), each followed by
tanh-GELU → LayerNorm → learned position embedding → 4 pre-LN
``TransformerBlock``s (8 heads; their attention is the small-MHA kernel K2 on
CUDA) → final LayerNorm → (B, T', embed_dim). At 4000 samples T = 21 mel
frames and T' = 11 tokens.

The Flax module sizes its position embedding from the first input it sees;
here the number of samples is a constructor argument.
"""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from ..core.config import AudioConfig
from ..ops import audio as audio_ops
from ..parallel.mesh import whole_param
from .layers import Conv1d, LayerNorm, TransformerBlock


def num_tokens(num_samples: int, audio_cfg: AudioConfig = AudioConfig()) -> int:
    """Tokens the encoder gives for ``num_samples``: mel frames
    1 + samples//hop, halved (rounding up) by the stride-2 conv."""
    frames = 1 + num_samples // audio_cfg.hop_size
    return (frames - 1) // 2 + 1


class AudioFeatureEncoder(nn.Module):
    """Raw waveform (B, samples) → frame features (B, T', embed_dim)."""

    def __init__(self, num_samples: int, embed_dim: int = 768, num_layers: int = 4,
                 num_heads: int = 8, audio_cfg: AudioConfig = AudioConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.audio_cfg = audio_cfg
        self.dtype = dtype
        self.conv1 = Conv1d(audio_cfg.num_mels, embed_dim // 2, 5, stride=2, padding=2,
                            dtype=dtype)
        self.conv2 = Conv1d(embed_dim // 2, embed_dim, 3, stride=1, padding=1, dtype=dtype)
        self.norm_in = LayerNorm(embed_dim)
        self.pos_embedding = nn.Parameter(   # Flax: normal(0.02), float32
            0.02 * torch.randn(1, num_tokens(num_samples, audio_cfg), embed_dim))
        self.blocks = nn.ModuleList(
            TransformerBlock(embed_dim, num_heads, 4 * embed_dim, dtype)
            for _ in range(num_layers))
        self.norm_out = LayerNorm(embed_dim)

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        mel = audio_ops.melspectrogram(wave.float(), self.audio_cfg)   # (B, 80, T)
        x = F.gelu(self.conv1(mel.to(self.dtype)), approximate="tanh")
        x = F.gelu(self.conv2(x), approximate="tanh").transpose(1, 2)  # (B, T', E)
        x = self.norm_in(x) + whole_param(self, "pos_embedding").to(self.dtype)
        for block in self.blocks:
            x = block(x)
        return self.norm_out(x)
