"""Audio+image-conditioned diffusion U-Net, in NCHW.

Port of ``lipreading_video_generation_tpu/models/unet_audio.py``'s
``UNetAudio``: the noisy frame's channels,
the projected audio features broadcast over H×W (mean over time →
Linear+ReLU, float32) and the condition frame through a float32 1×1 conv
are concatenated on the channel axis and denoised by ``UNetModel``. The
audio encoder is the native ``AudioFeatureEncoder`` or, with
``cfg.audio_encoder == "wav2vec2"``, ``models.wav2vec2.Wav2Vec2Encoder`` at
the ``w2v_*`` sizes (``models/ports.graft_wav2vec2_into_diffusion`` puts
ported weights into it); ``encode_condition`` takes the mean over its T′
frames either way.
Conditioning is split as in JAX: ``encode_condition`` runs once per
request, ``denoise`` once per sampling step. In ``train()`` mode the U-Net
applies ``cfg.dropout``, with masks drawn from the ``generator`` passed to
``denoise``/``forward`` (the audio encoder has no dropout, as in JAX).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from ..core.config import DiffusionConfig
from ..ops.image import resize
from .audio_encoder import AudioFeatureEncoder
from .layers import Conv2d, Linear
from .unet import UNetModel


class UNetAudio(nn.Module):
    def __init__(self, cfg: DiffusionConfig):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.dtype)
        if cfg.audio_encoder == "wav2vec2":
            from .wav2vec2 import Wav2Vec2Encoder

            self.audio_encoder = Wav2Vec2Encoder(
                cfg.audio_embed_dim, cfg.w2v_num_layers, cfg.w2v_num_heads, cfg.w2v_ffn_dim,
                cfg.w2v_conv_dim, cfg.w2v_conv_kernel, cfg.w2v_conv_stride,
                cfg.w2v_pos_conv_kernel, cfg.w2v_pos_conv_groups, dtype=dtype)
        else:
            self.audio_encoder = AudioFeatureEncoder(cfg.audio_samples, cfg.audio_embed_dim,
                                                     dtype=dtype)
        self.audio_proj = Linear(cfg.audio_embed_dim, cfg.audio_proj_dim)
        self.im_cond_conv = Conv2d(cfg.im_channels, cfg.im_cond_channels, 1)
        self.unet = UNetModel(
            in_channels=cfg.im_channels + cfg.audio_proj_dim + cfg.im_cond_channels,
            out_channels=cfg.im_channels, base_channels=cfg.base_channels,
            channel_mult=cfg.channel_mult, num_res_blocks=cfg.num_res_blocks,
            attention_resolutions=cfg.attention_resolutions, num_heads=cfg.num_heads,
            time_embed_dim=cfg.time_embed_dim, dtype=dtype, dropout=cfg.dropout,
            remat=cfg.remat)

    def encode_condition(self, audio_wave: torch.Tensor, cond_image: torch.Tensor) -> torch.Tensor:
        """(B, samples) waveform + (B, C, h, w) condition frame →
        (B, audio_proj + im_cond, H, W) float32 conditioning map."""
        size = self.cfg.im_size
        a = self.audio_encoder(audio_wave).to(torch.float32).mean(dim=1)
        a = F.relu(self.audio_proj(a))
        a_map = a[:, :, None, None].expand(-1, -1, size, size)
        img = cond_image.to(torch.float32)
        if img.shape[-2:] != (size, size):   # bilinear, antialiased (jax.image.resize)
            img = resize(img.permute(0, 2, 3, 1), (size, size)).permute(0, 3, 1, 2)
        return torch.cat([a_map, self.im_cond_conv(img)], dim=1)

    def denoise(self, xt: torch.Tensor, cond_map: torch.Tensor, t: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One ε-prediction: (B, C, H, W) noisy frame + conditioning map + (B,) t."""
        return self.unet(torch.cat([xt, cond_map.to(xt.dtype)], dim=1), t, generator)

    def forward(self, xt: torch.Tensor, cond_image: torch.Tensor, audio_wave: torch.Tensor,
                t: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.denoise(xt, self.encode_condition(audio_wave, cond_image), t, generator)
