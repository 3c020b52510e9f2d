"""The lipreading expert: AV-HuBERT's video transform, the trainable
conformer encoder and the character seq2seq expert of the GAN's lip loss.

Port of ``lipreading_video_generation_tpu/models/lip_expert.py``:

- ``avhubert_video_transform``: BGR-weighted gray, /255, center crop 88×88,
  (x − 0.421) / 0.165;
- ``ConformerBlock`` (half-step SiLU FFN, the port's pre-LN
  ``TransformerBlock``, a GLU / depthwise-15 / SiLU conv module, half-step
  FFN, LayerNorm) and ``ConformerLipEncoder`` (a 3-D conv stem, spatial mean,
  a projection, a learned position embedding of ``num_frames`` rows,
  conformer blocks): (B, T, 88, 88, 1) → (B, T, E) float32;
- ``expert_loss`` (feature matching), ``encode_transcript`` /
  ``decode_tokens`` (characters → ids, PAD 0, BOS 1), ``DecoderBlock``
  (pre-LN causal self-attention, cross-attention into the encoder's
  features, tanh-GELU FFN), ``LipExpertSeq2Seq`` and ``seq2seq_expert_loss``
  (teacher-forced character cross-entropy).

Attention is ``ops.attention.mha``: on the card the encoder's and the
decoder's causal self-attention are K2 (float32: the CUDA-core route); the
cross-attention (48 queries, T keys) is the plain ``_mha_einsum``, as in
JAX. Random draws come in as tensors: ``seq2seq_expert_loss`` takes the
token-dropout ``keep`` mask. Modules are NCHW / NCTHW inside; parameters
float32, computed in ``dtype``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ..ops import image as image_ops
from ..ops.attention import mha
from ..parallel.mesh import whole_param
from .layers import Conv1d, Conv3d, LayerNorm, Linear, TransformerBlock


def avhubert_video_transform(frames: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) RGB or gray frames on the uint8 scale → (..., 88, 88,
    1) float32, normalised as AV-HuBERT's transform."""
    if frames.shape[-1] == 3:
        frames = image_ops.bgr_to_gray(frames)
    x = frames.to(torch.float32) / 255.0
    return (image_ops.center_crop(x, (88, 88)) - 0.421) / 0.165


class ConformerBlock(nn.Module):
    def __init__(self, features: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        e = features
        self.ff1_norm, self.ff1_in, self.ff1_out = (LayerNorm(e), Linear(e, 4 * e, dtype),
                                                    Linear(4 * e, e, dtype))
        self.attn = TransformerBlock(e, num_heads, 4 * e, dtype)
        self.conv_norm = LayerNorm(e)
        self.conv_pw1 = Conv1d(e, 2 * e, 1, dtype=dtype)
        self.conv_dw = Conv1d(e, e, 15, padding=7, groups=e, dtype=dtype)
        self.conv_pw2 = Conv1d(e, e, 1, dtype=dtype)
        self.ff2_norm, self.ff2_in, self.ff2_out = (LayerNorm(e), Linear(e, 4 * e, dtype),
                                                    Linear(4 * e, e, dtype))
        self.out_norm = LayerNorm(e)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + 0.5 * self.ff1_out(F.silu(self.ff1_in(self.ff1_norm(x))))
        x = self.attn(x)
        h = self.conv_pw1(self.conv_norm(x).transpose(1, 2))
        h = self.conv_pw2(F.silu(self.conv_dw(F.glu(h, dim=1))))
        x = x + h.transpose(1, 2)
        x = x + 0.5 * self.ff2_out(F.silu(self.ff2_in(self.ff2_norm(x))))
        return self.out_norm(x)


class ConformerLipEncoder(nn.Module):
    """(B, T, 88, 88, 1) mouth video → (B, T, embed_dim) float32. The stem
    has ``stem_base``, 2·base and 4·base channels; the position embedding
    has ``num_frames`` rows (Flax sizes it from its first input)."""

    def __init__(self, embed_dim: int = 768, num_layers: int = 6, num_heads: int = 8,
                 stem_base: int = 64, num_frames: int = 5, dtype: torch.dtype = torch.float32):
        super().__init__()
        b = stem_base
        self.dtype = dtype
        self.stem1 = Conv3d(1, b, (5, 7, 7), (1, 2, 2), (2, 3, 3), dtype=dtype)
        self.stem2 = Conv3d(b, 2 * b, (1, 3, 3), (1, 2, 2), (0, 1, 1), dtype=dtype)
        self.stem3 = Conv3d(2 * b, 4 * b, (1, 3, 3), (1, 2, 2), (0, 1, 1), dtype=dtype)
        self.proj = Linear(4 * b, embed_dim, dtype)
        self.pos_embedding = nn.Parameter(0.02 * torch.randn(1, num_frames, embed_dim))
        self.blocks = nn.ModuleList(ConformerBlock(embed_dim, num_heads, dtype)
                                    for _ in range(num_layers))

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        x = video.to(self.dtype).permute(0, 4, 1, 2, 3)           # (B, 1, T, H, W)
        for conv in (self.stem1, self.stem2, self.stem3):
            x = F.relu(conv(x))
        x = self.proj(x.mean(dim=(3, 4)).transpose(1, 2))          # (B, T, E)
        x = x + whole_param(self, "pos_embedding").to(self.dtype)
        for block in self.blocks:
            x = block(x)
        return x.to(torch.float32)

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        return self(video)


def expert_loss(encoder: nn.Module, generated: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Feature matching of a frozen expert: the mean squared distance of its
    features of the generated and (detached) ground-truth windows, (B, T, H,
    W, C) on the uint8 scale."""
    g = encoder.encode(avhubert_video_transform(generated))
    with torch.no_grad():
        t = encoder.encode(avhubert_video_transform(target))
    return torch.mean((g - t) ** 2)


PAD_ID = 0
BOS_ID = 1
_CHARS = " abcdefghijklmnopqrstuvwxyz'"
CHAR_TO_ID = {c: i + 2 for i, c in enumerate(_CHARS)}
VOCAB_SIZE = 2 + len(_CHARS)


def encode_transcript(text: str, max_len: int = 48) -> np.ndarray:
    """Lowercased transcript → (max_len,) int32 character ids, PAD-padded;
    unknown characters are dropped."""
    ids = [CHAR_TO_ID[c] for c in text.lower() if c in CHAR_TO_ID][:max_len]
    out = np.full((max_len,), PAD_ID, np.int32)
    out[: len(ids)] = ids
    return out


def decode_tokens(tokens) -> str:
    inv = {v: k for k, v in CHAR_TO_ID.items()}
    return "".join(inv.get(int(t), "") for t in tokens if int(t) > 1)


class DecoderBlock(nn.Module):
    """Pre-LN decoder block: causal self-attention over the tokens,
    cross-attention into the lip features, tanh-GELU FFN."""

    def __init__(self, features: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        e = features
        self.num_heads = num_heads
        self.norm1, self.self_qkv, self.self_proj = (LayerNorm(e), Linear(e, 3 * e, dtype),
                                                     Linear(e, e, dtype))
        self.norm2, self.cross_q, self.cross_kv, self.cross_proj = (
            LayerNorm(e), Linear(e, e, dtype), Linear(e, 2 * e, dtype), Linear(e, e, dtype))
        self.norm3, self.fc1, self.fc2 = LayerNorm(e), Linear(e, 4 * e, dtype), Linear(4 * e, e,
                                                                                       dtype)

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        q, k, v = self.self_qkv(self.norm1(x)).chunk(3, dim=-1)
        x = x + self.self_proj(mha(q, k, v, self.num_heads, causal=True))
        k, v = self.cross_kv(memory).chunk(2, dim=-1)
        x = x + self.cross_proj(mha(self.cross_q(self.norm2(x)), k, v, self.num_heads))
        return x + self.fc2(F.gelu(self.fc1(self.norm3(x)), approximate="tanh"))


class LipExpertSeq2Seq(nn.Module):
    """Conformer lip encoder + character transformer decoder: ``encode``
    gives (B, T, E) features (the feature-matching path), the forward (B, L,
    VOCAB_SIZE) float32 next-character logits under teacher forcing."""

    def __init__(self, embed_dim: int = 256, enc_layers: int = 2, dec_layers: int = 2,
                 num_heads: int = 4, max_text_len: int = 48, stem_base: int = 64,
                 num_frames: int = 5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder = ConformerLipEncoder(embed_dim, enc_layers, num_heads, stem_base,
                                           num_frames, dtype)
        self.tok_embed = nn.Embedding(VOCAB_SIZE, embed_dim)
        nn.init.normal_(self.tok_embed.weight, std=embed_dim ** -0.5)   # Flax Embed's variance
        self.dec_pos = nn.Parameter(0.02 * torch.randn(1, max_text_len, embed_dim))
        self.blocks = nn.ModuleList(DecoderBlock(embed_dim, num_heads, dtype)
                                    for _ in range(dec_layers))
        self.out_norm = LayerNorm(embed_dim)
        self.head = Linear(embed_dim, VOCAB_SIZE, dtype)

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        return self.encoder(video)

    def forward(self, video: torch.Tensor, tokens_in: torch.Tensor) -> torch.Tensor:
        memory = self.encoder(video)
        x = F.embedding(tokens_in.long(), whole_param(self.tok_embed, "weight")).to(self.dtype)
        x = x + whole_param(self, "dec_pos")[:, : x.shape[1]].to(self.dtype)
        for block in self.blocks:
            x = block(x, memory)
        return self.head(self.out_norm(x)).to(torch.float32)


def seq2seq_expert_loss(model: LipExpertSeq2Seq, video_rgb: torch.Tensor, tokens: torch.Tensor,
                        keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Teacher-forced character cross-entropy of ``model`` reading
    ``video_rgb`` (B, T, H, W, C) on the uint8 scale against ``tokens`` (B,
    L), over the non-PAD targets. ``keep`` (bool, (B, L)), pretraining's
    token dropout, PADs the teacher-forced input characters where it is
    false (BOS is always kept); without it nothing is dropped, as in the
    GAN's criterion."""
    video = avhubert_video_transform(video_rgb)
    tokens = tokens.to(video.device, torch.long)
    bos = torch.full((tokens.shape[0], 1), BOS_ID, dtype=torch.long, device=tokens.device)
    tokens_in = torch.cat([bos, tokens[:, :-1]], dim=1)
    if keep is not None:
        keep = keep.to(tokens.device, torch.bool) | (tokens_in == BOS_ID)
        tokens_in = torch.where(keep, tokens_in, PAD_ID)
    logp = torch.log_softmax(model(video, tokens_in), dim=-1)
    nll = -torch.gather(logp, -1, tokens[..., None])[..., 0]
    mask = (tokens != PAD_ID).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
