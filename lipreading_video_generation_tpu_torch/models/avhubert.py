"""AV-HuBERT video encoder: the frozen lipreading expert's weight-port path.

Port of ``lipreading_video_generation_tpu/models/avhubert.py``: the video
path of the public AV-HuBERT model,

- frontend: a 3-D conv stem (5x7x7, temporal stride 1, spatial /2, no bias)
  with a folded BatchNorm (``_Affine``), a per-channel PReLU and a 1x3x3
  max-pool /2 (padding −inf), then a per-frame ResNet-18 trunk (PReLU
  variant, ``_BasicBlock``) averaged over space to 8·base features;
- modality fuse: the video features projected to the encoder width and
  concatenated after a zero audio slot ([zeros, video], fairseq's order for
  a video-only call), LayerNorm, ``post_extract_proj``;
- fairseq's post-norm encoder: a grouped conv positional embedding (kernel
  128, 16 groups, SamePad trims the last step of an even kernel, exact
  GELU) added to the input, an input LayerNorm, then N post-norm layers
  (``_EncoderLayer``, which ``models/wav2vec2`` reuses); their attention is
  ``ops.attention.mha`` (K2 on the card: float32 by the CUDA-core route).

Modules are NCHW / NCTHW inside; the input is (B, T, 88, 88, 1) from
``lip_expert.avhubert_video_transform`` and the output (B, T, embed_dim)
float32. Parameters are float32, computed in ``dtype``. The names of
``state_dict`` are the Flax module's (``frontend_conv``, ``layer1_block0.bn1``,
``enc_layer_0.q_proj`` …), so ``convert.avhubert_state_dict_from_flax`` only
transposes.

``convert_avhubert_state_dict`` reads a fairseq ``state["model"]``: it folds
every BatchNorm into a scale and bias (eps 1e-5), composes the weight-normed
positional conv as g·v/‖v‖ in float64 (the norm over dims 0 and 1), and
raises on a key outside the known skip set (audio frontend, decoder,
pretraining heads), so layout drift fails at port time.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ..ops.attention import mha
from .layers import Conv1d, Conv2d, Conv3d, LayerNorm, Linear


def _channels(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-channel vector shaped to broadcast over (B, C, ...)."""
    return t.reshape((1, -1) + (1,) * (x.ndim - 2))


class _Affine(nn.Module):
    """Per-channel scale and bias: a BatchNorm with its running statistics
    folded in at conversion time."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * _channels(self.scale.to(self.dtype), x) + _channels(self.bias.to(self.dtype), x)


class _ChannelPReLU(nn.Module):
    """``nn.PReLU(num_parameters=C)``: a learned negative slope a channel."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((features,), 0.25))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, _channels(self.alpha.to(self.dtype), x) * x)


class _BasicBlock(nn.Module):
    """ResNet-18 basic block, PReLU variant, folded BatchNorms."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_features, features, 3, stride, 1, bias=False, dtype=dtype)
        self.bn1 = _Affine(features, dtype)
        self.relu1 = _ChannelPReLU(features, dtype)
        self.conv2 = Conv2d(features, features, 3, 1, 1, bias=False, dtype=dtype)
        self.bn2 = _Affine(features, dtype)
        self.down = stride != 1 or in_features != features
        if self.down:
            self.down_conv = Conv2d(in_features, features, 1, stride, 0, bias=False, dtype=dtype)
            self.down_bn = _Affine(features, dtype)
        self.relu2 = _ChannelPReLU(features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.relu1(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        residual = self.down_bn(self.down_conv(x)) if self.down else x
        return self.relu2(h + residual)


class _EncoderLayer(nn.Module):
    """fairseq's post-norm transformer layer (``layer_norm_first=False``):
    residual then LayerNorm after self-attention and after the exact-GELU
    FFN."""

    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Linear(embed_dim, embed_dim, dtype))
        self.self_attn_ln = LayerNorm(embed_dim)
        self.fc1 = Linear(embed_dim, ffn_dim, dtype)
        self.fc2 = Linear(ffn_dim, embed_dim, dtype)
        self.final_ln = LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = self.out_proj(mha(self.q_proj(x), self.k_proj(x), self.v_proj(x),
                                 self.num_heads))
        x = self.self_attn_ln(x + attn)
        h = self.fc2(F.gelu(self.fc1(x)))
        return self.final_ln(x + h)


def pos_conv_embed(conv: Conv1d, x: torch.Tensor) -> torch.Tensor:
    """fairseq's conv positional embedding of (B, T, E): the grouped conv
    (padding kernel // 2), SamePad's trim of the last step for an even
    kernel, exact GELU."""
    pos = conv(x.transpose(1, 2))
    if conv.kernel_size[0] % 2 == 0:
        pos = pos[..., :-1]
    return F.gelu(pos).transpose(1, 2)


class AVHubertVideoEncoder(nn.Module):
    """(B, T, 88, 88, 1) transformed mouth video → (B, T, embed_dim).

    Defaults are AV-HuBERT *base* (12 layers, 768 wide, 12 heads, FFN 3072,
    ResNet base 64)."""

    def __init__(self, embed_dim: int = 768, num_layers: int = 12, num_heads: int = 12,
                 ffn_dim: int = 3072, resnet_base: int = 64, pos_conv_kernel: int = 128,
                 pos_conv_groups: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        base = resnet_base
        self.dtype = dtype
        self.frontend_conv = Conv3d(1, base, (5, 7, 7), (1, 2, 2), (2, 3, 3), bias=False,
                                    dtype=dtype)
        self.frontend_bn = _Affine(base, dtype)
        self.frontend_prelu = _ChannelPReLU(base, dtype)
        self.block_names: List[str] = []
        c_in = base
        for li, (feats, stride) in enumerate([(base, 1), (2 * base, 2), (4 * base, 2),
                                              (8 * base, 2)], start=1):
            for bi in range(2):
                name = f"layer{li}_block{bi}"
                self.add_module(name, _BasicBlock(c_in, feats, stride if bi == 0 else 1,
                                                  dtype))
                self.block_names.append(name)
                c_in = feats
        self.video_proj = Linear(8 * base, embed_dim, dtype)
        self.fuse_ln = LayerNorm(2 * embed_dim)
        self.post_extract_proj = Linear(2 * embed_dim, embed_dim, dtype)
        self.pos_conv = Conv1d(embed_dim, embed_dim, pos_conv_kernel,
                               padding=pos_conv_kernel // 2, groups=pos_conv_groups, dtype=dtype)
        self.encoder_ln = LayerNorm(embed_dim)
        self.layers = [f"enc_layer_{i}" for i in range(num_layers)]
        for name in self.layers:
            self.add_module(name, _EncoderLayer(embed_dim, num_heads, ffn_dim, dtype))

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        if video.ndim != 5:
            raise ValueError(f"expected (B, T, H, W, 1) video, got {tuple(video.shape)}")
        b, t = video.shape[:2]
        x = video.to(self.dtype).permute(0, 4, 1, 2, 3)               # (B, 1, T, H, W)
        x = self.frontend_prelu(self.frontend_bn(self.frontend_conv(x)))
        x = F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))          # pads with −inf
        x = x.transpose(1, 2).reshape((b * t,) + x.shape[1:2] + x.shape[3:])
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3)).reshape(b, t, -1)                      # (B, T, 8·base)
        v = self.video_proj(x)
        x = self.post_extract_proj(self.fuse_ln(torch.cat([torch.zeros_like(v), v], dim=-1)))
        x = self.encoder_ln(x + pos_conv_embed(self.pos_conv, x))
        for name in self.layers:
            x = getattr(self, name)(x)
        return x.to(torch.float32)

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        """The lip-expert protocol's name for the forward (as
        ``lip_expert.ConformerLipEncoder.encode``)."""
        return self(video)


# ---------------------------------------------------------------------------
# fairseq state_dict → the port's state_dict
# ---------------------------------------------------------------------------

_BN_EPS = 1e-5
_BN_KEYS = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")


def _np(sd: Dict[str, Any], key: str, dtype=None) -> np.ndarray:
    return np.asarray(sd[key], dtype)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _folded_bn(sd: Dict[str, Any], prefix: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """BatchNorm (weight, bias, running stats) → (scale, bias), in float64."""
    scale = _np(sd, f"{prefix}.weight", np.float64) / np.sqrt(
        _np(sd, f"{prefix}.running_var", np.float64) + _BN_EPS)
    bias = _np(sd, f"{prefix}.bias", np.float64) - _np(sd, f"{prefix}.running_mean",
                                                       np.float64) * scale
    return _t(scale), _t(bias)


def _linear(out: Dict[str, torch.Tensor], name: str, sd: Dict[str, Any], prefix: str) -> None:
    out[f"{name}.weight"] = _t(sd[f"{prefix}.weight"])
    if f"{prefix}.bias" in sd:
        out[f"{name}.bias"] = _t(sd[f"{prefix}.bias"])


def _weight_norm(g, v) -> torch.Tensor:
    """g·v/‖v‖ in float64, the norm over dims (0, 1) (torch's
    ``weight_norm(dim=2)``: one norm per kernel position)."""
    g, v = np.asarray(g, np.float64), np.asarray(v, np.float64)
    return _t(g * v / np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True)))


def infer_config(sd: Dict[str, Any], num_heads: Optional[int] = None,
                 pos_conv_groups: Optional[int] = None) -> Dict[str, int]:
    """The architecture read off the checkpoint; the head count (default
    embed_dim // 64) and the conv groups (default 16) are not in the
    shapes."""
    embed_dim = int(_np(sd, "post_extract_proj.weight").shape[0])
    layers = 0
    while f"encoder.layers.{layers}.fc1.weight" in sd:
        layers += 1
    if layers == 0:
        raise ValueError("no encoder.layers.* keys — not an AV-HuBERT state_dict")
    return {
        "embed_dim": embed_dim,
        "num_layers": layers,
        "num_heads": int(num_heads or max(1, embed_dim // 64)),
        "ffn_dim": int(_np(sd, "encoder.layers.0.fc1.weight").shape[0]),
        "resnet_base": int(_np(sd, "feature_extractor_video.resnet.frontend3D.0.weight")
                           .shape[0]),
        "pos_conv_kernel": int(_np(sd, "encoder.pos_conv.0.weight_v").shape[-1]),
        "pos_conv_groups": int(pos_conv_groups or 16),
    }


_EXPECTED_SKIPS = ("feature_extractor_audio.", "decoder.", "final_proj.", "mask_emb",
                   "label_embs_concat")


def convert_avhubert_state_dict(
    sd: Dict[str, Any],
) -> Tuple[Dict[str, torch.Tensor], Dict[str, int], List[str]]:
    """fairseq AV-HuBERT ``state["model"]`` (arrays or tensors) → (the
    port's float32 ``state_dict``, config, skipped keys). ``ValueError`` on
    a key outside the expected skips (layout drift); a missing key raises
    ``KeyError``."""
    sd = {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else v) for k, v in sd.items()}
    cfg = infer_config(sd)
    out: Dict[str, torch.Tensor] = {}
    consumed: set = set()

    def take(*keys: str) -> None:
        consumed.update(k for k in keys if k in sd)

    def bn(name: str, prefix: str) -> None:
        out[f"{name}.scale"], out[f"{name}.bias"] = _folded_bn(sd, prefix)
        take(*(f"{prefix}.{s}" for s in _BN_KEYS))

    vp = "feature_extractor_video.resnet"
    out["frontend_conv.weight"] = _t(sd[f"{vp}.frontend3D.0.weight"])
    bn("frontend_bn", f"{vp}.frontend3D.1")
    out["frontend_prelu.alpha"] = _t(sd[f"{vp}.frontend3D.2.weight"])
    take(f"{vp}.frontend3D.0.weight", f"{vp}.frontend3D.2.weight")
    for li in range(1, 5):
        for bi in range(2):
            tp, name = f"{vp}.trunk.layer{li}.{bi}", f"layer{li}_block{bi}"
            for conv in ("conv1", "conv2"):
                out[f"{name}.{conv}.weight"] = _t(sd[f"{tp}.{conv}.weight"])
            for relu in ("relu1", "relu2"):
                out[f"{name}.{relu}.alpha"] = _t(sd[f"{tp}.{relu}.weight"])
            take(*(f"{tp}.{m}.weight" for m in ("conv1", "conv2", "relu1", "relu2")))
            bn(f"{name}.bn1", f"{tp}.bn1")
            bn(f"{name}.bn2", f"{tp}.bn2")
            if f"{tp}.downsample.0.weight" in sd:
                out[f"{name}.down_conv.weight"] = _t(sd[f"{tp}.downsample.0.weight"])
                take(f"{tp}.downsample.0.weight")
                bn(f"{name}.down_bn", f"{tp}.downsample.1")

    for name, prefix in (("video_proj", "feature_extractor_video.proj"),
                         ("fuse_ln", "layer_norm"), ("post_extract_proj", "post_extract_proj"),
                         ("encoder_ln", "encoder.layer_norm")):
        _linear(out, name, sd, prefix)
        take(f"{prefix}.weight", f"{prefix}.bias")
    pc = "encoder.pos_conv.0"
    out["pos_conv.weight"] = _weight_norm(sd[f"{pc}.weight_g"], sd[f"{pc}.weight_v"])
    out["pos_conv.bias"] = _t(sd[f"{pc}.bias"])
    take(f"{pc}.weight_g", f"{pc}.weight_v", f"{pc}.bias")

    for i in range(cfg["num_layers"]):
        lp, name = f"encoder.layers.{i}", f"enc_layer_{i}"
        pairs = [(f"{p}_proj", f"{lp}.self_attn.{p}_proj") for p in ("q", "k", "v", "out")]
        pairs += [("self_attn_ln", f"{lp}.self_attn_layer_norm"), ("fc1", f"{lp}.fc1"),
                  ("fc2", f"{lp}.fc2"), ("final_ln", f"{lp}.final_layer_norm")]
        for sub, prefix in pairs:
            _linear(out, f"{name}.{sub}", sd, prefix)
            take(f"{prefix}.weight", f"{prefix}.bias")

    skipped = sorted(k for k in sd if k not in consumed)
    unexpected = [k for k in skipped if not k.startswith(_EXPECTED_SKIPS)]
    if unexpected:
        raise ValueError("unrecognized AV-HuBERT checkpoint keys (layout drift?): "
                         + ", ".join(unexpected[:20]))
    return out, cfg, skipped
