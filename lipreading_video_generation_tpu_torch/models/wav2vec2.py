"""wav2vec2 speech encoder: the reference's pretrained diffusion audio
conditioning (``facebook/wav2vec2-base-960h``).

Port of ``lipreading_video_generation_tpu/models/wav2vec2.py``'s
``Wav2Vec2Encoder`` (HF ``Wav2Vec2Model``, base layout, ``feat_extract_norm=
"group"``): seven no-bias ``VALID`` 1-D convs (512 channels, kernels
10,3,3,3,3,2,2, strides 5,2,2,2,2,2,2), a per-channel GroupNorm after the
first only, exact GELU after each; LayerNorm(512) → Linear(512 → 768); the
grouped conv positional embedding (kernel 128, 16 groups, SamePad, GELU)
added to the input, an input LayerNorm, then N post-norm layers
(``avhubert._EncoderLayer``; their attention is ``ops.attention.mha``: K2
on the card up to 128² scores, bf16 by the tensor-core route at 4,000
samples, T′ = 12; K3 above, e.g. T′ = 511 on a 10.24 s wave). Norm epsilons
are the JAX package's (1e-6, where HF uses 1e-5). Parameters are float32,
computed in ``dtype``; names are the Flax module's.

The converter reads an HF state dict: a bare ``Wav2Vec2Model`` or the
``Wav2Vec2ForCTC`` wrapper (``wav2vec2.``-prefixed, plus ``lm_head``), with
the weight-normed positional conv in either serialisation (``weight_g`` /
``weight_v`` or ``parametrizations.weight.original0/1``), composed as
g·v/‖v‖ in float64. ``hf_key_map`` is the one key list both the converter
and ``selftest.make_wav2vec2_selftest_pth`` use.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from .avhubert import _EncoderLayer, _t, _weight_norm, pos_conv_embed
from .layers import Conv1d, GroupNorm, LayerNorm, Linear

BASE_CONV_DIM = (512,) * 7
BASE_CONV_KERNEL = (10, 3, 3, 3, 3, 2, 2)
BASE_CONV_STRIDE = (5, 2, 2, 2, 2, 2, 2)


def num_frames(num_samples: int, conv_kernel: Sequence[int] = BASE_CONV_KERNEL,
               conv_stride: Sequence[int] = BASE_CONV_STRIDE) -> int:
    """T′ the feature extractor gives for ``num_samples`` (``VALID`` convs):
    12 at 4,000, 511 at 163,840."""
    n = num_samples
    for k, s in zip(conv_kernel, conv_stride):
        n = (n - k) // s + 1
    return n


class Wav2Vec2Encoder(nn.Module):
    """Raw waveform (B, samples) → frame features (B, T′, embed_dim) float32.

    Defaults are wav2vec2-*base*. Inputs are zero-mean, unit-variance per
    utterance (``pipelines/train_diffusion.normalize_audio``)."""

    def __init__(self, embed_dim: int = 768, num_layers: int = 12, num_heads: int = 12,
                 ffn_dim: int = 3072, conv_dim: Sequence[int] = BASE_CONV_DIM,
                 conv_kernel: Sequence[int] = BASE_CONV_KERNEL,
                 conv_stride: Sequence[int] = BASE_CONV_STRIDE, pos_conv_kernel: int = 128,
                 pos_conv_groups: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.n_conv = len(conv_dim)
        c_in = 1
        for i, (c, k, s) in enumerate(zip(conv_dim, conv_kernel, conv_stride)):
            self.add_module(f"conv_{i}", Conv1d(c_in, c, k, s, bias=False, dtype=dtype))
            c_in = c
        self.conv_gn = GroupNorm(conv_dim[0], num_groups=conv_dim[0])
        self.proj_ln = LayerNorm(conv_dim[-1])
        self.proj = Linear(conv_dim[-1], embed_dim, dtype)
        self.pos_conv = Conv1d(embed_dim, embed_dim, pos_conv_kernel,
                               padding=pos_conv_kernel // 2, groups=pos_conv_groups, dtype=dtype)
        self.encoder_ln = LayerNorm(embed_dim)
        self.layers = [f"enc_layer_{i}" for i in range(num_layers)]
        for name in self.layers:
            self.add_module(name, _EncoderLayer(embed_dim, num_heads, ffn_dim, dtype))

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        if wave.ndim != 2:
            raise ValueError(f"expected (B, samples) waveform, got {tuple(wave.shape)}")
        x = wave[:, None, :].to(self.dtype)
        for i in range(self.n_conv):
            x = getattr(self, f"conv_{i}")(x)
            if i == 0:
                x = self.conv_gn(x).to(self.dtype)
            x = F.gelu(x)
        x = self.proj(self.proj_ln(x.transpose(1, 2)))
        x = self.encoder_ln(x + pos_conv_embed(self.pos_conv, x))
        for name in self.layers:
            x = getattr(self, name)(x)
        return x.to(torch.float32)


# ---------------------------------------------------------------------------
# HF state_dict → the port's state_dict
# ---------------------------------------------------------------------------

_POS = "encoder.pos_conv_embed.conv"
WEIGHT_NORM_LAYOUTS = {"weight_g": ("weight_g", "weight_v"),
                       "parametrizations": ("parametrizations.weight.original0",
                                            "parametrizations.weight.original1")}
_EXPECTED_SKIPS = ("masked_spec_embed", "quantizer.", "project_hid.", "project_q.", "adapter.")


def hf_key_map(n_conv: int, num_layers: int) -> List[Tuple[str, str]]:
    """(HF ``Wav2Vec2Model`` key, the port's key) for every tensor but the
    positional conv's weight-norm pair (whose composition is
    ``pos_conv.weight``)."""
    pairs = [(f"feature_extractor.conv_layers.{i}.conv.weight", f"conv_{i}.weight")
             for i in range(n_conv)]
    for hf, port in (("feature_extractor.conv_layers.0.layer_norm", "conv_gn"),
                     ("feature_projection.layer_norm", "proj_ln"),
                     ("feature_projection.projection", "proj"),
                     ("encoder.layer_norm", "encoder_ln")):
        pairs += [(f"{hf}.weight", f"{port}.weight"), (f"{hf}.bias", f"{port}.bias")]
    pairs.append((f"{_POS}.bias", "pos_conv.bias"))
    for i in range(num_layers):
        lp = f"encoder.layers.{i}"
        subs = [(f"attention.{p}_proj", f"{p}_proj") for p in ("q", "k", "v", "out")]
        subs += [("layer_norm", "self_attn_ln"), ("feed_forward.intermediate_dense", "fc1"),
                 ("feed_forward.output_dense", "fc2"), ("final_layer_norm", "final_ln")]
        pairs += [(f"{lp}.{hf}.{w}", f"enc_layer_{i}.{port}.{w}")
                  for hf, port in subs for w in ("weight", "bias")]
    return pairs


def _strip_hf_prefix(sd: Dict[str, Any]) -> Dict[str, Any]:
    """``Wav2Vec2ForCTC`` nests the encoder under ``wav2vec2.``; keep only
    those keys, unprefixed. A bare ``Wav2Vec2Model`` dict is returned as is."""
    if not any(k.startswith("wav2vec2.") for k in sd):
        return dict(sd)
    return {k[len("wav2vec2."):]: v for k, v in sd.items() if k.startswith("wav2vec2.")}


def _pos_conv_keys(sd: Dict[str, Any]) -> Tuple[str, str]:
    for g, v in WEIGHT_NORM_LAYOUTS.values():
        if f"{_POS}.{g}" in sd:
            return f"{_POS}.{g}", f"{_POS}.{v}"
    raise ValueError("no pos_conv weight_norm keys in state_dict")


def infer_config(sd: Dict[str, Any], num_heads: Optional[int] = None,
                 pos_conv_groups: Optional[int] = None) -> Dict[str, Any]:
    """The architecture read off the checkpoint. Heads default to
    embed_dim // 64; the conv groups come from the grouped weight's shape;
    the strides are base's (5, 2, 2, …), as in every published wav2vec2."""
    sd = _strip_hf_prefix(sd)
    n_conv = 0
    while f"feature_extractor.conv_layers.{n_conv}.conv.weight" in sd:
        n_conv += 1
    if n_conv == 0:
        raise ValueError("no feature_extractor.conv_layers.* keys — not a wav2vec2 state_dict")
    shapes = [np.shape(sd[f"feature_extractor.conv_layers.{i}.conv.weight"])
              for i in range(n_conv)]
    embed_dim = int(np.shape(sd["feature_projection.projection.weight"])[0])
    layers = 0
    while f"encoder.layers.{layers}.feed_forward.intermediate_dense.weight" in sd:
        layers += 1
    pos_v = np.shape(sd[_pos_conv_keys(sd)[1]])
    return {
        "embed_dim": embed_dim,
        "num_layers": layers,
        "num_heads": int(num_heads or max(1, embed_dim // 64)),
        "ffn_dim": int(np.shape(sd["encoder.layers.0.feed_forward.intermediate_dense.weight"])[0]),
        "conv_dim": tuple(int(s[0]) for s in shapes),
        "conv_kernel": tuple(int(s[2]) for s in shapes),
        "conv_stride": tuple([5] + [2] * (n_conv - 1)),
        "pos_conv_kernel": int(pos_v[-1]),
        "pos_conv_groups": int(pos_conv_groups or embed_dim // int(pos_v[1])),
    }


def convert_wav2vec2_state_dict(
    sd: Dict[str, Any], num_heads: Optional[int] = None,
    pos_conv_groups: Optional[int] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any], List[str]]:
    """HF wav2vec2 state dict (arrays or tensors) → (the port's float32
    ``state_dict``, config, skipped keys). ``ValueError`` on a key outside
    the expected skips (CTC head, quantizer and pretraining tensors,
    ``masked_spec_embed``): layout drift fails at port time."""
    full = {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else v) for k, v in sd.items()}
    sd = _strip_hf_prefix(full)
    cfg = infer_config(sd, num_heads, pos_conv_groups)
    out = {port: _t(sd[hf]) for hf, port in hf_key_map(len(cfg["conv_dim"]), cfg["num_layers"])}
    gk, vk = _pos_conv_keys(sd)
    out["pos_conv.weight"] = _weight_norm(sd[gk], sd[vk])
    consumed = {hf for hf, _ in hf_key_map(len(cfg["conv_dim"]), cfg["num_layers"])} | {gk, vk}
    skipped = sorted(set(sd) - consumed)
    unexpected = [k for k in skipped if not k.startswith(_EXPECTED_SKIPS)]
    if unexpected:
        raise ValueError("unrecognized wav2vec2 checkpoint keys (layout drift?): "
                         + ", ".join(unexpected[:20]))
    prefixed = any(k.startswith("wav2vec2.") for k in full)
    dropped = sorted(k for k in full if k.startswith(("lm_head.", "dropout."))
                     or (prefixed and not k.startswith("wav2vec2.")))
    return out, cfg, skipped + dropped
