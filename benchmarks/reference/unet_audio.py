"""Plain audio- and image-conditioned diffusion U-Net, DDIM sampling and
its request, for the benchmark's comparison.

The model (the reference repo's ``video-generation/diffusion``: train.py
48-97, test.py 33-49), in float32:

- audio encoder: log-mel of the normalised wave (``audio.py``) → conv1d
  80→E/2 (5 taps, stride 2) → tanh-GELU → conv1d E/2→E (3 taps) →
  tanh-GELU → LayerNorm + learned positions → 4 pre-LN transformer blocks
  (8 heads, MLP 4E, tanh-GELU) → LayerNorm; its mean over time → dense +
  ReLU → broadcast over the frame;
- the condition frame resized to the model's size, in [-1, 1], through a
  1x1 conv; both maps concatenated after the noisy frame's channels;
- the U-Net: sinusoidal time embedding ([cos, sin]) → dense → SiLU →
  dense; a 3x3 stem; per level ResBlocks (GN → SiLU → conv, scale-shift
  by the time embedding, GN → SiLU → conv, a 1x1 skip where the channels
  change) with an attention block after each where the level has one
  (GN → qkv → softmax attention over the H·W tokens → projection, a
  residual), a stride-2 conv down; the middle; the way up with the skips
  concatenated and nearest 2x upsampling + conv; GN → SiLU → 3x3 conv out.

``ddim_request`` samples a clip: x_T → ``steps`` deterministic DDIM
updates (eta 0) over the strided timesteps of the sqrt-linear β schedule →
uint8 frames. Parameters are read from a state dict under the served
model's key names; every product goes through ``Numerics``. Nothing here
imports the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import audio, image
from .nn import Numerics, group_norm, layer_norm


def plan(base: int, mult: Sequence[int], num_res: int, attn_res: Sequence[int]) -> List[Tuple]:
    """The U-Net's steps after the stem: ("res", cin, cout), ("attn", c),
    ("down", c), ("up", c), ("push",), ("cat",)."""
    steps: List[Tuple] = []
    ch, skip_ch, ds = base, [base], 1
    for level, m in enumerate(mult):
        for _ in range(num_res):
            steps.append(("res", ch, base * m))
            ch = base * m
            if ds in attn_res:
                steps.append(("attn", ch))
            steps.append(("push",))
            skip_ch.append(ch)
        if level != len(mult) - 1:
            steps += [("down", ch), ("push",)]
            skip_ch.append(ch)
            ds *= 2
    steps += [("res", ch, ch), ("attn", ch), ("res", ch, ch)]
    for level, m in reversed(list(enumerate(mult))):
        for _ in range(num_res + 1):
            steps += [("cat",), ("res", ch + skip_ch.pop(), base * m)]
            ch = base * m
            if ds in attn_res:
                steps.append(("attn", ch))
        if level != 0:
            steps.append(("up", ch))
            ds //= 2
    return steps


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000) * torch.arange(half, dtype=torch.float32,
                                                      device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class UNetAudio:
    """The conditioned U-Net over a state dict ``p`` in ``numerics``; ``cfg``
    is the configuration file's dict."""

    def __init__(self, p: Dict[str, torch.Tensor], cfg: dict, numerics: Numerics):
        if cfg["audio_encoder"] != "native":
            raise ValueError(f"the reference has the native audio encoder only, "
                             f"not {cfg['audio_encoder']!r}")
        self.p, self.cfg, self.num = p, cfg, numerics
        self.steps = plan(cfg["base_channels"], cfg["channel_mult"], cfg["num_res_blocks"],
                          cfg["attention_resolutions"])

    def _lin(self, key: str, x: torch.Tensor) -> torch.Tensor:
        return self.num.linear(x, self.p[f"{key}.weight"], self.p[f"{key}.bias"])

    def _conv(self, key: str, x: torch.Tensor, stride=1, padding=1) -> torch.Tensor:
        return self.num.conv2d(x, self.p[f"{key}.weight"], self.p[f"{key}.bias"], stride, padding)

    def _gn(self, key: str, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.p[f"{key}.weight"], self.p[f"{key}.bias"])

    def _ln(self, key: str, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.p[f"{key}.weight"], self.p[f"{key}.bias"])

    def encode_audio(self, wave: torch.Tensor) -> torch.Tensor:
        """(B, samples) raw wave → (B, audio_proj) after dense + ReLU."""
        p, pre = self.p, "audio_encoder"
        mel = audio.melspectrogram(audio.normalize_audio(wave.float()))
        x = F.gelu(self.num.conv1d(mel, p[f"{pre}.conv1.weight"], p[f"{pre}.conv1.bias"], 2, 2),
                   approximate="tanh")
        x = F.gelu(self.num.conv1d(x, p[f"{pre}.conv2.weight"], p[f"{pre}.conv2.bias"], 1, 1),
                   approximate="tanh").transpose(1, 2)
        x = self._ln(f"{pre}.norm_in", x) + p[f"{pre}.pos_embedding"].float()
        for i in range(self.cfg["audio_layers"]):
            blk = f"{pre}.blocks.{i}"
            q, k, v = self._lin(f"{blk}.qkv", self._ln(f"{blk}.norm1", x)).chunk(3, dim=-1)
            x = x + self._lin(f"{blk}.proj", self.num.attention(q, k, v, self.cfg["audio_heads"]))
            h = F.gelu(self._lin(f"{blk}.mlp.fc1", self._ln(f"{blk}.norm2", x)), approximate="tanh")
            x = x + self._lin(f"{blk}.mlp.fc2", h)
        a = self._ln(f"{pre}.norm_out", x).mean(dim=1)
        return F.relu(self._lin("audio_proj", a))

    def condition(self, frame_u8: torch.Tensor, wave: torch.Tensor) -> torch.Tensor:
        """Condition frames (B, h, w, 3) uint8 and waves (B, samples) → the
        (B, audio_proj + im_cond, S, S) map."""
        size = self.cfg["im_size"]
        img = image.resize(frame_u8, (size, size)).float() / 255.0 * 2.0 - 1.0
        a = self.encode_audio(wave)
        a_map = a[:, :, None, None].expand(-1, -1, size, size)
        return torch.cat([a_map, self._conv("im_cond_conv", img.permute(0, 3, 1, 2), 1, 0)], dim=1)

    def _res(self, key: str, x: torch.Tensor, emb: torch.Tensor, keep=None) -> torch.Tensor:
        h = self._conv(f"{key}.conv1", F.silu(self._gn(f"{key}.norm1", x)))
        scale, shift = self._lin(f"{key}.emb", F.silu(emb))[:, :, None, None].chunk(2, dim=1)
        h = F.silu(self._gn(f"{key}.norm2", h) * (1 + scale) + shift)
        if keep is not None:      # dropout: kept values scaled by 1/(1 - rate)
            h = torch.where(keep, h / (1.0 - self.cfg["dropout"]), 0.0)
        h = self._conv(f"{key}.conv2", h)
        if f"{key}.skip.weight" in self.p:
            x = self._conv(f"{key}.skip", x, 1, 0)
        return x + h

    def _attn(self, key: str, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        flat = self._gn(f"{key}.norm", x).reshape(b, c, h * w).transpose(1, 2)
        q, k, v = self._lin(f"{key}.qkv", flat).chunk(3, dim=-1)
        out = self._lin(f"{key}.proj", self.num.attention(q, k, v, self.cfg["num_heads"]))
        return x + out.transpose(1, 2).reshape(b, c, h, w)

    def denoise(self, xt: torch.Tensor, cond: torch.Tensor, t: torch.Tensor,
                keep=None) -> torch.Tensor:
        """ε of (B, 3, S, S) noisy frames given the condition map and (B,) t;
        ``keep``: the ResBlocks' dropout keep-masks in order (training)."""
        keep = iter(keep) if keep is not None else None
        u = "unet"
        emb = self._lin(f"{u}.time2", F.silu(self._lin(
            f"{u}.time1", timestep_embedding(t, self.cfg["base_channels"]))))
        h = self._conv(f"{u}.stem", torch.cat([xt, cond], dim=1))
        skips = [h]
        i = 0
        for step in self.steps:
            if step[0] == "push":
                skips.append(h)
                continue
            if step[0] == "cat":
                h = torch.cat([h, skips.pop()], dim=1)
                continue
            key = f"{u}.layers.{i}"
            i += 1
            if step[0] == "res":
                h = self._res(key, h, emb, None if keep is None else next(keep))
            elif step[0] == "attn":
                h = self._attn(key, h)
            elif step[0] == "down":
                h = self._conv(f"{key}.conv", h, 2, 1)
            else:
                h = self._conv(f"{key}.conv", h.repeat_interleave(2, 2).repeat_interleave(2, 3))
        return self._conv(f"{u}.out_conv", F.silu(self._gn(f"{u}.out_norm", h)))


def res_shapes(cfg: dict, b: int) -> List[Tuple[int, int, int, int]]:
    """(b, channels, H, W) of each ResBlock's output, in order."""
    res, out = cfg["im_size"], []
    for step in plan(cfg["base_channels"], cfg["channel_mult"], cfg["num_res_blocks"],
                     cfg["attention_resolutions"]):
        if step[0] == "res":
            out.append((b, step[2], res, res))
        elif step[0] == "down":
            res //= 2
        elif step[0] == "up":
            res *= 2
    return out


def alphas_cumprod(cfg: dict) -> np.ndarray:
    """ᾱ_t of the sqrt-linear β schedule, float64."""
    betas = np.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5, cfg["num_timesteps"],
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def ddim_timesteps(num_timesteps: int, steps: int) -> np.ndarray:
    return (np.arange(steps) * (num_timesteps / steps)).astype(np.int64)[::-1]


def ddim_request(model: UNetAudio, frame_u8: torch.Tensor, waves: torch.Tensor,
                 x_t: torch.Tensor, steps: int, block: int = 4) -> torch.Tensor:
    """A clip (T, S, S, 3) uint8 from one condition frame (h, w, 3) uint8,
    T waves (T, samples) and x_T (T, 3, S, S), by ``steps`` DDIM updates with
    eta 0, frames ``block`` at a time (every frame is independent)."""
    acp = alphas_cumprod(model.cfg).astype(np.float32)
    ts = ddim_timesteps(model.cfg["num_timesteps"], steps)
    outs = []
    with model.num.context():
        for i in range(0, len(waves), block):
            w = waves[i:i + block]
            cond = model.condition(frame_u8[None].expand((len(w),) + tuple(frame_u8.shape)), w)
            x = x_t[i:i + block].float()
            for j, t in enumerate(ts):
                t_prev = int(ts[j + 1]) if j + 1 < len(ts) else -1
                eps = model.denoise(x, cond, torch.full((len(w),), int(t), device=x.device))
                a_t = torch.tensor(acp[t], device=x.device)
                a_prev = torch.tensor(acp[t_prev] if t_prev >= 0 else 1.0, device=x.device)
                x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
                x = torch.sqrt(a_prev) * x0 + torch.sqrt(torch.clamp(1.0 - a_prev, min=0.0)) * eps
            x = (torch.clamp(x, -1.0, 1.0) + 1.0) / 2.0
            outs.append(image.to_uint8(x.permute(0, 2, 3, 1)))
    return torch.cat(outs)
