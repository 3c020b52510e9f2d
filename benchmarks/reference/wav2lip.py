"""Plain Wav2Lip-style generator and lip-sync request, for the benchmark's
comparison.

The generator (Wav2Lip, github.com/Rudrabha/Wav2Lip ``models/wav2lip.py``,
as the reference repo's GAN sets it): a mel encoder (80x16 → 512x1x1), a
face encoder over the 6-channel 96x96 input (masked target ⊕ reference)
with seven skips, and a decoder that resizes (nearest) and convolves back
to 96x96, concatenating the skips deepest first; 51 convolutions, each
followed by GroupNorm and ReLU (a residual block adds its input), then a
1x1 convolution to RGB and a sigmoid. The reference repo's variant uses
GroupNorm where Wav2Lip has BatchNorm, and a nearest resize + conv where
Wav2Lip has transposed convolutions; this copy follows the variant.

``request`` is one lip-sync request end to end: crop each face box to
96x96 in [0, 1], mask its lower half, the generator, the faces ×255 pasted
back into their boxes, rounded to uint8.

Parameters are read from a state dict under the served model's key names;
every product goes through ``Numerics``. Nothing here imports the program.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import image
from .nn import Numerics, group_norm

AUDIO_PLAN = (
    ("conv", 32, 3, 1, 1), ("res", 32), ("res", 32),
    ("conv", 64, 3, (3, 1), 1), ("res", 64), ("res", 64),
    ("conv", 128, 3, 3, 1), ("res", 128), ("res", 128),
    ("conv", 256, 3, (3, 2), 1), ("res", 256),
    ("conv", 512, 3, 1, 0), ("conv", 512, 1, 1, 0),
)
FACE_PLAN = (
    ("conv", 16, 7, 1, 3), ("skip",),
    ("conv", 32, 3, 2, 1), ("res", 32), ("res", 32), ("skip",),
    ("conv", 64, 3, 2, 1), ("res", 64), ("res", 64), ("res", 64), ("skip",),
    ("conv", 128, 3, 2, 1), ("res", 128), ("res", 128), ("skip",),
    ("conv", 256, 3, 2, 1), ("res", 256), ("res", 256), ("skip",),
    ("conv", 512, 3, 2, 1), ("res", 512), ("skip",),
    ("conv", 512, 3, 1, 0), ("conv", 512, 1, 1, 0), ("skip",),
)
DECODER_PLAN = (
    ("conv", 512, 1, 1, 0), ("cat",),
    ("up", 512, 3), ("res", 512), ("cat",),
    ("up", 512, 6), ("res", 512), ("res", 512), ("cat",),
    ("up", 384, 12), ("res", 384), ("res", 384), ("cat",),
    ("up", 256, 24), ("res", 256), ("res", 256), ("cat",),
    ("up", 128, 48), ("res", 128), ("res", 128), ("cat",),
    ("up", 64, 96), ("res", 64), ("res", 64), ("cat",),
    ("conv", 32, 3, 1, 1),
)


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def scale_channels(ch: int, width: float) -> int:
    return max(8, int(round(ch * width / 8)) * 8)


class Generator:
    """The generator over a state dict ``p`` in ``numerics``."""

    def __init__(self, p: Dict[str, torch.Tensor], numerics: Numerics, width: float = 1.0):
        self.p, self.num, self.width = p, numerics, width

    def _block(self, key: str, x: torch.Tensor, stride=1, padding=1) -> torch.Tensor:
        """conv → GroupNorm → ReLU, the block at ``key``."""
        p = self.p
        y = self.num.conv2d(x, p[f"{key}.conv.weight"], p[f"{key}.conv.bias"], _pair(stride),
                            _pair(padding))
        return F.relu(group_norm(y, p[f"{key}.norm.weight"], p[f"{key}.norm.bias"]))

    def _step(self, prefix: str, i: int, step, x: torch.Tensor) -> torch.Tensor:
        key = f"{prefix}.layers.{i}"
        if step[0] == "conv":
            return self._block(key, x, step[3], step[4])
        if step[0] == "res":
            return x + self._block(f"{key}.block", x)
        size = step[2]
        x = x.index_select(2, image.nearest_index(x.shape[2], size, x.device))
        x = x.index_select(3, image.nearest_index(x.shape[3], size, x.device))
        return self._block(f"{key}.block", x)

    def _run(self, prefix: str, plan, x: torch.Tensor, skips: List[torch.Tensor] = None,
             keep: List[torch.Tensor] = None) -> torch.Tensor:
        i = 0
        for step in plan:
            if step[0] == "skip":
                keep.append(x)
            elif step[0] == "cat":
                x = torch.cat([x, skips.pop()], dim=1)
            else:
                x = self._step(prefix, i, step, x)
                i += 1
        return x

    def __call__(self, mel: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
        """mel (B, 80, 16), faces (B, 96, 96, 6) → (B, 96, 96, 3) in [0, 1]."""
        with self.num.context():
            emb = self._run("audio", AUDIO_PLAN, mel[:, None].float())
            feats: List[torch.Tensor] = []
            self._run("face", FACE_PLAN, faces.float().permute(0, 3, 1, 2), keep=feats)
            x = self._run("decoder", DECODER_PLAN, emb, skips=feats)
            p = self.p
            x = self.num.conv2d(x, p["decoder.out_conv.weight"], p["decoder.out_conv.bias"])
            return torch.sigmoid(x).permute(0, 2, 3, 1)


def request(gen: Generator, frames_u8: torch.Tensor, boxes: torch.Tensor, mels: torch.Tensor,
            batch: int, img: int = 96) -> torch.Tensor:
    """One lip-sync request: uint8 frames (N, H, W, 3), y1y2x1x2 boxes (N, 4)
    and mel windows (N, 80, 16) → uint8 frames, in batches of ``batch``
    frames (the int8 activation scales are a batch's, as served)."""
    outs = []
    for i in range(0, len(frames_u8), batch):
        f = frames_u8[i:i + batch].float()
        b = boxes[i:i + batch].float()
        faces = image.crop_and_resize(f, b, (img, img)) / 255.0
        x = image.concat_reference(image.mask_lower_half(faces), faces)
        g = gen(mels[i:i + batch].float(), x)
        out = image.paste_back(f, g * 255.0, b)
        outs.append(torch.clamp(torch.round(out), 0, 255).to(torch.uint8))
    return torch.cat(outs)


def conv_shapes(width: float = 1.0, img: int = 96, mel_hw=(80, 16)) -> List[Tuple[int, ...]]:
    """(out_h, out_w, cin, cout, kh, kw) of each of the generator's 2-D
    convolutions for one frame, in call order, from the plans."""
    out: List[Tuple[int, ...]] = []

    def conv(h, w, cin, cout, k, stride, pad):
        (sh, sw), (ph, pw) = _pair(stride), _pair(pad)
        oh, ow = (h + 2 * ph - k) // sh + 1, (w + 2 * pw - k) // sw + 1
        out.append((oh, ow, cin, cout, k, k))
        return oh, ow

    def walk(plan, h, w, ch, skips=None, keep=None):
        for step in plan:
            if step[0] == "skip":
                keep.append((ch, h, w))
            elif step[0] == "cat":
                ch += skips.pop()[0]
            elif step[0] == "conv":
                c = scale_channels(step[1], width)
                h, w = conv(h, w, ch, c, step[2], step[3], step[4])
                ch = c
            elif step[0] == "res":
                conv(h, w, ch, ch, 3, 1, 1)
            else:
                c = scale_channels(step[1], width)
                h = w = step[2]
                conv(h, w, ch, c, 3, 1, 1)
                ch = c
        return h, w, ch

    _, _, emb = walk(AUDIO_PLAN, mel_hw[0], mel_hw[1], 1)
    feats: list = []
    walk(FACE_PLAN, img, img, 6, keep=feats)
    h, w, ch = walk(DECODER_PLAN, 1, 1, emb, skips=feats)
    conv(h, w, ch, 3, 1, 1, 0)
    return out
