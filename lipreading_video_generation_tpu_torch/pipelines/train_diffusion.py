"""Diffusion training helpers of the port.

Only ``normalize_audio`` is ported so far (the sampler needs it); the
trainer itself is ROADMAP's diffusion-training slice, with the flash
backward kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def normalize_audio(wave: torch.Tensor) -> torch.Tensor:
    """First-order high-pass (~300 Hz at 16 kHz) + per-clip standardisation
    (population std + 1e-6), as ``pipelines/train_diffusion.normalize_audio``
    of the JAX package."""
    alpha = 0.889  # exp(-2π·300/16000)
    hp = wave - alpha * F.pad(wave[..., :-1], (1, 0))
    mean = hp.mean(dim=-1, keepdim=True)
    std = hp.std(dim=-1, keepdim=True, correction=0) + 1e-6
    return (hp - mean) / std
