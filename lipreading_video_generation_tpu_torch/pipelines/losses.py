"""Training losses of the port.

Port of ``lipreading_video_generation_tpu/pipelines/losses.py``'s
``noise_mse``; the GAN losses come with the GAN slice.
"""
from __future__ import annotations

import torch


def noise_mse(noise_pred: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """ε-prediction MSE, in float32."""
    return torch.mean((noise_pred.to(torch.float32) - noise.to(torch.float32)) ** 2)
