"""Training losses of the port.

Port of ``lipreading_video_generation_tpu/pipelines/losses.py``'s
``noise_mse``, ``softmax_xent`` and ``accuracy``; the GAN losses come with
the GAN slice.
"""
from __future__ import annotations

import torch


def noise_mse(noise_pred: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """ε-prediction MSE, in float32."""
    return torch.mean((noise_pred.to(torch.float32) - noise.to(torch.float32)) ** 2)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of (B, C) logits against (B,) integer labels."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.take_along_dim(logp, labels.long()[:, None], dim=-1))


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Share of rows whose argmax (the first maximum on ties, as
    ``jnp.argmax``) is the label, float32."""
    return (torch.argmax(logits, dim=-1) == labels).to(torch.float32).mean()
