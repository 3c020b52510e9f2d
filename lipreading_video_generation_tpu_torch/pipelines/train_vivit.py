"""ViViT lipreader serving steps.

Port of ``lipreading_video_generation_tpu/pipelines/train_vivit.py``'s
``preprocess_clips``, ``predict_step`` and ``predict_step_int8``; the
trainer itself is not ported yet. Where JAX's steps take a train state, these
take the ``models.vivit.ViViT`` module, and run on its device.
"""
from __future__ import annotations

import torch

from ..models.vivit import ViViT
from ..ops import quant


def preprocess_clips(clips_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, T, H, W, C) → float32 in [0, 1]."""
    return clips_uint8.to(torch.float32) / 255.0


@torch.inference_mode()
def predict_step(model: ViViT, clips_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 clips in, float32 log-probs (B, num_classes) out."""
    return torch.log_softmax(model(preprocess_clips(clips_uint8)), dim=-1)


@torch.inference_mode()
def predict_step_int8(model: ViViT, clips_uint8: torch.Tensor) -> torch.Tensor:
    """``predict_step`` with every Linear of the classifier in dynamic int8
    (``ops/quant.py``; on a CUDA device each product is one launch of the
    int8 matmul kernel). Attention, LayerNorm and the softmax stay float."""
    with quant.int8_serving(model):
        logits = model(preprocess_clips(clips_uint8))
    return torch.log_softmax(logits, dim=-1)
