"""The two config dataclasses the ported slice needs.

Copies of ``lipreading_video_generation_tpu/core/config.py``'s
``ViViTConfig`` and ``PreprocessConfig`` with the same field names and
defaults: the JAX package's ``core/__init__`` imports jax and orbax, so the
port cannot import the originals. Fields this port cannot honour yet raise
when set.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ViViTConfig:
    """ViViT word-level lipreader (reference: lipreading/main.py:33-36,59-60,
    huggingface_vivit_model.py:18-46)."""

    image_size: int = 32
    num_frames: int = 5
    num_channels: int = 1
    tubelet_size: Tuple[int, int, int] = (1, 8, 8)  # (t, h, w) tubelet embedding
    hidden_size: int = 256
    num_layers: int = 12
    num_heads: int = 8
    mlp_dim: int = 1024
    dropout: float = 0.0
    num_classes: int = 64
    # training (huggingface_vivit_model.py:36-47)
    batch_size: int = 16
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    lr_step_epochs: int = 2
    lr_step_gamma: float = 0.2
    num_epochs: int = 10
    dtype: str = "bfloat16"
    # Sequence- and pipeline-parallel encoders need a device mesh, which the
    # port does not have yet (ROADMAP, multi-GPU parallelism).
    sequence_parallel: bool = False
    sequence_axis: str = "model"
    pipeline_parallel: bool = False
    pp_num_micro: int = 0

    def __post_init__(self):
        if self.sequence_parallel or self.pipeline_parallel:
            raise NotImplementedError(
                "ViViTConfig: sequence_parallel and pipeline_parallel are not "
                "ported yet (ROADMAP: multi-GPU parallelism)")


@dataclass(frozen=True)
class PreprocessConfig:
    """Mouth-ROI / face-crop preprocessing
    (reference: lipreading/preprocess.py, gan-model/preprocessing/preprocess.py)."""

    lip_crop_size: Tuple[int, int] = (48, 48)   # lipreading path (get_data.py:45)
    model_input_size: Tuple[int, int] = (32, 32)  # ViViT input (main.py:35-36)
    face_det_batch_size: int = 16
    gen_batch_size: int = 128
    box_smooth_T: int = 5       # inference.py:61-68
    clahe_clip_limit: float = 0.2
    clahe_grid: Tuple[int, int] = (8, 8)
    face_det_score_threshold: float = 0.5
    nms_threshold: float = 0.3
