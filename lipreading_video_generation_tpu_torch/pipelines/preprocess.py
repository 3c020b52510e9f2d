"""Mouth-ROI preprocessing: face box → mouth crop → gray → CLAHE → model input.

Port of ``lipreading_video_generation_tpu/pipelines/preprocess.py``'s
``mouth_box_from_face``, ``mouth_roi_pipeline_from_boxes``,
``mouth_roi_pipeline``, ``slice_word_clips`` and
``preprocess_clip_for_lipreading`` (face tracks, mouth boxes, ROI, word
windows for one clip). The JAX package's ``vmap`` over frames becomes an
explicit batch dimension: crop+resize, gray, CLAHE and the final resize each
run once over all T frames. On CUDA tensors the CLAHE step is the kernel K1
(one launch a clip); there is no CPU fallback for it.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core.config import PreprocessConfig
from ..ops import image as image_ops


def mouth_box_from_face(face_box: torch.Tensor, min_size: int = 48) -> torch.Tensor:
    """Geometric mouth region of y1y2x1x2 face boxes (..., 4): rows
    [0.62, 0.92] and cols [0.22, 0.78] of the face box, expanded to at least
    min_size × min_size. Returns float32 (..., 4)."""
    y1, y2, x1, x2 = face_box.to(torch.float32).unbind(-1)
    h = y2 - y1
    w = x2 - x1
    box = torch.stack([y1 + 0.62 * h, y1 + 0.92 * h, x1 + 0.22 * w, x1 + 0.78 * w], dim=-1)
    return image_ops.expand_box_to_min_size(box, min_size, min_size)


def mouth_roi_pipeline_from_boxes(
    frames_uint8: torch.Tensor,     # (T, H, W, 3) RGB uint8
    mouth_boxes: torch.Tensor,      # (T, 4) y1y2x1x2 float mouth crops
    crop_hw: Tuple[int, int] = (48, 48),
    out_hw: Tuple[int, int] = (32, 32),
    clahe_clip: float = 0.2,
    grid: Tuple[int, int] = (8, 8),
) -> torch.Tensor:
    """ROI pipeline from precomputed mouth boxes → (T, out_h, out_w, 1)
    uint8: cubic crop+resize to crop_hw, luma, CLAHE on the float luma,
    antialiased bilinear resize to out_hw, round half to even."""
    crops = image_ops.crop_and_resize(frames_uint8, mouth_boxes, crop_hw, "cubic")
    gray = image_ops.rgb_to_gray(crops)[..., 0]            # (T, h, w) float32
    boosted = image_ops.clahe(gray, clahe_clip, grid)
    out = image_ops.resize(boosted[..., None], out_hw, "bilinear")
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def mouth_roi_pipeline(
    frames_uint8: torch.Tensor,     # (T, H, W, 3) RGB uint8
    face_boxes: torch.Tensor,       # (T, 4) y1y2x1x2 float
    crop_hw: Tuple[int, int] = (48, 48),
    out_hw: Tuple[int, int] = (32, 32),
    clahe_clip: float = 0.2,
    grid: Tuple[int, int] = (8, 8),
) -> torch.Tensor:
    """All-frames mouth-ROI pipeline with the geometric mouth-box estimate
    → (T, out_h, out_w, 1) uint8."""
    mouth = mouth_box_from_face(face_boxes, crop_hw[0])
    return mouth_roi_pipeline_from_boxes(frames_uint8, mouth, crop_hw, out_hw,
                                         clahe_clip, grid)


def slice_word_clips(
    processed_frames: np.ndarray,                 # (T, h, w, 1)
    word_frame_spans: Sequence[Tuple[str, int, int]],
    max_frames: int = 5,
) -> Tuple[List[np.ndarray], List[str]]:
    """Per-word frame windows (get_data.py:54-58), zero-padded/truncated to
    ``max_frames`` like prepare_all_videos (feature_extraction.py:60-77)."""
    clips, words = [], []
    t = len(processed_frames)
    for word, start, end in word_frame_spans:
        start = max(0, min(start, t - 1))
        end = max(start + 1, min(end, t))
        clip = processed_frames[start:end]
        if len(clip) >= max_frames:
            clip = clip[:max_frames]
        else:
            pad = np.zeros((max_frames - len(clip),) + clip.shape[1:], clip.dtype)
            clip = np.concatenate([clip, pad])
        clips.append(clip)
        words.append(word)
    return clips, words


def preprocess_clip_for_lipreading(
    frames: np.ndarray,
    s3fd_params,
    word_spans: Sequence[Tuple[str, int, int]],
    cfg: PreprocessConfig = PreprocessConfig(),
    max_frames: int = 5,
    landmark_params=None,
) -> Tuple[List[np.ndarray], List[str]]:
    """One clip: (T, H, W, 3) RGB uint8 frames → face tracks
    (``inference.detect_face_tracks`` with the ``models.s3fd.S3FD``
    ``s3fd_params``) → mouth boxes (the ``LipLandmarkNet``
    ``landmark_params`` where given, else ``mouth_box_from_face``) →
    ``mouth_roi_pipeline_from_boxes`` → word windows. Runs on the
    detector's device; the frames stay there from their upload to the uint8
    ROI. Returns (clips [(max_frames, h, w, 1) uint8], words)."""
    from ..models import lip_landmark
    from .inference import detect_face_tracks

    device = next(s3fd_params.parameters()).device
    frames_t = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
    boxes = detect_face_tracks(s3fd_params, frames_t, cfg)
    if landmark_params is not None:
        mouth = lip_landmark.predict_mouth_boxes(landmark_params, frames_t, boxes,
                                                 cfg.lip_crop_size[0])
    else:
        mouth = mouth_box_from_face(boxes, cfg.lip_crop_size[0])
    processed = mouth_roi_pipeline_from_boxes(frames_t, mouth, cfg.lip_crop_size,
                                              cfg.model_input_size, cfg.clahe_clip_limit,
                                              cfg.clahe_grid)
    return slice_word_clips(processed.cpu().numpy(), word_spans, max_frames)
