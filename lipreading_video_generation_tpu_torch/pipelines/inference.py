"""Lip-sync serving from decoded frames: crop faces → generate → paste back.

Port of ``lipreading_video_generation_tpu/pipelines/inference.py``'s
``_mel_chunks``, ``paste_back``, ``gen_input_prep``, ``lipsync_batch`` and
``generate_frames``: host uint8 frames (N, H, W, 3), y1y2x1x2 face boxes
(N, 4) and aligned mel windows (N, 80, 16) → per batch of
``PreprocessConfig.gen_batch_size`` frames: crop each face to ``img_size``,
scale to [0, 1], mask the lower half, concatenate the unmasked face as the
reference → ``TalkingFaceGenerator`` → resize each generated face to its box
and paste it into the full frame → uint8 frames on the host.

With ``GanConfig.serve_int8`` every convolution of the generator runs
through the int8 matmul kernel (``ops/quant.py``); with
``serve_int8_static`` one calibration pass over frames sampled evenly across
the request fixes the activation scales first, with 5% headroom.

Not carried over: the JAX package runs the whole request as one device
program (``lax.map`` over step-stacked batches, padded to a batch multiple
and sharded over a mesh); here a Python loop takes the batches one by one on
one device, the last one as short as it is, and ``mesh_spec`` raises. Face
detection and video/audio file I/O (``detect_face_tracks``,
``prepare_input_frames``, ``lipsync_video``) are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.config import AudioConfig, GanConfig, PreprocessConfig
from ..core.device import resolve_device
from ..models.generator import TalkingFaceGenerator
from ..ops import audio as audio_ops
from ..ops import image as image_ops
from ..ops import quant

# headroom on the calibrated activation scales, for frames between the sampled ones
_STATIC_HEADROOM = 1.05


def _mel_chunks(mel: torch.Tensor, num_frames: int, fps: float, audio_cfg: AudioConfig,
                mel_step: int = 16) -> torch.Tensor:
    """(80, T_mel) → (num_frames, 80, mel_step) windows aligned to the video
    frames 0..num_frames-1."""
    starts = torch.arange(num_frames, dtype=torch.float32, device=mel.device)
    return audio_ops.mel_windows(mel, starts, fps, mel_step, audio_cfg.sample_rate,
                                 audio_cfg.hop_size)


def paste_back(frame: torch.Tensor, roi: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Resize generated ROIs (..., h, w, C) to their y1y2x1x2 boxes (..., 4)
    and paste them into the full frames (..., H, W, C) → float32 frames:
    every frame pixel inside the box samples the ROI bilinearly (zero
    padded), every other pixel keeps the frame's value."""
    H, W = frame.shape[-3], frame.shape[-2]
    y1, y2, x1, x2 = (box[..., i, None].to(torch.float32) for i in range(4))
    rows = torch.arange(H, dtype=torch.float32, device=frame.device)
    cols = torch.arange(W, dtype=torch.float32, device=frame.device)
    ys = (rows - y1) / torch.clamp(y2 - y1, min=1.0) * roi.shape[-3] - 0.5
    xs = (cols - x1) / torch.clamp(x2 - x1, min=1.0) * roi.shape[-2] - 0.5
    resized = image_ops._bilinear_sample(roi.to(torch.float32), ys, xs)
    inside = (((rows >= y1) & (rows < y2))[..., :, None, None]
              & ((cols >= x1) & (cols < x2))[..., None, :, None])
    return torch.where(inside, resized, frame.to(torch.float32))


def gen_input_prep(frames_f: torch.Tensor, boxes: torch.Tensor, img: int) -> torch.Tensor:
    """Float frames (B, H, W, 3) in [0, 255] and boxes (B, 4) → the
    generator's 6-channel input (B, img, img, 6): the face crop in [0, 1]
    with its lower half masked, then the unmasked crop as the reference.
    The one definition of the input prep, shared by ``lipsync_batch`` and
    the static-int8 calibration pass."""
    faces = image_ops.crop_and_resize(frames_f, boxes, (img, img)) / 255.0
    return image_ops.concat_reference(image_ops.mask_lower_half(faces), faces)


def lipsync_batch(gen: TalkingFaceGenerator, frames_u8: torch.Tensor, boxes: torch.Tensor,
                  mels: torch.Tensor, img: int, int8: bool = False,
                  act_scales: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """One generation batch on ``gen``'s device: uint8 frames (B, H, W, 3),
    boxes (B, 4), mel windows (B, 80, 16) → uint8 frames with the generated
    faces pasted in. ``int8`` routes the generator's convs through
    ``quant.int8_serving`` (with the static ``act_scales`` if given)."""
    frames_f = frames_u8.to(torch.float32)
    x = gen_input_prep(frames_f, boxes, img)
    if int8:
        with quant.int8_serving(gen, act_scales):
            g = gen(mels[..., None], x)
    else:
        g = gen(mels[..., None], x)
    out = paste_back(frames_f, g * 255.0, boxes)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def generate_frames(
    gen_params: Dict[str, torch.Tensor],   # TalkingFaceGenerator state_dict
    frames_seq: np.ndarray,                # (N, H, W, 3) uint8 input frames
    boxes: np.ndarray,                     # (N, 4) y1y2x1x2 face boxes
    mel_windows: np.ndarray,               # (N, 80, 16) aligned mel chunks
    gan_cfg: GanConfig = GanConfig(),
    pre_cfg: PreprocessConfig = PreprocessConfig(),
    model_width: float = 1.0,
    mesh_spec=None,
    device=None,
) -> np.ndarray:
    """Generate and paste back every output frame, ``pre_cfg.gen_batch_size``
    frames at a time, on ``device`` (None: the card). ``gen_params`` is the
    generator's ``state_dict`` (``models.convert.generator_state_dict_from_flax``
    bridges Flax params), on any device. The generator runs in float32, as
    in the JAX package's serving path. Returns (N, H, W, 3) uint8."""
    if mesh_spec is not None:
        raise NotImplementedError(
            "generate_frames: mesh_spec is not ported yet (ROADMAP §1 item 13, "
            "multi-GPU parallelism)")
    device = resolve_device(device)
    num_out = len(frames_seq)
    if num_out == 0:
        return np.zeros((0,) + tuple(frames_seq.shape[1:]), np.uint8)
    with torch.device(device):
        gen = TalkingFaceGenerator(width=model_width).eval()
    gen.load_state_dict(gen_params)
    img = gan_cfg.img_size
    int8 = gan_cfg.serve_int8

    def on_device(a, idx) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a)[idx])).to(device)

    outs = []
    with torch.inference_mode():
        act_scales = None
        if int8 and gan_cfg.serve_int8_static:
            n_cal = min(pre_cfg.gen_batch_size, num_out)
            cal_idx = np.unique(np.linspace(0, num_out - 1, n_cal).astype(np.int64))
            x_cal = gen_input_prep(on_device(frames_seq, cal_idx).to(torch.float32),
                                   on_device(boxes, cal_idx), img)
            mel_cal = on_device(mel_windows, cal_idx)[..., None]
            act_scales = quant.calibrate_activation_scales(gen, [(mel_cal, x_cal)])
            act_scales = {k: s * _STATIC_HEADROOM for k, s in act_scales.items()}
            del x_cal, mel_cal
        for i in range(0, num_out, pre_cfg.gen_batch_size):
            idx = slice(i, i + pre_cfg.gen_batch_size)
            out = lipsync_batch(gen, on_device(frames_seq, idx), on_device(boxes, idx),
                                on_device(mel_windows, idx), img, int8, act_scales)
            outs.append(out.cpu().numpy())
    return np.concatenate(outs)
