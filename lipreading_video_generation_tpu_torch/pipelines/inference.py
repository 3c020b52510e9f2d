"""Lip-sync serving: a face video and a speech track → the lip-synced video.

Port of ``lipreading_video_generation_tpu/pipelines/inference.py``:
``lipsync_video`` (read and condition the frames, the wav's mel, S3FD face
tracks, the aligned mel windows, ``generate_frames``, write and mux) with
``InferenceResult`` and ``prepare_input_frames``, and below it
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

``detect_face_tracks`` turns frames into smoothed face boxes with
``models.s3fd`` (batches of ``PreprocessConfig.face_det_batch_size``, the
last padded by repeating its last frame; the best face of each frame;
undetected frames take the last detected box, whole-frame boxes where
nothing is found), all on the detector's device.

Not carried over: the JAX package runs the whole request as one device
program (``lax.map`` over step-stacked batches, padded to a batch multiple
and sharded over a mesh); here a Python loop takes the batches one by one on
one device, the last one as short as it is, and writes each into one output
array allocated before the first (pinned host memory on a card, with
non-blocking copies both ways).
``lipsync_video`` reads and writes video through OpenCV (imported on call)
unless its ``read_frames`` / ``write_video`` seams are given, so it runs
from frames in memory where OpenCV is absent; without ffmpeg the video is
written silent and ``muxed`` is False, as in the JAX package.
"""
from __future__ import annotations

import collections
import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.config import AudioConfig, GanConfig, PreprocessConfig
from ..core.device import resolve_device
from ..data import video as video_io
from ..models.generator import TalkingFaceGenerator
from ..models.s3fd import S3FD, detect_faces
from ..ops import audio as audio_ops
from ..ops import image as image_ops
from ..ops import quant
from ..parallel import mesh as pmesh
from ..parallel.distributed import is_primary
from ..utils.profiling import annotate

# headroom on the calibrated activation scales, for frames between the sampled ones
_STATIC_HEADROOM = 1.05

# batches ``generate_frames`` wrote into its output, by route: "pinned" (a card: rows
# staged in pinned host memory, non-blocking copies both ways) or "plain" (the CPU)
HOST_IO_ROUTES: collections.Counter = collections.Counter()


@torch.no_grad()
def detect_face_tracks(
    s3fd: S3FD,
    frames,
    cfg: PreprocessConfig = PreprocessConfig(),
    pads: tuple = (0, 0, 0, 0),
    nosmooth: bool = False,
) -> torch.Tensor:
    """Batched S3FD over all frames → (T, 4) float32 y1y2x1x2 face boxes on
    the detector's device.

    ``frames``: (T, H, W, 3) RGB uint8, a numpy array or a tensor on any
    device. Frames with no detection take the previous frame's box (the
    frames before the first detection take the first); with no detection
    at all every box is the whole frame. ``pads`` = (pady1, pady2, padx1,
    padx2) widen the boxes, clipped to the frame; then the T =
    ``cfg.box_smooth_T`` moving average (``ops.image.smooth_boxes``) unless
    ``nosmooth``."""
    device = next(s3fd.parameters()).device
    if isinstance(frames, np.ndarray):
        frames = torch.from_numpy(np.ascontiguousarray(frames))
    frames = frames.to(device)
    t, h, w = frames.shape[:3]
    bs = cfg.face_det_batch_size
    bgr = torch.flip(frames, dims=[-1]).to(torch.float32)
    all_boxes, all_valid = [], []
    for i in range(0, t, bs):
        chunk = bgr[i: i + bs]
        n = len(chunk)
        if n < bs:
            chunk = torch.cat([chunk, chunk[-1:].expand((bs - n,) + chunk.shape[1:])])
        boxes, _, valid = detect_faces(s3fd, chunk, score_threshold=cfg.face_det_score_threshold,
                                       nms_threshold=cfg.nms_threshold)
        all_boxes.append(boxes[:n, 0])               # best face per frame
        all_valid.append(valid[:n, 0])
    boxes, valid = torch.cat(all_boxes), torch.cat(all_valid)     # (T, 4) x1y1x2y2
    # carry the last detection forward; frames before the first take the first
    idx = torch.arange(t, device=device)
    last = torch.cummax(torch.where(valid, idx, torch.full_like(idx, -1)), dim=0).values
    first = torch.argmax(valid.to(torch.int32))
    boxes = boxes[torch.where(last >= 0, last, first)]
    whole = torch.tensor([0.0, 0.0, w - 1.0, h - 1.0], device=device)
    boxes = torch.where(valid.any(), boxes, whole)
    # pads, clipped to the frame
    pady1, pady2, padx1, padx2 = pads
    x1 = torch.clamp(boxes[:, 0] - padx1, min=0)
    y1 = torch.clamp(boxes[:, 1] - pady1, min=0)
    x2 = torch.clamp(boxes[:, 2] + padx2, max=w)
    y2 = torch.clamp(boxes[:, 3] + pady2, max=h)
    yx = torch.stack([y1, y2, x1, x2], dim=1).to(torch.float32)
    return yx if nosmooth else image_ops.smooth_boxes(yx, cfg.box_smooth_T)


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
                  act_scales: Optional[Dict[str, float]] = None,
                  scale_reducer=None) -> torch.Tensor:
    """One generation batch on ``gen``'s device: uint8 frames (B, H, W, 3),
    boxes (B, 4), mel windows (B, 80, 16) → uint8 frames with the generated
    faces pasted in. ``int8`` routes the generator's convs through
    ``quant.int8_serving`` (with the static ``act_scales`` if given; a
    ``scale_reducer`` makes the dynamic scales those of the global batch
    whose rows these are)."""
    with annotate("lipsync/prep"):
        frames_f = frames_u8.to(torch.float32)
        x = gen_input_prep(frames_f, boxes, img)
    with annotate("lipsync/generator"):
        if int8:
            with quant.int8_serving(gen, act_scales, scale_reducer):
                g = gen(mels[..., None], x)
        else:
            g = gen(mels[..., None], x)
    with annotate("lipsync/paste"):
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
    in the JAX package's serving path. Returns (N, H, W, 3) uint8.

    The output is one (N, H, W, 3) uint8 array allocated before the first
    batch; each batch's frames are written into its rows. On a card it is
    pinned host memory, each batch's rows go up through a pinned staging
    block and come back into it with non-blocking copies, and the host
    waits for the device once, after the last batch (``HOST_IO_ROUTES``
    counts the batches by route). The returned array holds the pinned
    block for as long as the caller holds the array.

    ``mesh_spec`` (default ``build_mesh()``; 1×1 without a process group)
    serves data-parallel: every rank holds the request, each batch is padded
    to a data multiple, each data rank generates its rows and the frames are
    gathered on every rank (the static-int8 calibration runs the same
    frames on every rank, so the scales agree).

    Program spans (``utils.profiling.annotate``): ``lipsync/build`` once, then
    for each batch ``lipsync/gather`` (its rows staged and sent to the
    device), ``lipsync_batch``'s ``lipsync/prep``, ``lipsync/generator`` and
    ``lipsync/paste``, and ``lipsync/fetch`` (gathered, its copy into the
    output's rows enqueued); last ``lipsync/concat`` (the wait for the last
    copy, and the array handed back)."""
    spec = mesh_spec or pmesh.build_mesh()
    device = resolve_device(device)
    num_out = len(frames_seq)
    if num_out == 0:
        return np.zeros((0,) + tuple(frames_seq.shape[1:]), np.uint8)
    with annotate("lipsync/build"):
        with torch.device(device):
            gen = TalkingFaceGenerator(width=model_width).eval()
        gen.load_state_dict(gen_params)
        pmesh.shard_params(spec, gen)
    img = gan_cfg.img_size
    int8 = gan_cfg.serve_int8
    pinned = device.type == "cuda"

    def on_device(a, rows) -> torch.Tensor:
        """``rows`` (a slice, or an index array) of a host array, copied into
        a fresh host block and sent to ``device``. A pinned block on a card:
        the caching host allocator hands it out again only once the
        non-blocking copy from it has completed."""
        src = np.asarray(a)[rows]
        dtype = torch.from_numpy(np.empty(0, src.dtype)).dtype
        host = torch.empty(src.shape, dtype=dtype, pin_memory=pinned)
        np.copyto(host.numpy(), src)
        return host.to(device, non_blocking=pinned)

    out = torch.empty((num_out,) + tuple(frames_seq.shape[1:]), dtype=torch.uint8,
                      pin_memory=pinned)
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
            n = min(pre_cfg.gen_batch_size, num_out - i)
            rows = slice(i, i + n)
            if not pmesh.is_degenerate(spec):
                shard = pmesh.padded_rows(spec, n)
                idx = np.arange(i, i + shard.count * spec.data_size).clip(max=i + n - 1)
                rows = idx[shard.start:shard.start + shard.count]
            with annotate("lipsync/gather"):
                batch = [on_device(a, rows) for a in (frames_seq, boxes, mel_windows)]
            res = lipsync_batch(gen, *batch, img, int8, act_scales, pmesh.data_max(spec))
            del batch       # the inputs freed before the next batch's are gathered
            with annotate("lipsync/fetch"):
                out[i:i + n].copy_(pmesh.all_gather(res, spec, spec.data_axis)[:n],
                                   non_blocking=pinned)
                del res     # stream-ordered: the block is reused only after the copy
                HOST_IO_ROUTES["pinned" if pinned else "plain"] += 1
    with annotate("lipsync/concat"):
        if pinned:
            torch.cuda.current_stream(device).synchronize()
        return out.numpy()


@dataclasses.dataclass
class InferenceResult:
    frames: np.ndarray          # (T, H, W, 3) uint8 output frames
    boxes: np.ndarray           # (T, 4) y1y2x1x2 face boxes used
    muxed: bool                 # the audio was muxed in


def prepare_input_frames(face_path: str, resize_factor: int = 1, rotate: bool = False,
                         crop: tuple = (0, -1, 0, -1),
                         default_fps: float = 25.0) -> Tuple[np.ndarray, float]:
    """(frames (T, H, W, 3) RGB uint8, fps) of a face video, or of a still
    image (.jpg/.jpeg/.png: one frame at ``default_fps``), through OpenCV,
    conditioned as the reference does: downscaled by ``resize_factor``
    (OpenCV's bilinear resize), rotated 90° clockwise, then cropped (y1, y2,
    x1, x2), −1 meaning to the edge."""
    cv2 = video_io._cv2("prepare_input_frames")
    ext = face_path.rsplit(".", 1)[-1].lower()
    if ext in ("jpg", "png", "jpeg"):
        img = cv2.imread(face_path)
        if img is None:
            raise FileNotFoundError(f"cannot read image {face_path!r}")
        frames, fps = img[None, :, :, ::-1], default_fps
    else:
        frames, fps = video_io.read_video_frames(face_path)
    if resize_factor > 1:
        h, w = frames.shape[1] // resize_factor, frames.shape[2] // resize_factor
        frames = np.stack([cv2.resize(f, (w, h)) for f in frames])
    if rotate:
        frames = np.rot90(frames, k=-1, axes=(1, 2)).copy()
    y1, y2, x1, x2 = crop
    y2 = frames.shape[1] if y2 == -1 else y2
    x2 = frames.shape[2] if x2 == -1 else x2
    return frames[:, y1:y2, x1:x2], fps


def _load_wav(audio_path: str, audio_cfg: AudioConfig) -> np.ndarray:
    """A .wav as it is; any other file through ffmpeg's audio extraction
    into a temporary .wav (``ValueError`` without ffmpeg or a sidecar .wav)."""
    if audio_path.endswith(".wav"):
        return video_io.load_wav(audio_path, audio_cfg.sample_rate)
    import tempfile

    fd, tmp_wav = tempfile.mkstemp(suffix=".wav")
    os.close(fd)
    try:
        if not video_io.extract_audio(audio_path, tmp_wav, audio_cfg.sample_rate):
            raise ValueError(
                f"cannot extract audio from {audio_path!r} (no ffmpeg and no sidecar .wav)")
        return video_io.load_wav(tmp_wav, audio_cfg.sample_rate)
    finally:
        os.unlink(tmp_wav)


def lipsync_video(
    gen_params: Dict[str, torch.Tensor],
    s3fd: S3FD,
    face_video: str,
    audio_path: str,
    out_path: str,
    gan_cfg: GanConfig = GanConfig(),
    audio_cfg: AudioConfig = AudioConfig(),
    pre_cfg: PreprocessConfig = PreprocessConfig(),
    static_frame: bool = False,
    model_width: float = 1.0,
    pads: tuple = (0, 10, 0, 0),
    resize_factor: int = 1,
    crop: tuple = (0, -1, 0, -1),
    rotate: bool = False,
    nosmooth: bool = False,
    mesh_spec=None,
    *,
    read_frames: Callable[..., Tuple[np.ndarray, float]] = prepare_input_frames,
    write_video: Callable[[str, np.ndarray, float], None] = video_io.write_video,
    device=None,
) -> InferenceResult:
    """End-to-end lip-sync on ``device`` (None: the card): the frames of
    ``face_video`` (``read_frames(path, resize_factor, rotate, crop)`` →
    (frames, fps), by default ``prepare_input_frames``; one frame, or
    ``static_frame``, repeats the first), the mel of ``audio_path``
    (refused when not finite), as many output frames as the audio lasts at
    the video's fps (the input frames wrap around), S3FD face tracks widened
    by ``pads`` and smoothed unless ``nosmooth`` (``s3fd``: an ``S3FD`` with
    its weights), the
    aligned mel windows, ``generate_frames`` (``gen_params``: the
    generator's ``state_dict``), then ``write_video(path, frames, fps)`` of
    the silent video beside ``out_path`` and the audio muxed in with ffmpeg
    where it is installed. A ``write_video`` that writes no file keeps the
    result only in the returned ``InferenceResult`` (``muxed`` False).
    ``mesh_spec``: ``generate_frames`` data-parallel over it (every rank
    runs the whole request around it); the primary rank writes the video."""
    device = resolve_device(device)
    frames, fps = read_frames(face_video, resize_factor, rotate, crop)
    frames = np.asarray(frames)
    if static_frame or len(frames) == 1:
        frames = np.repeat(frames[:1], max(len(frames), 1), 0)
    wav = _load_wav(audio_path, audio_cfg)
    mel = audio_ops.melspectrogram(torch.from_numpy(wav).to(device), audio_cfg)
    if not bool(torch.isfinite(mel).all()):
        raise ValueError("mel contains NaN/inf")

    # as many output frames as the audio lasts at the video's fps
    num_out = int(mel.shape[-1] / audio_cfg.mel_step_per_frame / 25.0 * fps)
    num_out = max(1, min(num_out, int(len(wav) / audio_cfg.sample_rate * fps)))
    frames_seq = frames[np.arange(num_out) % len(frames)]

    s3fd = s3fd.to(device).eval()
    boxes = detect_face_tracks(s3fd, frames_seq, pre_cfg, pads=pads,
                               nosmooth=nosmooth).cpu().numpy()
    windows = _mel_chunks(mel, num_out, fps, audio_cfg).cpu().numpy()       # (N, 80, 16)
    result = generate_frames(gen_params, frames_seq, boxes, windows, gan_cfg, pre_cfg,
                             model_width, mesh_spec=mesh_spec, device=device)
    if not is_primary():
        return InferenceResult(frames=result, boxes=boxes, muxed=False)

    tmp_video, wav_tmp = out_path + ".silent.mp4", out_path + ".wav"
    muxed = False
    try:
        write_video(tmp_video, result, fps)
        if os.path.exists(tmp_video):
            video_io.save_wav(wav_tmp, wav, audio_cfg.sample_rate)
            muxed = video_io.mux_audio(tmp_video, wav_tmp, out_path)
    finally:
        for p in (tmp_video, wav_tmp):
            if os.path.exists(p) and p != out_path:
                os.unlink(p)
    return InferenceResult(frames=result, boxes=boxes, muxed=muxed)
