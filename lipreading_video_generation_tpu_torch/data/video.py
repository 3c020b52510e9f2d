"""Host-side media IO: video decode, wav IO, ffmpeg gating.

Port of ``lipreading_video_generation_tpu/data/video.py``: decoded frames
are (T, H, W, 3) uint8 numpy arrays (RGB unless asked otherwise), the one
boundary between files and the device pipelines.

OpenCV is imported inside the functions that read or write video, and a
missing ``cv2`` raises ``ImportError`` naming what needs it: the port runs
where OpenCV is absent as long as frames come from memory (see
``pipelines.lipreading_e2e.run(read_frames=...)``). wav IO is scipy's;
ffmpeg (audio extraction and muxing) is used where it is on the PATH.
PNG images are written without OpenCV (``write_png``: ``zlib`` and
``struct``), so the sampler writes its frames where OpenCV is absent.
"""
from __future__ import annotations

import importlib
import os
import shutil
import struct
import subprocess
import zlib
from typing import List, Optional, Tuple

import numpy as np
from scipy.io import wavfile

FFMPEG = shutil.which("ffmpeg")


def _cv2(what: str):
    """The ``cv2`` module; ``ImportError`` naming ``what`` needs it."""
    try:
        return importlib.import_module("cv2")
    except ImportError as e:
        raise ImportError(
            f"{what} needs OpenCV (cv2), which is not installed here; pass decoded "
            "frames instead (e.g. lipreading_e2e.run(..., read_frames=...))") from e


def read_video_frames(
    path: str,
    max_frames: Optional[int] = None,
    resize: Optional[Tuple[int, int]] = None,
    to_rgb: bool = True,
) -> Tuple[np.ndarray, float]:
    """Decode a video into (T, H, W, 3) uint8 + fps. cv2 yields BGR; RGB is
    returned by default (the framework-wide channel order)."""
    cv2 = _cv2("read_video_frames")
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {path!r}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    frames: List[np.ndarray] = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if resize is not None:
            frame = cv2.resize(frame, (resize[1], resize[0]))
        if to_rgb:
            frame = frame[:, :, ::-1]
        frames.append(frame)
        if max_frames is not None and len(frames) >= max_frames:
            break
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path!r}")
    return np.stack(frames), float(fps)


def video_frame_count(path: str) -> int:
    cv2 = _cv2("video_frame_count")
    cap = cv2.VideoCapture(path)
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()


def write_video(path: str, frames: np.ndarray, fps: float = 25.0) -> None:
    """(T, H, W, 3) RGB uint8 → video file (DIVX for .avi, mp4v otherwise)."""
    cv2 = _cv2("write_video")
    t, h, w, _ = frames.shape
    fourcc = cv2.VideoWriter_fourcc(*("DIVX" if path.endswith(".avi") else "mp4v"))
    out = cv2.VideoWriter(path, fourcc, fps, (w, h))
    try:
        for f in frames:
            out.write(np.ascontiguousarray(f[:, :, ::-1]))
    finally:
        out.release()


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """(H, W, 3) RGB uint8 → an 8-bit RGB PNG file (every row unfiltered,
    one zlib stream), written without OpenCV."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)   # 8-bit RGB, no interlace
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
                + _png_chunk(b"IDAT", zlib.compress(raw, 6)) + _png_chunk(b"IEND", b""))


def write_image(path: str, img: np.ndarray) -> None:
    """(H, W, 3) RGB uint8 → an image file: ``write_png`` for ``.png``,
    OpenCV for other formats (``ImportError`` where it is absent)."""
    if path.lower().endswith(".png"):
        write_png(path, img)
    elif not _cv2("write_image").imwrite(path, np.ascontiguousarray(img[:, :, ::-1])):
        raise OSError(f"OpenCV could not write {path!r}")


def load_wav(path: str, target_sr: int = 16000) -> np.ndarray:
    """wav → float32 mono in [-1, 1] at target_sr (linear resample if
    needed)."""
    sr, data = wavfile.read(path)
    if data.ndim == 2:
        data = data.mean(axis=1)
    if np.issubdtype(data.dtype, np.integer):
        data = data.astype(np.float32) / float(np.iinfo(data.dtype).max)
    else:
        data = data.astype(np.float32)
    if sr != target_sr:
        n_out = int(round(len(data) * target_sr / sr))
        x_old = np.linspace(0.0, 1.0, len(data), endpoint=False)
        x_new = np.linspace(0.0, 1.0, n_out, endpoint=False)
        data = np.interp(x_new, x_old, data).astype(np.float32)
    return data


def save_wav(path: str, wav: np.ndarray, sr: int = 16000) -> None:
    """float wav → int16 file with peak rescale."""
    scaled = wav * (32767 / max(0.01, float(np.max(np.abs(wav)))))
    wavfile.write(path, sr, scaled.astype(np.int16))


def extract_audio(video_path: str, wav_path: str, sr: int = 16000) -> bool:
    """mp4 → wav via ffmpeg when available; otherwise a sidecar ``.wav``
    next to the video is copied. Returns success."""
    sidecar = os.path.splitext(video_path)[0] + ".wav"
    if os.path.exists(sidecar):
        if os.path.abspath(sidecar) != os.path.abspath(wav_path):
            shutil.copyfile(sidecar, wav_path)
        return True
    if FFMPEG is None:
        return False
    cmd = [FFMPEG, "-y", "-i", video_path, "-ac", "1", "-ar", str(sr),
           "-acodec", "pcm_s16le", "-loglevel", "error", wav_path]
    return subprocess.run(cmd, check=False).returncode == 0


def mux_audio(video_path: str, wav_path: str, out_path: str) -> bool:
    """Remux a video with audio. Without ffmpeg, or if the mux fails, the
    silent video is copied to ``out_path`` and False returned."""
    if FFMPEG is None:
        shutil.copyfile(video_path, out_path)
        return False
    cmd = [FFMPEG, "-y", "-i", wav_path, "-i", video_path, "-strict", "-2",
           "-q:v", "1", "-loglevel", "error", out_path]
    if subprocess.run(cmd, check=False).returncode == 0:
        return True
    shutil.copyfile(video_path, out_path)
    return False
