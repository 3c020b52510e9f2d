"""Offline dataset preprocessing: videos → per-clip face-crop frames + wav.

Port of ``lipreading_video_generation_tpu/pipelines/offline_preprocess.py``:
each clip of a manifest is decoded, its face tracked by S3FD in batches
(``inference.detect_face_tracks``), the crops written as ``{i}.jpg`` with
``audio.wav`` (and ``text.txt`` where the clip has a transcript) into
``out_root/<clip_id>/``, the layout ``data.datasets.load_gan_clip`` reads.
Hosts split the clip list round-robin (``shard_for_host``). OpenCV writes
the JPEGs and is imported on call.
"""
from __future__ import annotations

import os
import traceback
from typing import List, Optional, Sequence, Tuple

from ..core.config import PreprocessConfig
from ..data import video as video_io
from ..data.manifest import ClipRecord, parse_transcript
from ..models.s3fd import S3FD


def shard_for_host(items: Sequence, host_id: int, num_hosts: int) -> List:
    """This host's slice of the work list: every ``num_hosts``-th item from
    ``host_id`` on."""
    return [it for i, it in enumerate(items) if i % num_hosts == host_id]


def process_clip(s3fd: S3FD, record: ClipRecord, out_root: str,
                 cfg: PreprocessConfig = PreprocessConfig(),
                 crop_pad: int = 0) -> Optional[str]:
    """One clip: decode → face tracks (on ``s3fd``'s device) → crops, wav and
    transcript on disk. Returns the clip's directory, or None when it failed
    (the traceback printed, nothing raised)."""
    from .inference import detect_face_tracks

    try:
        cv2 = video_io._cv2("process_clip")
        frames, _ = video_io.read_video_frames(record.video_path)
        boxes = detect_face_tracks(s3fd, frames, cfg).cpu().numpy()    # (T, 4) y1y2x1x2
        out_dir = os.path.join(out_root, record.clip_id)
        os.makedirs(out_dir, exist_ok=True)
        h, w = frames.shape[1:3]
        for i, (frame, box) in enumerate(zip(frames, boxes)):
            y1 = max(0, int(box[0]) - crop_pad)
            y2 = min(h, int(box[1]) + crop_pad)
            x1 = max(0, int(box[2]) - crop_pad)
            x2 = min(w, int(box[3]) + crop_pad)
            cv2.imwrite(os.path.join(out_dir, f"{i}.jpg"), frame[y1:y2, x1:x2, ::-1])
        video_io.extract_audio(record.video_path, os.path.join(out_dir, "audio.wav"))
        if record.transcript_path and os.path.exists(record.transcript_path):
            text, _ = parse_transcript(record.transcript_path)
            if text:
                with open(os.path.join(out_dir, "text.txt"), "w") as f:
                    f.write(text.lower() + "\n")
        return out_dir
    except Exception:  # noqa: BLE001 — a failed clip is counted, the dataset goes on
        traceback.print_exc()
        return None


def preprocess_dataset(s3fd: S3FD, records: Sequence[ClipRecord], out_root: str,
                       cfg: PreprocessConfig = PreprocessConfig(), host_id: int = 0,
                       num_hosts: int = 1) -> Tuple[int, int]:
    """This host's shard of ``records`` through ``process_clip`` →
    (ok, failed)."""
    ok = failed = 0
    for rec in shard_for_host(records, host_id, num_hosts):
        if process_clip(s3fd, rec, out_root, cfg) is None:
            failed += 1
        else:
            ok += 1
    return ok, failed
