"""High-level face-detection API.

Port of ``lipreading_video_generation_tpu/models/face_api.py``: construct a
``FaceAlignment`` once, call ``get_detections_for_batch`` on a uint8 BGR
image batch, get per-image ``(x1, y1, x2, y2)`` boxes or None. Backed by
``models.s3fd``'s batched detector on one device.
"""
from __future__ import annotations

import enum
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.prng import seeded
from .s3fd import S3FD, detect_faces


class LandmarksType(enum.Enum):
    """Kept for the interface; detection only, as in the reference."""

    TWO_D = 1
    TWO_HALF_D = 2
    THREE_D = 3


class FaceAlignment:
    """Batched face detector with the reference's API shape. ``state_dict``
    is an ``S3FD`` state dict in ``s3fd.pth``'s layout (None: weights made
    from ``seed``); ``device`` is where it runs (None: the card)."""

    def __init__(
        self,
        landmarks_type: LandmarksType = LandmarksType.TWO_D,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        score_threshold: float = 0.5,
        nms_threshold: float = 0.3,
        seed: int = 0,
        device=None,
    ):
        self.landmarks_type = landmarks_type
        self.model = seeded(S3FD, seed).to(resolve_device(device)).eval()
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.score_threshold = score_threshold
        self.nms_threshold = nms_threshold

    def get_detections_for_batch(self, images: np.ndarray
                                 ) -> List[Optional[Tuple[int, int, int, int]]]:
        """(B, H, W, 3) uint8 BGR → per image the best face's (x1, y1, x2, y2)
        as ints, or None where there is none."""
        boxes, _, valid = detect_faces(
            self.model, torch.from_numpy(np.ascontiguousarray(images)),
            score_threshold=self.score_threshold, nms_threshold=self.nms_threshold)
        boxes, valid = boxes.cpu().numpy(), valid.cpu().numpy()
        out: List[Optional[Tuple[int, int, int, int]]] = []
        for b in range(len(images)):
            if not valid[b].any():
                out.append(None)
                continue
            x1, y1, x2, y2 = boxes[b, 0]
            out.append((int(x1), int(y1), int(x2), int(y2)))
        return out
