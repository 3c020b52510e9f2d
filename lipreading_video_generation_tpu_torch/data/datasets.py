"""Dataset samplers: fixed-shape numpy batches for the trainers.

Port of the part of ``lipreading_video_generation_tpu/data/datasets.py``
the ViViT trainer needs: ``WordClipSampler`` (:347-393) and
``synthetic_word_clips`` (:550-565), copied in numpy, so a batch and the
shuffle order equal the JAX package's bit for bit. The rest of that module
reads videos through OpenCV or feeds the GAN and diffusion trainers and
comes with their slices.
"""
from __future__ import annotations

from typing import Dict, Iterator, Sequence

import numpy as np


class WordClipSampler:
    """Per-word mouth-ROI windows → fixed (T, H, W) uint8 clips + label ids.

    Clips shorter than ``max_frames`` are zero-padded, longer ones cut.
    """

    def __init__(
        self,
        clips: Sequence[np.ndarray],   # each (t, H, W) or (t, H, W, C) uint8
        labels: Sequence[int],
        max_frames: int = 5,
        seed: int = 0,
    ):
        if len(clips) != len(labels):
            raise ValueError(f"{len(clips)} clips but {len(labels)} labels")
        self.clips = list(clips)
        self.labels = np.asarray(labels, np.int32)
        self.max_frames = max_frames
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.clips)

    def _fix(self, clip: np.ndarray) -> np.ndarray:
        if clip.ndim == 3:
            clip = clip[..., None]
        t = len(clip)
        if t >= self.max_frames:
            return clip[: self.max_frames]
        pad = np.zeros((self.max_frames - t,) + clip.shape[1:], clip.dtype)
        return np.concatenate([clip, pad])

    def batches(self, batch_size: int, shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """Whole batches of ``{"clips": (B, T, H, W, C) uint8, "labels": (B,)
        int32}``; a shuffled pass draws its order from the sampler's own
        generator, so each epoch has another."""
        idx = np.arange(len(self.clips))
        if shuffle:
            self.rng.shuffle(idx)
        for i in range(0, len(idx) - batch_size + 1, batch_size):
            pick = idx[i : i + batch_size]
            yield {
                "clips": np.stack([self._fix(self.clips[j]) for j in pick]),
                "labels": self.labels[pick],
            }


def synthetic_word_clips(
    n: int = 64, t: int = 5, hw: int = 32, num_classes: int = 8, seed: int = 0
):
    """Clips whose mean brightness encodes the label — linearly separable,
    so training-convergence smoke tests can assert learning."""
    rng = np.random.default_rng(seed)
    clips, labels = [], []
    for i in range(n):
        label = int(rng.integers(num_classes))
        base = 255.0 * (label + 0.5) / num_classes
        clip = np.clip(
            rng.normal(base, 20.0, (t, hw, hw)), 0, 255
        ).astype(np.uint8)
        clips.append(clip)
        labels.append(label)
    return clips, labels
