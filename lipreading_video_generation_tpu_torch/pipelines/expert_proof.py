"""Does the sync expert discriminate? Aligned against shifted mel windows.

Port of the part of ``lipreading_video_generation_tpu/pipelines/expert_proof.py``
that ``train_syncnet.train`` reports with: ``_window_batch`` (face windows,
start frames and waves of held-out clips, with shift headroom),
``_sync_sims`` (the SyncNet's cosine of the window mel and the real face
window), ``alignment_scores`` (those cosines for aligned and for
±``shift``-frame shifted mels over the same face windows) and ``auc`` (the
rank AUC of the two). The windows and shift signs come from
``np.random.default_rng(seed)`` in the JAX package's order. The generator's
proof (``aperture_envelope_correlation``, ``mouth_aperture_proxy``) comes
with the lip expert (ROADMAP §1 item 7).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..core.config import AudioConfig, GanConfig
from ..data.datasets import GanClip
from ..models.syncnet import SyncNet, stack_window_lower_half
from .train_gan import prepare_batch


def _window_batch(clips: Sequence[GanClip], t: int, n: int, rng: np.random.Generator,
                  max_shift: int = 0) -> Dict[str, np.ndarray]:
    """n (window, wav, start) triples with ``max_shift`` frames of headroom on
    both sides of each window; clips shorter than t + 2·max_shift + 2 frames
    are skipped (``ValueError`` when none is long enough)."""
    min_len = t + 2 * max_shift + 2
    eligible = [c for c in clips if len(c.frames) >= min_len]
    if not eligible:
        raise ValueError(
            f"no clip has the >= {min_len} frames needed for T={t} windows with "
            f"{max_shift}-frame shift headroom (longest: {max(len(c.frames) for c in clips)})")
    windows, starts, wavs = [], [], []
    max_wav = max(len(c.wav) for c in eligible)
    for _ in range(n):
        clip = eligible[rng.integers(len(eligible))]
        lo, hi = max_shift + 1, len(clip.frames) - t - max_shift
        start = int(rng.integers(lo, hi))
        windows.append(clip.frames[start: start + t])
        starts.append(start)
        wavs.append(np.pad(clip.wav, (0, max_wav - len(clip.wav))))
    return {
        "window": np.stack(windows),
        "wrong_window": np.stack(windows),  # unused by the sync scorer
        "start_frame": np.asarray(starts, np.int32),
        "wav": np.stack(wavs).astype(np.float32),
    }


@torch.no_grad()
def _sync_sims(syncnet: SyncNet, batch: Dict[str, np.ndarray], cfg: GanConfig,
               audio_cfg: AudioConfig = AudioConfig()) -> torch.Tensor:
    """Cosine of (mel at start_frame, real face window) for each pair."""
    device = next(syncnet.parameters()).device
    prep = prepare_batch(batch, cfg, audio_cfg, device)
    a, v = syncnet(prep["mel"], stack_window_lower_half(prep["gt"]))
    return torch.sum(a * v, dim=-1)


def alignment_scores(syncnet: SyncNet, cfg: GanConfig, clips: Sequence[GanClip],
                     n_pairs: int = 64, shift: int = 6, seed: int = 0,
                     audio_cfg: AudioConfig = AudioConfig()) -> Tuple[np.ndarray, np.ndarray]:
    """(positive, negative) cosines of ``syncnet`` (on its device) for
    aligned and ``shift``-frame shifted mels over the same face windows; a
    working expert scores the positives higher (``auc``)."""
    rng = np.random.default_rng(seed)
    batch = _window_batch(clips, cfg.syncnet_T, n_pairs, rng, max_shift=shift)
    sign = rng.choice([-1, 1], size=n_pairs)
    shifted = dict(batch, start_frame=(batch["start_frame"] + sign * shift).astype(np.int32))
    pos = _sync_sims(syncnet, batch, cfg, audio_cfg).cpu().numpy()
    neg = _sync_sims(syncnet, shifted, cfg, audio_cfg).cpu().numpy()
    return pos, neg


def auc(pos: np.ndarray, neg: np.ndarray) -> float:
    """Rank AUC: P(pos > neg) + 0.5·P(tie), over all pairs."""
    pos = np.asarray(pos)[:, None]
    neg = np.asarray(neg)[None, :]
    return float((pos > neg).mean() + 0.5 * (pos == neg).mean())
