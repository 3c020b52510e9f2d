"""End-to-end lipreading: LRS2 records → word clips → ViViT → sentence eval.

Port of ``lipreading_video_generation_tpu/pipelines/lipreading_e2e.py``: walk
the LRS2 tree, extract per-word mouth-ROI clips (S3FD face tracks, mouth
boxes, the fused ROI pipeline with CLAHE), build the vocabulary, train the
ViViT classifier, and evaluate word accuracy and LM-scored sentence accuracy.
On the card, each clip launches the CLAHE kernel K1 once, the ViViT's
attention is the small-MHA kernel K2 (bf16, tensor-core route), and the
sentence scorer's word LM launches K2 too (float32, causal, CUDA-core route)
in every training step and beam level.

``read_frames`` (keyword-only; default ``data.video.read_video_frames``,
which decodes with OpenCV) maps a record's video path to (frames, fps): a
caller without OpenCV feeds decoded frames from memory through it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import Config, replace
from ..core.device import resolve_device
from ..core.prng import seeded
from ..data import video as video_io
from ..data.datasets import WordClipSampler
from ..data.manifest import ClipRecord, build_manifest, build_vocab, word_windows
from ..models.s3fd import S3FD
from . import sentence_eval as se
from . import train_vivit
from .preprocess import preprocess_clip_for_lipreading

ReadFrames = Callable[[str], Tuple[np.ndarray, float]]


@dataclasses.dataclass
class LipreadingDataset:
    """Word clips of a set of records, with their sentence boundaries."""

    clips: List[np.ndarray]          # (T, h, w, 1) uint8 each
    labels: np.ndarray               # (N,) word ids
    words: List[str]
    vocab: Dict[str, int]
    sentence_start_idx: List[int]    # first word index of each clip/sentence
    transcripts: List[str]


def build_word_clip_dataset(
    cfg: Config,
    records: Sequence[ClipRecord],
    s3fd_params: Optional[S3FD] = None,
    max_clips: Optional[int] = None,
    landmark_params=None,
    *,
    read_frames: ReadFrames = video_io.read_video_frames,
    device=None,
) -> LipreadingDataset:
    """LRS2 records → per-word ROI clips + labels + sentence boundaries, on
    ``device`` (None: the card). ``s3fd_params`` is the face detector (None:
    an ``S3FD`` drawn from seed 0, whose detections are noise: the tracks
    then fall back to whole-frame boxes); ``landmark_params`` a
    ``LipLandmarkNet`` that replaces the geometric mouth-box estimate.
    Records whose frames cannot be read are skipped."""
    device = resolve_device(device)
    if s3fd_params is None:
        s3fd_params = seeded(S3FD, 0)
    s3fd_params = s3fd_params.to(device).eval()
    if landmark_params is not None:
        landmark_params = landmark_params.to(device).eval()
    vocab = build_vocab(records)
    clips: List[np.ndarray] = []
    words: List[str] = []
    labels: List[int] = []
    starts: List[int] = []
    transcripts: List[str] = []
    for rec in records[: max_clips or len(records)]:
        spans = word_windows(rec, cfg.gan.fps)
        if not spans:
            continue
        try:
            frames, _ = read_frames(rec.video_path)
        except (OSError, ValueError):
            continue
        cclips, cwords = preprocess_clip_for_lipreading(
            frames, s3fd_params, spans, cfg.preprocess, cfg.vivit.num_frames,
            landmark_params=landmark_params)
        starts.append(len(words))
        transcripts.append(rec.text)
        for clip, word in zip(cclips, cwords):
            clips.append(clip)
            words.append(word)
            labels.append(vocab.get(word.upper(), 0))
    return LipreadingDataset(
        clips=clips, labels=np.asarray(labels, np.int32), words=words, vocab=vocab,
        sentence_start_idx=starts, transcripts=transcripts)


def run(
    cfg: Config,
    data_root: str,
    num_epochs: Optional[int] = None,
    max_clips: Optional[int] = None,
    metrics_writer=None,
    landmark_checkpoint: Optional[str] = None,
    s3fd_checkpoint: Optional[str] = None,
    *,
    read_frames: ReadFrames = video_io.read_video_frames,
    device=None,
) -> Tuple[train_vivit.ViViTTrainState, Dict[str, float]]:
    """Manifest → word clips → ViViT training → word accuracy and
    beam-search sentence accuracy, on ``device`` (None: the card).

    ``s3fd_checkpoint`` is a ``torch.save``d ``S3FD`` state dict in
    ``s3fd.pth``'s layout (without it the detector is drawn from a seed and
    the ROIs come from whole-frame boxes); ``landmark_checkpoint`` a
    ``train-landmark --out`` directory. The last ~15% of sentences are held
    out for eval; where that holds out none, eval is on the training clips."""
    device = resolve_device(device)
    landmark_params = None
    if landmark_checkpoint is not None:
        from .train_landmark import load_params

        landmark_params = load_params(landmark_checkpoint, device=device)
    s3fd_params = None
    if s3fd_checkpoint is not None:
        s3fd_params = seeded(S3FD, 0)
        s3fd_params.load_state_dict(torch.load(s3fd_checkpoint, map_location="cpu",
                                               weights_only=True))
    records, skipped = build_manifest(data_root, require_transcript=True)
    ds = build_word_clip_dataset(cfg, records, s3fd_params=s3fd_params, max_clips=max_clips,
                                 landmark_params=landmark_params, read_frames=read_frames,
                                 device=device)
    if not ds.clips:
        raise ValueError(f"no word clips extracted from {data_root!r} ({skipped} skipped)")

    cfg = replace(cfg, vivit=replace(cfg.vivit, num_classes=max(2, len(ds.vocab))))
    # train/test cut at a sentence boundary: the last ~15% of sentences held out
    cut_sentence = max(1, int(0.85 * len(ds.sentence_start_idx)))
    cut = (ds.sentence_start_idx[cut_sentence]
           if cut_sentence < len(ds.sentence_start_idx) else len(ds.clips))
    train_clips, train_labels = ds.clips[:cut], ds.labels[:cut]
    test_clips, test_labels = ds.clips[cut:], ds.labels[cut:]
    if not test_clips:  # tiny datasets: eval on train
        test_clips, test_labels = train_clips, train_labels
    sampler = WordClipSampler(train_clips, train_labels, cfg.vivit.num_frames, seed=cfg.seed)
    test_sampler = WordClipSampler(test_clips, test_labels, cfg.vivit.num_frames, seed=cfg.seed)
    bs = min(cfg.vivit.batch_size, len(train_clips), len(test_clips))
    state, best = train_vivit.train(
        cfg,
        lambda: sampler.batches(bs),
        lambda: test_sampler.batches(bs, shuffle=False),
        num_epochs=num_epochs,
        metrics_writer=metrics_writer,
        device=device,
    )

    # sentence-level eval over the full word sequence
    fixed = np.stack([sampler._fix(c) for c in ds.clips])
    logp = train_vivit.predict_sharded(state.model.eval(), fixed).cpu().numpy()
    vocab_list = [w for w, _ in sorted(ds.vocab.items(), key=lambda kv: kv[1])]
    scorer = se.fit_default_scorer(ds.transcripts, seed=cfg.seed, device=device)
    sent_acc = se.evaluate_sentences(
        logp, ds.labels, ds.sentence_start_idx, vocab_list, scorer,
        word_top_k=cfg.sentence_eval.word_top_k,
        beam_width=cfg.sentence_eval.beam_width,
        keep_top=cfg.sentence_eval.keep_top,
    )
    return state, {**best, "sentence_accuracy": sent_acc}
