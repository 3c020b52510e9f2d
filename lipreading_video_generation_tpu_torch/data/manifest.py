"""LRS2 dataset manifests: filelists, transcripts, word alignments, vocab.

Copy of ``lipreading_video_generation_tpu/data/manifest.py`` (pure Python;
the port keeps its own copy so that it never imports the JAX package):
- filelists ``train/val/test.txt`` of clip ids,
- per-clip ``.txt`` transcripts whose first line is ``Text:  ...`` and
  whose lines 5+ are ``WORD start end`` word alignments,
- vocab building over transcript words, id 0 for OOV/pad.

Entries that fail to parse are dropped and counted, so sampling is
deterministic.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class WordSpan:
    word: str
    start: float  # seconds
    end: float


@dataclass
class ClipRecord:
    clip_id: str            # e.g. "6330311066473698535/00011"
    video_path: str
    transcript_path: Optional[str] = None
    text: str = ""
    words: List[WordSpan] = field(default_factory=list)


def read_filelist(path: str) -> List[str]:
    """Lines of clip ids (get_image_list, dataset.py:20-27)."""
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def parse_transcript(path: str) -> Tuple[str, List[WordSpan]]:
    """LRS2 transcript: line 1 ``Text:  THE WORDS``; alignment lines
    ``WORD start end score`` from line 5 on (get_data.py:13-20,62-66)."""
    text = ""
    words: List[WordSpan] = []
    with open(path) as f:
        lines = f.read().splitlines()
    if lines and lines[0].lower().startswith("text:"):
        text = lines[0].split(":", 1)[1].strip()
    for line in lines[4:]:
        parts = line.split()
        if len(parts) >= 3:
            try:
                words.append(WordSpan(parts[0], float(parts[1]), float(parts[2])))
            except ValueError:
                continue
    return text, words


def build_manifest(
    data_root: str,
    filelist: Optional[Sequence[str]] = None,
    require_transcript: bool = False,
) -> Tuple[List[ClipRecord], int]:
    """Walk (or filter by filelist) an LRS2-layout tree of ``<id>.mp4`` +
    ``<id>.txt`` pairs → validated ClipRecords. Returns (records, skipped).
    """
    records: List[ClipRecord] = []
    skipped = 0
    if filelist is not None:
        candidates = [os.path.join(data_root, cid) for cid in filelist]
    else:
        candidates = []
        for dirpath, _, files in sorted(os.walk(data_root)):
            for fn in sorted(files):
                if fn.endswith(".mp4"):
                    candidates.append(os.path.join(dirpath, fn)[: -len(".mp4")])
    for base in candidates:
        video = base + ".mp4"
        txt = base + ".txt"
        if not os.path.exists(video):
            skipped += 1
            continue
        rec = ClipRecord(
            clip_id=os.path.relpath(base, data_root),
            video_path=video,
        )
        if os.path.exists(txt):
            rec.transcript_path = txt
            try:
                rec.text, rec.words = parse_transcript(txt)
            except OSError:
                skipped += 1
                continue
        elif require_transcript:
            skipped += 1
            continue
        records.append(rec)
    return records, skipped


def build_vocab(records: Sequence[ClipRecord]) -> Dict[str, int]:
    """word → id over all transcript words (get_data.py:62-72 +
    keras StringLookup at main.py:49-51); id 0 reserved for OOV/pad."""
    vocab: Dict[str, int] = {"[UNK]": 0}
    for rec in records:
        for w in rec.text.split():
            w = w.upper()
            if w not in vocab:
                vocab[w] = len(vocab)
    return vocab


def word_windows(
    rec: ClipRecord, fps: float = 25.0
) -> List[Tuple[str, int, int]]:
    """(word, start_frame, end_frame) per aligned word —
    round(fps·t) slicing per get_data.py:54-58."""
    out = []
    for span in rec.words:
        out.append((span.word, int(round(fps * span.start)), int(round(fps * span.end))))
    return out
