"""Sentence-level lipreading eval: per-word top-k → LM-scored beam search.

Port of ``lipreading_video_generation_tpu/pipelines/sentence_eval.py``: per
word slot take the classifier's top-5 words, beam-search (width 20) over slot
combinations scored by a language model, keep the top-5 candidate sentences,
and count the sentence correct if the ground truth is among them.

A scorer is any callable ``scorer(sentence) -> float`` (higher is more
acceptable); one with ``score_batch(sentences)`` scores a whole beam level
in one call. Provided:

- ``NeuralScorer`` — the causal word LM of ``models.word_lm``, trained on
  the dataset's own transcripts; one batched forward per beam level, on
  the card the small-MHA kernel K2 (float32, causal, CUDA-core route) in
  each of its layers.
- ``NgramScorer`` — an add-k bigram LM, for transcript sets too small to
  train on (pure Python, a copy of the JAX package's).
- ``make_hf_cola_scorer`` — the reference's DistilBERT-CoLA scorer, where
  ``transformers`` and its checkpoint are installed.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device


class NgramScorer:
    """Add-k-smoothed bigram LM over training transcripts."""

    def __init__(self, k: float = 0.1):
        self.k = k
        self.unigram: Dict[str, int] = defaultdict(int)
        self.bigram: Dict[Tuple[str, str], int] = defaultdict(int)
        self.vocab = set()
        self.total = 0

    def fit(self, sentences: Sequence[str]) -> "NgramScorer":
        for s in sentences:
            words = ["<s>"] + s.upper().split() + ["</s>"]
            for w in words:
                self.vocab.add(w)
                self.unigram[w] += 1
                self.total += 1
            for a, b in zip(words[:-1], words[1:]):
                self.bigram[(a, b)] += 1
        return self

    def __call__(self, sentence: str) -> float:
        words = ["<s>"] + sentence.upper().split() + ["</s>"]
        v = max(1, len(self.vocab))
        lp = 0.0
        for a, b in zip(words[:-1], words[1:]):
            num = self.bigram[(a, b)] + self.k
            den = self.unigram[a] + self.k * v
            lp += math.log(num / den)
        return lp / max(1, len(words) - 1)  # length-normalized


class NeuralScorer:
    """Trained word-transformer acceptability scorer (``models.word_lm``).

    ``fit(transcripts)`` trains the LM on ``device`` (None: the card);
    ``score_batch`` scores a whole beam level in one forward.
    Length-normalised log-likelihood, the scale of ``NgramScorer``.
    """

    def __init__(self, max_len: int = 32, steps: int = 400, seed: int = 0,
                 hidden: int = 64, num_layers: int = 2, device=None):
        self.max_len = max_len
        self.steps = steps
        self.seed = seed
        self.hidden = hidden
        self.num_layers = num_layers
        self.device = resolve_device(device)
        self.model = None
        self.vocab = None

    def fit(self, sentences: Sequence[str]) -> "NeuralScorer":
        from ..models import word_lm

        self.model, self.vocab = word_lm.train_word_lm(
            list(sentences), max_len=self.max_len, steps=self.steps, seed=self.seed,
            hidden=self.hidden, num_layers=self.num_layers, device=self.device)
        return self

    @torch.inference_mode()
    def score_batch(self, sentences: Sequence[str]) -> List[float]:
        from ..models import word_lm

        toks = word_lm.encode_sentences(list(sentences), self.vocab, self.max_len)
        scores = word_lm.sequence_log_likelihood(self.model,
                                                 torch.from_numpy(toks).to(self.device))
        return scores.cpu().tolist()

    def __call__(self, sentence: str) -> float:
        return self.score_batch([sentence])[0]


def fit_default_scorer(transcripts: Sequence[str], min_sentences: int = 8,
                       seed: int = 0, device=None):
    """The default scorer: a trained ``NeuralScorer`` (on ``device``, None:
    the card) when there are at least ``min_sentences`` transcripts, the
    bigram ``NgramScorer`` otherwise."""
    transcripts = [t for t in transcripts if t and t.strip()]
    if len(transcripts) >= min_sentences:
        return NeuralScorer(seed=seed, device=device).fit(transcripts)
    return NgramScorer().fit(transcripts)


def make_hf_cola_scorer(model_name: str = "textattack/distilbert-base-uncased-CoLA"):
    """The reference's DistilBERT-CoLA acceptability scorer, where
    ``transformers`` and the checkpoint are installed (imported on call)."""
    from transformers import AutoModelForSequenceClassification, AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(model_name)
    model = AutoModelForSequenceClassification.from_pretrained(model_name)
    model.eval()

    def scorer(sentence: str) -> float:
        ids = tokenizer.encode(sentence, return_tensors="pt")
        with torch.no_grad():
            logits = model(ids)[0]
        return float(torch.log_softmax(logits, dim=-1).squeeze()[1])

    return scorer


def _score_all(scorer: Callable[[str], float], sentences: Sequence[str]) -> List[float]:
    """One beam-expansion level of scores: batched through the scorer's
    ``score_batch`` when it has one, per-candidate calls otherwise."""
    batch_fn = getattr(scorer, "score_batch", None)
    if batch_fn is not None:
        return list(batch_fn(sentences))
    return [scorer(s) for s in sentences]


def beam_search(
    scorer: Callable[[str], float],
    possible_words: Sequence[Sequence[str]],
    beam_width: int = 20,
    k: int = 5,
) -> List[str]:
    """Slot-wise beam search (sentence_eval.py:5-23): expand every beam by
    each slot candidate, keep beam_width by LM score, return top-k. Each
    expansion level is scored via ``_score_all`` (one batched call for
    batch-capable scorers)."""
    if not possible_words:
        return []
    beams: List[Tuple[float, str]] = [(0.0, "")]
    for slot in possible_words:
        expansions = []
        for _, prefix in beams:
            for word in slot:
                cand = (prefix + " " + word).strip()
                expansions.append(cand)
        scores = _score_all(scorer, expansions)
        scored = sorted(zip(scores, expansions), reverse=True)
        beams = scored[:beam_width]
    return [c for _, c in beams[:k]]


def evaluate_sentences(
    log_probs: np.ndarray,
    labels: np.ndarray,
    sentence_start_idx: Sequence[int],
    vocab_list: Sequence[str],
    scorer: Callable[[str], float],
    word_top_k: int = 5,
    beam_width: int = 20,
    keep_top: int = 5,
) -> float:
    """Sentence accuracy (sentence_eval.py:36-56, with its indexing bugs
    fixed): log_probs (N_words, |vocab|) classifier outputs in sentence
    order; labels (N_words,); sentence_start_idx marks sentence boundaries.
    A sentence counts as correct if the ground-truth word string is among
    the top ``keep_top`` beam candidates.
    """
    starts = list(sentence_start_idx)
    correct = 0
    for si, idx in enumerate(starts):
        next_idx = starts[si + 1] if si + 1 < len(starts) else len(labels)
        possible = []
        for pos in range(idx, next_idx):
            top = np.argsort(log_probs[pos])[::-1][:word_top_k]
            possible.append([vocab_list[int(p)] for p in top])
        candidates = beam_search(scorer, possible, beam_width, keep_top)
        truth = " ".join(vocab_list[int(labels[p])] for p in range(idx, next_idx))
        if truth in candidates:
            correct += 1
    return correct / max(1, len(starts))
