"""Soundex phonetic label collapsing.

Copy of ``lipreading_video_generation_tpu/pipelines/phonetics.py`` (pure
Python): each vocabulary word maps to its American Soundex class, so
visually identical words can share one label.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

_CODES = {
    **{c: "1" for c in "BFPV"},
    **{c: "2" for c in "CGJKQSXZ"},
    **{c: "3" for c in "DT"},
    **{c: "4" for c in "L"},
    **{c: "5" for c in "MN"},
    **{c: "6" for c in "R"},
}


def soundex(word: str) -> str:
    """American Soundex (jellyfish.soundex-compatible for A-Z words)."""
    w = "".join(c for c in word.upper() if c.isalpha())
    if not w:
        return ""
    first = w[0]
    # encode all letters; H/W are transparent (do not split runs), vowels split
    digits = []
    prev_code = _CODES.get(first, "")
    for c in w[1:]:
        code = _CODES.get(c, "")
        if code:
            if code != prev_code:
                digits.append(code)
            prev_code = code
        elif c in "HW":
            pass  # transparent: previous code survives
        else:
            prev_code = ""  # vowels reset run
    return (first + "".join(digits) + "000")[:4]


def create_phonetics(
    vocab_list: Sequence[str],
) -> Tuple[Dict[str, int], Dict[int, str], Dict[str, str], Dict[str, List[str]]]:
    """(phonetic→label, label→phonetic, word→phonetic, phonetic→words)
    (phonetics.py:3-15)."""
    word_to_phonetic = {w: soundex(w) for w in vocab_list}
    phonetic_to_word: Dict[str, List[str]] = defaultdict(list)
    for w, p in word_to_phonetic.items():
        phonetic_to_word[p].append(w)
    phonetic_list = sorted(set(word_to_phonetic.values()))
    phonetic_to_label = {p: i for i, p in enumerate(phonetic_list)}
    label_to_phonetic = {i: p for i, p in enumerate(phonetic_list)}
    return phonetic_to_label, label_to_phonetic, word_to_phonetic, dict(phonetic_to_word)


def word_labels_to_phonetic_labels(
    labels: Sequence[int],
    vocab_list: Sequence[str],
    word_to_phonetic: Dict[str, str],
    phonetic_to_label: Dict[str, int],
) -> List[int]:
    """Vectorized word-label → phonetic-label mapping (phonetics.py:17-21)."""
    return [phonetic_to_label[word_to_phonetic[vocab_list[x]]] for x in labels]
