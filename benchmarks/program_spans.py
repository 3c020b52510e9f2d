"""The program's own spans in the traced slice: the ``utils/profiling.annotate``
ranges the port opens inside the driver's ``bench/`` ranges (``lipsync/*``,
``sample/*``, ``train/*``, ``int8/*``), read by name from the host ops of the
slice's main thread. Their time, and the part of it in which the card ran no
device op of a given kind: idle where no kernel, memcpy or memset ran, as
``idle_pct`` counts it, wherever the op was launched from (the autograd
engine launches the backward from a thread of its own).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import devtrace

COMPUTE_CATS = ("kernel", "gpu_memset")     # the card's work other than copies


def intervals(sl, names: Iterable[str]) -> List[Tuple[float, float]]:
    """(start, end) in us of the main thread's spans named one of ``names``,
    clipped to the slice's window."""
    names = set(names)
    return [(max(h.start, sl.w0), min(h.end, sl.w1)) for h in sl.host
            if h.tid == sl.main_tid and h.name in names and h.end > sl.w0 and h.start < sl.w1]


def uncovered(sl, names: Iterable[str], cats: Sequence[str]) -> Tuple[float, float]:
    """(length of the union of the spans, the part of it in which no device
    op of ``cats`` ran), us: |A \\ B| = |A ∪ B| − |B|."""
    spans = intervals(sl, names)
    busy = [(op.start, op.end) for op in sl.device if op.cat in cats]
    return (devtrace.covered(spans),
            devtrace.covered(spans + busy) - devtrace.covered(busy))


def idle_pct(sl, names: Iterable[str]) -> Optional[float]:
    """100 × the part of the union of the spans in which no device op ran,
    over that union; None where the slice has no such span or no device op."""
    if sl is None or not sl.device:
        return None
    total, idle = uncovered(sl, names, devtrace.DEVICE_CATS)
    return 100.0 * idle / total if total > 0 else None


def per_unit(sl, names: Iterable[str], base: str, cats: Sequence[str] = ()) -> Optional[float]:
    """Time of the spans in which no device op of ``cats`` ran (all of it
    for none), ms over the slice's ``base`` count ("units": requests or
    steps; "frames"); None where either is missing."""
    if sl is None or not getattr(sl, base):
        return None
    total, left = uncovered(sl, names, cats)
    return left * 1e-3 / getattr(sl, base) if total > 0 else None
