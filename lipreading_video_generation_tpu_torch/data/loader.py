"""The host side of the feed: a producer thread keeps numpy batches ready
while the card computes.

Port of ``lipreading_video_generation_tpu/data/loader.py``'s
``iterator_feed``, ``host_prefetch``, ``take`` and ``stack_batches``.
``prefetch_to_device`` comes with the GAN trainer that uses it.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator

import numpy as np


def iterator_feed(it: Iterator[Dict[str, np.ndarray]]) -> Callable[[], Dict[str, np.ndarray]]:
    """Adapt an iterator of batches to the batch_fn protocol (raises
    ``StopIteration`` at its end)."""
    def fn():
        return next(it)
    return fn


def host_prefetch(
    batch_fn: Callable[[], Dict[str, np.ndarray]],
    depth: int = 16,
) -> Iterator[Dict[str, np.ndarray]]:
    """Producer-thread iterator of host batches (no device transfer): while
    the card runs a step, the producer makes the next ones. Ends cleanly
    when ``batch_fn`` raises StopIteration; any other exception of
    ``batch_fn`` is raised here, in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def producer():
        try:
            while not stop.is_set():
                try:
                    batch = batch_fn()
                except StopIteration:
                    break
                q.put(batch)
        except Exception as e:  # noqa: BLE001 — handed to the consumer, which raises it
            q.put(e)
            return
        q.put(None)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            batch = q.get()
            if batch is None:
                break
            if isinstance(batch, Exception):
                raise batch
            yield batch
    finally:
        stop.set()
        while not q.empty():
            q.get_nowait()


def take(it: Iterator, n: int) -> list:
    """Up to ``n`` items from ``it`` (fewer at feed end)."""
    out = []
    for _ in range(n):
        try:
            out.append(next(it))
        except StopIteration:
            break
    return out


def stack_batches(raws) -> Dict[str, np.ndarray]:
    """[{k: (B, ...)}] → {k: (N, B, ...)}: a step-stacked host tree."""
    return {k: np.stack([r[k] for r in raws]) for k in raws[0]}
