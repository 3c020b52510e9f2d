"""The feed: a producer thread keeps batches ready while the card computes.

Port of ``lipreading_video_generation_tpu/data/loader.py``:
``prefetch_to_device`` (batches handed out as tensors on the device),
``iterator_feed``, ``host_prefetch`` (numpy batches, the trainers' feed),
``take`` and ``stack_batches``; ``dispatch_bounds``, the trainers' chunking.
"""
from __future__ import annotations

import itertools
import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..core.device import resolve_device


def prefetch_to_device(batch_fn: Callable[[], Dict[str, np.ndarray]], spec=None,
                       depth: int = 2, num_batches: Optional[int] = None,
                       device=None) -> Iterator[Dict[str, torch.Tensor]]:
    """Run ``batch_fn`` in a producer thread and hand out its batches as
    tensors on ``device`` (``None``: the card), ``depth`` of them made and
    copied ahead, until ``num_batches`` or the end of the feed (a
    ``StopIteration`` or ``None`` from ``batch_fn``). The copies run in the
    producer thread on the device's current stream, so work queued after
    them sees their data. With ``spec`` (a mesh) each rank copies only its
    rows of every batch (``parallel.mesh.shard_batch``: the whole batch
    where its rows do not divide the data axis)."""
    from ..parallel.mesh import shard_batch

    device = resolve_device(device)
    produced = itertools.count()

    def on_device():
        if num_batches is not None and next(produced) >= num_batches:
            raise StopIteration
        batch = batch_fn()
        if batch is None:
            return None
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in shard_batch(spec, batch).items()}

    return host_prefetch(on_device, depth)


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
    when ``batch_fn`` raises StopIteration or returns ``None``; any other
    exception of ``batch_fn`` is raised here, in the consumer. ``close()``
    (or the end of the loop that consumes it) stops the producer and waits
    for it."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def producer():
        try:
            while not stop.is_set():
                try:
                    batch = batch_fn()
                except StopIteration:
                    break
                if batch is None:
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
        # free a producer waiting to put, and let it finish the batch it is
        # making: then nothing runs batch_fn once the feed is closed
        while thread.is_alive():
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass


def take(it: Iterator, n: int) -> list:
    """Up to ``n`` items from ``it`` (fewer at feed end)."""
    out = []
    for _ in range(n):
        try:
            out.append(next(it))
        except StopIteration:
            break
    return out


def dispatch_bounds(step: int, num_steps: int, steps_per_dispatch: int,
                    *intervals: Optional[int]) -> int:
    """How many steps the dispatch starting at ``step`` takes: up to
    ``steps_per_dispatch`` (at least 1), ending at ``num_steps`` and at the
    next multiple of each interval given (checkpoints, evals), so the steps
    at which those happen do not depend on ``steps_per_dispatch``."""
    bounds = [num_steps, step + max(1, steps_per_dispatch)]
    bounds += [step + iv - step % iv for iv in intervals if iv]
    return max(1, min(bounds) - step)


def stack_batches(raws) -> Dict[str, np.ndarray]:
    """[{k: (B, ...)}] → {k: (N, B, ...)}: a step-stacked host tree."""
    return {k: np.stack([r[k] for r in raws]) for k in raws[0]}
