"""Profiling and timing harness.

Port of ``lipreading_video_generation_tpu/utils/profiling.py``: ``annotate``
names a span in ``torch.profiler`` traces (``record_function``; on the card
its device row carries the time of the kernels launched inside it),
``trace`` records a profiler session into a directory, ``Timer`` is a wall
clock that waits for the device of each result before it reads the time.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import numpy as np
import torch

from .flops import attention_flops


@contextlib.contextmanager
def annotate(name: str):
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, and CUDA where there is a card) and write its
    chrome trace into ``log_dir`` (``trace.<pid>.json``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace.{os.getpid()}.json"))


def _sync(out) -> None:
    """Wait for the devices of the CUDA tensors in ``out`` (a tensor, or a
    list, tuple or dict of them)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _sync(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _sync(v)


class Timer:
    """Wall-clock timing of a function whose result is waited for."""

    def __init__(self):
        self.samples: list = []

    def measure(self, fn: Callable, *args, warmup: int = 2, iters: int = 10,
                **kw) -> Dict[str, float]:
        """``warmup`` calls, then ``iters`` timed ones, each ending when its
        result's device is done. Returns mean, median, min and std in s."""
        for _ in range(warmup):
            out = fn(*args, **kw)
        if warmup:
            _sync(out)
        for _ in range(iters):
            t0 = time.perf_counter()
            _sync(fn(*args, **kw))
            self.samples.append(time.perf_counter() - t0)
        s = np.asarray(self.samples[-iters:])
        return {"mean_s": float(s.mean()), "median_s": float(np.median(s)),
                "min_s": float(s.min()), "std_s": float(s.std())}


def flops_estimate_attention(b: int, h: int, s: int, d: int) -> int:
    """2·(QKᵀ) + 2·(PV) matmul FLOPs of self-attention over ``s`` tokens
    (``flops.attention_flops`` over the b·h heads)."""
    return int(attention_flops(b * h, s, d))
