"""Structured metrics & logging.

Port of ``lipreading_video_generation_tpu/core/metrics.py``: a train step
returns a flat ``{name: scalar}`` dict of device tensors; ``Metrics`` pulls
it to host floats (``to_host``: one device-to-host copy a dict) and fans it
out to pluggable writers.
"""
from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from typing import Dict, Mapping, Optional, TextIO

import torch


def to_host(metrics: Mapping) -> Dict[str, float]:
    """A metric dict (0-d tensors, or numbers) as host floats: the values on
    the card come back in one synchronising copy for the whole dict."""
    on_card = [k for k, v in metrics.items()
               if isinstance(v, torch.Tensor) and v.device.type != "cpu"]
    host = {}
    if on_card:
        stacked = torch.stack([metrics[k].detach().reshape(()).to(torch.float64)
                               for k in on_card])
        host = dict(zip(on_card, stacked.tolist()))
    return {k: host[k] if k in host else float(v) for k, v in metrics.items()}


class MetricWriter:
    def write(self, step: int, metrics: Mapping[str, float]) -> None:  # pragma: no cover
        raise NotImplementedError

    def close(self) -> None:
        pass


class ConsoleWriter(MetricWriter):
    def __init__(self, stream: Optional[TextIO] = None, every: int = 1):
        self.stream = stream or sys.stderr
        self.every = max(1, every)

    def write(self, step: int, metrics: Mapping[str, float]) -> None:
        if step % self.every:
            return
        parts = ", ".join(f"{k}={v:.5g}" for k, v in sorted(metrics.items()))
        print(f"[step {step}] {parts}", file=self.stream, flush=True)


class JsonlWriter(MetricWriter):
    def __init__(self, path: str):
        self.f = open(path, "a")

    def write(self, step: int, metrics: Mapping[str, float]) -> None:
        rec = {"step": step, "time": time.time(), **metrics}
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()

    def close(self) -> None:
        self.f.close()


class RunningMean:
    """Streaming mean per metric."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    def update(self, metrics: Mapping[str, float]) -> None:
        for k, v in metrics.items():
            self.total[k] += float(v)
            self.count[k] += 1

    def means(self) -> Dict[str, float]:
        return {k: self.total[k] / max(1, self.count[k]) for k in self.total}

    def reset(self) -> None:
        self.total.clear()
        self.count.clear()


class Metrics:
    """Fan-out to several writers."""

    def __init__(self, *writers: MetricWriter):
        self.writers = list(writers)

    def write(self, step: int, metrics: Mapping) -> None:
        host = to_host(metrics)
        for w in self.writers:
            w.write(step, host)

    def close(self) -> None:
        for w in self.writers:
            w.close()
