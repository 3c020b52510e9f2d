"""The port's program spans.

``annotate(name)`` names a stretch of host work in a ``torch.profiler``
trace: while a profiler session is active (``torch.profiler.profile``,
``emit_nvtx``) it is a ``record_function`` range, on the clock the trace's
device rows use, so a reader can set the kernels, copies and idle gaps of
the card against the span they fall in. With no session active it checks
one flag and enters nothing: the pipelines keep their spans on the
untraced path at the cost of that check.

Span names are ``<layer>/<stage>`` (``lipsync/generator``, ``sample/step``,
``train/backward``, ``int8/quantise``); the benchmark's per-layer metrics
read them by name.
"""
from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

__all__ = ["annotate"]

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()      # stateless: one instance serves every span


def annotate(name: str):
    """Context manager: a ``record_function`` range named ``name`` while a
    profiler runs, a no-op otherwise.

    >>> with annotate("lipsync/paste"):
    ...     out = paste_back(frames, faces, boxes)
    """
    return record_function(name) if _profiler_enabled() else _OFF
