"""Where the port's entry points run.

Every entry point that takes a ``device`` defaults to the card: ``None``
means ``default_device()``, which raises when there is no CUDA device.
Nothing steps down to the CPU on its own; a caller that wants the CPU (the
CPU tests do) says ``device="cpu"``.
"""
from __future__ import annotations

import torch


def default_device() -> torch.device:
    """``torch.device("cuda")``; ``RuntimeError`` without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is false): the port's entry "
            "points run on the card by default; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is the card."""
    return default_device() if device is None else torch.device(device)
