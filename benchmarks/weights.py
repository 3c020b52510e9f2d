"""Weights and seeds from ``--seed``.

``from_seed`` fills every leaf of a model's state dict from one standard
normal draw of a ``torch.Generator`` on the device, in float32 (the served
models keep float32 parameters), scaled by the kind of leaf: a weight of
rank 2 or more by 1/sqrt(fan_in), a norm's scale about 1 and its shift
about 0 (±0.1), position embeddings and biases by 0.02. Leaves that the
models' own initialisers set to zero (a ResBlock's second convolution, an
attention output projection, the U-Net's output convolution) are filled
too: at zero they would cut those layers out of the output, and the
comparison with the reference would not see them.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def derive(seed: int, *tags: int) -> int:
    """A 63-bit seed from ``seed`` and ``tags`` (any non-negative ints)."""
    hi, lo = np.random.SeedSequence([int(seed), *map(int, tags)]).generate_state(2, np.uint32)
    return ((int(hi) << 32) | int(lo)) & ((1 << 63) - 1)


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), *map(int, tags)]))


def from_seed(shapes: Dict[str, torch.Tensor], seed: int, device) -> Dict[str, torch.Tensor]:
    """{key: float32 tensor on ``device``} for every key of ``shapes``
    (tensors of any device, meta included, of which only the shape is read)."""
    total = sum(t.numel() for t in shapes.values())
    gen = torch.Generator(device=device).manual_seed(derive(seed, 1))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for key, t in shapes.items():
        v = flat[off:off + t.numel()].view(t.shape)
        off += t.numel()
        leaf = key.rsplit(".", 1)
        is_norm = len(leaf) == 2 and "norm" in leaf[0].rsplit(".", 1)[-1]
        if is_norm and leaf[1] == "weight":
            v.mul_(0.1).add_(1.0)
        elif is_norm:
            v.mul_(0.1)
        elif t.ndim >= 2 and "pos_embedding" not in key:
            v.mul_(1.0 / math.sqrt(t[0].numel()))
        else:
            v.mul_(0.02)
        out[key] = v
    return out
