"""DenseNet-121 per-frame feature extractor.

Port of ``lipreading_video_generation_tpu/models/densenet.py``: a 7×7/2
conv and a 3×3/2 max pool, dense blocks (6, 12, 24, 16) of growth 32 with
×0.5 transitions between them, a final BatchNorm, ReLU and global average
pool to 1024 features. Input (B, H, W, 3) imagenet-normalised frames (NHWC,
as in the JAX package), output (B, 1024) float32; the convolutions run in
NCHW, in ``dtype``.

The module's ``state_dict`` has torchvision's ``densenet121`` key names
(``features.conv0``, ``features.norm0``,
``features.denseblock{i}.denselayer{j}.{norm1,conv1,norm2,conv2}``,
``features.transition{i}.{norm,conv}``, ``features.norm5``), so a
torchvision state dict loads without renaming once
``convert_torch_state_dict`` has dropped what the JAX converter drops
(``classifier.*``, ``num_batches_tracked``).

``BatchNorm`` is Flax's ``nn.BatchNorm(dtype=float32)``, not
``torch.nn.BatchNorm2d``: eps 1e-5, statistics in float32 with the fast
variance E[x²]−E[x]² (clipped at 0), output float32; in ``train()`` mode it
normalises with the biased batch variance and moves the running mean and
variance towards the batch's by ``1 − momentum`` (momentum 0.99), the
variance also biased (``BatchNorm2d`` would store the unbiased one). That
is JAX's ``apply(..., train=True, mutable=["batch_stats"])``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from .layers import Conv2d

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` over (B, C, H, W): float32 params and running
    statistics, float32 output (see the module docstring)."""

    def __init__(self, channels: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.training:
            mean = x32.mean((0, 2, 3))
            var = torch.clamp((x32 * x32).mean((0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x32 - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class _DenseLayer(nn.Module):
    """BN → ReLU → 1×1 conv (4·growth) → BN → ReLU → 3×3 conv (growth),
    concatenated after the input's channels."""

    def __init__(self, in_channels: int, growth: int, dtype: torch.dtype):
        super().__init__()
        self.norm1 = BatchNorm(in_channels)
        self.conv1 = Conv2d(in_channels, 4 * growth, 1, bias=False, dtype=dtype)
        self.norm2 = BatchNorm(4 * growth)
        self.conv2 = Conv2d(4 * growth, growth, 3, padding=1, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(self.norm1(x)))
        h = self.conv2(F.relu(self.norm2(h)))
        return torch.cat([x, h.to(x.dtype)], dim=1)


class _Transition(nn.Module):
    """BN → ReLU → 1×1 conv → 2×2/2 average pool (VALID)."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype):
        super().__init__()
        self.norm = BatchNorm(in_channels)
        self.conv = Conv2d(in_channels, out_channels, 1, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, 2)


class _Features(nn.Module):
    """torchvision's ``features`` container: its child names are the keys."""

    def __init__(self, growth: int, block_config: Tuple[int, ...], init_features: int,
                 dtype: torch.dtype):
        super().__init__()
        self.conv0 = Conv2d(3, init_features, 7, stride=2, padding=3, bias=False, dtype=dtype)
        self.norm0 = BatchNorm(init_features)
        self.stages = []
        ch = init_features
        for bi, layers in enumerate(block_config):
            block = nn.Sequential()
            for li in range(layers):
                block.add_module(f"denselayer{li + 1}", _DenseLayer(ch + li * growth, growth, dtype))
            self.add_module(f"denseblock{bi + 1}", block)
            self.stages.append(f"denseblock{bi + 1}")
            ch += layers * growth
            if bi != len(block_config) - 1:
                self.add_module(f"transition{bi + 1}", _Transition(ch, ch // 2, dtype))
                self.stages.append(f"transition{bi + 1}")
                ch //= 2
        self.norm5 = BatchNorm(ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.max_pool2d(F.relu(self.norm0(self.conv0(x))), 3, 2, padding=1)
        for name in self.stages:
            h = getattr(self, name)(h)
        return F.relu(self.norm5(h))


class DenseNet121(nn.Module):
    """(B, H, W, 3) imagenet-normalised frames → (B, 1024) pooled features
    (float32); convolutions in ``dtype``."""

    def __init__(self, growth: int = 32, block_config: Tuple[int, ...] = (6, 12, 24, 16),
                 init_features: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features = _Features(growth, tuple(block_config), init_features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.features(x.permute(0, 3, 1, 2))
        return h.mean(dim=(2, 3)).float()


def imagenet_preprocess(frames_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (..., 3) → imagenet-normalised float32 (torchvision's
    convention)."""
    x = frames_uint8.to(torch.float32) / 255.0
    mean = torch.from_numpy(IMAGENET_MEAN).to(x.device)
    std = torch.from_numpy(IMAGENET_STD).to(x.device)
    return (x - mean) / std


_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _is_features_key(key: str) -> bool:
    """The keys the JAX package's ``convert_torch_state_dict`` maps: a leaf
    of ``weight``/``bias``/``running_*`` under ``features.`` in a dense
    block, a transition, ``conv0``, ``norm0`` or ``norm5``."""
    parts = key.split(".")
    if len(parts) < 3 or parts[0] != "features" or parts[-1] not in _LEAVES:
        return False
    return (parts[1].startswith(("denseblock", "transition"))
            or parts[1] in ("conv0", "norm0", "norm5"))


def convert_torch_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A torchvision ``densenet121`` state dict → this module's, as float32
    CPU tensors. Keys outside ``features.`` (``classifier.*``), and
    ``num_batches_tracked``, are dropped, as the JAX converter drops them;
    every other key keeps its name, so torchvision's legacy names
    (``norm.1``, ``conv.2``) reach ``ports._validate_against_init`` and are
    refused there, as in the JAX package."""
    return {k: torch.as_tensor(v).detach().to("cpu", torch.float32)
            for k, v in state_dict.items() if _is_features_key(k)}
