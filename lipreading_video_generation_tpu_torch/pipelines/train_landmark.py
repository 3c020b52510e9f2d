"""Lip-landmark regressor training.

Port of ``lipreading_video_generation_tpu/pipelines/train_landmark.py``:
``LipLandmarkNet`` learns the 4 normalised lip points with an L1 loss and
Adam, on faces from the synthetic
renderer (``models.lip_landmark.synthetic_face_batch``) with the
augmentation curriculum (``full_augment``: affine warp with the labels
warped alike, occluder, highlight, illumination, blur, photometric jitter),
the photometric jitter alone, or none.

PyTorch idiom where JAX keeps a pure state: ``LandmarkTrainState`` holds the
model, its ``torch.optim.Adam`` and the step count, and ``train_step``
updates it in place. The random draws come from ``torch.Generator``s, so the
faces and augmentations differ from the JAX package's; the tests hold them
by their properties. Checkpoints are ``core.checkpoint``'s
(``{"params": state_dict}``); Orbax checkpoints are not read.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Tuple

import torch

from ..core import checkpoint as ckpt
from ..core import prng
from ..core.device import resolve_device
from ..models import lip_landmark
from ..models.lip_landmark import _uniform
from ..ops import image as image_ops


@dataclasses.dataclass
class LandmarkTrainState:
    model: lip_landmark.LipLandmarkNet
    optimizer: torch.optim.Adam
    step: int

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_state(seed: int = 0, lr: float = 3e-4, width: int = 32,
                 device=None) -> LandmarkTrainState:
    """``LipLandmarkNet(width)`` drawn from ``seed`` on ``device`` (None:
    the card), with Adam at ``lr``."""
    model = prng.seeded(lambda: lip_landmark.LipLandmarkNet(width=width), seed)
    model = model.to(resolve_device(device)).train()
    # torch's Adam defaults are optax.adam's: β 0.9/0.999, eps 1e-8 outside the root
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    return LandmarkTrainState(model, opt, 0)


def train_step(state: LandmarkTrainState, images: torch.Tensor,
               points: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One L1 step on (B, 64, 64, 1) crops against (B, 4, 2) normalised
    points; updates ``state`` in place and returns {"loss"} (a device
    scalar)."""
    pred = state.model(images)
    loss = torch.mean(torch.abs(pred - points))
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return {"loss": loss.detach()}


def photometric_augment(gen: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    """Per-sample gain [0.7, 1.3] and bias [-0.1, 0.1] plus N(0, 0.03²)
    sensor noise, clipped to [0, 1]."""
    n = images.shape[0]
    gain = _uniform(gen, (n, 1, 1, 1), 0.7, 1.3)
    bias = _uniform(gen, (n, 1, 1, 1), -0.1, 0.1)
    noise = 0.03 * torch.randn(images.shape, generator=gen, device=gen.device)
    return torch.clamp(images * gain + bias + noise, 0.0, 1.0)


def affine_warp(images: torch.Tensor, points: torch.Tensor, theta: torch.Tensor,
                scale: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate (``theta``, radians), scale and shift (``tx``, ``ty``, in image
    widths) (n, S, S, 1) images about their centre, each by its own (n,)
    parameters: every output pixel samples the input bilinearly at its
    inverse image (edge-clamped). The (n, 4, 2) normalised points move
    alike and are clipped to [0, 1]."""
    size = images.shape[1]
    col = lambda v: v[:, None, None]   # noqa: E731
    gy, gx = lip_landmark._grid(size, images.device)
    cos, sin = col(torch.cos(theta)), col(torch.sin(theta))
    dx, dy = gx - 0.5 - col(tx), gy - 0.5 - col(ty)
    sx = 0.5 + (cos * dx + sin * dy) / col(scale)
    sy = 0.5 + (-sin * dx + cos * dy) / col(scale)
    img = image_ops.map_coordinates(images[..., 0], sy * size - 0.5, sx * size - 0.5)
    rel = points - 0.5
    cos, sin, sc = torch.cos(theta)[:, None], torch.sin(theta)[:, None], scale[:, None]
    points = torch.stack([0.5 + tx[:, None] + sc * (cos * rel[..., 0] - sin * rel[..., 1]),
                          0.5 + ty[:, None] + sc * (sin * rel[..., 0] + cos * rel[..., 1])],
                         dim=-1)
    return img[..., None], torch.clamp(points, 0.0, 1.0)


def full_augment(gen: torch.Generator, images: torch.Tensor, points: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The robustness curriculum: an ``affine_warp`` (rotation ±20°, scale
    0.8-1.25, shift ±10%; the points warped alike and clipped to [0, 1]), a
    random occluder rectangle and a bright highlight ellipse (each with
    probability 0.5), a low-frequency illumination field, a Gaussian blur
    σ ∈ [0, 2] (9×9), then ``photometric_augment``."""
    n, size = images.shape[0], images.shape[1]
    col = lambda v: v[:, None, None]   # noqa: E731
    gy, gx = lip_landmark._grid(size, images.device)

    theta, scale = _uniform(gen, (n,), -0.35, 0.35), _uniform(gen, (n,), 0.8, 1.25)
    tx, ty = _uniform(gen, (n,), -0.1, 0.1), _uniform(gen, (n,), -0.1, 0.1)
    img, points = affine_warp(images, points, theta, scale, tx, ty)
    img = img[..., 0]

    # occluder: a random rectangle with a random fill
    ou, ohw = _uniform(gen, (n, 2), 0.1, 0.9), _uniform(gen, (n, 2), 0.04, 0.16)
    ofill, oon = _uniform(gen, (n,), 0.0, 1.0), _uniform(gen, (n,), 0.0, 1.0) > 0.5
    rect = ((torch.abs(gx - col(ou[:, 0])) <= col(ohw[:, 0]))
            & (torch.abs(gy - col(ou[:, 1])) <= col(ohw[:, 1])))
    img = torch.where(rect & col(oon), col(ofill).expand_as(img), img)

    # highlight: a bright ellipse
    bu, bhw = _uniform(gen, (n, 2), 0.15, 0.85), _uniform(gen, (n, 2), 0.03, 0.12)
    bon = _uniform(gen, (n,), 0.0, 1.0) > 0.5
    ell = (((gx - col(bu[:, 0])) / col(bhw[:, 0])) ** 2
           + ((gy - col(bu[:, 1])) / col(bhw[:, 1])) ** 2 <= 1.0)
    img = torch.where(ell & col(bon), torch.full_like(img, 0.88), img)

    # low-frequency illumination: a directional field
    phi, amp = col(_uniform(gen, (n,), 0.0, 2 * math.pi)), col(_uniform(gen, (n,), 0.0, 0.55))
    img = img * (1.0 + amp * ((gx - 0.5) * torch.cos(phi) + (gy - 0.5) * torch.sin(phi)))

    images = lip_landmark.gaussian_blur(img[..., None], _uniform(gen, (n,), 1e-3, 2.0), 4)
    images = photometric_augment(gen, images)
    return torch.clamp(images, 0.0, 1.0), points


def train(
    num_steps: int = 800,
    batch_size: int = 64,
    seed: int = 0,
    lr: float = 3e-4,
    checkpoint_dir: Optional[str] = None,
    log_every: int = 100,
    augment="full",
    device=None,
) -> LandmarkTrainState:
    """Train on synthetic faces on ``device`` (None: the card); with
    ``checkpoint_dir``, save the final params there (``load_params`` reads
    them). ``augment``: "full" (``full_augment``), "photometric"/True
    (``photometric_augment``) or False/None."""
    state = create_state(prng.fold_in(prng.make_root_key(seed), 1), lr=lr, device=device)
    gen = torch.Generator(device=state.device)
    root = prng.make_root_key(seed)
    for step in range(num_steps):
        gen.manual_seed(prng.fold_in(root, 1000 + step))
        imgs, pts = lip_landmark.synthetic_face_batch(gen, batch_size)
        if augment == "full":
            imgs, pts = full_augment(gen, imgs, pts)
        elif augment:
            imgs = photometric_augment(gen, imgs)
        metrics = train_step(state, imgs, pts)
        if log_every and (step + 1) % log_every == 0:
            print(f"landmark step {step + 1}: loss {float(metrics['loss']):.4f}")
    if checkpoint_dir is not None:
        ckpt.save_once(_params_path(checkpoint_dir),
                       {"params": {k: v.detach().cpu() for k, v in
                                   state.model.state_dict().items()}})
    return state


def _params_path(checkpoint_dir: str) -> str:
    return os.path.join(checkpoint_dir, "params.pt")


def load_params(checkpoint_dir: str, device=None) -> lip_landmark.LipLandmarkNet:
    """The ``LipLandmarkNet`` that ``train(checkpoint_dir=...)`` saved, in
    eval mode on ``device`` (None: the card). ``ValueError`` with a retrain
    hint when the checkpoint is not this net's."""
    params = ckpt.load_once(_params_path(checkpoint_dir))["params"]
    model = lip_landmark.LipLandmarkNet()
    try:
        model.load_state_dict(params)
    except RuntimeError as e:
        raise ValueError(
            f"landmark checkpoint at {checkpoint_dir!r} does not match the current "
            "LipLandmarkNet; retrain with `train-landmark --out <dir>`") from e
    return model.to(resolve_device(device)).eval()
