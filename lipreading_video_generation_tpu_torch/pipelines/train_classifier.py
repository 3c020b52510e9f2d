"""Noisy-image classifier training: the ``EncoderUNetModel`` of guidance.

Port of ``lipreading_video_generation_tpu/pipelines/train_classifier.py``:
the classifier learns class labels of q-sampled noisy images x_t at uniform
t (cross-entropy, Adam), so that its ∇_{x_t} log p(y | x_t) can steer
sampling (``sample_diffusion.sample`` with ``classifier_cfg``). Synthetic
task: class k lights up quadrant k of the image (``synthetic_batch``,
numpy, unchanged). ``train_step`` takes explicit ``t`` and ``noise`` as the
diffusion trainer's does; the state owns one generator for them and the
dropout masks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import ClassifierConfig, DiffusionConfig
from ..core.device import resolve_device
from ..core.prng import seeded
from ..models.schedulers import make_scheduler
from ..models.unet import EncoderUNetModel
from ..ops import image as image_ops
from .train_diffusion import ADAM_BETAS, ADAM_EPS, draw_t_noise


def make_classifier(ccfg: ClassifierConfig, in_channels: int = 3) -> EncoderUNetModel:
    return EncoderUNetModel(
        in_channels, num_out=ccfg.num_classes, base_channels=ccfg.base_channels,
        channel_mult=tuple(ccfg.channel_mult), num_res_blocks=ccfg.num_res_blocks,
        attention_resolutions=tuple(ccfg.attention_resolutions), num_heads=ccfg.num_heads,
        time_embed_dim=ccfg.time_embed_dim, dropout=ccfg.dropout,
        dtype=getattr(torch, ccfg.dtype))


@dataclasses.dataclass
class ClassifierTrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator
    scheduler: Any

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_state(ccfg: ClassifierConfig, dcfg: DiffusionConfig, seed: int = 0,
                 device=None) -> ClassifierTrainState:
    device = resolve_device(device)
    model = seeded(lambda: make_classifier(ccfg, dcfg.im_channels), seed).to(device).train()
    opt = torch.optim.Adam(model.parameters(), lr=ccfg.learning_rate, betas=ADAM_BETAS,
                           eps=ADAM_EPS)
    gen = torch.Generator(device=device).manual_seed(seed)
    return ClassifierTrainState(model, opt, 0, gen, make_scheduler(
        dcfg.scheduler, dcfg.num_timesteps, dcfg.beta_start, dcfg.beta_end))


def synthetic_batch(rng: np.random.Generator, ccfg: ClassifierConfig,
                    dcfg: DiffusionConfig) -> Dict[str, np.ndarray]:
    """Class k = bright quadrant k on a dark background (uint8 frames)."""
    if ccfg.num_classes > 4:
        raise ValueError(
            f"synthetic quadrant task supports at most 4 classes, got "
            f"{ccfg.num_classes} (labels >= 4 would be unlearnable: their "
            "quadrant slice is empty)")
    b, s = ccfg.batch_size, dcfg.im_size
    labels = rng.integers(0, ccfg.num_classes, (b,))
    imgs = rng.integers(0, 60, (b, s, s, dcfg.im_channels), dtype=np.int64)
    h = s // 2
    for i, y in enumerate(labels):
        r0, c0 = (y // 2) * h, (y % 2) * h
        imgs[i, r0:r0 + h, c0:c0 + h] += 170
    return {"image": np.clip(imgs, 0, 255).astype(np.uint8),
            "label": labels.astype(np.int32)}


def train_step(state: ClassifierTrainState, batch: Dict[str, Any], ccfg: ClassifierConfig,
               dcfg: DiffusionConfig, t=None, noise=None) -> Dict[str, torch.Tensor]:
    """One CE step on q-sampled ``batch["image"]`` (uint8 (B, H, W, C) at
    ``dcfg.im_size``) with ``batch["label"]``; updates ``state`` in place.
    Returns {"loss", "accuracy"} as device scalars."""
    state.model.train()
    dev = state.device
    x0 = image_ops.normalize_uint8(torch.as_tensor(batch["image"]).to(dev), symmetric=True)
    x0 = x0.permute(0, 3, 1, 2)
    y = torch.as_tensor(batch["label"]).to(dev, torch.long)
    t, noise = draw_t_noise(state, x0, dcfg.num_timesteps, t, noise)
    xt = state.scheduler.add_noise(x0, noise, t)
    logits = state.model(xt, t, generator=state.generator)
    loss = F.cross_entropy(logits.float(), y)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    acc = (logits.detach().argmax(-1) == y).float().mean()
    return {"loss": loss.detach(), "accuracy": acc}


def train(ccfg: ClassifierConfig, dcfg: DiffusionConfig,
          batch_fn: Callable[[], Dict[str, Any]], num_steps: int, seed: int = 0,
          log_every: int = 50, device=None) -> ClassifierTrainState:
    state = create_state(ccfg, dcfg, seed, device)
    for i in range(num_steps):
        metrics = train_step(state, batch_fn(), ccfg, dcfg)
        if log_every and (i + 1) % log_every == 0:
            print(f"[classifier step {i + 1}] loss={float(metrics['loss']):.4f} "
                  f"acc={float(metrics['accuracy']):.3f}")
    return state


def save_classifier(path: str, state: ClassifierTrainState) -> None:
    torch.save({"classifier": state.model.state_dict()}, path)


def load_classifier_params(path: str) -> Dict[str, torch.Tensor]:
    """The classifier ``state_dict`` that ``save_classifier`` wrote (what
    ``sample_diffusion.sample`` takes as ``classifier_params``)."""
    return torch.load(path, map_location="cpu", weights_only=False)["classifier"]


def load_classifier(ccfg: ClassifierConfig, params: Dict[str, torch.Tensor], device,
                    in_channels: int = 3) -> EncoderUNetModel:
    """An eval-mode ``EncoderUNetModel`` with ``params`` on ``device``."""
    model = make_classifier(ccfg, in_channels).eval()
    model.load_state_dict(params)
    return model.to(device)

