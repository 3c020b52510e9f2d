"""Diffusion super-resolution trainer of the ``SuperResModel``.

Port of ``lipreading_video_generation_tpu/pipelines/train_superres.py``:
train on (area-downsampled low, high) pairs made from the target frames,
q-sample + ε-MSE + Adam + EMA with the diffusion trainer's state
(``train_diffusion.DiffusionTrainState``); the trained model is the second
stage of ``sample_diffusion.sample_cascade``. One step per iteration (no
``train_scan``); ``train_step`` takes explicit ``t`` and ``noise`` as the
diffusion trainer's does.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..core.config import SuperResConfig
from ..models.unet import SuperResModel, UNetModel
from ..ops import image as image_ops
from .losses import noise_mse
from .train_diffusion import (DiffusionTrainState, apply_update, draw_t_noise,
                              load_sampling_params, new_state, resume, save_checkpoint, seeded)


def make_sr_model(cfg: SuperResConfig) -> SuperResModel:
    return SuperResModel(UNetModel(
        in_channels=2 * cfg.im_channels, out_channels=cfg.im_channels,
        base_channels=cfg.base_channels, channel_mult=cfg.channel_mult,
        num_res_blocks=cfg.num_res_blocks, attention_resolutions=cfg.attention_resolutions,
        num_heads=cfg.num_heads, time_embed_dim=cfg.time_embed_dim,
        dtype=getattr(torch, cfg.dtype), dropout=cfg.dropout))


def create_state(cfg: SuperResConfig, seed: int = 0, device=None,
                 ema_rate: float = 0.9999) -> DiffusionTrainState:
    return new_state(seeded(lambda: make_sr_model(cfg), seed), cfg, seed, device, ema_rate)


def prepare_batch(batch: Dict[str, Any], cfg: SuperResConfig, device) -> Dict[str, torch.Tensor]:
    """uint8 target frames (B, h, w, 3) → ±1 high (B, 3, im, im) and ±1 low
    (B, 3, low, low): the antialiased resize to ``im_size`` and from there to
    ``low_size``, each rounded to uint8."""
    hi = image_ops.resize(torch.as_tensor(batch["target_frame"]).to(device),
                          (cfg.im_size, cfg.im_size))
    low = image_ops.resize(hi, (cfg.low_size, cfg.low_size))
    return {k: image_ops.normalize_uint8(x, symmetric=True).permute(0, 3, 1, 2)
            for k, x in (("high", hi), ("low", low))}


def train_step(state: DiffusionTrainState, batch: Dict[str, Any], cfg: SuperResConfig,
               t=None, noise=None) -> Dict[str, torch.Tensor]:
    state.model.train()
    prep = prepare_batch(batch, cfg, state.device)
    t, noise = draw_t_noise(state, prep["high"], cfg.num_timesteps, t, noise)
    noisy = state.scheduler.add_noise(prep["high"], noise, t)
    loss = noise_mse(state.model(noisy, prep["low"], t, generator=state.generator), noise)
    apply_update(state, loss)
    return {"loss": loss.detach()}


def train(cfg: SuperResConfig, batch_fn: Callable[[], Dict[str, Any]], num_steps: int = 1000,
          seed: int = 0, checkpoint_dir: Optional[str] = None, metrics_writer=None,
          checkpoint_every: int = 500, mesh_spec=None, device=None) -> DiffusionTrainState:
    """Step loop as ``train_diffusion.train``; also saves the last step."""
    if mesh_spec is not None:
        raise NotImplementedError(
            "train: mesh_spec is not ported yet (ROADMAP §1 item 13, multi-GPU parallelism)")
    state = resume(create_state(cfg, seed, device), checkpoint_dir)
    while state.step < num_steps:
        batch = batch_fn()
        if batch is None:
            break   # finite feed exhausted
        metrics = train_step(state, batch, cfg)
        if metrics_writer is not None:
            metrics_writer.write(state.step, {"loss": float(metrics["loss"])})
        if checkpoint_dir and state.step % checkpoint_every == 0:
            save_checkpoint(checkpoint_dir, state)
    if checkpoint_dir and state.step % checkpoint_every != 0:
        save_checkpoint(checkpoint_dir, state)
    return state


# SR checkpoints have the diffusion trainer's layout
load_sr_params = load_sampling_params
