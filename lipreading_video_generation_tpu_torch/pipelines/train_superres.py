"""Diffusion super-resolution trainer of the ``SuperResModel``.

Port of ``lipreading_video_generation_tpu/pipelines/train_superres.py``:
train on (area-downsampled low, high) pairs made from the target frames,
q-sample + ε-MSE + Adam + EMA with the diffusion trainer's state
(``train_diffusion.DiffusionTrainState``); the trained model is the second
stage of ``sample_diffusion.sample_cascade``. A dispatch of
``steps_per_dispatch`` batches runs as that many ordinary steps (no
``train_scan``); ``train_step`` takes explicit ``t`` and ``noise`` as the
diffusion trainer's does. On a mesh the steps run data-parallel as the
diffusion trainer's do.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..core.config import MeshConfig, SuperResConfig
from ..data.loader import dispatch_bounds, host_prefetch, take
from ..parallel import mesh as pmesh
from ..parallel.distributed import is_primary
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
          checkpoint_every: int = 500, mesh_spec=None, steps_per_dispatch: int = 4,
          device=None) -> DiffusionTrainState:
    """Step loop as ``train_diffusion.train`` (dispatches of up to
    ``steps_per_dispatch`` steps cut at checkpoints, no eval); writes
    ``{"loss"}`` at each step's count after it and also saves the last
    step; ``mesh_spec`` (default ``build_mesh()``) as in ``train_diffusion.train``."""
    spec = mesh_spec or pmesh.build_mesh(MeshConfig())
    state = pmesh.shard_state(spec, resume(create_state(cfg, seed, device), checkpoint_dir))
    writer = metrics_writer if is_primary() else None
    feed = host_prefetch(batch_fn, depth=2 * max(1, steps_per_dispatch))
    try:
        while state.step < num_steps:
            raws = take(feed, dispatch_bounds(state.step, num_steps, steps_per_dispatch,
                                              checkpoint_every))
            if not raws:
                break   # finite feed exhausted
            for batch in raws:
                metrics = pmesh.run_sharded(spec, train_step, state, batch, cfg)
                if writer is not None:
                    writer.write(state.step, {"loss": float(metrics["loss"])})
            if checkpoint_dir and state.step % checkpoint_every == 0:
                save_checkpoint(checkpoint_dir, state)
    finally:
        feed.close()
    if checkpoint_dir and state.step % checkpoint_every != 0:
        save_checkpoint(checkpoint_dir, state)
    return state


# SR checkpoints have the diffusion trainer's layout: a checkpoint directory
# (latest step, EMA params by default) or a file holding {"params": ...}
load_sr_params = load_sampling_params
