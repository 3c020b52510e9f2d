"""Lip-sync GAN training: the generator against its discriminator and a
frozen sync expert.

Port of ``lipreading_video_generation_tpu/pipelines/train_gan.py``: the
batch prep on the device (resize, [0, 1], the masked target beside the
wrong-window reference, the whole-clip mel, the window mel and the per-frame
mels at offset −1), then one G+D step in JAX's order:

1. the generator's loss lip·lip_weight + syncnet_wt·sync + disc_wt·BCE(D(g), 1)
   + (1 − syncnet_wt − disc_wt)·L1 through the discriminator's params as they
   were before this step, the frozen SyncNet and (``lip_weight`` > 0) the
   frozen lip expert, backward into the generator only, then its Adam
   update. The lip term: with ``text_tokens`` in the batch and a
   ``LipExpertSeq2Seq`` expert, its character cross-entropy reading the
   generated window (``seq2seq_expert_loss``, no token dropout); otherwise,
   and always for an AV-HuBERT encoder, the mean squared distance of its
   features of the generated window and of the ground truth (detached).
   The expert runs in float32 whatever ``cfg.dtype`` is, has no gradient
   and no optimizer;
2. the discriminator's BCE on the real window and on ``g`` of step 1 (made
   with the generator's old params, detached), then its Adam update.

Both optimizers are ``torch.optim.Adam(betas=(adam_b1, adam_b2), eps=1e-8)``,
optax's ``adam``, over float32 master params (the models cast to
``cfg.dtype`` inside ``forward``). An eval every ``eval_interval`` steps
opens the sync gate (``syncnet_wt`` 0 → 0.03) once the eval sync loss falls
below 0.75; a checkpoint every ``checkpoint_interval`` steps holds both
networks, both Adam states, the gate and the step.

PyTorch idiom where JAX keeps a pure state: ``GanTrainState`` holds the
three modules, the two optimizers, the step and the gate, and ``train_step``
updates it in place. The step draws nothing at random. Not carried over:
``gan_train_scan`` (several steps in one device program): a dispatch of
``steps_per_dispatch`` batches runs as that many ordinary steps.
On a mesh (``train(mesh_spec=...)``, by default ``build_mesh()`` over the
process group) each data rank runs the step on its rows of the batch, both
networks' gradients are averaged over ``data`` (their Adam moments sharded
under ZeRO-1), the losses and the eval that drives the gate are averaged,
and the primary rank writes checkpoints and sample dumps. The networks use
GroupNorm, so there are no batch statistics to reduce.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core import prng
from ..core.checkpoint import CheckpointManager, load_once
from ..core.config import AudioConfig, GanConfig, MeshConfig
from ..core.device import resolve_device
from ..core.prng import seeded
from ..data.loader import dispatch_bounds, host_prefetch, take
from ..models.discriminator import Discriminator
from ..models.generator import TalkingFaceGenerator
from ..models.syncnet import SyncNet, stack_window_lower_half
from ..ops import audio as audio_ops
from ..ops import image as image_ops
from ..parallel import mesh as pmesh
from ..parallel.distributed import is_primary
from . import losses
from .train_diffusion import ADAM_EPS


@dataclasses.dataclass
class GanTrainState:
    """Everything a step changes: ``gen`` and ``disc`` (float32 params,
    their optimizers ``gen_opt`` and ``disc_opt``), ``step``, and the sync
    gate ``syncnet_wt``; ``syncnet`` is the frozen sync expert and
    ``lip_expert`` the frozen lip expert (None at ``lip_weight`` 0): no
    grads, no optimizer."""

    gen: TalkingFaceGenerator
    disc: Discriminator
    syncnet: SyncNet
    gen_opt: torch.optim.Adam
    disc_opt: torch.optim.Adam
    step: int
    syncnet_wt: float
    lip_expert: Optional[torch.nn.Module] = None

    @property
    def device(self) -> torch.device:
        return next(self.gen.parameters()).device


def create_state(cfg: GanConfig, seed: int = 0, syncnet_params=None, device=None,
                 lip_expert_params=None, lip_expert_model=None) -> GanTrainState:
    """A fresh state on ``device`` (None: the card): generator,
    discriminator and SyncNet at ``cfg.model_width`` and ``cfg.dtype``,
    initialised from ``seed`` (Flax's init rules, one fold of the seed
    each); ``syncnet_params`` (a SyncNet ``state_dict``) replaces the
    expert's init. At ``cfg.lip_weight`` > 0 also the frozen lip expert:
    ``lip_expert_model`` (e.g. ``ports.load_avhubert_expert``'s encoder)
    or ``train_lip_expert.default_expert()`` at ``syncnet_T`` frames, with
    ``lip_expert_params`` (a ``state_dict``) loaded into it, else drawn
    from the seed's fourth fold; float32."""
    device = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    kg, kd, ks = (prng.fold_in(prng.make_root_key(seed), i) for i in range(3))
    gen = seeded(lambda: TalkingFaceGenerator(dtype=dtype, width=cfg.model_width), kg)
    disc = seeded(lambda: Discriminator(dtype=dtype, width=cfg.model_width), kd)
    syncnet = seeded(lambda: SyncNet(dtype=dtype, width=cfg.model_width,
                                     syncnet_T=cfg.syncnet_T), ks)
    if syncnet_params is not None:
        syncnet.load_state_dict(syncnet_params)
    gen, disc = gen.to(device).train(), disc.to(device).train()
    syncnet = syncnet.to(device).eval().requires_grad_(False)
    lip_expert = None
    if cfg.lip_weight > 0:
        from .train_lip_expert import default_expert

        lip_expert = lip_expert_model
        if lip_expert is None:
            lip_expert = seeded(lambda: default_expert(num_frames=cfg.syncnet_T),
                                prng.fold_in(prng.make_root_key(seed), 3))
        if lip_expert_params is not None:
            lip_expert.load_state_dict(lip_expert_params)
        lip_expert = lip_expert.to(device, torch.float32).eval().requires_grad_(False)
    betas = (cfg.adam_b1, cfg.adam_b2)
    return GanTrainState(
        gen, disc, syncnet,
        torch.optim.Adam(gen.parameters(), lr=cfg.learning_rate, betas=betas, eps=ADAM_EPS),
        torch.optim.Adam(disc.parameters(), lr=cfg.disc_learning_rate, betas=betas,
                         eps=ADAM_EPS),
        0, float(cfg.syncnet_wt), lip_expert)


def clip_mel_windows(mel: torch.Tensor, start_frames: torch.Tensor, cfg: GanConfig,
                     audio_cfg: AudioConfig) -> torch.Tensor:
    """Per-clip mels (B, num_mels, T_mel) and start frames (B, K) → the
    aligned windows (B, K, num_mels, mel_step) (``ops.audio.window_starts``)."""
    step = cfg.syncnet_mel_step_size
    first = audio_ops.window_starts(start_frames, mel.shape[-1], cfg.fps, step,
                                    audio_cfg.sample_rate, audio_cfg.hop_size)
    idx = first[..., None] + torch.arange(step, device=mel.device)             # (B, K, step)
    b = torch.arange(mel.shape[0], device=mel.device)[:, None, None, None]
    m = torch.arange(mel.shape[1], device=mel.device)[None, None, :, None]
    return mel[b, m, idx[:, :, None, :]]


def prepare_batch(batch: Dict[str, Any], cfg: GanConfig, audio_cfg: AudioConfig,
                  device) -> Dict[str, torch.Tensor]:
    """A host batch (uint8 ``window`` and ``wrong_window`` (B, T, H, W, 3),
    ``start_frame`` (B,), ``wav`` (B, samples)) → on ``device``: ``x`` (B, T,
    img, img, 6), the masked target beside the wrong reference; ``gt`` (B,
    T, img, img, 3) in [0, 1]; ``mel`` (B, 80, 16, 1), the window at the
    start frame; ``indiv_mels`` (B, T, 80, 16, 1), frame s + i's window
    starting at video frame max(s + i − 1, 0)."""
    size = (cfg.img_size, cfg.img_size)

    def frames(key):
        return image_ops.normalize_uint8(
            image_ops.resize(torch.as_tensor(batch[key]).to(device), size))

    gt, wrong = frames("window"), frames("wrong_window")
    x = image_ops.concat_reference(image_ops.mask_lower_half(gt), wrong)
    mel_full = audio_ops.melspectrogram(
        torch.as_tensor(batch["wav"], dtype=torch.float32).to(device), audio_cfg)
    start = torch.as_tensor(batch["start_frame"]).to(device, torch.float32)
    t = torch.arange(cfg.syncnet_T, dtype=torch.float32, device=device)
    frame_ids = torch.clamp(start[:, None] + t - 1.0, min=0.0)
    return {
        "x": x,
        "gt": gt,
        "mel": clip_mel_windows(mel_full, start[:, None], cfg, audio_cfg)[:, 0, ..., None],
        "indiv_mels": clip_mel_windows(mel_full, frame_ids, cfg, audio_cfg)[..., None],
    }


def _sync_loss(syncnet: SyncNet, mel: torch.Tensor, generated: torch.Tensor) -> torch.Tensor:
    """−log cos(audio, face) of the window mel against the lower halves of
    the T generated frames stacked on channels."""
    a, v = syncnet(mel, stack_window_lower_half(generated))
    return losses.cosine_bce_sync_loss(a, v)


def lip_loss(expert: torch.nn.Module, generated: torch.Tensor, gt: torch.Tensor,
             text_tokens=None) -> torch.Tensor:
    """The lip-expert term of the G loss on [0, 1] windows (see the
    module's docstring)."""
    from ..models.lip_expert import (LipExpertSeq2Seq, avhubert_video_transform,
                                     seq2seq_expert_loss)

    if text_tokens is not None and isinstance(expert, LipExpertSeq2Seq):
        return seq2seq_expert_loss(expert, generated * 255.0, torch.as_tensor(text_tokens))
    gf = expert.encode(avhubert_video_transform(generated * 255.0))
    with torch.no_grad():
        tf = expert.encode(avhubert_video_transform(gt * 255.0))
    return torch.mean((gf - tf) ** 2)


def train_step(state: GanTrainState, batch: Dict[str, Any], cfg: GanConfig,
               audio_cfg: AudioConfig = AudioConfig()) -> Dict[str, torch.Tensor]:
    """One G+D step on a host batch (see the module's docstring); updates
    ``state`` in place and leaves each network's gradients in its params'
    ``.grad``. Returns the G loss terms, ``syncnet_wt``, ``loss/d_real`` and
    ``loss/d_fake`` as device scalars."""
    prep = prepare_batch(batch, cfg, audio_cfg, state.device)
    gen, disc = state.gen.train(), state.disc.train()

    disc.requires_grad_(False)          # D's params as they were: out of G's backward
    try:
        g = gen(prep["indiv_mels"], prep["x"])
        recon = losses.l1(g, prep["gt"])
        sync = _sync_loss(state.syncnet, prep["mel"], g)
        perceptual = losses.perceptual_adversarial_loss(disc(g))
        if cfg.lip_weight > 0 and state.lip_expert is not None:
            lip = lip_loss(state.lip_expert, g, prep["gt"], batch.get("text_tokens"))
        else:
            lip = torch.zeros((), device=g.device)
        total, metrics = losses.generator_loss(recon, sync, perceptual, lip, state.syncnet_wt,
                                               cfg.disc_wt, cfg.lip_weight)
        state.gen_opt.zero_grad(set_to_none=True)
        total.backward()
        state.gen_opt.step()
    finally:
        disc.requires_grad_(True)

    real_pred = disc(prep["gt"])
    fake_pred = disc(g.detach())
    d_real, d_fake = losses.discriminator_loss(real_pred, fake_pred)
    state.disc_opt.zero_grad(set_to_none=True)
    (d_real + d_fake).backward()
    state.disc_opt.step()
    state.step += 1
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics.update({"loss/d_real": d_real.detach(), "loss/d_fake": d_fake.detach()})
    return metrics


@torch.no_grad()
def generate_step(state: GanTrainState, batch: Dict[str, Any], cfg: GanConfig,
                  audio_cfg: AudioConfig = AudioConfig()) -> torch.Tensor:
    """The generated windows of a host batch, (B, T, img, img, 3) in [0, 1]."""
    prep = prepare_batch(batch, cfg, audio_cfg, state.device)
    return state.gen(prep["indiv_mels"], prep["x"])


@torch.no_grad()
def gan_eval_step(state: GanTrainState, batch: Dict[str, Any], cfg: GanConfig,
                  audio_cfg: AudioConfig = AudioConfig()) -> Dict[str, torch.Tensor]:
    """The sync loss that drives the gate, L1, PSNR and SSIM of the generated
    windows against the real ones, as device scalars."""
    prep = prepare_batch(batch, cfg, audio_cfg, state.device)
    g = state.gen(prep["indiv_mels"], prep["x"])
    return {
        "eval/sync_loss": _sync_loss(state.syncnet, prep["mel"], g),
        "eval/l1": losses.l1(g, prep["gt"]),
        "eval/psnr": losses.psnr(g, prep["gt"]),
        "eval/ssim": losses.ssim(g, prep["gt"]),
    }


def maybe_open_sync_gate(state: GanTrainState, eval_sync_loss: float,
                         cfg: GanConfig) -> GanTrainState:
    """``syncnet_wt`` 0 → ``cfg.syncnet_wt_after_gate`` once the eval sync
    loss is below ``cfg.syncnet_gate_threshold``; idempotent."""
    if float(eval_sync_loss) < cfg.syncnet_gate_threshold and state.syncnet_wt == 0.0:
        state.syncnet_wt = float(np.float32(cfg.syncnet_wt_after_gate))
    return state


def checkpoint_tree(state: GanTrainState) -> Dict[str, Any]:
    """What resume needs: both networks, both Adam states, the gate and the
    step, in the one-process layout (a state placed on a mesh gathers its
    slices: every rank builds the tree)."""
    return {"gen": pmesh.full_state_dict(None, state.gen),
            "disc": pmesh.full_state_dict(None, state.disc),
            "gen_opt": state.gen_opt.state_dict(), "disc_opt": state.disc_opt.state_dict(),
            "syncnet_wt": float(state.syncnet_wt), "step": int(state.step)}


def restore_state(state: GanTrainState, restored: Dict[str, Any]) -> GanTrainState:
    """``checkpoint_tree``'s tree into ``state``, placed on a mesh or not."""
    pmesh.load_full_state_dict(None, state.gen, restored["gen"])
    pmesh.load_full_state_dict(None, state.disc, restored["disc"])
    state.gen_opt.load_state_dict(restored["gen_opt"])
    state.disc_opt.load_state_dict(restored["disc_opt"])
    state.syncnet_wt = float(restored["syncnet_wt"])
    state.step = int(restored["step"])
    return state


def load_generator_params(checkpoint_path: str) -> Dict[str, torch.Tensor]:
    """The generator's ``state_dict`` (on the CPU) from a ``train-gan``
    checkpoint directory (its latest step) or a ``save_once`` file of
    ``{"gen": state_dict}``."""
    if os.path.isdir(checkpoint_path):
        mgr = CheckpointManager(checkpoint_path)
        if mgr.latest_step() is not None:
            return mgr.restore()["gen"]
    return load_once(checkpoint_path)["gen"]


def _dump_sample(sample_dir: str, step: int, g: torch.Tensor) -> None:
    """The first window's generated frames side by side as
    ``step<step>.jpg``, where OpenCV is installed."""
    from ..data.video import _cv2

    try:
        cv2 = _cv2("train_gan sample dumps")
    except ImportError:
        return
    os.makedirs(sample_dir, exist_ok=True)
    collage = (torch.cat(list(g[0]), dim=1) * 255).to(torch.uint8).cpu().numpy()
    cv2.imwrite(os.path.join(sample_dir, f"step{step}.jpg"), collage[:, :, ::-1])


def train(cfg: GanConfig, batch_fn: Callable[[], Dict[str, Any]],
          eval_batch_fn: Optional[Callable[[], Dict[str, Any]]] = None,
          num_steps: int = 1000, seed: int = 0, checkpoint_dir: Optional[str] = None,
          audio_cfg: AudioConfig = AudioConfig(), metrics_writer=None,
          syncnet_params=None, sample_dir: Optional[str] = None, mesh_spec=None,
          steps_per_dispatch: int = 8, device=None, lip_expert_params=None,
          lip_expert_model=None) -> GanTrainState:
    """Step loop until ``num_steps`` (or the end of a finite feed): host
    batches made ahead by a producer thread (``data.loader.host_prefetch``,
    ``2 × steps_per_dispatch`` deep); each dispatch takes up to
    ``steps_per_dispatch`` of them, cut at the next eval and checkpoint (as
    the JAX package's chunks are), and runs them as that many G+D steps, so
    the results equal one step a dispatch. ``metrics_writer.write(step,
    metrics)`` after each step; every ``cfg.eval_interval`` steps a
    ``gan_eval_step`` (on the feed's next batch when ``eval_batch_fn`` is
    ``batch_fn``, else the dispatch's last) and the gate; every
    ``cfg.checkpoint_interval`` steps a checkpoint in ``checkpoint_dir`` and
    a sample dump of the dispatch's last batch in ``sample_dir``. Resumes
    from the latest checkpoint of ``checkpoint_dir``. ``mesh_spec`` (default
    ``build_mesh()``) runs the steps data-parallel (see the module's
    docstring)."""
    spec = mesh_spec or pmesh.build_mesh(MeshConfig())
    state = create_state(cfg, seed, syncnet_params, device, lip_expert_params,
                         lip_expert_model)
    mgr = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
    if mgr is not None and mgr.latest_step() is not None:
        restore_state(state, mgr.restore())
    state = pmesh.shard_state(spec, state)
    writer = metrics_writer if is_primary() else None
    feed = host_prefetch(batch_fn, depth=2 * max(1, steps_per_dispatch))
    try:
        while state.step < num_steps:
            raws = take(feed, dispatch_bounds(state.step, num_steps, steps_per_dispatch,
                                              cfg.eval_interval, cfg.checkpoint_interval))
            if not raws:
                break   # finite feed exhausted
            for batch in raws:
                metrics = pmesh.run_sharded(spec, train_step, state, batch, cfg, audio_cfg)
                if writer is not None:
                    writer.write(state.step - 1, metrics)
            step = state.step
            if eval_batch_fn is not None and step % cfg.eval_interval == 0:
                if eval_batch_fn is batch_fn:   # the producer thread owns batch_fn
                    nb = take(feed, 1)
                    eb = nb[0] if nb else batch
                else:
                    eb = eval_batch_fn()
                em = pmesh.run_sharded(spec, gan_eval_step, state, eb, cfg, audio_cfg)
                maybe_open_sync_gate(state, float(em["eval/sync_loss"]), cfg)
                if writer is not None:
                    writer.write(step - 1, em)
            if mgr is not None and step % cfg.checkpoint_interval == 0:
                mgr.save(step, checkpoint_tree(state))
            if sample_dir is not None and step % cfg.checkpoint_interval == 0 and is_primary():
                _dump_sample(sample_dir, step, generate_step(state, batch, cfg, audio_cfg))
    finally:
        feed.close()
    return state
