"""SyncNet expert pretraining.

Port of ``lipreading_video_generation_tpu/pipelines/train_syncnet.py``:
Adam (lr 1e-4) on the SyncNet over (mel window, face window) pairs of
``train_gan.prepare_batch``, with three objectives:

- ``"bce"``: BCE over the raw cosine similarity, with positives (y = 1,
  the aligned mel) and negatives (y = 0, the same clip's mel shifted by
  3-8 video frames, turned the other way where it would leave the mel);
- ``"infonce"``: symmetric InfoNCE over the in-batch cosine matrix at
  temperature 0.07;
- ``"infonce_hard"`` (default): InfoNCE whose negative columns also hold
  each sample's own shifted mel.

JAX draws ``y`` and each negative's shift magnitude and sign from threefry;
here they come from a ``torch.Generator`` re-seeded each step with
``core.prng.step_key``, or from the caller (``draws``), so that the tests
hand JAX's draws over and parity never depends on a seed. The SyncNet runs
at float32 in pretraining, as in the JAX package. ``train`` reports the
held-out aligned-vs-shifted AUC (``expert_proof``) every ``eval_every``
steps and at the last.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, Optional

import torch

from ..core import prng
from ..core.checkpoint import load_once
from ..core.config import AudioConfig, GanConfig
from ..core.device import resolve_device
from ..core.prng import seeded
from ..models.syncnet import SyncNet, stack_window_lower_half
from ..ops import audio as audio_ops
from . import losses
from .train_diffusion import ADAM_BETAS, ADAM_EPS
from .train_gan import clip_mel_windows, prepare_batch

OBJECTIVES = ("infonce_hard", "infonce", "bce")
TEMPERATURE = 0.07


@dataclasses.dataclass
class SyncnetTrainState:
    """``model`` (float32), its ``optimizer``, the ``step``, and the
    ``generator`` of the negatives, re-seeded from ``root_key`` each step."""

    model: SyncNet
    optimizer: torch.optim.Adam
    step: int
    generator: torch.Generator
    root_key: int

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_state(cfg: GanConfig, seed: int = 0, lr: float = 1e-4,
                 device=None) -> SyncnetTrainState:
    """A fresh float32 SyncNet at ``cfg.model_width`` from ``seed`` on
    ``device`` (None: the card), with optax ``adam``'s Adam."""
    device = resolve_device(device)
    model = seeded(lambda: SyncNet(width=cfg.model_width, syncnet_T=cfg.syncnet_T),
                   seed).to(device).train()
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)
    return SyncnetTrainState(model, opt, 0, torch.Generator(device=device),
                             prng.make_root_key(seed))


def draw_negatives(state: SyncnetTrainState, b: int, bce: bool) -> Dict[str, torch.Tensor]:
    """The step's random draws from the state's generator: ``mag`` (B,) in
    3..8 and ``sign`` (B,) ±1 of each negative's shift, and, for ``bce``,
    the pair labels ``y`` (B,) in {0, 1}."""
    gen = state.generator
    gen.manual_seed(prng.step_key(state.root_key, state.step))
    dev = gen.device
    out = {}
    if bce:
        out["y"] = (torch.rand(b, generator=gen, device=dev) > 0.5).to(torch.float32)
    out["mag"] = torch.randint(3, 9, (b,), generator=gen, device=dev).to(torch.float32)
    out["sign"] = torch.where(torch.rand(b, generator=gen, device=dev) > 0.5, 1.0, -1.0)
    return out


def _shifted_mel_windows(mel_full: torch.Tensor, start: torch.Tensor, y: torch.Tensor,
                         mag: torch.Tensor, sign: torch.Tensor, cfg: GanConfig,
                         audio_cfg: AudioConfig) -> torch.Tensor:
    """Per-sample mel windows (B, 80, 16, 1): aligned where y = 1, else
    shifted by sign·mag video frames within the clip; a shift that would
    leave the mel goes the other way instead of clamping, so a negative is
    never aligned by accident."""
    mel_per_frame = (audio_cfg.sample_rate / audio_cfg.hop_size) / cfg.fps
    max_start = (mel_full.shape[-1] - cfg.syncnet_mel_step_size) / mel_per_frame
    neg = start + sign * mag
    neg = torch.where(neg < 0.0, start + mag, neg)
    neg = torch.where(neg > max_start, start - mag, neg)
    sel = torch.where(y > 0.5, start, neg)
    return clip_mel_windows(mel_full, sel[:, None], cfg, audio_cfg)[:, 0, ..., None]


def train_step(state: SyncnetTrainState, batch: Dict[str, Any], cfg: GanConfig,
               audio_cfg: AudioConfig = AudioConfig(), objective: str = "infonce_hard",
               draws: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """One Adam step of ``objective`` on a host GAN batch; updates ``state``
    in place (the gradients stay in the params' ``.grad``). ``draws``
    ({"mag", "sign"} and, for ``bce``, "y", each (B,)) replaces the
    generator's draws. Returns {"loss"} as a device scalar."""
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown syncnet objective {objective!r}")
    device = state.device
    prep = prepare_batch(batch, cfg, audio_cfg, device)
    faces = stack_window_lower_half(prep["gt"])
    b = faces.shape[0]
    if draws is None:
        draws = draw_negatives(state, b, objective == "bce")
    draws = {k: torch.as_tensor(v, dtype=torch.float32).to(device) for k, v in draws.items()}
    model = state.model.train()

    if objective != "infonce":
        mel_full = audio_ops.melspectrogram(
            torch.as_tensor(batch["wav"], dtype=torch.float32).to(device), audio_cfg)
        start = torch.as_tensor(batch["start_frame"]).to(device, torch.float32)
        y = draws["y"] if objective == "bce" else torch.zeros(b, device=device)
        shifted = _shifted_mel_windows(mel_full, start, y, draws["mag"], draws["sign"], cfg,
                                       audio_cfg)
    lbl = torch.arange(b, device=device)
    if objective == "bce":
        a, v = model(shifted, faces)
        loss = losses.syncnet_contrastive_loss(a, v, y)
    elif objective == "infonce":
        a, v = model(prep["mel"], faces)
        logits = (a @ v.T) / TEMPERATURE
        loss = 0.5 * (losses.softmax_xent(logits, lbl) + losses.softmax_xent(logits.T, lbl))
    else:
        a_pos, v = model(prep["mel"], faces)
        a_neg, _ = model(shifted, faces)
        cols = torch.cat([a_pos, a_neg], dim=0)                  # (2B, D)
        loss = 0.5 * (losses.softmax_xent((v @ cols.T) / TEMPERATURE, lbl)
                      + losses.softmax_xent((a_pos @ v.T) / TEMPERATURE, lbl))
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return {"loss": loss.detach()}


def train(cfg: GanConfig, batch_fn: Callable[[], Dict[str, Any]], num_steps: int,
          seed: int = 0, lr: float = 1e-4, objective: str = "infonce_hard",
          metrics_writer=None, eval_clips=None, eval_every: int = 0,
          audio_cfg: AudioConfig = AudioConfig(), device=None) -> SyncnetTrainState:
    """``num_steps`` steps on ``batch_fn()``'s batches; with held-out
    ``eval_clips`` and ``eval_every``, the aligned-vs-shifted AUC
    (``expert_proof.alignment_scores`` / ``auc``) joins the metrics at every
    ``eval_every``-th step and the last. Clips too short for the AUC's shift
    headroom are dropped up front (with a warning when none is left)."""
    state = create_state(cfg, seed, lr, device)
    if eval_clips is not None and eval_every:
        shift = 6   # alignment_scores' default
        min_len = cfg.syncnet_T + 2 * shift + 2
        usable = [c for c in eval_clips if len(c.frames) >= min_len]
        if not usable:
            warnings.warn(
                f"all {len(eval_clips)} held-out clips are shorter than the {min_len} frames "
                "the aligned-vs-shifted AUC eval needs; skipping AUC reporting", stacklevel=2)
            eval_clips = None
        else:
            eval_clips = usable
    for step in range(num_steps):
        m = train_step(state, batch_fn(), cfg, audio_cfg, objective)
        if eval_clips is not None and eval_every and (
                step % eval_every == 0 or step == num_steps - 1):
            from .expert_proof import alignment_scores, auc

            pos, neg = alignment_scores(state.model, cfg, eval_clips, seed=seed,
                                        audio_cfg=audio_cfg)
            m = dict(m, auc=auc(pos, neg))
        if metrics_writer is not None:
            metrics_writer.write(step, m)
    return state


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """The SyncNet ``state_dict`` (on the CPU) of a ``train-syncnet --out``
    export (``{"syncnet": state_dict}``)."""
    return load_once(path)["syncnet"]
