"""CNN frame features and the FeatureTransformer trainer: the Keras path.

Port of ``lipreading_video_generation_tpu/pipelines/feature_extraction.py``:
``embed_frames`` turns mouth-ROI clips into (N, T, 1024) DenseNet121
features, chunk by chunk on the device, with zero features for frames that
are all black (the reference zero-pads at the feature level); ``train`` runs
the epoch loop of the small transformer over those features (Adam, sparse
cross-entropy, a validation split), with ``create_state``, ``train_step``
and ``eval_step``.

On the card the DenseNet is torch's convolutions (cuDNN), BatchNorm and
pooling, as XLA's are in the JAX package, and the FeatureTransformer's
attention is the small-MHA kernel K2 (``ops.attention.mha``): float32 at
1024 features and 2 heads, head dim 512, by its CUDA-core route, one launch
a block in every forward; its backward is the einsum VJP.

PyTorch idiom where JAX keeps a pure state: ``FeatureTrainState`` holds the
model (float32 params), a ``torch.optim.Adam`` with optax ``adam``'s
hyperparameters, the step count and one ``torch.Generator`` on the model's
device, re-seeded each step with ``core.prng.step_key`` (JAX folds the step
into its dropout key), from which the dropout masks are drawn. JAX's
``embed_frames`` pads its last chunk to ``batch_frames``; in eval mode
padding changes no other frame's features, so the port does not pad.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..core import prng
from ..core.config import FeatureTransformerConfig
from ..core.device import resolve_device
from ..core.prng import seeded
from ..models.densenet import DenseNet121, imagenet_preprocess
from ..models.vivit import FeatureTransformer
from . import losses
from .train_diffusion import ADAM_BETAS, ADAM_EPS


@dataclasses.dataclass
class FeatureSet:
    """The reference's ``prepare_all_videos`` outputs."""

    features: np.ndarray            # (N, max_seq, num_features)
    labels: np.ndarray              # (N,)
    sentence_start_idx: List[int]   # word-index boundaries per sentence
    test_train_cut_idx: int         # first test-set row


def _densenet(variables_or_model: Union[DenseNet121, Mapping[str, torch.Tensor]]
              ) -> DenseNet121:
    if isinstance(variables_or_model, DenseNet121):
        return variables_or_model
    from ..models.ports import _materialise

    return _materialise(DenseNet121, variables_or_model)


def embed_frames(variables_or_model: Union[DenseNet121, Mapping[str, torch.Tensor]],
                 clips_uint8: np.ndarray, batch_frames: int = 512, device=None) -> np.ndarray:
    """(N, T, H, W, C) uint8 mouth ROIs → (N, T, 1024) float32 features.

    ``variables_or_model`` is a ``DenseNet121`` (moved to ``device`` and
    put in eval mode) or its state dict (``ports.densenet_variables_or_init``).
    Grayscale frames are repeated to 3 channels; ``batch_frames`` frames go
    through the network at a time on ``device`` (None: the card); a frame
    whose largest value is 0 gets zero features, an all-black real frame
    too, as in the JAX package."""
    device = resolve_device(device)
    model = _densenet(variables_or_model).to(device).eval()
    n, t = clips_uint8.shape[:2]
    frames = np.ascontiguousarray(clips_uint8).reshape((n * t,) + clips_uint8.shape[2:])
    feats = []
    with torch.inference_mode():
        for i in range(0, len(frames), batch_frames):
            chunk = torch.from_numpy(frames[i:i + batch_frames]).to(device)
            if chunk.shape[-1] == 1:
                chunk = chunk.expand(chunk.shape[:-1] + (3,))
            out = model(imagenet_preprocess(chunk))
            is_pad = chunk.reshape(len(chunk), -1).amax(dim=1) == 0
            feats.append(torch.where(is_pad[:, None], 0.0, out).cpu())
    return torch.cat(feats).numpy().reshape(n, t, -1)


@dataclasses.dataclass
class FeatureTrainState:
    """Everything a step changes: ``model`` (float32 params), ``optimizer``,
    ``step`` (updates done), and the ``generator`` of the dropout masks,
    re-seeded from ``root_key`` each step."""

    model: FeatureTransformer
    optimizer: torch.optim.Adam
    step: int
    generator: torch.Generator
    root_key: int

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_state(cfg: FeatureTransformerConfig, seed: int = 0, num_features: Optional[int] = None,
                 device=None) -> FeatureTrainState:
    """A fresh train state: a ``FeatureTransformer`` over ``num_features``
    (None: ``cfg.num_features``) per frame, initialised from ``seed``
    (Flax's init rules), in train mode on ``device`` (None: the card), and
    Adam at ``cfg.learning_rate`` (optax ``adam``: β 0.9/0.999, eps 1e-8
    added after the square root)."""
    device = resolve_device(device)
    model = seeded(lambda: FeatureTransformer(
        cfg.num_classes, num_features or cfg.num_features, cfg.max_seq_length,
        dense_dim=cfg.dense_dim, num_heads=cfg.num_heads, num_layers=cfg.num_layers,
        dropout=cfg.dropout, head_dropout=cfg.head_dropout), seed).to(device).train()
    opt = torch.optim.Adam(model.parameters(), lr=cfg.learning_rate, betas=ADAM_BETAS,
                           eps=ADAM_EPS)
    return FeatureTrainState(model, opt, 0, torch.Generator(device=device),
                             prng.make_root_key(seed))


def train_step(state: FeatureTrainState, feats: torch.Tensor, labels: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
    """One cross-entropy step in train mode (dropout on) on (B, T, F) float
    features and (B,) integer labels; updates ``state`` in place. Returns
    {"loss", "accuracy"} as device scalars."""
    model = state.model.train()
    feats = torch.as_tensor(feats).to(state.device, torch.float32)
    labels = torch.as_tensor(labels).to(state.device, torch.long)
    state.generator.manual_seed(prng.step_key(state.root_key, state.step))
    logits = model(feats, generator=state.generator)
    loss = losses.softmax_xent(logits, labels)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return {"loss": loss.detach(), "accuracy": losses.accuracy(logits.detach(), labels)}


@torch.no_grad()
def eval_step(state: FeatureTrainState, feats: torch.Tensor, labels: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
    """Loss and accuracy in eval mode (no dropout)."""
    feats = torch.as_tensor(feats).to(state.device, torch.float32)
    labels = torch.as_tensor(labels).to(state.device, torch.long)
    state.model.eval()
    try:
        logits = state.model(feats)
    finally:
        state.model.train()
    return {"loss": losses.softmax_xent(logits, labels),
            "accuracy": losses.accuracy(logits, labels)}


def train(cfg: FeatureTransformerConfig, features: np.ndarray, labels: np.ndarray,
          seed: int = 0, batch_size: int = 64, metrics_writer=None, device=None
          ) -> Tuple[FeatureTrainState, Dict[str, float]]:
    """The reference's epoch loop: a permutation from
    ``np.random.default_rng(seed)`` holds out the first
    ``max(1, int(cfg.val_split · N))`` clips, each of ``cfg.num_epochs``
    epochs reshuffles the rest with the same generator and steps over whole
    batches; then one eval on the held-out clips. ``metrics_writer.write(step,
    metrics)`` after each step, steps numbered from 1. Features and labels go
    to ``device`` (None: the card) once."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = len(features)
    idx = rng.permutation(n)
    n_val = max(1, int(cfg.val_split * n))
    val_idx, tr_idx = idx[:n_val], idx[n_val:]
    state = create_state(cfg, seed, features.shape[-1], device)
    feats = torch.from_numpy(np.asarray(features, np.float32)).to(device)
    labs = torch.from_numpy(np.asarray(labels, np.int64)).to(device)
    for _ in range(cfg.num_epochs):
        rng.shuffle(tr_idx)
        for i in range(0, len(tr_idx) - batch_size + 1, batch_size):
            pick = torch.from_numpy(tr_idx[i:i + batch_size]).to(device)
            m = train_step(state, feats[pick], labs[pick])
            if metrics_writer is not None:
                metrics_writer.write(state.step, m)
    pick = torch.from_numpy(val_idx).to(device)
    val = eval_step(state, feats[pick], labs[pick])
    return state, {k: float(v) for k, v in val.items()}
