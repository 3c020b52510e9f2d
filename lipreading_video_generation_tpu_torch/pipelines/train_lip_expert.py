"""Train the text-conditioned lipreading expert (character seq2seq).

Port of ``lipreading_video_generation_tpu/pipelines/train_lip_expert.py``:
``default_expert`` (the sizes the GAN's lip loss expects), ``create_state``
(Adam at 1e-4, optax's hyperparameters), ``train_step`` (teacher-forced
character cross-entropy with 30% token dropout on the decoder's inputs) and
``load_params`` (a ``train-lip-expert --out`` export). The trained expert is
the GAN's frozen lip expert (``train_gan``, ``--lip-expert-checkpoint``).

PyTorch idiom where JAX keeps a pure state: ``LipExpertTrainState`` holds
the module, its ``torch.optim.Adam``, the step and a ``torch.Generator`` on
the module's device, from which the token-dropout mask is drawn unless the
caller passes one (the tests pass JAX's).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..core.checkpoint import load_once
from ..core.device import resolve_device
from ..core.prng import seeded
from ..models.lip_expert import LipExpertSeq2Seq, seq2seq_expert_loss
from .train_diffusion import ADAM_BETAS, ADAM_EPS

TOKEN_DROPOUT = 0.3


def default_expert(max_text_len: int = 48, embed_dim: int = 256, enc_layers: int = 2,
                   dec_layers: int = 2, num_heads: int = 4, stem_base: int = 64,
                   num_frames: int = 5) -> LipExpertSeq2Seq:
    return LipExpertSeq2Seq(embed_dim=embed_dim, enc_layers=enc_layers, dec_layers=dec_layers,
                            num_heads=num_heads, max_text_len=max_text_len, stem_base=stem_base,
                            num_frames=num_frames)


@dataclasses.dataclass
class LipExpertTrainState:
    model: LipExpertSeq2Seq
    optimizer: torch.optim.Adam
    step: int
    generator: torch.Generator

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_state(seed: int = 0, syncnet_T: int = 5, learning_rate: float = 1e-4,
                 max_text_len: int = 48, device=None, **model_sizes) -> LipExpertTrainState:
    """A fresh expert (seeded Flax-style init) on ``device`` (None: the card)."""
    device = resolve_device(device)
    model = seeded(lambda: default_expert(max_text_len, num_frames=syncnet_T, **model_sizes),
                   seed).to(device).train()
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate, betas=ADAM_BETAS, eps=ADAM_EPS)
    gen = torch.Generator(device=device).manual_seed(seed)
    return LipExpertTrainState(model, opt, 0, gen)


def token_keep_mask(state: LipExpertTrainState, shape) -> torch.Tensor:
    """Bernoulli(1 − ``TOKEN_DROPOUT``) keep mask drawn from the state's
    generator."""
    return torch.rand(shape, generator=state.generator,
                      device=state.generator.device) >= TOKEN_DROPOUT


def train_step(state: LipExpertTrainState, batch: Dict[str, Any],
               keep: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One Adam step on ``batch`` (``window`` (B, T, H, W, 3) uint8,
    ``text_tokens`` (B, L)); ``keep`` is the token-dropout mask (drawn when
    None). Returns {"loss"} as a device scalar."""
    device = state.device
    window = torch.as_tensor(batch["window"]).to(device, torch.float32)
    tokens = torch.as_tensor(batch["text_tokens"]).to(device)
    if keep is None:
        keep = token_keep_mask(state, tokens.shape)
    loss = seq2seq_expert_loss(state.model.train(), window, tokens, keep=torch.as_tensor(keep))
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return {"loss": loss.detach()}


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """The expert's ``state_dict`` (on the CPU) from a ``train-lip-expert
    --out`` file of ``{"lip_expert": state_dict}``."""
    return load_once(path)["lip_expert"]
