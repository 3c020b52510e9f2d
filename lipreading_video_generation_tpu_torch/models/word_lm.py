"""Small causal word-level transformer LM for sentence scoring.

Port of ``lipreading_video_generation_tpu/models/word_lm.py``: a learned
word embedding and position embedding, pre-LN causal transformer blocks and
logits from the tied embedding; trained on the dataset's own transcripts, it
scores beam-search sentence candidates (``pipelines.sentence_eval``).

What keeps it equal to the Flax module: LayerNorm eps 1e-6 (``models.layers``),
the tanh GELU, the logits ``x @ embedding.T`` in float32. The attention is
``ops.attention.mha(..., causal=True)``: on the card, float32 (B, S ≤ 31, 64)
inputs with 4 heads go to the small-MHA kernel K2 by its CUDA-core route
(``csrc/small_mha.cu``), and its backward is the einsum VJP under autograd;
on the CPU it is ``_mha_einsum``, the JAX package's path at these shapes.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..core.prng import seeded
from ..ops.attention import mha
from .layers import LayerNorm, Linear

PAD, BOS, EOS, UNK = 0, 1, 2, 3
_SPECIALS = ["<pad>", "<s>", "</s>", "<unk>"]


class WordLM(nn.Module):
    """tokens (B, S) int → next-token logits (B, S, V) float32."""

    def __init__(self, vocab_size: int, hidden: int = 64, num_layers: int = 2,
                 num_heads: int = 4, mlp_dim: int = 128, max_len: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers, self.num_heads, self.dtype = num_layers, num_heads, dtype
        self.embedding = nn.Parameter(0.02 * torch.randn(vocab_size, hidden))
        self.pos_embedding = nn.Parameter(0.02 * torch.randn(max_len, hidden))
        for i in range(num_layers):
            self.add_module(f"ln1_{i}", LayerNorm(hidden))
            self.add_module(f"qkv_{i}", Linear(hidden, 3 * hidden, dtype))
            self.add_module(f"proj_{i}", Linear(hidden, hidden, dtype))
            self.add_module(f"ln2_{i}", LayerNorm(hidden))
            self.add_module(f"fc1_{i}", Linear(hidden, mlp_dim, dtype))
            self.add_module(f"fc2_{i}", Linear(mlp_dim, hidden, dtype))
        self.ln_f = LayerNorm(hidden)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        s = tokens.shape[1]
        x = self.embedding[tokens].to(self.dtype) + self.pos_embedding[:s].to(self.dtype)
        for i in range(self.num_layers):
            layer = lambda name: getattr(self, f"{name}_{i}")   # noqa: E731
            q, k, v = layer("qkv")(layer("ln1")(x)).chunk(3, dim=-1)
            x = x + layer("proj")(mha(q, k, v, self.num_heads, causal=True))
            h = F.gelu(layer("fc1")(layer("ln2")(x)), approximate="tanh")
            x = x + layer("fc2")(h)
        x = self.ln_f(x)
        return x.to(torch.float32) @ self.embedding.T          # tied embedding head


def build_word_vocab(sentences: Sequence[str]) -> Dict[str, int]:
    vocab = dict(zip(_SPECIALS, range(len(_SPECIALS))))
    for s in sentences:
        for w in s.upper().split():
            vocab.setdefault(w, len(vocab))
    return vocab


def encode_sentences(sentences: Sequence[str], vocab: Dict[str, int],
                     max_len: int) -> np.ndarray:
    """<s> w1 … wn </s>, PAD-padded/truncated to max_len → (N, max_len) int32."""
    out = np.full((len(sentences), max_len), PAD, np.int32)
    for i, s in enumerate(sentences):
        ids = [BOS] + [vocab.get(w, UNK) for w in s.upper().split()][: max_len - 2] + [EOS]
        out[i, : len(ids)] = ids
    return out


def _token_log_probs(model: WordLM, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """log p of each next token of ``tokens`` (B, S) and the mask of real
    (non-PAD) targets, each (B, S - 1)."""
    logp = torch.log_softmax(model(tokens[:, :-1]), dim=-1)
    targets = tokens[:, 1:].long()
    tok_lp = torch.gather(logp, -1, targets[..., None])[..., 0]
    return tok_lp, (targets != PAD).to(torch.float32)


def sequence_log_likelihood(model: WordLM, tokens: torch.Tensor) -> torch.Tensor:
    """Length-normalised log p(tokens) under the LM, PAD ignored → (B,)."""
    tok_lp, mask = _token_log_probs(model, tokens)
    return torch.sum(tok_lp * mask, dim=-1) / torch.clamp(torch.sum(mask, dim=-1), min=1.0)


def lm_loss(model: WordLM, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token negative log-likelihood over the real targets."""
    tok_lp, mask = _token_log_probs(model, tokens)
    return -torch.sum(tok_lp * mask) / torch.clamp(torch.sum(mask), min=1.0)


def fit_word_lm(model: WordLM, data: np.ndarray, steps: int = 400, batch_size: int = 64,
                lr: float = 3e-3, seed: int = 0) -> WordLM:
    """``steps`` Adam steps of ``lm_loss`` on batches of the encoded
    sentences ``data`` picked with replacement by
    ``np.random.default_rng(seed)``, as the JAX package picks them. Updates
    ``model`` in place, on its device, and returns it."""
    device = next(model.parameters()).device
    # torch's Adam defaults are optax.adam's: β 0.9/0.999, eps 1e-8 outside the root
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    data_t = torch.from_numpy(data).to(device)
    rng = np.random.default_rng(seed)
    model.train()
    for _ in range(steps):
        pick = rng.integers(0, len(data), min(batch_size, len(data)))
        loss = lm_loss(model, data_t[torch.from_numpy(pick).to(device)])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return model.eval()


def train_word_lm(
    sentences: Sequence[str],
    hidden: int = 64,
    num_layers: int = 2,
    num_heads: int = 4,
    mlp_dim: int = 128,
    max_len: int = 32,
    steps: int = 400,
    batch_size: int = 64,
    lr: float = 3e-3,
    seed: int = 0,
    device=None,
) -> Tuple[WordLM, Dict[str, int]]:
    """Pretrain a ``WordLM`` on transcripts on ``device`` (None: the card);
    returns (model in eval mode, vocab). The JAX package returns (params,
    vocab, model): here the model holds its params."""
    vocab = build_word_vocab(sentences)
    model = seeded(lambda: WordLM(len(vocab), hidden, num_layers, num_heads, mlp_dim, max_len),
                   seed).to(resolve_device(device))
    return fit_word_lm(model, encode_sentences(sentences, vocab, max_len), steps, batch_size,
                       lr, seed), vocab
