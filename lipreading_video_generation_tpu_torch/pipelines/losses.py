"""Training losses and image metrics of the port.

Port of ``lipreading_video_generation_tpu/pipelines/losses.py``: ``bce``,
``l1``, ``softmax_xent``, ``accuracy``, the lip-sync GAN's
``cosine_bce_sync_loss``, ``syncnet_contrastive_loss``,
``perceptual_adversarial_loss``, ``discriminator_loss`` and
``generator_loss``, ``noise_mse``, and the frame metrics ``psnr`` and
``ssim`` (11-tap Gaussian, σ 1.5, as two separable depthwise VALID convs in
float32). Probabilities and similarities are clipped to [1e-7, 1 − 1e-7]
before a log, as there.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-7


def bce(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy of probabilities against targets, mean."""
    p = torch.clamp(pred, EPS, 1.0 - EPS)
    return -torch.mean(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of (B, C) logits against (B,) integer labels."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.take_along_dim(logp, labels.long()[:, None], dim=-1))


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Share of rows whose argmax (the first maximum on ties, as
    ``jnp.argmax``) is the label, float32."""
    return (torch.argmax(logits, dim=-1) == labels).to(torch.float32).mean()


def _cosine(audio_emb: torch.Tensor, face_emb: torch.Tensor) -> torch.Tensor:
    """Row-wise cosine similarity of unit-norm embeddings, clipped for the log."""
    return torch.clamp(torch.sum(audio_emb * face_emb, dim=-1), EPS, 1.0 - EPS)


def cosine_bce_sync_loss(audio_emb: torch.Tensor, face_emb: torch.Tensor) -> torch.Tensor:
    """BCE(cos-sim, 1) = −log(sim) over L2-normalised (B, D) embeddings: the
    scale the 0.75 sync gate is set on."""
    return -torch.mean(torch.log(_cosine(audio_emb, face_emb)))


def syncnet_contrastive_loss(audio_emb: torch.Tensor, face_emb: torch.Tensor,
                             y: torch.Tensor) -> torch.Tensor:
    """BCE(cos-sim, y) over positive (y = 1) and negative (y = 0) pairs."""
    sim = _cosine(audio_emb, face_emb)
    return -torch.mean(y * torch.log(sim) + (1.0 - y) * torch.log(1.0 - sim))


def perceptual_adversarial_loss(fake_pred: torch.Tensor) -> torch.Tensor:
    """The generator's adversarial term, BCE(D(fake), 1)."""
    return bce(fake_pred, torch.ones_like(fake_pred))


def discriminator_loss(real_pred: torch.Tensor,
                       fake_pred: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BCE(D(real), 1), BCE(D(fake), 0))."""
    return (bce(real_pred, torch.ones_like(real_pred)),
            bce(fake_pred, torch.zeros_like(fake_pred)))


def generator_loss(l1_recon: torch.Tensor, sync: torch.Tensor, perceptual: torch.Tensor,
                   lip: torch.Tensor, syncnet_wt, disc_wt: float,
                   lip_weight: float) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """lip_weight·lip + syncnet_wt·sync + disc_wt·perceptual +
    (1 − syncnet_wt − disc_wt)·L1, and its terms by name."""
    total = (lip_weight * lip + syncnet_wt * sync + disc_wt * perceptual
             + (1.0 - syncnet_wt - disc_wt) * l1_recon)
    return total, {
        "loss/g_total": total,
        "loss/l1": l1_recon,
        "loss/sync": sync,
        "loss/perceptual": perceptual,
        "loss/lip": lip,
        "syncnet_wt": torch.as_tensor(syncnet_wt, dtype=torch.float32),
    }


def noise_mse(noise_pred: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """ε-prediction MSE, in float32."""
    return torch.mean((noise_pred.to(torch.float32) - noise.to(torch.float32)) ** 2)


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB, float32 (the MSE floored at 1e-12)."""
    mse = torch.mean((a.to(torch.float32) - b.to(torch.float32)) ** 2)
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


def _gaussian_taps(device) -> torch.Tensor:
    r = torch.arange(11, dtype=torch.float32, device=device) - 5.0
    w = torch.exp(-(r ** 2) / (2.0 * 1.5 ** 2))
    return w / torch.sum(w)


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Mean structural similarity of images (..., H, W, C) (Wang et al. 2004:
    an 11×11 Gaussian window of σ 1.5, K1 0.01, K2 0.03; VALID windows only),
    float32."""
    c = a.shape[-1]
    a = a.to(torch.float32).reshape((-1,) + tuple(a.shape[-3:])).permute(0, 3, 1, 2)
    b = b.to(torch.float32).reshape((-1,) + tuple(b.shape[-3:])).permute(0, 3, 1, 2)
    w = _gaussian_taps(a.device)
    kh = w.reshape(1, 1, 11, 1).expand(c, 1, 11, 1)
    kw = w.reshape(1, 1, 1, 11).expand(c, 1, 1, 11)

    def blur(x):
        return F.conv2d(F.conv2d(x, kh, groups=c), kw, groups=c)

    mu_a, mu_b = blur(a), blur(b)
    var_a = blur(a * a) - mu_a ** 2
    var_b = blur(b * b) - mu_b ** 2
    cov = blur(a * b) - mu_a * mu_b
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    s = (((2 * mu_a * mu_b + c1) * (2 * cov + c2))
         / ((mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)))
    return torch.mean(s)
