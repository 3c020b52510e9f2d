"""Plain ε-MSE training steps of the diffusion U-Net, for the benchmark's
comparison: the reference repo's conditional-DDPM step (video-generation/
diffusion/train.py) with Adam (β 0.9/0.999, eps 1e-8, no weight decay).

A step: the uint8 target and condition frames resized (antialiased, rounded
back to uint8) to the model's size and put in [-1, 1], the raw audio; t, the
noise and the ResBlocks' dropout keep-masks drawn, in that order, from one
``torch.Generator`` (the trainer's own stream: the same seed gives the same
draws); x_t = √ᾱ_t·x_0 + √(1−ᾱ_t)·ε; the mean squared error of the
predicted ε over the batch; autograd; Adam. The batch is computed in chunks
of rows whose gradients add up to the whole batch's, so that float32
attention over 16,384 tokens fits. ``fault="half_batch"`` takes the loss
over the first half of the batch only (a planted fault for the limits).

``train`` returns what the benchmark compares: each step's loss, each
leaf's gradient at the first step, each leaf's change after the last.
Nothing here imports the program.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import image
from .nn import Numerics
from .unet_audio import UNetAudio, alphas_cumprod, res_shapes

BETAS, EPS = (0.9, 0.999), 1e-8


def draws(gen: torch.Generator, cfg: dict, b: int):
    """(t, noise, keep-masks) of one step, in the trainer's order."""
    dev = gen.device
    t = torch.randint(0, cfg["num_timesteps"], (b,), generator=gen, device=dev)
    s = cfg["im_size"]
    noise = torch.randn((b, cfg["im_channels"], s, s), generator=gen, device=dev)
    keep = [torch.empty(shape, dtype=torch.bool, device=dev).bernoulli_(1.0 - cfg["dropout"],
                                                                         generator=gen)
            for shape in res_shapes(cfg, b)]
    return t, noise, keep


def _frames(u8: torch.Tensor, size: int) -> torch.Tensor:
    return (image.resize(u8, (size, size)).float() / 255.0 * 2.0 - 1.0).permute(0, 3, 1, 2)


def train(params0: Dict[str, torch.Tensor], cfg: dict, batches: List[dict], gen_seed: int,
          lr: float, numerics: Numerics, device, chunk: int = 2,
          fault: Optional[str] = None) -> dict:
    """``len(batches)`` steps from ``params0``; ``batches``: dicts of host
    ``target_frame``/``cond_frame`` uint8 (B, h, w, 3) and ``audio`` (B, samples)."""
    p = {k: v.detach().clone().float().requires_grad_() for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    gen = torch.Generator(device=device).manual_seed(gen_seed)
    model = UNetAudio(p, cfg, numerics)
    acp = alphas_cumprod(cfg)
    sa = torch.from_numpy(np.sqrt(acp).astype(np.float32)).to(device)
    so = torch.from_numpy(np.sqrt(1.0 - acp).astype(np.float32)).to(device)
    size = cfg["im_size"]
    out = {"loss": [], "grad": {}, "change": {}}
    with numerics.context():
        for step, batch in enumerate(batches, start=1):
            b = len(batch["audio"])
            t, noise, keep = draws(gen, cfg, b)
            rows = b // 2 if fault == "half_batch" else b
            for k in p:
                p[k].grad = None
            total = 0.0
            for i in range(0, rows, chunk):
                sl = slice(i, min(i + chunk, rows))
                target = _frames(torch.from_numpy(batch["target_frame"][sl]).to(device), size)
                x_t = sa[t[sl]][:, None, None, None] * target + so[t[sl]][:, None, None, None] * noise[sl]
                cond = model.condition(torch.from_numpy(batch["cond_frame"][sl]).to(device),
                                       torch.from_numpy(batch["audio"][sl]).to(device))
                pred = model.denoise(x_t, cond, t[sl], [mk[sl] for mk in keep])
                loss = ((pred - noise[sl]) ** 2).sum() / (rows * noise[0].numel())
                loss.backward()
                total += float(loss.detach())
            out["loss"].append(total)
            with torch.no_grad():
                c1, c2 = 1.0 - BETAS[0] ** step, 1.0 - BETAS[1] ** step
                for k, w in p.items():
                    g = w.grad if w.grad is not None else torch.zeros_like(w)
                    if step == 1:
                        out["grad"][k] = g.detach().clone()
                    m[k].mul_(BETAS[0]).add_(g, alpha=1.0 - BETAS[0])
                    v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1.0 - BETAS[1])
                    w.sub_(lr / c1 * m[k] / ((v2[k] / c2).sqrt() + EPS))
    with torch.no_grad():
        out["change"] = {k: p[k] - params0[k].float() for k in p}
    return out
