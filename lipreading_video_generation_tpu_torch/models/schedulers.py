"""DDPM noise schedulers.

Port of ``lipreading_video_generation_tpu/models/schedulers.py``:
``LinearScheduler``, ``LinearSchedulerV2``, ``CosineScheduler`` and
``make_scheduler``, with ``add_noise``, ``pred_x0``, ``ddim_prev``,
``dpmpp_2m_prev`` and ``sample_prev_timestep``. The tables are built in
float64 numpy exactly as in JAX and gathered as float32; the updates run in
float32 on the tensors' device and are layout-free (NCHW here, NHWC in
JAX). Noise is an argument ``z`` (the tests pass JAX's draws) or comes from
a ``torch.Generator``: the random streams of the two frameworks differ.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import draw_batch

__all__ = ["LinearScheduler", "LinearSchedulerV2", "CosineScheduler", "make_scheduler"]


def _mask(m: torch.Tensor, ndim: int) -> torch.Tensor:
    return m.reshape(m.shape + (1,) * (ndim - m.ndim))


def _noise(z: Optional[torch.Tensor], like: torch.Tensor,
           generator: Optional[torch.Generator]) -> torch.Tensor:
    """``z`` as given, or a standard normal draw from ``generator``."""
    if z is not None:
        return z.to(like.device, like.dtype)
    dev = generator.device if generator is not None else like.device
    # axis 0 of x_t is the batch: drawn for the global one in a sharded request
    return draw_batch(lambda s: torch.randn(s, generator=generator, device=dev,
                                            dtype=like.dtype), like.shape).to(like.device)


@dataclasses.dataclass(frozen=True)
class _BaseScheduler:
    num_timesteps: int
    betas: np.ndarray
    alphas: np.ndarray
    alpha_cum_prod: np.ndarray
    # float32 tables already on a device, by (name, device): a copy from
    # host memory per step would wait for the device each time
    _tables: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def _bcast(self, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """Gather the float32 per-t coefficient ``name`` and shape it (B, 1, 1, ...)."""
        key = (name, t.device)
        if key not in self._tables:
            table = (np.arange(self.num_timesteps) > 0 if name == "nonzero"
                     else getattr(self, name))
            self._tables[key] = torch.from_numpy(
                np.asarray(table).astype(np.float32)).to(t.device)
        c = self._tables[key][t]
        return c.reshape(c.shape + (1,) * (ndim - c.ndim))

    @property
    def sqrt_alpha_cum_prod(self) -> np.ndarray:
        return np.sqrt(self.alpha_cum_prod)

    @property
    def sqrt_one_minus_alpha_cum_prod(self) -> np.ndarray:
        return np.sqrt(1.0 - self.alpha_cum_prod)

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        """q-sample: x_t = √ᾱ_t x_0 + √(1-ᾱ_t) ε."""
        sa = self._bcast("sqrt_alpha_cum_prod", t, original.ndim)
        so = self._bcast("sqrt_one_minus_alpha_cum_prod", t, original.ndim)
        return sa * original + so * noise

    def pred_x0(self, xt: torch.Tensor, noise_pred: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
        so = self._bcast("sqrt_one_minus_alpha_cum_prod", t, xt.ndim)
        sa = self._bcast("sqrt_alpha_cum_prod", t, xt.ndim)
        return torch.clamp((xt - so * noise_pred) / sa, -1.0, 1.0)

    def ddim_prev(self, xt: torch.Tensor, noise_pred: torch.Tensor, t: torch.Tensor,
                  t_prev: torch.Tensor, eta: float = 0.0, z: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One DDIM update x_t → x_{t_prev} (Song et al. 2021, eq. 12);
        ``t_prev < 0`` means fully denoised (ᾱ_prev = 1). Returns (x_prev,
        clamped x0 estimate). With ``eta == 0`` the noise term is zero and
        no noise is drawn."""
        acp_t = self._bcast("alpha_cum_prod", t, xt.ndim)
        final = _mask(t_prev < 0, xt.ndim)
        acp_prev = torch.where(final, torch.ones_like(acp_t),
                               self._bcast("alpha_cum_prod", torch.clamp(t_prev, min=0), xt.ndim))
        sa_t = torch.sqrt(acp_t)
        so_t = torch.sqrt(1.0 - acp_t)
        x0_est = (xt - so_t * noise_pred) / sa_t
        sigma = eta * torch.sqrt(torch.clamp((1.0 - acp_prev) / (1.0 - acp_t), min=0.0)
                                 * torch.clamp(1.0 - acp_t / acp_prev, min=0.0))
        dir_xt = torch.sqrt(torch.clamp(1.0 - acp_prev - sigma ** 2, min=0.0)) * noise_pred
        x_prev = torch.sqrt(acp_prev) * x0_est + dir_xt
        if eta != 0.0:
            x_prev = x_prev + sigma * _noise(z, xt, generator)
        return x_prev, torch.clamp(x0_est, -1.0, 1.0)

    def dpmpp_2m_prev(self, xt: torch.Tensor, noise_pred: torch.Tensor, t: torch.Tensor,
                      t_prev: torch.Tensor, d_prev: torch.Tensor, t_last: torch.Tensor,
                      use_2m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One DPM-Solver++(2M) update x_t → x_{t_prev} (Lu et al. 2022).
        ``d_prev``/``t_last`` are the previous step's x0 prediction and
        timestep; ``use_2m`` switches the second-order correction on. At
        ``t_prev < 0`` it returns D exactly. Masked lanes may hold inf/nan:
        ``torch.where`` selects, never mixes. Returns (x_prev, d)."""
        acp_t = self._bcast("alpha_cum_prod", t, xt.ndim)
        acp_l = self._bcast("alpha_cum_prod", t_last, xt.ndim)
        final = _mask(t_prev < 0, xt.ndim)
        acp_p = torch.where(final, torch.ones_like(acp_t),
                            self._bcast("alpha_cum_prod", torch.clamp(t_prev, min=0), xt.ndim))
        a_t, s_t = torch.sqrt(acp_t), torch.sqrt(1.0 - acp_t)
        a_p, s_p = torch.sqrt(acp_p), torch.sqrt(1.0 - acp_p)
        lam_t = 0.5 * (torch.log(acp_t) - torch.log1p(-acp_t))
        lam_l = 0.5 * (torch.log(acp_l) - torch.log1p(-acp_l))
        lam_p = torch.where(final, torch.full_like(acp_p, float("inf")),
                            0.5 * (torch.log(acp_p) - torch.log1p(-acp_p)))
        h = lam_p - lam_t
        d = torch.clamp((xt - s_t * noise_pred) / a_t, -1.0, 1.0)
        r = (lam_t - lam_l) / h
        d2 = (1.0 + 0.5 / r) * d - (0.5 / r) * d_prev
        du = torch.where(_mask(torch.as_tensor(use_2m, device=xt.device), xt.ndim), d2, d)
        x_prev = (s_p / s_t) * xt - a_p * torch.expm1(-h) * du
        return x_prev, d


def _compvis_betas(num_timesteps: int, beta_start: float, beta_end: float) -> np.ndarray:
    return np.linspace(beta_start**0.5, beta_end**0.5, num_timesteps, dtype=np.float64) ** 2


@dataclasses.dataclass(frozen=True)
class LinearScheduler(_BaseScheduler):
    """Canonical DDPM posterior sampler (linear_noise_scheduler.py:48-76)."""

    @classmethod
    def create(cls, num_timesteps: int, beta_start: float = 0.00085, beta_end: float = 0.012):
        betas = _compvis_betas(num_timesteps, beta_start, beta_end)
        alphas = 1.0 - betas
        return cls(num_timesteps, betas, alphas, np.cumprod(alphas))

    def sample_prev_timestep(self, xt: torch.Tensor, noise_pred: torch.Tensor, t: torch.Tensor,
                             z: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        x0 = self.pred_x0(xt, noise_pred, t)
        so = self._bcast("sqrt_one_minus_alpha_cum_prod", t, xt.ndim)
        beta = self._bcast("betas", t, xt.ndim)
        alpha = self._bcast("alphas", t, xt.ndim)
        mean = (xt - beta * noise_pred / so) / torch.sqrt(alpha)
        acp_prev = self._bcast("alpha_cum_prod", torch.clamp(t - 1, min=0), xt.ndim)
        acp_t = self._bcast("alpha_cum_prod", t, xt.ndim)
        variance = (1.0 - acp_prev) / (1.0 - acp_t) * beta
        nonzero = self._bcast("nonzero", t, xt.ndim)
        return mean + nonzero * torch.sqrt(variance) * _noise(z, xt, generator), x0


@dataclasses.dataclass(frozen=True)
class LinearSchedulerV2(_BaseScheduler):
    """Alternate formulation (linear_noise_scheduler.py:79-101)."""

    @classmethod
    def create(cls, num_timesteps: int, beta_start: float = 0.0001, beta_end: float = 0.01):
        betas = _compvis_betas(num_timesteps, beta_start, beta_end)
        alphas = 1.0 - betas
        return cls(num_timesteps, betas, alphas, np.cumprod(alphas))

    def sample_prev_timestep(self, xt: torch.Tensor, noise_pred: torch.Tensor, t: torch.Tensor,
                             z: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        so = self._bcast("sqrt_one_minus_alpha_cum_prod", t, xt.ndim)
        alpha = self._bcast("alphas", t, xt.ndim)
        beta = self._bcast("betas", t, xt.ndim)
        acp_t = self._bcast("alpha_cum_prod", t, xt.ndim)
        mean = xt - so * noise_pred / torch.sqrt(alpha)
        variance = (1.0 - acp_t) * beta
        z = _noise(z, xt, generator)
        return mean + torch.sqrt(variance) * z, self.pred_x0(xt, noise_pred, t)


@dataclasses.dataclass(frozen=True)
class CosineScheduler(_BaseScheduler):
    """cos² ᾱ schedule (noise_scheduler.py:4-29)."""

    @classmethod
    def create(cls, num_timesteps: int, s: float = 0.008):
        ts = np.arange(num_timesteps, dtype=np.float64) / num_timesteps
        acp = np.cos(((ts + s) / (1 + s)) * np.pi * 0.5) ** 2
        alphas = np.concatenate([[acp[0]], acp[1:] / acp[:-1]])
        betas = 1.0 - alphas
        return cls(num_timesteps, betas, alphas, acp)

    def sample_prev_timestep(self, xt: torch.Tensor, noise_pred: torch.Tensor, t: torch.Tensor,
                             z: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        sa = self._bcast("sqrt_alpha_cum_prod", t, xt.ndim)
        so = self._bcast("sqrt_one_minus_alpha_cum_prod", t, xt.ndim)
        mean = (xt - so * noise_pred) / sa
        acp_t = self._bcast("alpha_cum_prod", t, xt.ndim)
        acp_prev = self._bcast("alpha_cum_prod", torch.clamp(t - 1, min=0), xt.ndim)
        variance = acp_prev * (1.0 - acp_t) / torch.clamp(1.0 - acp_prev, min=1e-20)
        nonzero = self._bcast("nonzero", t, xt.ndim)
        z = _noise(z, xt, generator)
        variance = torch.where(nonzero > 0, variance, torch.full_like(variance, 1e-5))
        return mean + nonzero * torch.sqrt(variance) * z, mean


def make_scheduler(name: str, num_timesteps: int, beta_start: float, beta_end: float):
    if name == "linear":
        return LinearScheduler.create(num_timesteps, beta_start, beta_end)
    if name == "linear_v2":
        return LinearSchedulerV2.create(num_timesteps, beta_start, beta_end)
    if name == "cosine":
        return CosineScheduler.create(num_timesteps)
    raise ValueError(f"unknown scheduler {name!r}")
