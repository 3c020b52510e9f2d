"""Plain log-mel front end and wave normalisation of the diffusion model's
audio encoder, in float32 (float64 for the filterbank's construction).

librosa's conventions as the reference repo's ``audio.py`` uses them:
pre-emphasis 0.97 → centred STFT (n_fft 800, hop 200, periodic Hann,
numpy ``reflect`` padding) → Slaney mel filterbank (80 mels, 55-7600 Hz)
→ amplitude to dB, minus the 20 dB reference level → symmetric
normalisation to ±4. ``normalize_audio`` is the diffusion trainer's
first-order high-pass and per-clip standardisation. Nothing here imports
the program.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE, N_FFT, HOP, WIN, NUM_MELS = 16000, 800, 200, 800, 80
FMIN, FMAX = 55.0, 7600.0
PREEMPHASIS, MIN_LEVEL_DB, REF_LEVEL_DB, MAX_ABS = 0.97, -100.0, 20.0, 4.0


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    min_log_mel = min_log_hz / f_sp
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), m * f_sp)


def mel_filterbank() -> np.ndarray:
    """(80, 401) Slaney-normalised triangular filters, float32."""
    fft_freqs = np.linspace(0.0, SAMPLE_RATE / 2.0, N_FFT // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(FMIN), _hz_to_mel(FMAX), NUM_MELS + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - fft_freqs[None, :]
    weights = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    weights *= (2.0 / (hz[2:NUM_MELS + 2] - hz[:NUM_MELS]))[:, None]
    return weights.astype(np.float32)


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    i = torch.arange(-pad, n + pad, device=device)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j >= n, period - j, j)


def melspectrogram(wav: torch.Tensor) -> torch.Tensor:
    """(B, samples) float32 → (B, 80, 1 + samples // 200) normalised log-mel."""
    y = wav - PREEMPHASIS * F.pad(wav[..., :-1], (1, 0))
    x = y[..., _reflect_index(y.shape[-1], N_FFT // 2, y.device)]
    frames = x.unfold(-1, N_FFT, HOP)
    n = np.arange(WIN)
    window = torch.from_numpy((0.5 - 0.5 * np.cos(2.0 * np.pi * n / WIN)).astype(np.float32))
    mag = torch.fft.rfft(frames * window.to(y.device), n=N_FFT, dim=-1).abs().transpose(-1, -2)
    mel = torch.einsum("mf,...ft->...mt", torch.from_numpy(mel_filterbank()).to(y.device), mag)
    min_level = float(np.exp(MIN_LEVEL_DB / 20.0 * np.log(10.0)))
    S = 20.0 * torch.log10(torch.clamp(mel, min=min_level)) - REF_LEVEL_DB
    out = (2.0 * MAX_ABS) * ((S - MIN_LEVEL_DB) / (-MIN_LEVEL_DB)) - MAX_ABS
    return torch.clamp(out, -MAX_ABS, MAX_ABS)


def normalize_audio(wave: torch.Tensor) -> torch.Tensor:
    """High-pass y[n] = x[n] − 0.889·x[n−1], then zero mean and unit
    (population) standard deviation per clip, + 1e-6 on the deviation."""
    hp = wave - 0.889 * F.pad(wave[..., :-1], (1, 0))
    mean = hp.mean(dim=-1, keepdim=True)
    std = hp.std(dim=-1, keepdim=True, correction=0) + 1e-6
    return (hp - mean) / std
