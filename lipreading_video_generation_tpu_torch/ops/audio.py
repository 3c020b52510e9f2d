"""Log-mel audio frontend in plain torch.

Port of ``lipreading_video_generation_tpu/ops/audio.py``'s
``mel_filterbank``, ``preemphasis``, ``inv_preemphasis``, ``frame_signal``,
``stft_magnitude``, ``amp_to_db``, ``db_to_amp``, ``normalize_spec``,
``denormalize_spec``, ``melspectrogram`` and ``linearspectrogram`` (librosa
conventions: pre-emphasis → centred STFT with reflect padding and a periodic
Hann window → Slaney mel filterbank → amp-to-dB → ref-level shift →
symmetric normalisation to ±max_abs_value). The filterbank is the JAX
package's numpy construction, copied; the centre padding is numpy's
``reflect`` by index (repeated for waves shorter than the pad, as
``jnp.pad`` does); framing is ``unfold`` and the FFT is ``torch.fft.rfft``
(cuFFT on the card, where the JAX package uses XLA's FFT). Batched over any
leading dims of ``(..., samples)``. Also ``crop_mel_window`` and
``mel_windows``, which cut the 16-step mel windows aligned to video frames.
The filterbank and the window are built on each device once
(``mel_basis``, ``stft_window``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import AudioConfig

__all__ = ["mel_filterbank", "preemphasis", "inv_preemphasis", "frame_signal",
           "stft_magnitude", "amp_to_db", "db_to_amp", "normalize_spec", "denormalize_spec",
           "melspectrogram", "linearspectrogram", "crop_mel_window", "window_starts",
           "mel_windows", "mel_basis", "stft_window"]


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    log_region = f >= min_log_hz
    mel = np.where(log_region, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)
    return mel


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    f = m * f_sp
    log_region = m >= min_log_mel
    f = np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)
    return f


@functools.lru_cache(maxsize=8)
def _mel_filterbank_cached(sample_rate: int, n_fft: int, num_mels: int, fmin: float, fmax: float):
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_lo = _hz_to_mel_slaney(np.array(fmin))
    mel_hi = _hz_to_mel_slaney(np.array(fmax))
    mel_pts = np.linspace(mel_lo, mel_hi, num_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # slaney area normalization
    enorm = 2.0 / (hz_pts[2 : num_mels + 2] - hz_pts[:num_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def mel_filterbank(cfg: AudioConfig) -> np.ndarray:
    """(num_mels, n_fft//2+1) Slaney-normalised triangular filterbank."""
    if cfg.fmax > cfg.sample_rate // 2:
        raise ValueError("fmax above Nyquist")
    return _mel_filterbank_cached(cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.fmin, cfg.fmax)


def preemphasis(wav: torch.Tensor, k: float = 0.97, apply: bool = True) -> torch.Tensor:
    """y[n] = x[n] − k·x[n−1] along the last axis."""
    if not apply:
        return wav
    return wav - k * F.pad(wav[..., :-1], (1, 0))


_INV_PREEMPHASIS_BLOCK = 512


def inv_preemphasis(wav: torch.Tensor, k: float = 0.97, apply: bool = True) -> torch.Tensor:
    """The IIR inverse y[n] = x[n] + k·y[n−1] along the last axis, in float64
    blocks of 512 samples: inside a block the closed form
    y[s + t] = Σ_j k^(t−j)·x[s + j] + k^(t+1)·y[s − 1] is one triangular
    product, and the blocks follow one another. (JAX's ``associative_scan``
    in float32 sums in another order.)"""
    if not apply:
        return wav
    n = wav.shape[-1]
    b = max(1, min(_INV_PREEMPHASIS_BLOCK, n))
    i = torch.arange(b, device=wav.device)
    lag = (i[:, None] - i[None, :]).to(torch.float64)
    weights = torch.where(lag >= 0, k ** lag, torch.zeros_like(lag))   # (t, j)
    carry_gain = k ** (i + 1).to(torch.float64)
    x = wav.to(torch.float64)
    carry = torch.zeros(x.shape[:-1], dtype=torch.float64, device=wav.device)
    out = []
    for s in range(0, n, b):
        xb = x[..., s:s + b]
        m = xb.shape[-1]
        yb = xb @ weights[:m, :m].T + carry[..., None] * carry_gain[:m]
        out.append(yb)
        carry = yb[..., -1]
    return torch.cat(out, dim=-1).to(wav.dtype) if out else wav


def _hann_periodic(win_size: int) -> np.ndarray:
    n = np.arange(win_size)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_size)).astype(np.float32)


def frame_signal(wav: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(..., samples) → (..., num_frames, frame_length): frames of
    ``frame_length`` samples every ``hop``, the last one whole."""
    return wav.unfold(-1, frame_length, hop)


def reflect_index(n: int, pad: int, device=None) -> torch.Tensor:
    """Source index of each of the n + 2·pad samples of a wave of ``n``
    samples padded by ``pad`` on each side in numpy's ``reflect`` mode:
    the reflection repeats with period 2·(n − 1) when ``pad`` ≥ n, and a
    single sample is repeated."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j >= n, period - j, j)


def stft_magnitude(wav: torch.Tensor, n_fft: int = 800, hop: int = 200,
                   win_size: int = 800) -> torch.Tensor:
    """|STFT| with librosa conventions (centred, reflect padding, periodic
    Hann): (..., samples) → (..., n_fft//2+1, T), T = 1 + samples//hop."""
    if win_size > n_fft:
        raise ValueError("win_size must be <= n_fft")
    x = wav[..., reflect_index(wav.shape[-1], n_fft // 2, wav.device)]
    frames = frame_signal(x, n_fft, hop)                  # (..., T, n_fft)
    frames = frames * stft_window(n_fft, win_size, wav.device)
    mag = torch.fft.rfft(frames, n=n_fft, dim=-1).abs()
    return mag.transpose(-1, -2)


def amp_to_db(x: torch.Tensor, min_level_db: float = -100.0) -> torch.Tensor:
    min_level = float(np.exp(min_level_db / 20.0 * np.log(10.0)))
    return 20.0 * torch.log10(torch.clamp(x, min=min_level))


def db_to_amp(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, x * 0.05)


def normalize_spec(S: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    if cfg.symmetric_mels:
        out = ((2.0 * cfg.max_abs_value) * ((S - cfg.min_level_db) / (-cfg.min_level_db))
               - cfg.max_abs_value)
        return torch.clamp(out, -cfg.max_abs_value, cfg.max_abs_value)
    out = cfg.max_abs_value * ((S - cfg.min_level_db) / (-cfg.min_level_db))
    return torch.clamp(out, 0.0, cfg.max_abs_value)


def denormalize_spec(D: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """The inverse of ``normalize_spec`` (after its clip)."""
    if cfg.symmetric_mels:
        D = torch.clamp(D, -cfg.max_abs_value, cfg.max_abs_value)
        return ((D + cfg.max_abs_value) * -cfg.min_level_db / (2.0 * cfg.max_abs_value)
                + cfg.min_level_db)
    D = torch.clamp(D, 0.0, cfg.max_abs_value)
    return D * -cfg.min_level_db / cfg.max_abs_value + cfg.min_level_db


def _constant(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """``array`` on ``device`` as a plain tensor, even under ``inference_mode``
    (the cached constants below are shared by every caller and never written;
    they are never dropped either, since a captured CUDA graph reads them by
    address: a few KB for each config and device)."""
    with torch.inference_mode(False), torch.no_grad():
        return torch.from_numpy(array).to(device)


@functools.lru_cache(maxsize=None)
def stft_window(n_fft: int, win_size: int, device: torch.device) -> torch.Tensor:
    """The periodic Hann window of ``win_size`` centre-padded to ``n_fft``
    (like librosa), on ``device``; built once for each (n_fft, win_size,
    device), so that a step on the card copies nothing from pageable memory
    for it (nor may a CUDA graph's capture)."""
    window = _hann_periodic(win_size)
    if win_size < n_fft:
        lpad = (n_fft - win_size) // 2
        window = np.pad(window, (lpad, n_fft - win_size - lpad))
    return _constant(window, device)


@functools.lru_cache(maxsize=None)
def mel_basis(cfg: AudioConfig, device: torch.device) -> torch.Tensor:
    """``mel_filterbank(cfg)`` on ``device``, built once for each (cfg, device)."""
    return _constant(mel_filterbank(cfg), device)


def melspectrogram(wav: torch.Tensor, cfg: AudioConfig = AudioConfig()) -> torch.Tensor:
    """(..., samples) float32 → (..., num_mels, T) normalised log-mel."""
    basis = mel_basis(cfg, wav.device)
    y = preemphasis(wav, cfg.preemphasis, cfg.preemphasize)
    mag = stft_magnitude(y, cfg.n_fft, cfg.hop_size, cfg.win_size)
    mel = torch.einsum("mf,...ft->...mt", basis, mag)
    S = amp_to_db(mel, cfg.min_level_db) - cfg.ref_level_db
    if cfg.signal_normalization:
        S = normalize_spec(S, cfg)
    return S


def linearspectrogram(wav: torch.Tensor, cfg: AudioConfig = AudioConfig()) -> torch.Tensor:
    """(..., samples) float32 → (..., n_fft//2+1, T) normalised log-linear
    spectrogram."""
    y = preemphasis(wav, cfg.preemphasis, cfg.preemphasize)
    S = amp_to_db(stft_magnitude(y, cfg.n_fft, cfg.hop_size, cfg.win_size),
                  cfg.min_level_db) - cfg.ref_level_db
    if cfg.signal_normalization:
        S = normalize_spec(S, cfg)
    return S


def window_starts(start_frames: torch.Tensor, num_steps: int, fps: float = 25.0,
                  mel_step_size: int = 16, sample_rate: int = 16000,
                  hop: int = 200) -> torch.Tensor:
    """First mel step of the window aligned to each video frame of
    ``start_frames`` (any shape) in a mel of ``num_steps`` steps:
    floor(mel_steps_per_sec · start_frame / fps), clipped so that the window
    fits; the product and the quotient are float32, as in the JAX package."""
    starts = torch.as_tensor(start_frames, dtype=torch.float32)
    # a true division: a CUDA tensor divided by a Python number is multiplied
    # by the reciprocal, which can land just below an integer
    pos = (sample_rate / hop) * starts / torch.full_like(starts, fps)
    return torch.clamp(torch.floor(pos).long(), 0, num_steps - mel_step_size)


def mel_windows(mel: torch.Tensor, start_frames: torch.Tensor, fps: float = 25.0,
                mel_step_size: int = 16, sample_rate: int = 16000,
                hop: int = 200) -> torch.Tensor:
    """Aligned mel windows: (..., num_mels, T_mel) and (N,) start frames →
    (N, ..., num_mels, mel_step_size), each at ``window_starts``."""
    starts = torch.as_tensor(start_frames, dtype=torch.float32, device=mel.device)
    first = window_starts(starts, mel.shape[-1], fps, mel_step_size, sample_rate, hop)
    idx = first[:, None] + torch.arange(mel_step_size, device=mel.device)
    return torch.movedim(mel[..., idx], -2, 0)


def crop_mel_window(mel: torch.Tensor, start_frame, fps: float = 25.0, mel_step_size: int = 16,
                    sample_rate: int = 16000, hop: int = 200) -> torch.Tensor:
    """The ``mel_step_size``-step window of (..., num_mels, T_mel) aligned to
    video frame ``start_frame``."""
    start = torch.as_tensor(start_frame, dtype=torch.float32, device=mel.device).reshape(1)
    return mel_windows(mel, start, fps, mel_step_size, sample_rate, hop)[0]
