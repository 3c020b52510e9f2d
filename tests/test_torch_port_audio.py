"""The port's audio frontend, ``normalize_audio`` and native audio encoder
against the JAX package, on the same numpy waves and perturbed Flax params."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lipreading_video_generation_tpu.core.config import AudioConfig as JAudioCfg
from lipreading_video_generation_tpu.models.audio_encoder import AudioFeatureEncoder as JEnc
from lipreading_video_generation_tpu.ops import audio as jaudio
from lipreading_video_generation_tpu.pipelines.train_diffusion import normalize_audio as jnorm
from lipreading_video_generation_tpu_torch.core.config import AudioConfig as TAudioCfg
from lipreading_video_generation_tpu_torch.models import convert
from lipreading_video_generation_tpu_torch.models.audio_encoder import AudioFeatureEncoder as TEnc
from lipreading_video_generation_tpu_torch.models.audio_encoder import num_tokens
from lipreading_video_generation_tpu_torch.ops import audio as taudio
from lipreading_video_generation_tpu_torch.pipelines.train_diffusion import normalize_audio as tnorm


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


def _waves():
    rng = np.random.default_rng(0)
    noise = 0.3 * rng.standard_normal((2, 4000))
    t = np.arange(4000) / 16000.0
    tones = np.stack([0.5 * np.sin(2 * np.pi * 440.0 * t),
                      0.2 * np.sin(2 * np.pi * 3000.0 * t) + 0.1 * np.sin(2 * np.pi * 97.0 * t)])
    return np.concatenate([noise, tones]).astype(np.float32)


def test_mel_filterbank_is_the_jax_one():
    np.testing.assert_array_equal(taudio.mel_filterbank(TAudioCfg()),
                                  jaudio.mel_filterbank(JAudioCfg()))


def test_stft_magnitude_matches_jax():
    wave = _waves()
    want = np.asarray(jaudio.stft_magnitude(jnp.asarray(wave)))
    got = taudio.stft_magnitude(torch.from_numpy(wave)).numpy()
    assert got.shape == want.shape == (4, 401, 21)
    # float32 FFTs of 800 points by two libraries: relative 1e-5 of the peak
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * want.max())


def test_melspectrogram_matches_jax():
    """Random and sinusoidal waves; the dB floor and the clip to ±4 are
    where rounding shows, so the bound is absolute, in normalised units
    (8 units = 100 dB)."""
    wave = _waves()
    want = np.asarray(jaudio.melspectrogram(jnp.asarray(wave), JAudioCfg()))
    got = taudio.melspectrogram(torch.from_numpy(wave), TAudioCfg()).numpy()
    assert got.shape == want.shape == (4, 80, 21)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("samples", [1, 200, 400, 401, 1000])
def test_melspectrogram_short_waves_match_jax(samples):
    """Waves no longer than the STFT's centre pad (n_fft / 2 = 400 samples):
    the pad reflects again and again, as numpy's ``reflect`` mode does
    (``jnp.pad``), a single sample repeated; one wave and a batch of three.
    Bound as ``test_melspectrogram_matches_jax``."""
    rng = np.random.default_rng(samples)
    for shape in ((samples,), (3, samples)):
        wave = (0.3 * rng.standard_normal(shape)).astype(np.float32)
        want = np.asarray(jaudio.melspectrogram(jnp.asarray(wave), JAudioCfg()))
        got = taudio.melspectrogram(torch.from_numpy(wave), TAudioCfg()).numpy()
        assert got.shape == want.shape == shape[:-1] + (80, 1 + samples // 200)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("n,pad", [(1, 3), (2, 5), (3, 7), (5, 2), (200, 400), (401, 400)])
def test_reflect_index_is_numpys_reflect(n, pad):
    x = np.arange(n) * 1.5 + 1
    np.testing.assert_array_equal(x[taudio.reflect_index(n, pad).numpy()],
                                  np.pad(x, pad, mode="reflect"))


def test_spectrogram_helpers_match_jax():
    """``frame_signal`` bit for bit; ``inv_preemphasis`` inverts
    ``preemphasis`` (JAX's bound, tests/test_audio.py) and agrees with JAX's
    scan within 1e-5; ``linearspectrogram`` within 1e-3 (its 401 bins are
    not averaged by the mel filterbank: the FFTs' rounding at a bin of low
    magnitude shows, 4.0e-4 at 2 of 32,882 values);
    ``db_to_amp`` and ``denormalize_spec`` (symmetric and not) within 1e-5
    relative, the round trip within JAX's bound."""
    rng = np.random.default_rng(7)
    w = (0.3 * rng.standard_normal((2, 8000))).astype(np.float32)
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    np.testing.assert_array_equal(taudio.frame_signal(tw, 800, 200).numpy(),
                                  np.asarray(jaudio.frame_signal(jw, 800, 200)))
    y = taudio.preemphasis(tw)
    back = taudio.inv_preemphasis(y)
    np.testing.assert_allclose(back.numpy(), w, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(back.numpy(), np.asarray(jaudio.inv_preemphasis(
        jaudio.preemphasis(jw))), rtol=0, atol=1e-5)
    assert taudio.inv_preemphasis(y, apply=False) is y
    got = taudio.linearspectrogram(tw).numpy()
    assert got.shape == (2, 401, 41)
    np.testing.assert_allclose(got, np.asarray(jaudio.linearspectrogram(jw)), rtol=0, atol=1e-3)
    S = rng.uniform(-100, 0, (80, 20)).astype(np.float32)
    np.testing.assert_allclose(taudio.db_to_amp(torch.from_numpy(S)).numpy(),
                               np.asarray(jaudio.db_to_amp(jnp.asarray(S))), rtol=1e-5)
    for cfg in ({}, {"symmetric_mels": False}):
        tc, jc = TAudioCfg(**cfg), JAudioCfg(**cfg)
        n = taudio.normalize_spec(torch.from_numpy(S), tc)
        d = rng.uniform(-5, 5, (80, 20)).astype(np.float32)
        np.testing.assert_allclose(taudio.denormalize_spec(torch.from_numpy(d), tc).numpy(),
                                   np.asarray(jaudio.denormalize_spec(jnp.asarray(d), jc)),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(taudio.denormalize_spec(n, tc).numpy(), S, rtol=1e-4,
                                   atol=1e-3)


def test_normalize_audio_matches_jax():
    wave = _waves() * np.array([[1.0], [10.0], [0.01], [1.0]], np.float32)
    want = np.asarray(jnorm(jnp.asarray(wave)))
    got = tnorm(torch.from_numpy(wave)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("samples", [800, 4000])
def test_audio_encoder_matches_flax(samples):
    """4 blocks, 8 heads, embed 64; at 4000 samples 11 tokens (the K2 shape
    of the diffusion path at a narrower width)."""
    wave = np.ascontiguousarray(_waves()[:, :samples])
    enc = JEnc(embed_dim=64)
    params = enc.init(jax.random.key(0), jnp.asarray(wave))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32), params)
    want = np.asarray(enc.apply({"params": params}, jnp.asarray(wave)))
    port = TEnc(samples, embed_dim=64).eval()
    port.load_state_dict(convert.audio_encoder_state_dict_from_flax(params))
    with torch.inference_mode():
        got = port(torch.from_numpy(wave)).numpy()
    assert got.shape == want.shape == (4, num_tokens(samples), 64)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_mel_constants_are_built_once_a_device_and_give_the_same_log_mels():
    """``mel_basis`` and ``stft_window`` are made once for each (config,
    device), as plain tensors even when first made under ``inference_mode``,
    and the log-mels equal those of the filterbank and window built anew."""
    cfg = TAudioCfg()
    wav = torch.from_numpy(_waves())
    taudio.mel_basis.cache_clear()
    taudio.stft_window.cache_clear()
    with torch.inference_mode():
        taudio.melspectrogram(wav, cfg)
    got = taudio.melspectrogram(wav, cfg)
    cpu = torch.device("cpu")
    assert taudio.mel_basis(cfg, cpu) is taudio.mel_basis(cfg, cpu)
    # never dropped: a captured CUDA graph reads them by address
    assert taudio.mel_basis.cache_info().maxsize is None
    assert taudio.stft_window.cache_info().maxsize is None
    assert taudio.mel_basis.cache_info().misses == 1
    assert taudio.stft_window.cache_info().misses == 1
    assert not taudio.mel_basis(cfg, cpu).is_inference()
    assert not taudio.stft_window(cfg.n_fft, cfg.win_size, cpu).is_inference()

    n = np.arange(cfg.win_size)
    window = torch.from_numpy((0.5 - 0.5 * np.cos(2.0 * np.pi * n / cfg.win_size))
                              .astype(np.float32))
    y = taudio.preemphasis(wav, cfg.preemphasis, cfg.preemphasize)
    x = y[..., taudio.reflect_index(y.shape[-1], cfg.n_fft // 2)]
    mag = torch.fft.rfft(taudio.frame_signal(x, cfg.n_fft, cfg.hop_size) * window,
                         n=cfg.n_fft, dim=-1).abs().transpose(-1, -2)
    mel = torch.einsum("mf,...ft->...mt", torch.from_numpy(taudio.mel_filterbank(cfg)), mag)
    want = taudio.normalize_spec(taudio.amp_to_db(mel, cfg.min_level_db) - cfg.ref_level_db, cfg)
    assert cfg.win_size == cfg.n_fft and cfg.signal_normalization
    assert torch.equal(got, want)
