"""The port's super-resolution stage against the JAX package's, mirroring
tests/test_superres.py: the ``SuperResModel`` bridge and forward, one
training step's gradients, ``sample_superres`` fed JAX's x_T, and the
cascade.

Tiny configuration: 16×16 high-res from 8×8 low-res, base 16, channel_mult
(1, 2), one res block, attention at ds 1 (256 tokens: the flash path, JAX's
Pallas forward and backward in interpret mode) and ds 2 (64 tokens:
einsum), 2 heads, float32. Params are perturbed (the Flax init zeroes the
output conv, which would zero every prediction and gradient).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lipreading_video_generation_tpu.core.config import SuperResConfig as JSRCfg
from lipreading_video_generation_tpu.pipelines import losses as jlosses
from lipreading_video_generation_tpu.pipelines import sample_diffusion as jsd
from lipreading_video_generation_tpu.pipelines import train_superres as jsr
from lipreading_video_generation_tpu_torch.core.config import DiffusionConfig as TCfg
from lipreading_video_generation_tpu_torch.core.config import SuperResConfig as TSRCfg
from lipreading_video_generation_tpu_torch.models import convert
from lipreading_video_generation_tpu_torch.models.unet_audio import UNetAudio
from lipreading_video_generation_tpu_torch.pipelines import sample_diffusion as tsd
from lipreading_video_generation_tpu_torch.pipelines import train_diffusion as ttd
from lipreading_video_generation_tpu_torch.pipelines import train_superres as tsr

TINY_SR = dict(im_size=16, low_size=8, base_channels=16, channel_mult=(1, 2),
               num_res_blocks=1, attention_resolutions=(1, 2), num_heads=2,
               time_embed_dim=32, num_timesteps=10, dtype="float32", batch_size=2,
               sr_inference_steps=5)
TINY_BASE = dict(im_size=8, base_channels=16, channel_mult=(1, 2), num_res_blocks=1,
                 attention_resolutions=(2,), num_heads=2, time_embed_dim=32,
                 audio_embed_dim=32, audio_proj_dim=8, im_cond_channels=4,
                 audio_samples=800, num_timesteps=10, dtype="float32")
KEY = jax.random.key(0)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def sr():
    """Perturbed Flax ``SuperResModel`` params and the port loaded with
    them through the bridge."""
    cfg = JSRCfg(**TINY_SR)
    params = jsr.create_state(cfg, KEY).params
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32), params)
    tcfg = TSRCfg(**TINY_SR)
    model = tsr.make_sr_model(tcfg).eval()
    model.load_state_dict(convert.superres_state_dict_from_flax(params, tcfg))
    return cfg, tcfg, params, model


def test_superres_bridge_and_forward_match_flax(sr):
    """Float32 on both sides; the bilinear upsample of the low-res input and
    every layer sum in other orders: 1e-4."""
    cfg, tcfg, params, model = sr
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    low = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    t = np.array([9, 2], np.int32)
    want = jsr.make_sr_model(cfg).apply({"params": params}, jnp.asarray(x), jnp.asarray(low),
                                        jnp.asarray(t))
    with torch.no_grad():
        got = model(_nchw(x), _nchw(low), torch.from_numpy(t).long())
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-4, atol=1e-4)
    with pytest.raises(KeyError, match="unet"):
        convert.superres_state_dict_from_flax({"net": params["unet"]}, tcfg)


def test_superres_prepare_batch_matches_jax():
    """High = the target at ``im_size``, low = that downsampled; each a
    rounded uint8 resize, so a tie may round to the other level (≤ 2/255
    after normalising, at few pixels)."""
    rng = np.random.default_rng(3)
    batch = {"target_frame": rng.integers(0, 256, (2, 24, 24, 3), dtype=np.uint8)}
    want = jsr.prepare_batch({"target_frame": jnp.asarray(batch["target_frame"])},
                             JSRCfg(**TINY_SR))
    got = tsr.prepare_batch(batch, TSRCfg(**TINY_SR), "cpu")
    for k, shape in (("high", (2, 16, 16, 3)), ("low", (2, 8, 8, 3))):
        diff = np.abs(_nhwc(got[k]) - np.asarray(want[k]))
        assert _nhwc(got[k]).shape == shape
        assert diff.max() <= 2.01 / 255 and (diff > 0).mean() <= 0.02, (k, diff.max())


def test_superres_step_gradients_match_jax(sr):
    """ε-MSE and every parameter's gradient of one step at JAX's prepared
    batch, t and noise (Flax's gradient tree through the same bridge):
    float32, 1e-4 of each tensor's largest gradient, 1e-3 relative."""
    cfg, tcfg, params, _ = sr
    rng = np.random.default_rng(4)
    prep = jsr.prepare_batch({"target_frame": jnp.asarray(
        rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8))}, cfg)
    t = np.array([7, 1], np.int32)
    noise = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    sched = jsr.make_scheduler(cfg.scheduler, cfg.num_timesteps, cfg.beta_start, cfg.beta_end)
    noisy = sched.add_noise(prep["high"], jnp.asarray(noise), jnp.asarray(t))

    def loss_fn(p):
        pred = jsr.make_sr_model(cfg).apply({"params": p}, noisy, prep["low"], jnp.asarray(t))
        return jlosses.noise_mse(pred, jnp.asarray(noise))

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    state = tsr.create_state(tcfg, device="cpu")
    state.model.load_state_dict(convert.superres_state_dict_from_flax(params, tcfg))
    tt, tnoise = ttd.draw_t_noise(state, _nchw(prep["high"]), cfg.num_timesteps, t, noise)
    tnoisy = state.scheduler.add_noise(_nchw(prep["high"]), tnoise, tt)
    loss = ttd.noise_mse(state.model(tnoisy, _nchw(prep["low"]), tt), tnoise)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    want = convert.superres_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, grads_j), tcfg)
    got = dict(state.model.named_parameters())
    assert set(got) == set(want)
    gmax = max(w.abs().max().item() for w in want.values())
    for name, w in want.items():   # exact zeros (biases under one-channel groups): noise
        atol = max(1e-4 * w.abs().max().item(), 1e-7 * gmax)
        np.testing.assert_allclose(got[name].grad.numpy(), w.numpy(), rtol=1e-3, atol=atol,
                                   err_msg=name)


def test_sample_superres_matches_jax_given_its_x_T(sr):
    """η = 0, so JAX's x_T (the first half of its key split) is the only
    draw: the whole 5-step DDIM chain agrees to 1e-4."""
    cfg, tcfg, params, model = sr
    low = np.random.default_rng(5).uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    want = jsd.sample_superres(params, jnp.asarray(low), KEY, cfg)
    x_t = jax.random.normal(jax.random.split(KEY)[0], (2, 16, 16, 3))
    got = tsd.sample_superres(model, low, tcfg, noise=np.array(x_t))
    assert tuple(got.shape) == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_superres_train_reduces_loss_and_round_trips(tmp_path):
    """ε-MSE falls over 24 steps on one batch with t and noise held fixed
    (drawn anew, the per-step losses bounce with t); ``train`` saves its
    last step and ``load_sr_params`` returns the EMA params."""
    cfg = dataclasses.replace(TSRCfg(**TINY_SR), learning_rate=1e-3)
    rng = np.random.default_rng(0)
    batch = {"target_frame": rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)}
    t, noise = np.array([3, 6]), rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    state = tsr.create_state(cfg, device="cpu")
    losses = [tsr.train_step(state, batch, cfg, t, noise)["loss"].item() for _ in range(24)]
    assert np.isfinite(losses).all() and state.step == 24
    assert losses[-1] < 0.9 * losses[0], losses
    trained = tsr.train(cfg, lambda: batch, num_steps=3, checkpoint_dir=str(tmp_path),
                        checkpoint_every=2, device="cpu")
    assert ttd.latest_checkpoint(str(tmp_path)).endswith("step_000000003.pt")
    ema = tsr.load_sr_params(str(tmp_path))
    assert all(torch.equal(ema[n], v) for n, v in trained.ema.state_dict().items())


def test_sample_cascade_shapes_and_size_check():
    base_cfg, sr_cfg = TCfg(**TINY_BASE), TSRCfg(**TINY_SR)
    base = ttd.seeded(lambda: UNetAudio(base_cfg), 0).eval()
    sr_model = ttd.seeded(lambda: tsr.make_sr_model(sr_cfg), 1).eval()
    rng = np.random.default_rng(6)
    cond = rng.integers(0, 256, (1, 8, 8, 3), dtype=np.uint8)
    audio = rng.standard_normal((1, 800)).astype(np.float32)
    hi, low = tsd.sample_cascade(base, cond, audio, base_cfg, sr_model, sr_cfg,
                                 num_inference_steps=5, sr_inference_steps=5,
                                 generator=torch.Generator().manual_seed(0))
    assert tuple(low.shape) == (1, 8, 8, 3) and tuple(hi.shape) == (1, 16, 16, 3)
    assert torch.isfinite(hi).all() and 0 <= hi.min() and hi.max() <= 1
    with pytest.raises(ValueError, match="cascade mismatch"):
        tsd.sample_cascade(base, cond, audio, dataclasses.replace(base_cfg, im_size=16),
                           sr_model, sr_cfg, num_inference_steps=5)
