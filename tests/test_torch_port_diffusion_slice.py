"""The port's whole diffusion sampling slice against the JAX package:
uint8 condition frame + raw audio → conditioning → denoise steps → frames.

Both sides run the tiny configuration of ``scripts/bench_diffusion.py``
(attention at 16×16, 256 tokens, takes the flash path; 8×8 the einsum) in
float32 on the same perturbed params. The port is fed JAX's own random
draws: the initial x_T ``normal(split(key)[0], …)`` and, for the DDPM
chain, each step's ``normal(fold_in(split(key)[1], t), …)``."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lipreading_video_generation_tpu.core.config import DiffusionConfig as JCfg
from lipreading_video_generation_tpu.ops import image as jim
from lipreading_video_generation_tpu.pipelines import sample_diffusion as jsd
from lipreading_video_generation_tpu.pipelines import train_diffusion as jtd
from lipreading_video_generation_tpu_torch.core.config import ClassifierConfig, SuperResConfig
from lipreading_video_generation_tpu_torch.core.config import DiffusionConfig as TCfg
from lipreading_video_generation_tpu_torch.models.convert import unet_audio_state_dict_from_flax
from lipreading_video_generation_tpu_torch.models.unet_audio import UNetAudio
from lipreading_video_generation_tpu_torch.ops import attention as tatt
from lipreading_video_generation_tpu_torch.ops import image as tim
from lipreading_video_generation_tpu_torch.pipelines import sample_diffusion as tsd

TINY = dict(im_size=16, base_channels=32, channel_mult=(1, 2), num_res_blocks=1,
            attention_resolutions=(1, 2), num_heads=2, time_embed_dim=64,
            audio_embed_dim=64, audio_proj_dim=16, im_cond_channels=8,
            audio_samples=800, num_timesteps=50, dtype="float32")
# Float32 on both sides, other summation orders in every conv and GEMM;
# through 4 DDIM/DPM++ steps from t=49 (1/√ᾱ ≈ 1.06) the frames in [0, 1]
# agree to this bound.
TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = JCfg(**TINY)
    state = jtd.create_state(cfg, jax.random.key(0))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32), state.params)
    state = state.replace(params=params, ema_params=params)
    model = UNetAudio(TCfg(**TINY)).eval()
    model.load_state_dict(unet_audio_state_dict_from_flax(params, model.cfg))
    cond = rng.integers(0, 256, (2, 24, 24, 3), dtype=np.uint8)   # resized to 16×16
    audio = rng.standard_normal((2, cfg.audio_samples)).astype(np.float32)
    return cfg, state, model, cond, audio


def _x_T(key, shape):
    return np.array(jax.random.normal(jax.random.split(key)[0], shape))


def test_encode_condition_matches_jax(setup):
    """The 24→16 uint8 resize rounds a value that is a tie in exact
    arithmetic (116.5 here) to the even level in the port and, 1.5e-5 off,
    to the next one in JAX: such pixels may differ by one level (ROADMAP
    §3). Everywhere else the conditioning maps agree to the float32 bound."""
    cfg, state, model, cond, audio = setup
    want = np.asarray(jsd.encode_condition(state, jnp.asarray(cond), jnp.asarray(audio), cfg))
    got = tsd.encode_condition(model, cond, audio, TCfg(**TINY)).numpy()
    assert got.shape == want.shape == (2, 16, 16, 16 + 8)
    frames_j = np.asarray(jim.resize(jnp.asarray(cond), (16, 16))).astype(np.int32)
    frames_t = tim.resize(torch.from_numpy(cond), (16, 16)).numpy().astype(np.int32)
    tie = (frames_j != frames_t).any(-1)
    assert np.abs(frames_j - frames_t).max() <= 1 and tie.mean() <= 0.01
    np.testing.assert_allclose(got[~tie], want[~tie], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[..., :16], want[..., :16], rtol=1e-4, atol=1e-4)  # audio


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp"])
def test_sample_matches_jax(setup, sampler):
    cfg, state, model, cond, audio = setup
    key = jax.random.key(1)
    want, want_snaps = jsd.sample(state, jnp.asarray(cond), jnp.asarray(audio), key, cfg,
                                  num_inference_steps=4, sampler=sampler, snapshot_every=2)
    before = tatt.flash_attention.launch_count
    got, got_snaps = tsd.sample(model, cond, audio, TCfg(**TINY), num_inference_steps=4,
                                sampler=sampler, snapshot_every=2,
                                noise=_x_T(key, (2, 16, 16, 3)))
    assert tatt.flash_attention.launch_count == before        # CPU: plain version
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 16, 16, 3)
    assert got_snaps.shape == want_snaps.shape == (2, 2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_snaps.numpy(), np.asarray(want_snaps), rtol=TOL, atol=TOL)


def test_sample_video_uint8_matches_jax(setup):
    """T=3 frames from one condition frame; uint8 out. A value within the
    float bound of a rounding tie may land one level apart."""
    cfg, state, model, cond, audio = setup
    key = jax.random.key(2)
    windows = np.concatenate([audio, audio[:1] * 0.5])
    want = np.asarray(jsd.sample_video(state, jnp.asarray(cond[0]), jnp.asarray(windows), key,
                                       cfg, num_inference_steps=4))
    got = tsd.sample_video(model, cond[0], windows, TCfg(**TINY), num_inference_steps=4,
                           noise=_x_T(key, (3, 16, 16, 3))).numpy()
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (3, 16, 16, 3)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d == 0).mean() >= 0.99, (d.max(), (d == 0).mean())


def test_ddpm_chain_matches_jax(setup):
    """The full ancestral chain at num_timesteps=8, each step's noise passed
    explicitly (JAX's draw for that step)."""
    cfg, state, model, cond, audio = setup
    cfg8 = dataclasses.replace(cfg, num_timesteps=8)
    key = jax.random.key(3)
    want, want_snaps = jsd.sample(state, jnp.asarray(cond), jnp.asarray(audio), key, cfg8,
                                  snapshot_every=3)
    kloop = jax.random.split(key)[1]
    shape = (2, 16, 16, 3)
    step_noise = np.stack([np.array(jax.random.normal(jax.random.fold_in(kloop, t), shape))
                           for t in range(7, -1, -1)])
    got, got_snaps = tsd.sample(model, cond, audio, TCfg(**dict(TINY, num_timesteps=8)),
                                snapshot_every=3, noise=_x_T(key, shape), step_noise=step_noise)
    assert got_snaps.shape == want_snaps.shape == (3, 2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_snaps.numpy(), np.asarray(want_snaps), rtol=TOL, atol=TOL)


def test_sample_options_not_ported_raise(setup):
    _, _, model, cond, audio = setup
    cfg = TCfg(**TINY)
    with pytest.raises(ValueError, match="classifier_params"):
        tsd.sample(model, cond, audio, cfg, num_inference_steps=2, class_label=1,
                   classifier_cfg=ClassifierConfig())
    # the 1×1 mesh of one process gives mesh_spec=None's bits
    from lipreading_video_generation_tpu_torch.parallel.mesh import build_mesh

    def run(mesh):
        return tsd.sample(model, cond, audio, cfg, num_inference_steps=2, eta=1.0,
                          mesh_spec=mesh, generator=torch.Generator().manual_seed(3))
    for a, b in zip(run(None), run(build_mesh())):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="cascade mismatch"):
        tsd.sample_cascade(model, cond, audio, cfg, None, SuperResConfig(low_size=8))
    with pytest.raises(ValueError, match="sampler"):
        tsd.sample(model, cond, audio, cfg, num_inference_steps=2, sampler="euler")
    assert TCfg(audio_encoder="wav2vec2").audio_encoder == "wav2vec2"
    with pytest.raises(ValueError, match="native | wav2vec2"):
        TCfg(audio_encoder="hubert")
    # without explicit noise the draws come from the generator: same seed, same frames
    a = tsd.sample_video(model, cond[0], audio, cfg, num_inference_steps=2,
                         generator=torch.Generator().manual_seed(0))
    b = tsd.sample_video(model, cond[0], audio, cfg, num_inference_steps=2,
                         generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and a.shape == (2, 16, 16, 3)
