"""The port's diffusion U-Net against the Flax modules, on the same
perturbed params through ``models.convert`` and the same numpy inputs.

Every parameter is perturbed with random noise: the Flax init zeroes each
ResBlock's second conv, each AttentionBlock's output projection and the
U-Net's output conv, and would hide them. The attention blocks at 16×16
attend over 256 tokens (256² > 128²), so they go through the flash path
(``flash_reference`` here, JAX's flash kernel in interpret mode); at 8×8
through the einsum path. Float32 throughout, where the point is the
algorithm; tolerances state the summation-order bound of each module.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lipreading_video_generation_tpu.core.config import DiffusionConfig as JCfg
from lipreading_video_generation_tpu.models import unet as junet
from lipreading_video_generation_tpu.models.unet_audio import UNetAudio as JUNetAudio
from lipreading_video_generation_tpu_torch.core.config import DiffusionConfig as TCfg
from lipreading_video_generation_tpu_torch.models import convert
from lipreading_video_generation_tpu_torch.models import unet as tunet
from lipreading_video_generation_tpu_torch.models.unet_audio import UNetAudio as TUNetAudio
from lipreading_video_generation_tpu_torch.ops import attention as tatt

# bench_diffusion.py's tiny configuration, with attention at ds 1 (256
# tokens: flash) and 2 (64 tokens: einsum)
TINY = dict(im_size=16, base_channels=32, channel_mult=(1, 2), num_res_blocks=1,
            attention_resolutions=(1, 2), num_heads=2, time_embed_dim=64,
            audio_embed_dim=64, audio_proj_dim=16, im_cond_channels=8,
            audio_samples=800, num_timesteps=50, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


def perturb(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + scale * rng.standard_normal(np.shape(a)).astype(np.float32), params)


def _nhwc_to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nchw_to_nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 17, 249, 499], np.int32)
    for dim in (32, 33, 64):
        want = np.asarray(junet.timestep_embedding(jnp.asarray(t), dim))
        got = tunet.timestep_embedding(torch.from_numpy(t), dim).numpy()
        # float32 sin/cos of arguments up to 499 rad: a few ulp of the argument
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("c_in,c_out", [(32, 32), (48, 64)])
def test_res_block_matches_flax(c_in, c_out):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, c_in)).astype(np.float32)
    emb = rng.standard_normal((2, 64)).astype(np.float32)
    block = junet.ResBlock(c_out)
    params = perturb(block.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(emb))["params"], 1)
    want = np.asarray(block.apply({"params": params}, jnp.asarray(x), jnp.asarray(emb)))
    port = tunet.ResBlock(c_in, c_out, 64, torch.float32)
    port.load_state_dict(convert.res_block_state_dict_from_flax(params, c_in != c_out))
    with torch.inference_mode():
        got = _nchw_to_nhwc(port(_nhwc_to_nchw(x), torch.from_numpy(emb)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hw,heads", [(16, 1), (16, 2), (8, 2)])
def test_attention_block_matches_flax(hw, heads):
    """16×16 → 256 tokens: the flash path on both sides; 8×8: einsum."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, hw, hw, 32)).astype(np.float32)
    block = junet.AttentionBlock(heads)
    params = perturb(block.init(jax.random.key(0), jnp.asarray(x))["params"], 3)
    want = np.asarray(block.apply({"params": params}, jnp.asarray(x)))
    port = tunet.AttentionBlock(32, heads, torch.float32)
    port.load_state_dict(convert.attention_block_state_dict_from_flax(params))
    route = tatt.mha_route(heads, hw * hw, hw * hw, 32, torch.float32, torch.device("cpu"))
    assert route == ("flash" if hw == 16 else "einsum")
    with torch.inference_mode():
        got = _nchw_to_nhwc(port(_nhwc_to_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_unet_model_matches_flax():
    rng = np.random.default_rng(4)
    kw = dict(base_channels=32, channel_mult=(1, 2), num_res_blocks=1,
              attention_resolutions=(1, 2), num_heads=2, time_embed_dim=64)
    x = rng.standard_normal((2, 16, 16, 5)).astype(np.float32)
    t = np.array([3, 41], np.int32)
    model = junet.UNetModel(out_channels=3, remat=False, **kw)
    params = perturb(model.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(t))["params"], 5)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    port = tunet.UNetModel(5, 3, **kw)
    port.load_state_dict(convert.unet_state_dict_from_flax(
        params, kw["base_channels"], kw["channel_mult"], kw["num_res_blocks"],
        kw["attention_resolutions"]))
    with torch.inference_mode():
        got = _nchw_to_nhwc(port(_nhwc_to_nchw(x), torch.from_numpy(t)))
    assert got.shape == want.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def unet_audio():
    """Tiny Flax UNetAudio with perturbed params, and the port loaded
    through the bridge."""
    cfg = JCfg(**TINY)
    model = JUNetAudio(cfg)
    s = cfg.im_size
    params = model.init(jax.random.key(0), jnp.zeros((1, s, s, 3)), jnp.zeros((1, s, s, 3)),
                        jnp.zeros((1, cfg.audio_samples)), jnp.zeros((1,), jnp.int32))["params"]
    params = perturb(params, 6)
    port = TUNetAudio(TCfg(**TINY)).eval()
    port.load_state_dict(convert.unet_audio_state_dict_from_flax(params, port.cfg))
    return cfg, model, params, port


def test_unet_audio_encode_condition_and_denoise_match_flax(unet_audio):
    cfg, model, params, port = unet_audio
    rng = np.random.default_rng(7)
    wave = rng.standard_normal((2, cfg.audio_samples)).astype(np.float32)
    cond_img = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    xt = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([49, 7], np.int32)
    cond_j = model.apply({"params": params}, jnp.asarray(wave), jnp.asarray(cond_img),
                         method=JUNetAudio.encode_condition)
    eps_j = model.apply({"params": params}, jnp.asarray(xt), cond_j, jnp.asarray(t),
                        method=JUNetAudio.denoise)
    with torch.inference_mode():
        cond_t = port.encode_condition(torch.from_numpy(wave), _nhwc_to_nchw(cond_img))
        eps_t = port.denoise(_nhwc_to_nchw(xt), cond_t, torch.from_numpy(t))
    np.testing.assert_allclose(_nchw_to_nhwc(cond_t), np.asarray(cond_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_nchw_to_nhwc(eps_t), np.asarray(eps_j), rtol=1e-3, atol=1e-3)


def test_unet_audio_bridge_rejects_missing_and_extra_entries(unet_audio):
    _, _, params, port = unet_audio
    extra = dict(params, unet=dict(params["unet"], AttentionBlock_9=params["unet"]["AttentionBlock_0"]))
    with pytest.raises(KeyError, match="AttentionBlock_9"):
        convert.unet_audio_state_dict_from_flax(extra, port.cfg)
    missing = dict(params, unet={k: v for k, v in params["unet"].items() if k != "ResBlock_2"})
    with pytest.raises(KeyError, match="ResBlock_2"):
        convert.unet_audio_state_dict_from_flax(missing, port.cfg)
    res = dict(params["unet"]["ResBlock_0"], Conv_2=params["unet"]["ResBlock_0"]["Conv_0"])
    with pytest.raises(KeyError, match="Conv_2"):
        convert.unet_audio_state_dict_from_flax(
            dict(params, unet=dict(params["unet"], ResBlock_0=res)), port.cfg)
    with pytest.raises(KeyError, match="audio_proj"):
        convert.unet_audio_state_dict_from_flax(
            {k: v for k, v in params.items() if k != "audio_proj"}, port.cfg)


@pytest.mark.parametrize("kw", [TINY, {}], ids=["tiny", "defaults"])
def test_chip_smoke_params_have_the_flax_tree(kw):
    """``chip_smoke.py`` builds random Flax-layout params in numpy (the
    card's machine has no flax): same paths and shapes as ``UNetAudio.init``."""
    import os
    import sys

    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir)))
    import chip_smoke

    cfg = JCfg(**kw)
    s = cfg.im_size
    want = jax.eval_shape(lambda: JUNetAudio(cfg).init(
        jax.random.key(0), jnp.zeros((1, s, s, 3)), jnp.zeros((1, s, s, 3)),
        jnp.zeros((1, cfg.audio_samples)), jnp.zeros((1,), jnp.int32)))["params"]
    got = chip_smoke.flax_unet_audio_params(TCfg(**kw), 0)

    def paths(tree):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {jax.tree_util.keystr(p): tuple(np.shape(a)) for p, a in flat}

    assert paths(got) == paths(want)
    TUNetAudio(TCfg(**kw)).load_state_dict(convert.unet_audio_state_dict_from_flax(got, TCfg(**kw)))
