"""The port's wav2vec2 encoder (``models/wav2vec2``), its converter and port
path, and the diffusion model conditioned on it, against the JAX package and
against ``transformers``' own ``Wav2Vec2Model``.

Sizes: 64 wide, 2 layers, 4 heads, FFN 128, three convs of 24 channels
(kernels 10, 3, 3, strides 5, 2, 2), positional conv 16 taps in 4 groups,
as in the JAX package's port test; the diffusion U-Net at 16×16, base 16,
attention at ds 2 only (the einsum path), 800 samples (T′ = 39), float32,
dropout 0. Weights: Flax trees (``jax.eval_shape`` of ``init``) filled from
seeded numpy, bridged by ``models.convert``; HF models from a config object
and ``torch.manual_seed``.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lipreading_video_generation_tpu.core.config import DiffusionConfig as JCfg
from lipreading_video_generation_tpu.models import wav2vec2 as jw2v
from lipreading_video_generation_tpu.models.unet_audio import UNetAudio as JUNetAudio
from lipreading_video_generation_tpu.pipelines import losses as jlosses
from lipreading_video_generation_tpu.pipelines import train_diffusion as jtd
from lipreading_video_generation_tpu_torch.core.config import DiffusionConfig as TCfg
from lipreading_video_generation_tpu_torch.models import convert, ports, selftest
from lipreading_video_generation_tpu_torch.models import wav2vec2 as tw2v
from lipreading_video_generation_tpu_torch.pipelines import train_diffusion as ttd

SMALL = selftest.SMALL_WAV2VEC2
DIFF = dict(im_size=16, base_channels=16, channel_mult=(1, 2), num_res_blocks=1,
            attention_resolutions=(2,), num_heads=2, time_embed_dim=16, audio_proj_dim=8,
            im_cond_channels=4, audio_samples=800, num_timesteps=50, dropout=0.0,
            dtype="float32", audio_encoder="wav2vec2", audio_embed_dim=64, w2v_num_layers=2,
            w2v_num_heads=4, w2v_ffn_dim=128, w2v_conv_dim=(24, 24, 24),
            w2v_conv_kernel=(10, 3, 3), w2v_conv_stride=(5, 2, 2), w2v_pos_conv_kernel=16,
            w2v_pos_conv_groups=4)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


def _flax_tree(shapes, seed):
    """A Flax param tree of ``shapes`` from seeded numpy: kernels ~ N(0,
    1/fan_in), norm scales near 1, small biases."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if name.endswith("['kernel']"):
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name.endswith("['scale']"):
            v = 1.0 + 0.05 * rng.standard_normal(shape)
        else:
            v = 0.05 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _wave(n=2, samples=1600, seed=1):
    return np.random.default_rng(seed).standard_normal((n, samples)).astype(np.float32)


@pytest.fixture(scope="module")
def flax_encoder():
    model = jw2v.Wav2Vec2Encoder(**SMALL)
    params = _flax_tree(jax.eval_shape(model.init, jax.random.key(0),
                                       jnp.zeros((1, 1600)))["params"], 0)
    return params, np.asarray(model.apply({"params": params}, jnp.asarray(_wave())))


def test_encoder_matches_flax(flax_encoder):
    """The same weights through both encoders: float32, other summation
    orders in the convs and GEMMs; within 1e-4."""
    params, want = flax_encoder
    model = tw2v.Wav2Vec2Encoder(**SMALL)
    model.load_state_dict(convert.wav2vec2_state_dict_from_flax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(_wave())).numpy()
    assert got.shape == want.shape == (2, tw2v.num_frames(1600, SMALL["conv_kernel"],
                                                          SMALL["conv_stride"]), 64)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert tw2v.num_frames(4000) == 12 and tw2v.num_frames(163840) == 511


def _hf_model(ctc=False, seed=0):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(seed)
    cfg = transformers.Wav2Vec2Config(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
        conv_dim=(24, 24, 24), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, do_stable_layer_norm=False,
        feat_extract_norm="group", conv_bias=False, hidden_dropout=0.0, attention_dropout=0.0,
        feat_proj_dropout=0.0, layerdrop=0.0, vocab_size=32)
    cls = transformers.Wav2Vec2ForCTC if ctc else transformers.Wav2Vec2Model
    return cls(cfg).eval()


def _as_layout(sd, layout):
    """The positional conv's weight-norm pair renamed to ``layout``."""
    g, v = tw2v.WEIGHT_NORM_LAYOUTS[layout]
    out = {}
    for k, t in sd.items():
        for old_g, old_v in tw2v.WEIGHT_NORM_LAYOUTS.values():
            k = k.replace(old_g, g) if k.endswith(old_g) else k
            k = k.replace(old_v, v) if k.endswith(old_v) else k
        out[k] = t
    return out


@pytest.mark.parametrize("layout", ["weight_g", "parametrizations"])
def test_encoder_matches_transformers(layout):
    """HF ``Wav2Vec2Model`` (built from a config) → the port's converter →
    the port's encoder reproduces ``last_hidden_state`` within 2e-3 (JAX's
    own bound: the port's norm epsilons are 1e-6, HF's 1e-5), from either
    serialisation of the weight-normed positional conv."""
    hf = _hf_model()
    wave = _wave()
    with torch.no_grad():
        want = hf(torch.from_numpy(wave)).last_hidden_state.numpy()
    sd, cfg, skipped = tw2v.convert_wav2vec2_state_dict(_as_layout(hf.state_dict(), layout),
                                                        num_heads=4)
    assert skipped == ["masked_spec_embed"] and cfg["pos_conv_groups"] == 4
    model = tw2v.Wav2Vec2Encoder(**cfg)
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model(torch.from_numpy(wave)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_converter_equals_jax_and_reads_the_ctc_wrapper():
    """The ``Wav2Vec2ForCTC`` layout (``wav2vec2.`` prefix, ``lm_head``):
    the port's converter gives the bare model's weights, and exactly what the
    JAX package's converter gives, bridged (the positional conv composed in
    float64 on both sides)."""
    hf = _hf_model(ctc=True)
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    got, cfg, skipped = tw2v.convert_wav2vec2_state_dict(sd, num_heads=4)
    assert {"lm_head.weight", "lm_head.bias"} <= set(skipped)
    bare, cfg_bare, _ = tw2v.convert_wav2vec2_state_dict(hf.wav2vec2.state_dict(), num_heads=4)
    assert cfg == cfg_bare and all(torch.equal(got[k], bare[k]) for k in bare)
    jparams, jcfg, jskipped = jw2v.convert_wav2vec2_state_dict(sd, num_heads=4)
    assert jcfg == cfg and jskipped == skipped
    want = convert.wav2vec2_state_dict_from_flax(jparams)
    assert set(want) == set(got) and all(torch.equal(got[k], want[k]) for k in want)


def test_converter_rejects_layout_drift():
    sd = dict(_hf_model().state_dict())
    drift = dict(sd, **{"encoder.layers.0.attention.rotary_emb.inv_freq": torch.zeros(4)})
    with pytest.raises(ValueError, match="unrecognized"):
        tw2v.convert_wav2vec2_state_dict(drift, num_heads=4)
    with pytest.raises(KeyError):
        tw2v.convert_wav2vec2_state_dict(
            {k: v for k, v in sd.items() if "final_layer_norm" not in k}, num_heads=4)
    with pytest.raises(ValueError, match="not a wav2vec2"):
        tw2v.convert_wav2vec2_state_dict({"foo": torch.zeros(1)})


@pytest.mark.parametrize("layout", ["weight_g", "parametrizations"])
def test_selftest_file_has_the_hf_layout(tmp_path, layout):
    """``make_wav2vec2_selftest_pth`` writes, from the port's own key list,
    the key set and shapes of HF's ``Wav2Vec2ForCTC`` (whose positional conv
    is serialised as ``parametrizations``); ``port_wav2vec2`` ports it and
    ``load_wav2vec2_params`` reads the artifact back."""
    pth = selftest.make_wav2vec2_selftest_pth(str(tmp_path / "w.pth"), seed=3,
                                              weight_norm=layout)
    sd = torch.load(pth, weights_only=True)
    hf = _as_layout(_hf_model(ctc=True).state_dict(), layout)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape)
                                                          for k, v in hf.items()}
    got, cfg, _ = ports.port_wav2vec2(pth, str(tmp_path / "w2v"), num_heads=4)
    back, cfg_back = ports.load_wav2vec2_params(str(tmp_path / "w2v"))
    assert cfg_back == cfg and all(torch.equal(back[k], got[k]) for k in got)
    assert {k: v for k, v in cfg.items() if k in SMALL} == SMALL


@pytest.fixture(scope="module")
def jax_diffusion():
    """Perturbed params of a JAX ``UNetAudio`` with the wav2vec2 encoder,
    its conditioning map, and the loss and gradients of one training step
    at JAX's draws of t and noise."""
    cfg = JCfg(**DIFF)
    params = _flax_tree(jax.eval_shape(
        JUNetAudio(cfg).init, jax.random.key(0), jnp.zeros((1, 16, 16, 3)),
        jnp.zeros((1, 16, 16, 3)), jnp.zeros((1, 800)), jnp.zeros((1,), jnp.int32))["params"], 4)
    rng = np.random.default_rng(5)
    batch = {"target_frame": rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8),
             "cond_frame": rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8),
             "audio": rng.standard_normal((2, 800)).astype(np.float32)}
    t = np.array([3, 41])
    noise = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    prep = jtd.prepare_batch({k: jnp.asarray(v) for k, v in batch.items()}, cfg)
    cond = JUNetAudio(cfg).apply({"params": params}, prep["audio"], prep["cond"],
                                 method=JUNetAudio.encode_condition)
    noisy = jtd.make_scheduler(cfg.scheduler, cfg.num_timesteps, cfg.beta_start,
                               cfg.beta_end).add_noise(prep["target"], jnp.asarray(noise),
                                                       jnp.asarray(t))

    def loss_fn(p):
        pred = JUNetAudio(cfg).apply({"params": p}, noisy, prep["cond"], prep["audio"],
                                     jnp.asarray(t))
        return jlosses.noise_mse(pred, jnp.asarray(noise))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return {"params": params, "batch": batch, "t": t, "noise": noise,
            "cond": np.asarray(cond), "loss": float(loss),
            "grads": jax.tree_util.tree_map(np.asarray, grads)}


def _port_diffusion_state(params):
    cfg = TCfg(**DIFF)
    state = ttd.create_state(cfg, device="cpu")
    sd = convert.unet_audio_state_dict_from_flax(params, cfg)
    state.model.load_state_dict(sd)
    state.ema.load_state_dict(sd)
    return state


def test_encode_condition_matches_jax(jax_diffusion):
    """The conditioning map (the wav2vec2 features' mean over T′, projected,
    beside the condition frame's 1×1 conv) within 1e-5."""
    state = _port_diffusion_state(jax_diffusion["params"])
    prep = ttd.prepare_batch(jax_diffusion["batch"], state.model.cfg, "cpu")
    with torch.no_grad():
        got = state.model.encode_condition(prep["audio"], prep["cond"]).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), jax_diffusion["cond"], atol=1e-5, rtol=0)


def test_train_step_with_wav2vec2_matches_jax(jax_diffusion):
    """One step of ε-MSE through the U-Net and the jointly trained wav2vec2:
    the loss within 1e-5 relative, the gradient of every parameter within
    1e-4 of its tensor's largest and the wav2vec2 gradients within 1e-4 in
    relative L2 (float32, other summation orders); then ``train_step``
    moves the encoder's weights, which sit in the same Adam and EMA."""
    state = _port_diffusion_state(jax_diffusion["params"])
    cfg = state.model.cfg
    prep = ttd.prepare_batch(jax_diffusion["batch"], cfg, "cpu")
    t, noise = ttd.draw_t_noise(state, prep["target"], cfg.num_timesteps, jax_diffusion["t"],
                                jax_diffusion["noise"])
    loss = ttd.noise_mse(state.model(state.scheduler.add_noise(prep["target"], noise, t),
                                     prep["cond"], prep["audio"], t), noise)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_diffusion["loss"], rtol=1e-5)
    want = convert.unet_audio_state_dict_from_flax(jax_diffusion["grads"], cfg)
    got = {k: p.grad for k, p in state.model.named_parameters()}
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-8)
        assert float((got[k] - w).abs().max()) <= 1e-4 * scale + 1e-7, k
    enc = [k for k in want if k.startswith("audio_encoder.")]
    g = torch.cat([got[k].flatten() for k in enc])
    w = torch.cat([want[k].flatten() for k in enc])
    assert float((g - w).norm() / w.norm()) <= 1e-4
    before = {k: v.clone() for k, v in state.model.audio_encoder.state_dict().items()}
    ttd.train_step(state, jax_diffusion["batch"], cfg, t=jax_diffusion["t"],
                   noise=jax_diffusion["noise"])
    after = state.model.audio_encoder.state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in before)
    ema = dict(state.ema.named_parameters())
    assert all(not torch.equal(ema[f"audio_encoder.{k}"], after[k]) for k in
               ("proj.weight", "conv_0.weight"))


def test_create_state_grafts_a_ported_encoder(tmp_path):
    """``create_state(wav2vec2_checkpoint=...)`` puts the artifact's weights
    into the audio encoder (the rest from the seed); a config whose encoder
    does not fit raises."""
    selftest.make_wav2vec2_selftest_pth(str(tmp_path / "w.pth"), seed=6)
    ports.port_wav2vec2(str(tmp_path / "w.pth"), str(tmp_path / "w2v"), num_heads=4)
    w2v, w2v_cfg = ports.load_wav2vec2_params(str(tmp_path / "w2v"))
    cfg = ports.diffusion_cfg_with_wav2vec2(TCfg(**dict(DIFF, audio_encoder="native")), w2v_cfg)
    assert cfg == TCfg(**DIFF)
    state = ttd.create_state(cfg, seed=2, device="cpu", wav2vec2_checkpoint=str(tmp_path / "w2v"))
    enc = state.model.audio_encoder.state_dict()
    assert all(torch.equal(enc[k], w2v[k]) for k in w2v)
    plain = ttd.create_state(cfg, seed=2, device="cpu").model.state_dict()
    assert torch.equal(state.model.state_dict()["im_cond_conv.weight"], plain["im_cond_conv.weight"])
    with pytest.raises(ValueError, match="port mismatch"):
        ttd.create_state(dataclasses.replace(cfg, w2v_num_layers=1), device="cpu",
                         wav2vec2_checkpoint=str(tmp_path / "w2v"))
