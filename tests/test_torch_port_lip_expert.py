"""The port's lip expert against the JAX package: AV-HuBERT's video
transform, the conformer encoder and the character seq2seq expert
(``models/lip_expert``), ``train_lip_expert.train_step``, and a GAN step
with the lip-expert loss (``lip_weight`` > 0) for both expert kinds.

Sizes: the expert at embed 32, one encoder and one decoder layer, 4 heads,
stem base 4, 48 characters; AV-HuBERT at ResNet base 4, one layer, 64 wide;
the GAN at width 0.25, batch 2, float32, on both sides from JAX's eager
``prepare_batch`` (as ``test_torch_port_gan_train.py`` runs it, for the
same 80/25 reason). The token-dropout mask is JAX's draw, passed to the
port. Weights: Flax trees from seeded numpy, bridged by ``models.convert``.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from lipreading_video_generation_tpu.core.config import AudioConfig as JAudioCfg
from lipreading_video_generation_tpu.core.config import GanConfig as JGanCfg
from lipreading_video_generation_tpu.models import avhubert as javh
from lipreading_video_generation_tpu.models import lip_expert as jle
from lipreading_video_generation_tpu.models.discriminator import Discriminator as JDisc
from lipreading_video_generation_tpu.models.generator import TalkingFaceGenerator as JGen
from lipreading_video_generation_tpu.models.syncnet import SyncNet as JSync
from lipreading_video_generation_tpu.ops import image as jimage
from lipreading_video_generation_tpu.pipelines import train_gan as jtg
from lipreading_video_generation_tpu.pipelines import train_lip_expert as jtle
from lipreading_video_generation_tpu_torch.core.config import GanConfig
from lipreading_video_generation_tpu_torch.data import datasets as tdata
from lipreading_video_generation_tpu_torch.models import avhubert as tavh
from lipreading_video_generation_tpu_torch.models import convert
from lipreading_video_generation_tpu_torch.models import lip_expert as tle
from lipreading_video_generation_tpu_torch.ops import image as timage
from lipreading_video_generation_tpu_torch.pipelines import train_gan as ttg
from lipreading_video_generation_tpu_torch.pipelines import train_lip_expert as ttle

SIZES = dict(embed_dim=32, enc_layers=1, dec_layers=1, num_heads=4, stem_base=4)
AVH = dict(embed_dim=64, num_layers=1, num_heads=4, ffn_dim=128, resnet_base=4,
           pos_conv_kernel=16, pos_conv_groups=4)
GAN = dict(model_width=0.25, batch_size=2, dtype="float32", lip_weight=0.5)
CFG, JCFG = GanConfig(**GAN), JGanCfg(**GAN)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


def _flax_tree(module, seed, *inputs):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.key(0), *inputs)["params"]

    def fill(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if name.endswith("['kernel']"):
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name.endswith("['scale']"):
            v = 1.0 + 0.05 * rng.standard_normal(shape)
        elif name.endswith("['alpha']"):
            v = 0.25 + 0.05 * rng.standard_normal(shape)
        elif name.endswith("['embedding']"):
            v = rng.standard_normal(shape) / np.sqrt(shape[-1])
        else:
            v = 0.05 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _expert_params(seed=0):
    return _flax_tree(jtle.default_expert(**SIZES), seed, jnp.zeros((1, 5, 88, 88, 1)),
                      jnp.zeros((1, 48), jnp.int32))


def _port_expert(params):
    model = ttle.default_expert(**SIZES)
    model.load_state_dict(convert.lip_expert_state_dict_from_flax(params))
    return model


@pytest.fixture(scope="module")
def word_batch():
    clips = tdata.synthetic_word_av_clips(n_clips=4, frames=20)
    return tdata.GanWindowSampler(clips, 5, seed=1, with_text=True).sample_batch(2)


def test_video_transform_and_tokens_match_jax():
    """BGR-weighted gray, /255, center crop, normalisation: within 1e-6 of
    JAX on RGB and gray frames; transcripts encode and decode alike."""
    rgb = np.random.default_rng(0).integers(0, 256, (2, 3, 96, 100, 3)).astype(np.uint8)
    for x in (rgb, rgb[..., :1]):
        want = np.asarray(jle.avhubert_video_transform(jnp.asarray(x)))
        got = tle.avhubert_video_transform(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (2, 3, 88, 88, 1)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(timage.bgr_to_gray(torch.from_numpy(rgb)).numpy(),
                               np.asarray(jimage.bgr_to_gray(jnp.asarray(rgb))), atol=1e-4)
    assert np.array_equal(timage.center_crop(torch.from_numpy(rgb), (7, 9)).numpy(),
                          np.asarray(jimage.center_crop(jnp.asarray(rgb), (7, 9))))
    for text in ("Hello, world!", "it's " * 12):
        assert np.array_equal(tle.encode_transcript(text), jle.encode_transcript(text))
        assert tle.decode_tokens(tle.encode_transcript(text)) == jle.decode_tokens(
            jle.encode_transcript(text))


def test_encoder_logits_and_losses_match_flax(word_batch):
    """Conformer features, decoder logits, the seq2seq loss with JAX's
    token-dropout draw and without, and the feature-matching
    ``expert_loss``: float32, within 1e-5 (features), 1e-4 (logits) and
    1e-5 relative (losses)."""
    params = _expert_params()
    jm = jtle.default_expert(**SIZES)
    model = _port_expert(params)
    video = np.asarray(word_batch["window"], np.float32)
    tokens = word_batch["text_tokens"]
    feats = np.asarray(jm.apply({"params": params}, jle.avhubert_video_transform(video),
                                method="encode"))
    with torch.no_grad():
        got = model.encode(tle.avhubert_video_transform(torch.from_numpy(video))).numpy()
        np.testing.assert_allclose(got, feats, atol=1e-5, rtol=0)
        tokens_in = np.concatenate([np.ones((2, 1), np.int32), tokens[:, :-1]], axis=1)
        want = np.asarray(jm.apply({"params": params}, jle.avhubert_video_transform(video),
                                   jnp.asarray(tokens_in)))
        logits = model(tle.avhubert_video_transform(torch.from_numpy(video)),
                       torch.from_numpy(tokens_in)).numpy()
        np.testing.assert_allclose(logits, want, atol=1e-4, rtol=0)
        key = jax.random.key(7)
        keep = np.asarray(jax.random.bernoulli(key, 0.7, tokens.shape))
        for k, mask in ((key, keep), (None, None)):
            want = float(jle.seq2seq_expert_loss(jm, params, video, tokens, token_dropout_key=k))
            got = tle.seq2seq_expert_loss(model, torch.from_numpy(video), torch.from_numpy(tokens),
                                          keep=None if mask is None else torch.from_numpy(mask))
            np.testing.assert_allclose(got.item(), want, rtol=1e-5)
        other = video[::-1].copy()
        want = float(jle.expert_loss(jle.ConformerLipEncoder(32, 1, 4, 4), params["encoder"],
                                     video, other))
        got = tle.expert_loss(model.encoder, torch.from_numpy(video), torch.from_numpy(other))
        np.testing.assert_allclose(got.item(), want, rtol=1e-5)


def test_train_step_matches_jax(word_batch):
    """One Adam step of the expert from the same weights with the same
    token-dropout mask (JAX's draw from ``fold_in(key, step)``): the loss
    within 1e-5 relative, every gradient within 1e-4 of its tensor's
    largest, every parameter within 2·lr of JAX's after the step (Adam's
    first step is about lr·sign(g))."""
    params = _expert_params(1)
    key = jax.random.key(3)
    jstate = jtle.LipExpertTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                      opt_state=optax.adam(1e-4).init(params),
                                      tx=optax.adam(1e-4), model=jtle.default_expert(**SIZES))
    drop_key = jax.random.fold_in(key, 0)
    shape = word_batch["text_tokens"].shape
    keep = np.asarray(jax.random.bernoulli(drop_key, 0.7, shape))
    grads = jax.grad(lambda p: jle.seq2seq_expert_loss(
        jstate.model, p, word_batch["window"].astype(np.float32), word_batch["text_tokens"],
        token_dropout_key=drop_key))(params)
    jstate, jm = jtle.train_step(jstate, {k: jnp.asarray(v) for k, v in word_batch.items()}, key)

    state = ttle.create_state(device="cpu", **SIZES)
    state.model.load_state_dict(convert.lip_expert_state_dict_from_flax(params))
    m = ttle.train_step(state, word_batch, keep=torch.from_numpy(keep))
    assert state.step == 1
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    want_g = convert.lip_expert_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    for name, p in state.model.named_parameters():
        w = want_g[name]
        assert float((p.grad - w).abs().max()) <= 1e-4 * max(float(w.abs().max()), 1e-8), name
    want_p = convert.lip_expert_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jstate.params))
    got_p = state.model.state_dict()
    assert max(float((got_p[k] - want_p[k]).abs().max()) for k in want_p) <= 2e-4 * (1 + 1e-3)
    # the mask is drawn from the state's generator when none is given
    m2 = ttle.train_step(state, word_batch)
    assert state.step == 2 and np.isfinite(m2["loss"].item())
    assert ttle.token_keep_mask(state, (1000,)).float().mean().item() == pytest.approx(0.7, abs=0.06)


# --- the GAN step with the lip expert ---------------------------------------

@pytest.fixture(scope="module")
def gan_params():
    t = CFG.syncnet_T
    w = CFG.model_width
    return {
        "gen": _flax_tree(JGen(width=w), 0, jnp.zeros((1, t, 80, 16, 1)),
                          jnp.zeros((1, t, 96, 96, 6))),
        "disc": _flax_tree(JDisc(width=w), 1, jnp.zeros((1, t, 96, 96, 3))),
        "sync": _flax_tree(JSync(width=w), 2, jnp.zeros((1, 80, 16, 1)),
                           jnp.zeros((1, 48, 96, 3 * t))),
        "seq2seq": _expert_params(4),
        "avhubert": _flax_tree(javh.AVHubertVideoEncoder(**AVH), 5,
                               jnp.zeros((1, 5, 88, 88, 1))),
    }


@pytest.fixture(scope="module")
def gan_batch():
    clips = tdata.synthetic_av_clips(n_clips=3, frames=30, img=64, seed=0, with_text=True)
    return tdata.GanWindowSampler(clips, 5, seed=0, with_text=True).sample_batch(2)


def _eager_prep(batch):
    return jtg.prepare_batch({k: jnp.asarray(v) for k, v in batch.items()}, JCFG, JAudioCfg())


GEN_TX = optax.adam(JCFG.learning_rate, b1=JCFG.adam_b1, b2=JCFG.adam_b2)
DISC_TX = optax.adam(JCFG.disc_learning_rate, b1=JCFG.adam_b1, b2=JCFG.adam_b2)


@pytest.mark.parametrize("kind", ["seq2seq", "avhubert"])
def test_gan_step_with_lip_expert_matches_jax(gan_params, gan_batch, monkeypatch, kind):
    """A G+D step at ``lip_weight`` 0.5 with transcripts in the batch: the
    seq2seq expert's character cross-entropy, or AV-HuBERT's feature
    matching (which has no text decoder). Every loss term within 1e-5
    relative (1e-4 for the lip term: two float32 experts on random weights);
    the lip term's gradient with respect to the generated window within
    1e-4 in relative L2 (the expert's backward, K2's einsum VJP on the CPU);
    after the step G's and D's params within 2·lr of JAX's; the expert has
    no gradient and did not move."""
    prep = _eager_prep(gan_batch)
    jexpert = (jtle.default_expert(**SIZES) if kind == "seq2seq"
               else javh.AVHubertVideoEncoder(**AVH))
    jstate = jtg.GanTrainState(
        step=jnp.zeros((), jnp.int32), gen_params=gan_params["gen"],
        disc_params=gan_params["disc"], gen_opt=GEN_TX.init(gan_params["gen"]),
        disc_opt=DISC_TX.init(gan_params["disc"]), syncnet_params=gan_params["sync"],
        syncnet_wt=jnp.zeros((), jnp.float32), lip_expert_params=gan_params[kind],
        gen_tx=GEN_TX, disc_tx=DISC_TX, lip_expert_model=jexpert)
    monkeypatch.setattr(jtg, "prepare_batch", lambda b, cfg, audio_cfg: b)
    jbatch = dict(prep, text_tokens=jnp.asarray(gan_batch["text_tokens"]))
    jstate2, jm = jax.jit(jtg._gan_train_step_impl, static_argnames=("cfg", "audio_cfg"))(
        jstate, jbatch, jax.random.key(0), cfg=JCFG)

    if kind == "seq2seq":
        expert = ttle.default_expert(**SIZES)
        sd = convert.lip_expert_state_dict_from_flax(gan_params[kind])
    else:
        expert = tavh.AVHubertVideoEncoder(**AVH)
        sd = convert.avhubert_state_dict_from_flax(gan_params[kind])
    state = ttg.create_state(CFG, syncnet_params=convert.syncnet_state_dict_from_flax(
        gan_params["sync"]), device="cpu", lip_expert_params=sd, lip_expert_model=expert)
    state.gen.load_state_dict(convert.generator_state_dict_from_flax(gan_params["gen"]))
    state.disc.load_state_dict(convert.discriminator_state_dict_from_flax(gan_params["disc"]))
    tprep = {k: torch.from_numpy(np.array(v)) for k, v in prep.items()}
    monkeypatch.setattr(ttg, "prepare_batch", lambda b, cfg, audio_cfg, device: tprep)
    m = ttg.train_step(state, gan_batch, CFG)
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), atol=1e-7,
                                   rtol=1e-4 if k == "loss/lip" else 1e-5, err_msg=k)
    assert float(jm["loss/lip"]) > 0

    # the lip term's gradient with respect to the generated window
    g = np.asarray(jax.jit(lambda p: JGen(width=CFG.model_width).apply(
        {"params": p}, prep["indiv_mels"], prep["x"]))(gan_params["gen"]))

    def jlip(window):
        if kind == "seq2seq":
            return jle.seq2seq_expert_loss(jexpert, gan_params[kind], window * 255.0,
                                           jnp.asarray(gan_batch["text_tokens"]))
        feats = jexpert.apply({"params": gan_params[kind]},
                              jle.avhubert_video_transform(window * 255.0))
        target = jexpert.apply({"params": gan_params[kind]},
                               jle.avhubert_video_transform(prep["gt"] * 255.0))
        return jnp.mean((feats - jax.lax.stop_gradient(target)) ** 2)

    want = np.asarray(jax.grad(jlip)(jnp.asarray(g)))
    window = torch.from_numpy(g).requires_grad_()
    ttg.lip_loss(state.lip_expert, window, tprep["gt"], gan_batch["text_tokens"]).backward()
    got = window.grad.numpy()
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)

    for module, tree, lr in ((state.gen, jstate2.gen_params, CFG.learning_rate),
                             (state.disc, jstate2.disc_params, CFG.disc_learning_rate)):
        bridge = (convert.generator_state_dict_from_flax if module is state.gen
                  else convert.discriminator_state_dict_from_flax)
        want_p = bridge(jax.tree_util.tree_map(np.asarray, tree))
        got_p = module.state_dict()
        assert max(float((got_p[k] - want_p[k]).abs().max()) for k in want_p) <= 2 * lr * (1 + 1e-3)
    assert all(p.grad is None and not p.requires_grad for p in state.lip_expert.parameters())
    assert all(torch.equal(v, sd[k]) for k, v in state.lip_expert.state_dict().items())


def test_gan_step_without_text_uses_feature_matching(gan_params, gan_batch):
    """Without ``text_tokens`` the seq2seq expert scores by feature
    matching, as in JAX; the loss is ``lip_weight`` times that term."""
    expert = _port_expert(gan_params["seq2seq"])
    state = ttg.create_state(CFG, device="cpu", lip_expert_model=expert)
    g = torch.rand(2, 5, 96, 96, 3)
    gt = torch.rand(2, 5, 96, 96, 3)
    want = tle.expert_loss(expert, g * 255.0, gt * 255.0)
    assert torch.allclose(ttg.lip_loss(state.lip_expert, g, gt), want)
    batch = {k: v for k, v in gan_batch.items() if k != "text_tokens"}
    m = ttg.train_step(state, batch, dataclasses.replace(CFG, lip_weight=0.5))
    assert np.isfinite(m["loss/lip"].item()) and m["loss/lip"].item() > 0


def test_word_clips_aperture_and_envelope_correlation_match_jax():
    """``synthetic_word_av_clips`` (frames, waves, words) and
    ``mouth_aperture_proxy`` equal the JAX package's; the generator's proof
    ``aperture_envelope_correlation`` (its windows, references, RMS
    envelopes and pooled Pearson r) gives JAX's numbers for the same
    generated frames, within 1e-9."""
    from lipreading_video_generation_tpu.data import datasets as jdata
    from lipreading_video_generation_tpu.pipelines import expert_proof as jproof
    from lipreading_video_generation_tpu_torch.pipelines import expert_proof as tproof

    got, want = (d.synthetic_word_av_clips(n_clips=6, frames=24, img=48, n_words=3)
                 for d in (tdata, jdata))
    for g, w in zip(got, want):
        assert g.text == w.text and np.array_equal(g.frames, w.frames)
        assert np.array_equal(g.wav, w.wav)
    frames = got[0].frames.astype(np.float32) / 255.0
    np.testing.assert_array_equal(tdata.mouth_aperture_proxy(frames),
                                  jdata.mouth_aperture_proxy(frames))

    def gen(batch):          # "generated" frames: the reference window, darkened
        return np.asarray(batch["wrong_window"], np.float32) / 255.0 * 0.9

    cfg = GanConfig()
    t = tproof.aperture_envelope_correlation(gen, cfg, got, n_windows=8, seed=2)
    j = jproof.aperture_envelope_correlation(gen, JGanCfg(), want, n_windows=8, seed=2)
    assert set(t) == set(j) == {"r_generated", "r_ground_truth"}
    for k in j:
        assert abs(t[k] - j[k]) <= 1e-9, k
    assert t["r_ground_truth"] > 0.5
    wav = got[1].wav
    np.testing.assert_array_equal(tproof.frame_rms(wav, 30), jproof.frame_rms(wav, 30))
    with pytest.raises(ValueError, match="n_words"):
        tdata.synthetic_word_av_clips(n_words=7)


def test_train_val_split_matches_jax():
    """All but the last ``n_held_out`` clips, and those, as JAX's."""
    from lipreading_video_generation_tpu.pipelines import expert_proof as jproof
    from lipreading_video_generation_tpu_torch.pipelines import expert_proof as tproof

    clips = tdata.synthetic_gan_clips(n_clips=5, frames=8, img=16)
    for n in (1, 2, 4):
        got, want = tproof.train_val_split(clips, n), jproof.train_val_split(clips, n)
        assert [len(x) for x in got] == [5 - n, n]
        assert all(a is b for g, w in zip(got, want) for a, b in zip(g, w))
    assert tproof.train_val_split(clips)[1] == clips[-2:]
