"""The port's noisy-image classifier and classifier guidance against the JAX
package's, mirroring tests/test_classifier_guidance.py: the
``EncoderUNetModel`` bridge and forward, one training step's gradients,
``_guided_eps`` on the same ε, x_t and params, and the sampler's guidance
arguments; then the port's own classifier learning the synthetic task and
steering every sampler.

Tiny configuration: 16×16 images, base 8, channel_mult (1, 2), one res
block, attention at ds 1 (256 tokens: the flash path, so ∇ₓ runs the flash
backward; JAX's Pallas kernels in interpret mode) and ds 2 (64 tokens:
einsum), 2 heads, float32.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from lipreading_video_generation_tpu.core.config import ClassifierConfig as JCCfg
from lipreading_video_generation_tpu.core.config import DiffusionConfig as JDCfg
from lipreading_video_generation_tpu.models.schedulers import make_scheduler as jmake_scheduler
from lipreading_video_generation_tpu.pipelines import sample_diffusion as jsd
from lipreading_video_generation_tpu.pipelines import train_classifier as jtc
from lipreading_video_generation_tpu_torch.core.config import ClassifierConfig as TCCfg
from lipreading_video_generation_tpu_torch.core.config import DiffusionConfig as TDCfg
from lipreading_video_generation_tpu_torch.models import convert
from lipreading_video_generation_tpu_torch.models.schedulers import make_scheduler
from lipreading_video_generation_tpu_torch.models.unet_audio import UNetAudio
from lipreading_video_generation_tpu_torch.pipelines import sample_diffusion as tsd
from lipreading_video_generation_tpu_torch.pipelines import train_classifier as ttc
from lipreading_video_generation_tpu_torch.pipelines import train_diffusion as ttd

DCFG = dict(im_size=16, base_channels=8, channel_mult=(1, 2), num_res_blocks=1,
            attention_resolutions=(2,), num_heads=2, time_embed_dim=16,
            audio_embed_dim=16, audio_proj_dim=4, im_cond_channels=4,
            audio_samples=800, num_timesteps=10, dtype="float32")
CCFG = dict(num_classes=4, base_channels=8, channel_mult=(1, 2), num_res_blocks=1,
            attention_resolutions=(1, 2), num_heads=2, time_embed_dim=16,
            batch_size=32, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def clf():
    """Perturbed Flax classifier params and the port loaded with them."""
    jccfg = JCCfg(**CCFG)
    params = jtc.create_state(jccfg, JDCfg(**DCFG), jax.random.key(0)).params
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32), params)
    tccfg = TCCfg(**CCFG)
    model = ttc.make_classifier(tccfg).eval()
    model.load_state_dict(convert.encoder_unet_state_dict_from_flax(params, tccfg))
    return jccfg, tccfg, params, model


def test_classifier_bridge_and_forward_match_flax(clf):
    """Float32 logits; other summation orders in every layer: 1e-4."""
    jccfg, tccfg, params, model = clf
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
    t = np.array([0, 4, 9], np.int32)
    want = jtc.make_classifier(jccfg).apply({"params": params}, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = model(_nchw(x), torch.from_numpy(t).long())
    assert tuple(got.shape) == (3, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    with pytest.raises(KeyError, match="Dense_2"):
        convert.encoder_unet_state_dict_from_flax(
            {k: v for k, v in params.items() if k != "Dense_2"}, tccfg)


def test_classifier_step_gradients_match_jax(clf):
    """Cross-entropy, accuracy and every parameter's gradient of one
    ``train_step`` fed JAX's t and noise (Flax's gradient tree through the
    same bridge): float32, 1e-4 of each tensor's largest gradient."""
    jccfg, tccfg, params, _ = clf
    dcfg = JDCfg(**DCFG)
    batch = jtc.synthetic_batch(np.random.default_rng(3), dataclasses.replace(
        jccfg, batch_size=4), dcfg)
    rng = np.random.default_rng(4)
    t = np.array([0, 3, 6, 9], np.int32)
    noise = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    sched = jmake_scheduler(dcfg.scheduler, dcfg.num_timesteps, dcfg.beta_start, dcfg.beta_end)
    x0 = jnp.asarray(batch["image"], jnp.float32) / 255.0 * 2.0 - 1.0
    xt = sched.add_noise(x0, jnp.asarray(noise), jnp.asarray(t))

    def loss_fn(p):
        logits = jtc.make_classifier(jccfg).apply({"params": p}, xt, jnp.asarray(t))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(batch["label"])).mean(), logits

    (loss_j, logits_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(params)
    state = ttc.create_state(tccfg, TDCfg(**DCFG))
    state.model.load_state_dict(convert.encoder_unet_state_dict_from_flax(params, tccfg))
    sd0 = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    m = ttc.train_step(state, batch, tccfg, TDCfg(**DCFG), t, noise)
    np.testing.assert_allclose(m["loss"].item(), float(loss_j), rtol=1e-5)
    acc = float((np.argmax(np.asarray(logits_j), -1) == batch["label"]).mean())
    assert m["accuracy"].item() == acc and state.step == 1
    want = convert.encoder_unet_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, grads_j), tccfg)
    got = dict(state.model.named_parameters())
    assert set(got) == set(want)
    gmax = max(w.abs().max().item() for w in want.values())
    for name, w in want.items():   # exact zeros (biases under one-channel groups): noise
        atol = max(1e-4 * w.abs().max().item(), 1e-7 * gmax)
        np.testing.assert_allclose(got[name].grad.numpy(), w.numpy(), rtol=1e-3, atol=atol,
                                   err_msg=name)
        assert not torch.equal(got[name], sd0[name]) or w.abs().max() == 0, name  # Adam moved it


def test_guided_eps_matches_jax(clf):
    """ε − s·√(1−ᾱ_t)·∇ₓ Σ log p(y|x_t) on the same ε, x_t, t, labels and
    params: float32, the classifier's backward summed in other orders."""
    jccfg, tccfg, params, model = clf
    dcfg = JDCfg(**DCFG)
    rng = np.random.default_rng(5)
    eps = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    xt = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    tb = np.array([7, 2], np.int32)
    label = np.array([2, 1], np.int32)
    sched = jmake_scheduler(dcfg.scheduler, dcfg.num_timesteps, dcfg.beta_start, dcfg.beta_end)
    want = jsd._guided_eps(jnp.asarray(eps), jnp.asarray(xt), jnp.asarray(tb), sched, jccfg,
                           {"params": params, "label": jnp.asarray(label),
                            "scale": jnp.float32(100.0)})
    tsched = make_scheduler(dcfg.scheduler, dcfg.num_timesteps, dcfg.beta_start, dcfg.beta_end)
    got = tsd._guided_eps(_nchw(eps), _nchw(xt), torch.from_numpy(tb).long(), tsched, model,
                          torch.from_numpy(label).long(), 100.0)
    shift = np.abs(np.asarray(want) - eps).max()
    assert shift > 1e-2   # the guidance term is not negligible
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4 * shift)


@pytest.fixture(scope="module")
def trained():
    """The port's classifier after 120 steps on the synthetic quadrant
    task, as tests/test_classifier_guidance.py trains JAX's."""
    ccfg, dcfg = TCCfg(**CCFG), TDCfg(**DCFG)
    rng = np.random.default_rng(0)
    return ttc.train(ccfg, dcfg, lambda: ttc.synthetic_batch(rng, ccfg, dcfg), num_steps=120,
                     log_every=0)


def test_classifier_learns_noisy_quadrants(trained):
    """At moderate noise (t = T//3) accuracy is well above chance (0.25)."""
    ccfg, dcfg = TCCfg(**CCFG), TDCfg(**DCFG)
    batch = ttc.synthetic_batch(np.random.default_rng(1), ccfg, dcfg)
    x0 = _nchw(batch["image"]) / 255.0 * 2.0 - 1.0
    t = torch.full((x0.shape[0],), dcfg.num_timesteps // 3, dtype=torch.long)
    xt = trained.scheduler.add_noise(x0, torch.randn(x0.shape, generator=torch.Generator()
                                                     .manual_seed(2)), t)
    with torch.no_grad():
        logits = trained.model.eval()(xt, t)
    acc = (logits.argmax(-1).numpy() == batch["label"]).mean()
    assert acc > 0.6, acc


@pytest.mark.parametrize("sampler_kw", [
    {},                                              # full DDPM chain
    {"num_inference_steps": 5},                      # DDIM few-step
    {"num_inference_steps": 5, "sampler": "dpmpp"},  # DPM-Solver++(2M)
])
def test_guidance_steers_all_samplers(trained, sampler_kw):
    """Guided samples score higher under the classifier than unguided ones
    from the same draws, for every sampler."""
    ccfg, dcfg = TCCfg(**CCFG), TDCfg(**DCFG)
    model = ttd.seeded(lambda: UNetAudio(dcfg), 3).eval()
    rng = np.random.default_rng(4)
    cond = rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    audio = rng.standard_normal((2, 800)).astype(np.float32)
    params = trained.model.state_dict()
    x_plain, _ = tsd.sample(model, cond, audio, dcfg,
                            generator=torch.Generator().manual_seed(5), **sampler_kw)
    x_guided, _ = tsd.sample(model, cond, audio, dcfg, classifier_cfg=ccfg,
                             classifier_params=params, class_label=2, guidance_scale=10.0,
                             generator=torch.Generator().manual_seed(5), **sampler_kw)
    clf = ttc.load_classifier(ccfg, params, "cpu")
    with torch.no_grad():
        def logp(x01):
            xs = x01.permute(0, 3, 1, 2) * 2.0 - 1.0
            return torch.log_softmax(clf(xs, torch.zeros(2, dtype=torch.long)), -1)[:, 2]

        assert (logp(x_guided) > logp(x_plain)).all()
    clip = tsd.sample_video(model, cond[0], audio, dcfg, num_inference_steps=4,
                            classifier_cfg=ccfg, classifier_params=params, class_label=1,
                            guidance_scale=5.0, generator=torch.Generator().manual_seed(6))
    assert tuple(clip.shape) == (2, 16, 16, 3) and clip.dtype == torch.uint8


def test_classifier_checkpoint_round_trip(tmp_path, trained):
    ttc.save_classifier(str(tmp_path / "clf.pt"), trained)
    loaded = ttc.load_classifier_params(str(tmp_path / "clf.pt"))
    want = trained.model.state_dict()
    assert set(loaded) == set(want) and all(torch.equal(loaded[n], want[n]) for n in want)


def test_guidance_arguments_validated_as_in_jax(trained):
    ccfg, dcfg = TCCfg(**CCFG), TDCfg(**DCFG)
    model = ttd.seeded(lambda: UNetAudio(dcfg), 3).eval()
    cond, audio = np.zeros((1, 16, 16, 3), np.uint8), np.zeros((1, 800), np.float32)
    params = trained.model.state_dict()
    with pytest.raises(ValueError, match="class_label"):
        tsd.sample(model, cond, audio, dcfg, classifier_cfg=ccfg, classifier_params=params)
    with pytest.raises(ValueError, match="both"):
        tsd.sample(model, cond, audio, dcfg, classifier_cfg=ccfg)
    with pytest.raises(ValueError, match="out of range"):
        tsd.sample(model, cond, audio, dcfg, classifier_cfg=ccfg, classifier_params=params,
                   class_label=4)
    with pytest.raises(ValueError, match="at most 4 classes"):
        ttc.synthetic_batch(np.random.default_rng(0), dataclasses.replace(ccfg, num_classes=5),
                            dcfg)
