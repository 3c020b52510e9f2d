"""The port's lip-sync serving slice against the JAX package: the image and
audio helpers (1e-5), ``paste_back`` and ``gen_input_prep`` (1e-5 / 1e-4),
``generate_frames`` as a whole in float, dynamic int8 and static int8, and
the ViViT ``predict_step`` / ``predict_step_int8``. Same numpy inputs on both
sides, weights bridged from one Flax init per module (generator width
0.125, as tests/test_inference.py).

Bounds for the whole slice: float uint8 frames within 1 gray level of JAX's
(a value at a rounding tie may fall either way); int8 frames are compared by
mean |Δ| — both sides quantise activations that differ in the last float32
bit, a flipped ``round`` is a whole step, and the flips compound through 51
layers — below 6 levels to JAX's int8 frames (3.7 dynamic and 2.4 static
measured) and below 8 levels to the float path (the bound of
tests/test_inference.py; 2.8 and 2.6 measured).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lipreading_video_generation_tpu.core.config import (
    AudioConfig as JAudioCfg, GanConfig as JGanCfg, PreprocessConfig as JPreCfg,
    ViViTConfig as JViViTCfg)
from lipreading_video_generation_tpu.models.generator import TalkingFaceGenerator as JGen
from lipreading_video_generation_tpu.ops import audio as jaudio
from lipreading_video_generation_tpu.ops import image as jimage
from lipreading_video_generation_tpu.pipelines import inference as jinf
from lipreading_video_generation_tpu.pipelines import train_vivit as jtv
from lipreading_video_generation_tpu_torch.core import config as tcfg
from lipreading_video_generation_tpu_torch.models import convert
from lipreading_video_generation_tpu_torch.models.vivit import ViViT
from lipreading_video_generation_tpu_torch.ops import audio as taudio
from lipreading_video_generation_tpu_torch.ops import image as timage
from lipreading_video_generation_tpu_torch.ops import matmul_cuda as tmm
from lipreading_video_generation_tpu_torch.pipelines import inference as tinf
from lipreading_video_generation_tpu_torch.pipelines import train_vivit as ttv

WIDTH = 0.125
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def test_gan_config_matches_jax():
    assert dataclasses.asdict(tcfg.GanConfig()) == dataclasses.asdict(JGanCfg())
    assert tcfg.PreprocessConfig().gen_batch_size == JPreCfg().gen_batch_size == 128


def test_mask_lower_half_and_concat_reference_match_jax():
    x = _rand((2, 3, 7, 6, 3), 0)
    got = timage.mask_lower_half(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jimage.mask_lower_half(x)))
    assert got[..., 3:, :, :].abs().max() == 0 and torch.equal(got[..., :3, :, :],
                                                               torch.from_numpy(x)[..., :3, :, :])
    cat = timage.concat_reference(got, torch.from_numpy(x))
    np.testing.assert_array_equal(cat.numpy(), np.asarray(
        jimage.concat_reference(jimage.mask_lower_half(x), x)))


def test_bilinear_sample_matches_jax():
    img = _rand((9, 11, 3), 1)
    ys = np.array([-1.5, -0.25, 0.0, 3.3, 7.99, 8.0, 8.6, 12.0], np.float32)
    xs = np.array([-0.7, 0.5, 4.25, 10.0, 10.4, 11.2], np.float32)
    want = np.asarray(jimage._bilinear_sample(jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs)))
    got = timage._bilinear_sample(torch.from_numpy(img), torch.from_numpy(ys),
                                  torch.from_numpy(xs))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert got[0].abs().max() == 0 and got[-1].abs().max() == 0          # zero padding
    # batched: per-image coordinates
    imgs = _rand((2, 9, 11, 3), 2)
    ysb, xsb = np.stack([ys, ys + 0.5]), np.stack([xs, xs - 0.3])
    gotb = timage._bilinear_sample(torch.from_numpy(imgs), torch.from_numpy(ysb),
                                   torch.from_numpy(xsb))
    wantb = np.asarray(jax.vmap(jimage._bilinear_sample)(imgs, ysb, xsb))
    np.testing.assert_allclose(gotb.numpy(), wantb, **TOL)


@pytest.mark.parametrize("n,T", [(12, 5), (5, 5), (3, 5), (1, 5), (7, 1)])
def test_smooth_boxes_matches_jax(n, T):
    boxes = _rand((n, 4), 3, 20.0) + 50
    np.testing.assert_allclose(timage.smooth_boxes(torch.from_numpy(boxes), T).numpy(),
                               np.asarray(jimage.smooth_boxes(jnp.asarray(boxes), T)), **TOL)


def test_mel_windows_match_jax():
    mel = _rand((80, 100), 4)
    starts = np.array([0, 1, 2, 5, 10, 24.0, 24.99, 25, 26.5, 30, 500], np.float32)
    want = np.asarray(jaudio.mel_windows(jnp.asarray(mel), jnp.asarray(starts)))
    got = taudio.mel_windows(torch.from_numpy(mel), torch.from_numpy(starts))
    assert got.shape == (len(starts), 80, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[-1].numpy(), mel[:, -16:])           # clipped to fit
    one = taudio.crop_mel_window(torch.from_numpy(mel), 7, fps=30.0)
    np.testing.assert_array_equal(one.numpy(), np.asarray(
        jaudio.crop_mel_window(jnp.asarray(mel), 7, fps=30.0)))
    chunks = tinf._mel_chunks(torch.from_numpy(mel), 9, 25.0, tcfg.AudioConfig())
    np.testing.assert_array_equal(chunks.numpy(), np.asarray(
        jinf._mel_chunks(jnp.asarray(mel), 9, 25.0, JAudioCfg())))


def _request(n, h, w, seed):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    boxes = (np.tile(np.asarray([8.0, h - 8.0, 8.0, w - 12.0], np.float32), (n, 1))
             + rng.uniform(-3, 3, (n, 4))).astype(np.float32)
    mels = rng.standard_normal((n, 80, 16)).astype(np.float32)
    return frames, boxes, mels


def test_paste_back_matches_jax():
    frames, boxes, _ = _request(3, 40, 48, 5)
    boxes[2] = [35.0, 60.0, -4.0, 20.5]                     # partly outside the frame
    roi = np.random.default_rng(6).random((3, 16, 16, 3)).astype(np.float32) * 255
    want = np.asarray(jax.vmap(jinf.paste_back)(
        jnp.asarray(frames, jnp.float32), jnp.asarray(roi), jnp.asarray(boxes)))
    got = tinf.paste_back(torch.from_numpy(frames).float(), torch.from_numpy(roi),
                          torch.from_numpy(boxes))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)   # of 255 levels
    outside = np.ones((40, 48), bool)
    y1, y2, x1, x2 = boxes[0]
    outside[int(np.ceil(y1)):int(np.ceil(y2)), int(np.ceil(x1)):int(np.ceil(x2))] = False
    np.testing.assert_array_equal(got[0].numpy()[outside], frames[0].astype(np.float32)[outside])
    single = tinf.paste_back(torch.from_numpy(frames[1]).float(), torch.from_numpy(roi[1]),
                             torch.from_numpy(boxes[1]))
    assert torch.equal(single, got[1])


def test_gen_input_prep_matches_jax():
    frames, boxes, _ = _request(3, 40, 48, 7)
    want = np.asarray(jinf.gen_input_prep(jnp.asarray(frames, jnp.float32),
                                          jnp.asarray(boxes), 24))
    got = tinf.gen_input_prep(torch.from_numpy(frames).float(), torch.from_numpy(boxes), 24)
    assert got.shape == (3, 24, 24, 6)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert got[:, 12:, :, :3].abs().max() == 0              # masked lower half


@pytest.fixture(scope="module")
def tiny_generator():
    gen = JGen(width=WIDTH)
    params = gen.init(jax.random.key(0), jnp.zeros((1, 80, 16, 1)),
                      jnp.zeros((1, 96, 96, 6)))["params"]
    sd = convert.generator_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    return params, sd


@pytest.fixture(scope="module")
def float_frames(tiny_generator):
    """The float request on both sides: 6 frames in batches of 4 (so one
    batch is short; JAX pads it), non-square frames."""
    params, sd = tiny_generator
    frames, boxes, mels = _request(6, 64, 72, 8)
    want = jinf.generate_frames(params, frames, boxes, mels, JGanCfg(model_width=WIDTH),
                                JPreCfg(gen_batch_size=4), model_width=WIDTH)
    got = tinf.generate_frames(sd, frames, boxes, mels, tcfg.GanConfig(model_width=WIDTH),
                               tcfg.PreprocessConfig(gen_batch_size=4), model_width=WIDTH,
                               device="cpu")
    return want, got


def test_generate_frames_float_matches_jax(float_frames):
    want, got = float_frames
    frames = _request(6, 64, 72, 8)[0]
    assert got.shape == want.shape == (6, 64, 72, 3) and got.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.01
    assert (got != frames).mean() > 0.3                         # faces were pasted in
    np.testing.assert_array_equal(got[:, :4], frames[:, :4])    # outside every box


@pytest.mark.parametrize("static", [False, True])
def test_generate_frames_int8_tracks_jax(tiny_generator, float_frames, static):
    params, sd = tiny_generator
    frames, boxes, mels = _request(6, 64, 72, 8)
    kw = dict(model_width=WIDTH, serve_int8=True, serve_int8_static=static)
    want = jinf.generate_frames(params, frames, boxes, mels, JGanCfg(**kw),
                                JPreCfg(gen_batch_size=4), model_width=WIDTH)
    before = tmm.int8_matmul.launch_count
    got = tinf.generate_frames(sd, frames, boxes, mels, tcfg.GanConfig(**kw),
                               tcfg.PreprocessConfig(gen_batch_size=4), model_width=WIDTH,
                               device="cpu")
    assert tmm.int8_matmul.launch_count == before               # plain version on the CPU
    assert got.shape == want.shape and got.dtype == np.uint8
    to_jax = np.abs(got.astype(np.float32) - want.astype(np.float32)).mean()
    to_float = np.abs(got.astype(np.float32) - float_frames[1].astype(np.float32)).mean()
    assert to_jax < 6.0, to_jax
    assert 0 < to_float < 8.0, to_float
    np.testing.assert_array_equal(got[:, :4], frames[:, :4])


def test_generate_frames_edges(tiny_generator):
    _, sd = tiny_generator
    frames, boxes, mels = _request(2, 32, 32, 9)
    empty = tinf.generate_frames(sd, frames[:0], boxes[:0], mels[:0], model_width=WIDTH,
                                 device="cpu")
    assert empty.shape == (0, 32, 32, 3) and empty.dtype == np.uint8
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        tinf.generate_frames(sd, frames, boxes, mels, model_width=WIDTH, mesh_spec=object(),
                             device="cpu")
    with pytest.raises(RuntimeError, match="size mismatch"):
        tinf.generate_frames(sd, frames, boxes, mels, model_width=0.25, device="cpu")


VIVIT = dict(num_classes=8, hidden_size=32, num_layers=2, num_heads=2, mlp_dim=64,
             dtype="float32")


@pytest.fixture(scope="module")
def vivits():
    jstate = jtv.create_state(JViViTCfg(**VIVIT), jax.random.key(0))
    model = ViViT(tcfg.ViViTConfig(**VIVIT)).eval()
    model.load_state_dict(convert.vivit_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jstate.params)))
    clips = np.random.default_rng(10).integers(0, 256, (16, 5, 32, 32, 1), dtype=np.uint8)
    return jstate, model, clips


def test_predict_step_matches_jax(vivits):
    jstate, model, clips = vivits
    want = np.asarray(jtv.predict_step(jstate, jnp.asarray(clips)))
    got = ttv.predict_step(model, torch.from_numpy(clips))
    assert got.shape == (16, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.exp().sum(-1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(ttv.preprocess_clips(torch.from_numpy(clips)).numpy(),
                               np.asarray(jtv.preprocess_clips(jnp.asarray(clips))), **TOL)


def test_predict_step_int8_tracks_jax(vivits):
    """11 Linears in int8 on both sides. The bounds of tests/test_quant.py
    against the float path (top-1 agreement ≥ 0.9, max |Δ log-prob| < 0.25),
    and the two int8 outputs within 0.05 of each other (the integers agree
    until a float32 last-bit difference flips one)."""
    jstate, model, clips = vivits
    want = np.asarray(jtv.predict_step_int8(jstate, jnp.asarray(clips)))
    f = ttv.predict_step(model, torch.from_numpy(clips)).numpy()
    before = tmm.int8_matmul.launch_count
    got = ttv.predict_step_int8(model, torch.from_numpy(clips)).numpy()
    assert tmm.int8_matmul.launch_count == before
    assert not np.allclose(got, f)
    assert np.mean(np.argmax(got, -1) == np.argmax(f, -1)) >= 0.9
    assert np.abs(got - f).max() < 0.25
    assert np.abs(got - want).max() < 0.05
