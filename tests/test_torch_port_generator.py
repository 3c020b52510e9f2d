"""The port's talking-face generator and its conv blocks against the Flax
modules, on the same params through ``models.convert`` and the same numpy
inputs, float32. Tolerances: 1e-4 for the float forward (summation order
through up to 20 convs and GroupNorms); the int8 paths are compared by mean
|Δ| and PSNR, because a one-ulp difference before ``round`` flips a
quantised value by a whole step and the flips compound through 51 layers.

The Flax generator (width 0.25, 96×96: the encoder's strides need that
size) is built once for the module.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lipreading_video_generation_tpu.models import layers as jl
from lipreading_video_generation_tpu.models.generator import TalkingFaceGenerator as JGen
from lipreading_video_generation_tpu.ops import quant as jq
from lipreading_video_generation_tpu_torch.models import convert
from lipreading_video_generation_tpu_torch.models import layers as tl
from lipreading_video_generation_tpu_torch.models.generator import (
    TalkingFaceGenerator as TGen, skip_channels)
from lipreading_video_generation_tpu_torch.ops import quant as tq

WIDTH = 0.25


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _perturbed(params, seed):
    """numpy params, each moved a little so that no scale is exactly 1 and
    no bias exactly 0."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32), params)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _block_sd(p):
    """A Flax ConvBlock's params → the port's ConvBlock entries."""
    sd = {}
    convert._conv(sd, "conv", p["Conv_0"])
    convert._norm(sd, "norm", p["GroupNorm_0"])
    return sd


def _psnr(a, b):
    return 10.0 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-12))


@pytest.mark.parametrize("ch,width,want", [(16, 1.0, 16), (512, 0.25, 128), (16, 0.25, 8),
                                           (384, 0.125, 48), (32, 0.0625, 8), (96, 0.3, 32)])
def test_scale_channels_and_time_folding(ch, width, want):
    assert tl.scale_channels(ch, width) == jl.scale_channels(ch, width) == want
    x = torch.arange(2 * 3 * 4 * 5).reshape(2, 3, 4, 5)
    folded, b = tl.fold_time(x)
    assert folded.shape == (6, 4, 5) and b == 2
    assert torch.equal(tl.unfold_time(folded, b), x)


@pytest.mark.parametrize("kernel,stride,padding,act,residual", [
    (3, 1, 1, "relu", False), (7, 1, 3, "relu", False), (3, (3, 1), 1, "leaky", False),
    (3, 2, 1, "silu", False), (1, 1, 0, "none", False), (3, 1, 1, "relu", True)])
def test_conv_block_matches_flax(kernel, stride, padding, act, residual):
    x = _rand((2, 12, 9, 8), 0)
    jm = jl.ConvBlock(8 if residual else 12, kernel, stride, padding, act=act, residual=residual)
    params = _perturbed(jm.init(jax.random.key(0), x)["params"], 1)
    want = np.asarray(jm.apply({"params": params}, x))
    tm = tl.ConvBlock(8, 8 if residual else 12, kernel, stride, padding, act=act,
                      residual=residual).eval()
    tm.load_state_dict(_block_sd(params))
    with torch.no_grad():
        got = tm(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_conv_block_without_norm_and_bad_names():
    x = _rand((1, 6, 6, 4), 2)
    jm = jl.ConvBlock(5, norm="none")
    params = _perturbed(jm.init(jax.random.key(0), x)["params"], 3)
    tm = tl.ConvBlock(4, 5, norm="none").eval()
    sd = {}
    convert._conv(sd, "conv", params["Conv_0"])
    tm.load_state_dict(sd)
    with torch.no_grad():
        got = tm(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply({"params": params}, x)),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="norm"):
        tl.ConvBlock(4, 5, norm="batch")
    with pytest.raises(ValueError, match="act"):
        tl.ConvBlock(4, 5, act="gelu")


def test_res_conv_block_matches_flax():
    x = _rand((2, 7, 6, 16), 4)
    jm = jl.ResConvBlock(16)
    params = _perturbed(jm.init(jax.random.key(0), x)["params"], 5)
    tm = tl.ResConvBlock(16).eval()
    tm.load_state_dict({f"block.{k}": v for k, v in _block_sd(params["ConvBlock_0"]).items()})
    with torch.no_grad():
        got = tm(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply({"params": params}, x)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hw,target", [((1, 1), (3, 3)), ((3, 3), (6, 6)), ((6, 6), (12, 12)),
                                       ((4, 5), (10, 8)), ((5, 5), (5, 5))])
def test_upsample_conv_matches_flax(hw, target):
    """Nearest resize by JAX's index rule floor((i + 0.5)·in/out), at the
    decoder's integer factors and at a ragged one, then the conv block."""
    x = _rand((2,) + hw + (8,), 6)
    want_resized = np.asarray(jax.image.resize(x, (2,) + target + (8,), method="nearest"))
    got_resized = tl.resize_nearest(_nchw(x), target).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got_resized, want_resized)
    jm = jl.UpsampleConv(12, target)
    params = _perturbed(jm.init(jax.random.key(0), x)["params"], 7)
    tm = tl.UpsampleConv(8, 12, target).eval()
    tm.load_state_dict({f"block.{k}": v for k, v in _block_sd(params["ConvBlock_0"]).items()})
    with torch.no_grad():
        got = tm(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply({"params": params}, x)),
                               rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def generators():
    """(Flax generator, its perturbed numpy params, the port's generator on
    the bridged params, mel, faces)."""
    mel, faces = _rand((2, 80, 16, 1), 8), np.random.default_rng(9).random(
        (2, 96, 96, 6)).astype(np.float32)
    jg = JGen(width=WIDTH)
    params = _perturbed(jg.init(jax.random.key(0), mel, faces)["params"], 10)
    tg = TGen(width=WIDTH).eval()
    tg.load_state_dict(convert.generator_state_dict_from_flax(params))
    return jg, params, tg, mel, faces


def test_generator_bridge_is_exact_and_strict(generators):
    _, params, tg, _, _ = generators
    sd = tg.state_dict()
    assert len(sd) == 4 * 50 + 2 and all(v.dtype == torch.float32 for v in sd.values())
    assert sum(isinstance(m, tl.Conv2d) for m in tg.modules()) == 51
    k = params["FaceEncoder_0"]["ConvBlock_0"]["Conv_0"]["kernel"]          # HWIO → OIHW
    np.testing.assert_array_equal(sd["face.layers.0.conv.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["decoder.layers.1.block.norm.weight"].numpy(),
        params["FaceDecoder_0"]["UpsampleConv_0"]["ConvBlock_0"]["GroupNorm_0"]["scale"])
    assert skip_channels(WIDTH) == [8, 8, 16, 32, 64, 128, 128]
    broken = dict(params, FaceDecoder_0={k: v for k, v in params["FaceDecoder_0"].items()
                                         if k != "ResConvBlock_3"})
    with pytest.raises(KeyError, match="ResConvBlock_3"):
        convert.generator_state_dict_from_flax(broken)
    with pytest.raises(KeyError, match="unexpected"):
        convert.generator_state_dict_from_flax(dict(params, Extra={}))


def test_generator_float_forward_matches_flax(generators):
    jg, params, tg, mel, faces = generators
    want = np.asarray(jg.apply({"params": params}, mel, faces))
    with torch.no_grad():
        got = tg(torch.from_numpy(mel), torch.from_numpy(faces)).numpy()
    assert got.shape == want.shape == (2, 96, 96, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # (B, T, ...) windows fold into the batch and unfold again
    with torch.no_grad():
        folded = tg(torch.from_numpy(mel)[None], torch.from_numpy(faces)[None]).numpy()
    np.testing.assert_array_equal(folded, got[None])


def test_generator_quantized_apply_tracks_jax(generators):
    """Dynamic int8 on both sides, perturbed params: each path's PSNR
    against its own float output is above 28 dB and the two PSNRs are
    within 1.5 dB of each other (30.3 and 29.9 dB measured; on Flax's
    unperturbed init tests/test_quant.py holds JAX above 30 dB), and the two
    int8 outputs are as close to each other as either is to float (mean |Δ|
    < 0.03 in [0, 1]; 0.014 measured), not equal: the step function of
    ``round``."""
    jg, params, tg, mel, faces = generators
    jf = np.asarray(jg.apply({"params": params}, mel, faces))
    jq_out = np.asarray(jq.quantized_apply(jg, {"params": params}, mel, faces))
    with torch.no_grad():
        tf = tg(torch.from_numpy(mel), torch.from_numpy(faces)).numpy()
        tq_out = tq.quantized_apply(tg, torch.from_numpy(mel), torch.from_numpy(faces)).numpy()
    assert _psnr(jq_out, jf) > 28.0 and _psnr(tq_out, tf) > 28.0
    assert abs(_psnr(jq_out, jf) - _psnr(tq_out, tf)) < 1.5
    assert float(np.mean(np.abs(tq_out - jq_out))) < 0.03
    assert float(np.mean(np.abs(tq_out - tf))) < 0.03
    assert _psnr(tq_out, jq_out) > 28.0


def test_generator_calibration_matches_jax_through_the_name_map(generators):
    jg, params, tg, mel, faces = generators
    want = jq.calibrate_activation_scales(
        lambda m, x: jg.apply({"params": params}, m, x), [(mel, faces)])
    got = tq.calibrate_activation_scales(tg, [(torch.from_numpy(mel), torch.from_numpy(faces))])
    names = convert.generator_flax_module_names()
    assert len(got) == len(want) == len(names) == 51
    assert set(names) == set(want) and set(names.values()) == set(got)
    for jname, tname in names.items():
        assert got[tname] == pytest.approx(want[jname], rel=1e-5), jname
    # static int8 from those scales, on a fresh batch: the 28 dB bound of
    # tests/test_quant.py against float, and close to the dynamic mode
    mel2, faces2 = _rand((2, 80, 16, 1), 11), np.random.default_rng(12).random(
        (2, 96, 96, 6)).astype(np.float32)
    args = torch.from_numpy(mel2), torch.from_numpy(faces2)
    with torch.no_grad():
        f = tg(*args).numpy()
        static = tq.quantized_apply(tg, *args, act_scales=got).numpy()
        dynamic = tq.quantized_apply(tg, *args).numpy()
    assert _psnr(static, f) > 28.0
    assert float(np.mean(np.abs(static - dynamic))) < 0.05
    j_static = np.asarray(jq.quantized_apply(jg, {"params": params}, mel2, faces2,
                                             act_scales=want))
    assert float(np.mean(np.abs(static - j_static))) < 0.03
