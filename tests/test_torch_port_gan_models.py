"""The port's lip-sync GAN models, losses and data against the JAX package:
``Discriminator`` and ``SyncNet`` on weights from the Flax modules' own
init (perturbed, then bridged), ``stack_window_lower_half``, ``l2_normalize``,
every GAN loss with PSNR and SSIM, and the GAN side of ``data/datasets``,
all on the same numpy inputs.

Bounds: float32 forwards within 1e-5, bf16 within 2e-2 (both frameworks
round each conv output and the GroupNorm output to bf16, at other points of
their float32 sums). SyncNet runs at width 1.0, the ``GanConfig`` default:
at width 0.125 its last blocks normalise GroupNorm groups of two channels
at 1×1, which turns float32 rounding into ~1e-4 of the face embedding (JAX's
float32 embedding lies 9.9e-5 from a float64 evaluation there, the port's
1.4e-5), and bf16 rounding into ~0.2. Losses, PSNR and SSIM within 1e-5;
samplers and synthetic clips bit for bit.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lipreading_video_generation_tpu.data import datasets as jdata
from lipreading_video_generation_tpu.models import layers as jlayers
from lipreading_video_generation_tpu.models.discriminator import Discriminator as JDisc
from lipreading_video_generation_tpu.models.syncnet import SyncNet as JSync
from lipreading_video_generation_tpu.models.syncnet import stack_window_lower_half as jstack
from lipreading_video_generation_tpu.pipelines import losses as jlosses
from lipreading_video_generation_tpu_torch.data import datasets as tdata
from lipreading_video_generation_tpu_torch.data import video as tvideo
from lipreading_video_generation_tpu_torch.models import convert
from lipreading_video_generation_tpu_torch.models import layers as tlayers
from lipreading_video_generation_tpu_torch.models.discriminator import Discriminator as TDisc
from lipreading_video_generation_tpu_torch.models.discriminator import lower_half
from lipreading_video_generation_tpu_torch.models.syncnet import SyncNet as TSync
from lipreading_video_generation_tpu_torch.models.syncnet import stack_window_lower_half as tstack
from lipreading_video_generation_tpu_torch.pipelines import losses as tlosses

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


def _perturbed(params, seed):
    """Flax init leaves GroupNorm at (1, 0) and biases at 0, where a swapped
    mapping would not show: add seeded numpy noise to every leaf."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32), params)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    faces = rng.uniform(0, 1, (2, 5, 96, 96, 3)).astype(np.float32)
    mel = rng.standard_normal((2, 80, 16, 1)).astype(np.float32)
    return faces, mel


@pytest.fixture(scope="module")
def disc_params(inputs):
    init = jax.jit(JDisc(width=0.125).init)
    return _perturbed(init(jax.random.key(0), jnp.asarray(inputs[0]))["params"], 1)


@pytest.fixture(scope="module")
def sync_params(inputs):
    faces, mel = inputs
    init = jax.jit(JSync(width=1.0).init)
    return _perturbed(init(jax.random.key(1), jnp.asarray(mel),
                           jstack(jnp.asarray(faces)))["params"], 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_discriminator_matches_flax(inputs, disc_params, dtype):
    """Windows (B, T, 96, 96, 3) and single frames (B, 96, 96, 3) → one real
    probability per folded frame, float32, at width 0.125."""
    faces = inputs[0]
    jd = JDisc(width=0.125, dtype=jnp.dtype(dtype))
    model = TDisc(width=0.125, dtype=getattr(torch, dtype)).eval()
    model.load_state_dict(convert.discriminator_state_dict_from_flax(disc_params))
    for x in (faces, faces[:, 0]):
        want = np.asarray(jax.jit(jd.apply)({"params": disc_params}, jnp.asarray(x)))
        with torch.no_grad():
            got = model(torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == want.shape == (
            x.shape[0] * (x.shape[1] if x.ndim == 5 else 1), 1)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_syncnet_matches_flax(inputs, sync_params, dtype):
    """(audio, face) embeddings (B, 512), float32, of unit norm, at width 1.0."""
    faces, mel = inputs
    js = JSync(width=1.0, dtype=jnp.dtype(dtype))
    a, v = jax.jit(js.apply)({"params": sync_params}, jnp.asarray(mel), jstack(jnp.asarray(faces)))
    model = TSync(width=1.0, dtype=getattr(torch, dtype)).eval()
    model.load_state_dict(convert.syncnet_state_dict_from_flax(sync_params))
    with torch.no_grad():
        ta, tv = model(torch.from_numpy(mel), tstack(torch.from_numpy(faces)))
    for got, want in ((ta, a), (tv, v)):
        assert got.dtype == torch.float32 and got.shape == (2, 512)
        np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL[dtype])


def test_bridges_use_every_flax_leaf_once(disc_params, sync_params):
    """The state dicts cover the modules exactly; a missing or an extra Flax
    entry raises ``KeyError``."""
    for bridge, params, module in (
            (convert.discriminator_state_dict_from_flax, disc_params, TDisc(width=0.125)),
            (convert.syncnet_state_dict_from_flax, sync_params, TSync(width=1.0))):
        sd = bridge(params)
        assert set(sd) == set(module.state_dict())
        n_leaves = len(jax.tree_util.tree_leaves(params))
        assert len(sd) == n_leaves
        assert sum(t.numel() for t in sd.values()) == sum(
            np.size(a) for a in jax.tree_util.tree_leaves(params))
        first = sorted(params)[0]
        with pytest.raises(KeyError, match="missing"):
            bridge({k: v for k, v in params.items() if k != first})
        with pytest.raises(KeyError, match="unexpected"):
            bridge(dict(params, Extra_0={}))
        with pytest.raises(KeyError):
            bridge(dict(params, **{first: dict(params[first], Extra_0={})}))


def test_window_stacking_and_lower_half_are_bit_equal():
    rng = np.random.default_rng(3)
    for shape in ((2, 5, 96, 96, 3), (1, 3, 8, 6, 3)):
        w = rng.integers(0, 256, shape).astype(np.float32)
        got = tstack(torch.from_numpy(w)).numpy()
        want = np.asarray(jstack(jnp.asarray(w)))
        assert got.shape == want.shape and np.array_equal(got, want)
        # frame t's channel c lands at t·3 + c
        assert np.array_equal(got[..., 3 * 2 + 1], w[:, 2, shape[2] // 2:, :, 1])
    x = rng.standard_normal((2, 7, 5, 3)).astype(np.float32)
    assert np.array_equal(lower_half(torch.from_numpy(x)).numpy(), x[:, 3:])


def test_l2_normalize_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 17)).astype(np.float32)
    x[1] = 0.0      # eps inside the root keeps a zero row finite (and zero)
    got = tlayers.l2_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlayers.l2_normalize(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    assert np.all(got[1] == 0)


def _unit(rng, n, d):
    x = np.abs(rng.standard_normal((n, d))).astype(np.float32)   # post-ReLU embeddings
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_gan_losses_match_jax():
    """Every GAN loss on the same inputs, with probabilities at and beyond
    the 1e-7 clip (a saturated D) and identical embeddings (sim 1 → the
    clip)."""
    rng = np.random.default_rng(5)
    pred = rng.uniform(0, 1, (10, 1)).astype(np.float32)
    pred[:3, 0] = [0.0, 1.0, 1e-9]
    target = (rng.uniform(0, 1, (10, 1)) > 0.5).astype(np.float32)
    a, v = _unit(rng, 6, 32), _unit(rng, 6, 32)
    v[0] = a[0]
    y = (rng.uniform(0, 1, 6) > 0.5).astype(np.float32)
    g, gt = rng.uniform(0, 1, (2, 5, 24, 24, 3)).astype(np.float32), rng.uniform(
        0, 1, (2, 5, 24, 24, 3)).astype(np.float32)
    T, J = torch.from_numpy, jnp.asarray
    pairs = [
        (tlosses.bce(T(pred), T(target)), jlosses.bce(J(pred), J(target))),
        (tlosses.l1(T(g), T(gt)), jlosses.l1(J(g), J(gt))),
        (tlosses.cosine_bce_sync_loss(T(a), T(v)), jlosses.cosine_bce_sync_loss(J(a), J(v))),
        (tlosses.syncnet_contrastive_loss(T(a), T(v), T(y)),
         jlosses.syncnet_contrastive_loss(J(a), J(v), J(y))),
        (tlosses.perceptual_adversarial_loss(T(pred)),
         jlosses.perceptual_adversarial_loss(J(pred))),
        *zip(tlosses.discriminator_loss(T(pred), T(pred[::-1].copy())),
             jlosses.discriminator_loss(J(pred), J(pred[::-1].copy()))),
        (tlosses.psnr(T(g), T(gt)), jlosses.psnr(J(g), J(gt))),
        (tlosses.psnr(T(g), T(g)), jlosses.psnr(J(g), J(g))),          # MSE floor
        (tlosses.ssim(T(g), T(gt)), jlosses.ssim(J(g), J(gt))),
        (tlosses.ssim(T(g), T(g)), jlosses.ssim(J(g), J(g))),
        (tlosses.ssim(T(g[0, :, :, :, :1]), T(gt[0, :, :, :, :1])),
         jlosses.ssim(J(g[0, :, :, :, :1]), J(gt[0, :, :, :, :1]))),
    ]
    for i, (got, want) in enumerate(pairs):
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6, err_msg=i)
    for wt in (0.0, np.float32(0.03)):
        terms = [torch.tensor(x, dtype=torch.float32) for x in (0.3, 0.6, 0.7, 0.1)]
        got, gm = tlosses.generator_loss(*terms, float(wt), 0.07, 0.5)
        want, jm = jlosses.generator_loss(*[J(np.float32(x)) for x in (0.3, 0.6, 0.7, 0.1)],
                                          J(np.float32(wt)), 0.07, 0.5)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
        assert set(gm) == set(jm)
        for k in gm:
            np.testing.assert_allclose(gm[k].item(), float(jm[k]), rtol=1e-6, err_msg=k)


def test_gan_synthetic_clips_and_sampler_equal_jax():
    """The same seeds give the same clips and the same three batches, bit for
    bit and dtype for dtype; too-short clips are dropped in both."""
    for fn, kw in ((tdata.synthetic_av_clips, dict(n_clips=3, frames=20, img=32, seed=3)),
                   (tdata.synthetic_gan_clips, dict(n_clips=3, frames=16, img=32, seed=1))):
        got, want = fn(**kw), getattr(jdata, fn.__name__)(**kw)
        for g, w in zip(got, want):
            assert g.frames.dtype == w.frames.dtype and np.array_equal(g.frames, w.frames)
            assert g.wav.dtype == w.wav.dtype and np.array_equal(g.wav, w.wav)
        short = tdata.GanClip(got[0].frames[:12], got[0].wav[:8000])
        ts = tdata.GanWindowSampler(got + [short], 5, seed=2)
        js = jdata.GanWindowSampler(want + [jdata.GanClip(short.frames, short.wav)], 5, seed=2)
        assert len(ts.clips) == len(js.clips) == 3
        for b in (4, 1, 3):
            tb, jb = ts.sample_batch(b), js.sample_batch(b)
            assert set(tb) == set(jb)
            for k in jb:
                assert tb[k].dtype == jb[k].dtype and np.array_equal(tb[k], jb[k]), k
    with pytest.raises(ValueError, match="long enough"):
        tdata.GanWindowSampler([short], 5)


@pytest.mark.parametrize("call", [
    lambda: tdata.GanWindowSampler(tdata.synthetic_gan_clips(1, 16, 8), with_text=True),
    lambda: tdata.synthetic_gan_clips(with_text=True),
    lambda: tdata.synthetic_av_clips(with_text=True),
], ids=["sampler", "gan_clips", "av_clips"])
def test_transcripts_wait_for_the_lip_expert(call):
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 7"):
        call()


def test_load_gan_clip_matches_jax(tmp_path):
    """A preprocess-gan clip directory ({i}.jpg, audio.wav, text.txt) read by
    both packages, as it is and resized."""
    import cv2

    rng = np.random.default_rng(6)
    for i in range(12):     # out of order on disk: 0, 1, 10, 11, 2, ...
        cv2.imwrite(str(tmp_path / f"{i}.jpg"), rng.integers(0, 256, (40, 36, 3), np.uint8))
    tvideo.save_wav(str(tmp_path / "audio.wav"), rng.standard_normal(3200).astype(np.float32))
    (tmp_path / "text.txt").write_text("HELLO World\nignored\n")
    for size in (None, 24):
        got = tdata.load_gan_clip(str(tmp_path), size)
        want = jdata.load_gan_clip(str(tmp_path), size)
        assert np.array_equal(got.frames, want.frames) and np.array_equal(got.wav, want.wav)
        assert got.frames.shape == (12,) + ((40, 36) if size is None else (24, 24)) + (3,)
        assert got.text == want.text == "hello world"
