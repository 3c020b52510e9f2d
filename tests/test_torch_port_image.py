"""The PyTorch port's image ops and CLAHE against the JAX package.

Inputs are made with numpy from a seed and go through the JAX function and
its counterpart in ``lipreading_video_generation_tpu_torch`` on the CPU.
The Pallas CLAHE kernel runs in interpret mode, as in tests/test_image.py.
The CUDA kernel K1 is held against its plain version in
tests/test_torch_port_cuda.py.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lipreading_video_generation_tpu.ops import image as jim
from lipreading_video_generation_tpu.ops.clahe_pallas import clahe_pallas
from lipreading_video_generation_tpu.pipelines import preprocess as jpre
from lipreading_video_generation_tpu_torch.ops import _build
from lipreading_video_generation_tpu_torch.ops import clahe_cuda as tcl
from lipreading_video_generation_tpu_torch.ops import image as tim
from lipreading_video_generation_tpu_torch.pipelines import preprocess as tpre


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


# (y1, y2, x1, x2) on a 96×96 frame: inside; partly outside top-left and
# bottom-right; the bench's expanded mouth box that reaches y2 ≈ 96.3.
_BOXES = [(20.0, 70.0, 10.0, 80.0), (-6.5, 40.0, -3.0, 50.5),
          (60.0, 104.0, 70.0, 101.0), (50.3, 96.3, 24.1, 72.1)]


@pytest.mark.parametrize("box", _BOXES)
def test_crop_and_resize_cubic_matches_jax(box):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (96, 96, 3), dtype=np.uint8)
    b = np.asarray(box, np.float32)
    want = np.asarray(jim.crop_and_resize(jnp.asarray(img).astype(jnp.float32),
                                          jnp.asarray(b), (48, 48), "cubic"))
    got = tim.crop_and_resize(torch.from_numpy(img)[None], torch.from_numpy(b)[None],
                              (48, 48), "cubic")[0].numpy()
    # f32 sums of four taps in another order: ~1e-5 of the ~300 range
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_resize_48_to_32_antialiased_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 255, (3, 48, 48, 1)).astype(np.float32)
    want = np.asarray(jim.resize(jnp.asarray(x), (32, 32), "bilinear"))
    got = tim.resize(torch.from_numpy(x), (32, 32), "bilinear").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_gray_and_boxes_match_jax():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (4, 8, 8, 3), dtype=np.uint8)
    np.testing.assert_allclose(
        tim.rgb_to_gray(torch.from_numpy(img)).numpy(),
        np.asarray(jim.rgb_to_gray(jnp.asarray(img))), rtol=0, atol=1e-4)
    faces = (np.tile([8.0, 92.0, 6.0, 90.0], (16, 1))
             + rng.uniform(-30, 30, (16, 4))).astype(np.float32)
    for face in faces:
        want = np.asarray(jpre.mouth_box_from_face(jnp.asarray(face), 48))
        got = tpre.mouth_box_from_face(torch.from_numpy(face), 48).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# The shapes and grids of tests/test_image.py's Pallas check, at its clip
# limit 2.0, plus the main path's clip 0.2 on float gray values.
_CLAHE_CASES = [((48, 48), (8, 8), 2.0, np.uint8), ((2, 48, 48), (8, 8), 2.0, np.uint8),
                ((50, 46), (8, 8), 2.0, np.uint8), ((64, 64), (4, 4), 2.0, np.uint8),
                ((5, 48, 48), (8, 8), 0.2, np.float32)]


@pytest.mark.parametrize("shape,grid,clip,dtype", _CLAHE_CASES)
def test_clahe_reference_matches_jax(shape, grid, clip, dtype):
    """Histograms, CDF and LUT are exact on both sides; JAX blends the LUTs
    in bf16 (both ``clahe_xla`` and the Pallas kernel), the port in float32.
    In whole gray levels (float outputs rounded half to even, as the
    pipeline's uint8 cast does) they differ by at most 2, and by more than 1
    in < 1% of pixels."""
    rng = np.random.default_rng(3)
    if dtype == np.uint8:
        x = rng.integers(0, 256, shape, dtype=np.uint8)
    else:
        x = rng.uniform(0, 255, shape).astype(np.float32)
    got = np.round(tcl.clahe_reference(torch.from_numpy(x), clip, grid).numpy())
    for want in (jim.clahe_xla(jnp.asarray(x), clip, grid),
                 clahe_pallas(jnp.asarray(x), clip, grid, interpret=True)):
        d = np.abs(got.astype(np.float64) - np.round(np.asarray(want, np.float64)))
        assert d.max() <= 2 and (d > 1).mean() < 0.01, (shape, grid, d.max())


# The shapes that K1 took only since its redesign (a grid of 16 x 16 tiles of
# 9 pixels, 128 and 512 bins, tiles of 4,096 and 920 pixels) at clip limits
# 0.2, 2.0 and 2.5 (L = 2.5 at 64 x 64 in 4 x 4).
# The Pallas kernel runs where the JAX package's ``clahe_supported`` holds.
_CLAHE_MORE = [((48, 48), (16, 16), 256, 0.2, np.float32),
               ((2, 48, 48), (16, 16), 256, 2.0, np.uint8),
               ((48, 48), (8, 8), 128, 0.2, np.float32),
               ((48, 48), (8, 8), 512, 2.5, np.float32),
               ((128, 128), (2, 2), 256, 2.5, np.uint8),
               ((1, 180, 320), (8, 8), 256, 2.0, np.uint8),
               ((64, 64), (4, 4), 256, 2.5, np.float32)]


@pytest.mark.parametrize("shape,grid,nbins,clip,dtype", _CLAHE_MORE)
def test_clahe_reference_matches_jax_at_more_shapes(shape, grid, nbins, clip, dtype):
    """As ``test_clahe_reference_matches_jax``: whole levels within 2 of the
    JAX package's bf16 blend, more than 1 in < 1% of pixels. At 512 bins
    the levels above 256 are 2 apart in bf16 (8 significant bits): within 4,
    more than 2 in < 5% (``clahe_xla`` rounds its LUT upsample to bf16 once
    an axis: 1.6% measured; the Pallas kernel, once: 0%)."""
    from lipreading_video_generation_tpu.ops.clahe_pallas import clahe_supported as jax_supported

    rng = np.random.default_rng(5)
    if dtype == np.uint8:
        x = rng.integers(0, 256, shape, dtype=np.uint8)
    else:
        x = rng.uniform(0, 255, shape).astype(np.float32)
    got = np.round(tcl.clahe_reference(torch.from_numpy(x), clip, grid, nbins).numpy())
    wants = [jim.clahe_xla(jnp.asarray(x), clip, grid, nbins)]
    if jax_supported(shape[-2], shape[-1], grid, nbins):
        wants.append(clahe_pallas(jnp.asarray(x), clip, grid, nbins, interpret=True))
    scale, share = (1, 0.01) if nbins <= 256 else (nbins // 256, 0.05)
    for want in wants:
        d = np.abs(got.astype(np.float64) - np.round(np.asarray(want, np.float64)))
        assert d.max() <= 2 * scale and (d > scale).mean() < share, (shape, grid, nbins, d.max())


# (h, w, grid, nbins, clip, route): the packed route takes what the ViViT path
# gives K1 (the main path, at clip 2.0 too, where L is still 1), 16 x 16
# tiles, 128 and 8 bins at L = 1, and 88 x 88 (121 pixels a tile: area ·
# nbins² just below 2²³); the tiled route everything else: L above 1 (clip
# 10.0, 8 bins at clip 2.0), W not a multiple of 4, 256 pixels a tile (past
# 8-bit counters), 112 x 112 (area · nbins² past 2²³), 512 bins (past a byte
# a bin), the CPU cases above (tiles of 4,096 and 920 pixels), the card's
# frames of 360 x 640, padding that spans more than the last tile (5 x 5 in
# 4 x 4), 100, 3 and 20,000 bins, 17 x 17 tiles, a single pixel
_CLAHE_ROUTES = [(48, 48, (8, 8), 256, 0.2, "packed"), (48, 48, (8, 8), 256, 2.0, "packed"),
                 (48, 48, (16, 16), 256, 0.2, "packed"), (48, 48, (8, 8), 128, 0.2, "packed"),
                 (48, 48, (8, 8), 8, 0.2, "packed"), (88, 88, (8, 8), 256, 0.2, "packed"),
                 (48, 48, (8, 8), 256, 10.0, "tiled"), (48, 48, (8, 8), 8, 2.0, "tiled"),
                 (50, 46, (8, 8), 256, 0.2, "tiled"), (64, 64, (4, 4), 256, 0.2, "tiled"),
                 (112, 112, (8, 8), 256, 0.2, "tiled"), (48, 48, (8, 8), 512, 0.2, "tiled"),
                 (128, 128, (2, 2), 256, 0.2, "tiled"), (180, 320, (8, 8), 256, 0.2, "tiled"),
                 (360, 640, (8, 8), 256, 0.2, "tiled"), (5, 5, (4, 4), 256, 0.2, "tiled"),
                 (48, 48, (8, 8), 100, 0.2, "tiled"), (48, 48, (8, 8), 3, 0.2, "tiled"),
                 (48, 48, (8, 8), 20000, 0.2, "tiled"), (48, 48, (17, 17), 256, 0.2, "tiled"),
                 (1, 1, (1, 1), 256, 0.2, "tiled"), (64, 64, (4, 4), 16, 2.0, "tiled")]


@pytest.mark.parametrize("h,w,grid,nbins,clip,route", _CLAHE_ROUTES)
def test_clahe_route_takes_every_shape(h, w, grid, nbins, clip, route):
    """Every shape the JAX package's ``clahe`` takes has a route; the packed
    route's 8-bit counters hold the tile area and a LUT level, its integer
    scan is exact (L = 1, area·nbins² < 2²³), its shared memory fits a block,
    and an image that does not start on 16 bytes takes the tiled route."""
    assert tcl.clahe_supported(h, w, grid, nbins)
    assert tcl.clahe_route(h, w, grid, nbins, clip) == route
    lay = tcl.clahe_packed_layout(h, w, grid, nbins, clip)
    assert (lay is None) == (route == "tiled")
    if lay is not None:
        th, tw = -(-h // grid[0]), -(-w // grid[1])
        assert th * tw <= 255 and nbins <= 256 and th * tw * nbins ** 2 < 1 << 23
        assert max(1.0, clip * th * tw / nbins) == 1.0 and w % 4 == 0
        assert lay["smem"] <= _build.SMEM_PER_BLOCK
        assert grid[0] * grid[1] * lay["group"] <= 256 or lay["group"] == 1
        words = nbins // 4
        assert lay["lane_words"] * lay["group"] == words
        assert lay["group"] == 1 or lay["lane_words"] & (lay["lane_words"] - 1) == 0
        assert lay["tile_words"] >= words + (lay["group"] if lay["group"] > 1 else 0)
        assert (lay["tile_words"] - lay["group"]) % 32 == 0
        assert tcl.clahe_route(h, w, grid, nbins, clip, ptr=4) == "tiled"
    assert set(tcl.clahe_cuda.route_counts) == {"packed", "tiled"}


def test_clahe_packed_layout_at_the_main_path():
    """(48, 48) in 8 x 8 tiles of 36 pixels, 256 bins: 17 KB of 8-bit
    counters a block (int32 counters would take 64 KB), 4 lanes a tile of
    16 words each, each run padded by a word and the tile to 68 words (so
    that a warp's 32 lanes start on 32 banks), 16 bytes a row and a column,
    a byte a bin."""
    lay = tcl.clahe_packed_layout(48, 48, (8, 8), 256)
    assert lay == {"group": 4, "lane_words": 16, "tile_words": 68,
                   "smem": 64 * 68 * 4 + 16 * 96 + 2304}
    banks = {(t * 68 + g * 17) % 32 for t in range(8) for g in range(4)}
    assert len(banks) == 32
    assert not tcl.clahe_supported(48, 48, (8, 8), 1)
    with pytest.raises(ValueError, match="does not take"):
        tcl.clahe_route(0, 48, (8, 8), 256)


def test_clahe_luts_reference_is_the_reference_blend():
    """``clahe_reference`` blends the LUTs that ``clahe_luts_reference``
    gives: levels in 0..nbins-1, and a flat image maps to its tiles' level."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.uniform(0, 255, (2, 50, 46)).astype(np.float32))
    luts = tcl.clahe_luts_reference(x, 2.0, (8, 8), 128)
    assert luts.shape == (2, 64, 128) and luts.min() >= 0 and luts.max() <= 127
    assert torch.equal(luts, torch.round(luts))
    flat = torch.full((1, 48, 48), 100.0)
    lut = tcl.clahe_luts_reference(flat, 0.2, (8, 8))
    np.testing.assert_array_equal(tcl.clahe_reference(flat, 0.2, (8, 8)).numpy(),
                                  np.full((1, 48, 48), lut[0, 0, 100].item(), np.float32))


def test_clahe_cpu_dispatch_is_plain_and_launches_nothing():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(0, 255, (3, 48, 48)).astype(np.float32))
    before = tcl.clahe_cuda.launch_count
    np.testing.assert_array_equal(tim.clahe(x).numpy(), tcl.clahe_reference(x).numpy())
    u8 = x.round().to(torch.uint8)
    assert tim.clahe(u8).dtype == torch.uint8
    assert tcl.clahe_cuda.launch_count == before
    with pytest.raises(ValueError, match="CUDA"):
        tcl.clahe_cuda(x)


def test_lab_round_trip_and_contrast_boost_match_jax():
    """``rgb_to_lab`` / ``lab_to_rgb`` within 1e-4 of JAX (the goldens of
    tests/test_image.py: OpenCV's LAB within 3 levels on average, the round
    trip within 1.5); ``contrast_boost`` keeps shape and dtype and agrees with
    JAX's within CLAHE's known differences (ROADMAP §3: the bf16 blend, and a
    bin edge met by L values 3e-5 apart moves a tile's LUT entry): mean |d|
    below 0.5 level (0.25 measured), over 2 levels at under 1% of the values
    (0.11% uint8, 0.27% float)."""
    import cv2

    rng = np.random.default_rng(8)
    x = rng.integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    lab = tim.rgb_to_lab(torch.from_numpy(x))
    jlab = np.asarray(jim.rgb_to_lab(jnp.asarray(x)))
    np.testing.assert_allclose(lab.numpy(), jlab, rtol=0, atol=1e-4)
    assert np.mean(np.abs(lab.numpy()[0] - cv2.cvtColor(x[0], cv2.COLOR_RGB2LAB))) < 3.0
    back = tim.lab_to_rgb(lab).numpy()
    np.testing.assert_allclose(back, np.asarray(jim.lab_to_rgb(jnp.asarray(jlab))), rtol=0,
                               atol=1e-3)
    assert np.mean(np.abs(back - x)) < 1.5
    for img in (x, x.astype(np.float32)):
        got = tim.contrast_boost(torch.from_numpy(img))
        want = np.asarray(jim.contrast_boost(jnp.asarray(img)))
        assert got.shape == img.shape and got.dtype == (
            torch.uint8 if img.dtype == np.uint8 else torch.float32)
        d = np.abs(got.numpy().astype(np.float32) - want.astype(np.float32))
        assert d.mean() < 0.5 and (d > 2).mean() < 0.01, (d.mean(), (d > 2).mean())
    lo = rng.integers(100, 140, (64, 64, 3)).astype(np.uint8)   # a flat image gains contrast
    assert tim.contrast_boost(torch.from_numpy(lo)).numpy().std() > lo.std()


def test_resize_batch_random_crop_and_apply_mask_match_jax():
    """``resize_batch`` is JAX's (uint8 within a level at ties, float 1e-4);
    ``random_crop`` at a given offset is the slice JAX's draws lead to, and
    its own draws stay inside; ``apply_mask`` as JAX's and its golden."""
    import jax

    rng = np.random.default_rng(9)
    x = rng.integers(0, 256, (3, 40, 52, 3), dtype=np.uint8)
    for size, method in (((20, 26), "bilinear"), ((64, 30), "cubic"), ((13, 17), "nearest")):
        got = tim.resize_batch(torch.from_numpy(x), size, method).numpy().astype(np.int32)
        want = np.asarray(jim.resize_batch(jnp.asarray(x), size, method)).astype(np.int32)
        assert got.shape == want.shape == (3,) + size + (3,)
        assert np.abs(got - want).max() <= 1
        xf = x.astype(np.float32)
        np.testing.assert_allclose(
            tim.resize_batch(torch.from_numpy(xf), size, method).numpy(),
            np.asarray(jim.resize_batch(jnp.asarray(xf), size, method)), rtol=0, atol=1e-3)
    key = jax.random.key(3)
    want = np.asarray(jim.random_crop(key, jnp.asarray(x), 24))
    ky, kx = jax.random.split(key)
    yx = (int(jax.random.randint(ky, (), 0, 40 - 24 + 1)),
          int(jax.random.randint(kx, (), 0, 52 - 24 + 1)))
    assert np.array_equal(tim.random_crop(torch.from_numpy(x), 24, offset=yx).numpy(), want)
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        assert tim.random_crop(torch.from_numpy(x), 24, generator=g).shape == (3, 24, 24, 3)
    with pytest.raises(ValueError, match="outside"):
        tim.random_crop(torch.from_numpy(x), 24, offset=(17, 0))
    frames = np.full((2, 4, 4, 3), 7.0, np.float32)
    mask = np.zeros((4, 4), np.float32)
    mask[:2] = 255
    out = tim.apply_mask(torch.from_numpy(frames), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(out, np.asarray(jim.apply_mask(jnp.asarray(frames),
                                                                 jnp.asarray(mask))))
    assert out[:, :2].min() == 7.0 and out[:, 2:].max() == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_canny_edges_match_jax(seed):
    """Sobel gradients equal JAX's; the edge maps of a step edge and of
    blurred noise equal JAX's but for at most 0.5% of the pixels (the
    direction sector comes from float32 atan2, which may differ by an ulp
    at a sector's edge, and hysteresis spreads such a pixel's change)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((2, 48, 64), np.float32)
    x[0, :, 30:] = 255.0
    noise = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    x[1] = sum(np.roll(np.roll(noise, dy, 0), dx, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)) / 9
    for got, want in zip(tim._sobel(torch.from_numpy(x)), jim._sobel(jnp.asarray(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
    got = tim.canny_edges(torch.from_numpy(x), low=60.0, high=150.0).numpy()
    want = np.asarray(jim.canny_edges(jnp.asarray(x), low=60.0, high=150.0))
    assert got.dtype == np.uint8 and set(np.unique(got)) <= {0, 255}
    assert (got != want).mean() <= 5e-3
    np.testing.assert_array_equal(got[0], want[0])
    assert (got[0][:, 28:32] == 255).any(axis=1).all() and got[0][:, :26].max() == 0


def test_lucas_kanade_flow_matches_jax():
    """Points tracked through a smooth image shifted by (dx, dy) = (3, 2):
    within 1e-3 px of JAX's, the same in-bounds status, near the shift."""
    rng = np.random.default_rng(5)
    noise = rng.standard_normal((64, 64)).astype(np.float32)
    base = noise
    for _ in range(3):     # a box blur thrice: smooth enough for LK's linearisation
        base = sum(np.roll(np.roll(base, dy, 0), dx, 1) for dy in (-1, 0, 1)
                   for dx in (-1, 0, 1)) / 9
    base = (base * 400 + 128).astype(np.float32)
    shifted = np.roll(base, (2, 3), axis=(0, 1))
    pts = np.array([[20.0, 20.0], [32.0, 40.0], [40.0, 25.0], [63.5, 10.0]], np.float32)
    got, ok = tim.lucas_kanade_flow(torch.from_numpy(base), torch.from_numpy(shifted),
                                    torch.from_numpy(pts))
    want, jok = jim.lucas_kanade_flow(jnp.asarray(base), jnp.asarray(shifted), jnp.asarray(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(got.numpy()[:3] - pts[:3], np.tile([[3.0, 2.0]], (3, 1)), atol=0.5)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: the build raises a clear error; nothing falls back."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_CANDIDATES", (str(tmp_path / "nvcc"),))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(force=True)
    assert not (tmp_path / "build").exists()
