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


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: the build raises a clear error; nothing falls back."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_CANDIDATES", (str(tmp_path / "nvcc"),))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(force=True)
    assert not (tmp_path / "build").exists()
