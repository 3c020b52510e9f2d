"""The PyTorch port's whole slice — mouth-ROI preprocessing into the ViViT
forward — against the JAX package, plus the port's isolation from JAX."""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lipreading_video_generation_tpu.core.config import ViViTConfig as JConfig
from lipreading_video_generation_tpu.models.vivit import ViViT as JViViT
from lipreading_video_generation_tpu.ops import image as jim
from lipreading_video_generation_tpu.pipelines import preprocess as jpre
from lipreading_video_generation_tpu_torch.core.config import ViViTConfig as TConfig
from lipreading_video_generation_tpu_torch.models.convert import vivit_state_dict_from_flax
from lipreading_video_generation_tpu_torch.models.vivit import ViViT as TViViT
from lipreading_video_generation_tpu_torch.ops import attention as tatt
from lipreading_video_generation_tpu_torch.ops import clahe_cuda as tcl
from lipreading_video_generation_tpu_torch.ops import image as tim
from lipreading_video_generation_tpu_torch.pipelines import preprocess as tpre

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SMALL = dict(num_layers=2, hidden_size=64, num_heads=4, mlp_dim=128, num_classes=8,
             dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


def test_slice_matches_jax_end_to_end():
    """2 clips × 5 frames of 96×96 RGB, bench-style face boxes.

    ROI: the JAX package blends the CLAHE LUTs in bf16 and the port in
    float32 (up to ~1.7 gray levels apart before the 48→32 resize), so the
    uint8 ROI may differ by 2 levels, with ≥ 99% of pixels within 1. (A gray
    value within ~1e-4 of a rounding tie could also take the next histogram
    bin on one side and move a tile's LUT by a step of ~7 levels; these
    inputs have no such flip, which the test checks so a failure points
    there.)

    Logits: on the same ROI the two ViViTs meet the float32 bound (1e-4).
    End to end each side runs on its own ROI; those 1-2 level differences
    in a fifth of the pixels move the logits by ~3e-3, bounded at 2e-2.
    """
    launches = (tcl.clahe_cuda.launch_count, tatt.small_mha.launch_count)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (10, 96, 96, 3), dtype=np.uint8)
    boxes = (np.tile([8.0, 92.0, 6.0, 90.0], (10, 1))
             + rng.uniform(-2, 2, (10, 4))).astype(np.float32)

    roi_j = np.asarray(jpre.mouth_roi_pipeline(jnp.asarray(frames), jnp.asarray(boxes)))
    roi_t = tpre.mouth_roi_pipeline(torch.from_numpy(frames), torch.from_numpy(boxes))
    assert roi_t.dtype == torch.uint8 and roi_t.shape == roi_j.shape == (10, 32, 32, 1)
    d = np.abs(roi_t.numpy().astype(np.int32) - roi_j.astype(np.int32))
    assert d.max() <= 2 and (d <= 1).mean() >= 0.99, (d.max(), (d <= 1).mean())

    mouth = jax.vmap(lambda b: jpre.mouth_box_from_face(b, 48))(jnp.asarray(boxes))
    gray_j = np.asarray(jax.vmap(
        lambda f, b: jim.rgb_to_gray(jim.crop_and_resize(
            f, b, (48, 48), "cubic")))(jnp.asarray(frames).astype(jnp.float32), mouth))
    gray_t = tim.rgb_to_gray(tim.crop_and_resize(
        torch.from_numpy(frames), torch.from_numpy(np.array(mouth)), (48, 48), "cubic"))
    np.testing.assert_array_equal(np.round(gray_t.numpy()), np.round(gray_j))

    jmodel = JViViT(JConfig(**SMALL))
    clips_j = jnp.asarray(roi_j.reshape(2, 5, 32, 32, 1)).astype(jnp.float32) / 255.0
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32), jmodel.init(jax.random.key(0), clips_j)["params"])
    logits_j = np.asarray(jmodel.apply({"params": params}, clips_j))

    model = TViViT(TConfig(**SMALL)).eval()
    model.load_state_dict(vivit_state_dict_from_flax(params))
    with torch.inference_mode():
        same_roi = model(torch.from_numpy(np.array(clips_j))).numpy()
        own_roi = model(roi_t.reshape(2, 5, 32, 32, 1).float() / 255.0).numpy()
    np.testing.assert_allclose(same_roi, logits_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(own_roi, logits_j, rtol=0, atol=2e-2)
    assert (tcl.clahe_cuda.launch_count, tatt.small_mha.launch_count) == launches


def test_slice_word_clips_matches_jax():
    processed = np.arange(7 * 2 * 2, dtype=np.uint8).reshape(7, 2, 2, 1)
    spans = [("a", 0, 3), ("b", 2, 9), ("c", 6, 6), ("d", -4, 1)]
    want = jpre.slice_word_clips(processed, spans, 5)
    got = tpre.slice_word_clips(processed, spans, 5)
    assert got[1] == want[1]
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)


_ISOLATION = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "lipreading_video_generation_tpu")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
import lipreading_video_generation_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print(" ".join(names))
"""


def test_port_imports_neither_jax_nor_flax():
    """Every module of the port imports with jax, flax and the JAX package
    blocked, and none of them gets loaded."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _ISOLATION], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 20, sorted(names)
    pkg = "lipreading_video_generation_tpu_torch."
    assert {pkg + m for m in ("ops.audio", "models.unet", "models.unet_audio",
                              "models.audio_encoder", "models.schedulers",
                              "pipelines.sample_diffusion",
                              "pipelines.train_diffusion")} <= names
