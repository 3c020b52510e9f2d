"""The served lipreading request, ``pipelines.train_vivit.predict_frames``:
host frames and face boxes in, host log-probs out, held against the
benchmark's plain reference (``benchmarks/reference/vivit.py``: float32
PyTorch that imports nothing of the port) on seeded random weights, and the
benchmark's FLOP count of it against ``utils/flops``, and the benchmark's
comparison of the ROI that a request fed the classifier (its spans:
``test_torch_port_profiling.py``). All on the CPU at a small size: 2
blocks, hidden 64, 4 heads, MLP 192, 4 clips of five 96x96 frames."""
import os
import sys

import numpy as np
import pytest
import torch

from lipreading_video_generation_tpu_torch.core.config import PreprocessConfig, ViViTConfig
from lipreading_video_generation_tpu_torch.models.vivit import ViViT
from lipreading_video_generation_tpu_torch.pipelines import train_vivit
from lipreading_video_generation_tpu_torch.pipelines.preprocess import mouth_roi_pipeline
from lipreading_video_generation_tpu_torch.utils import flops

BENCH = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir, "benchmarks"))
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import harness  # noqa: E402
import weights  # noqa: E402
from reference import vivit as ref  # noqa: E402
from reference.nn import Numerics  # noqa: E402

SMALL = dict(hidden_size=64, num_layers=2, num_heads=4, mlp_dim=192, num_classes=64)
CLIPS, T = 4, 5
SEED = 2**31 + 29
# Gaps of a log-prob over the reference's standard deviation of the clip's
# log-probs across the classes (what the benchmark compares).
# float32: the same float32 products on both sides, summed in other orders
# through two blocks; the largest gap reads ~1e-6, and 1e-4 leaves a
# hundredfold margin while a single ROI pixel one level off (1/255 of a
# tubelet input) moves a log-prob by ~1e-3 of the spread.
F32_MAX_GAP = 1e-4
# bf16: the entry rounds every product's inputs and the residual stream to
# 8 bits of mantissa (2^-8 relative); through two blocks the largest gap
# reads ~0.015 and the mean ~0.004. The reference in fp8 (the precision
# below) reads ~0.3 and ~0.08 at this size: the limits sit between.
BF16_MAX_GAP, BF16_MEAN_GAP = 0.05, 0.012
# ROI pixels that may differ, by one level at most: both sides round the
# same float32 quantities (the antialiased output half to even, the luma to
# its CLAHE bin), but they blend the tiles' LUTs in their own order, so a
# value within rounding of a .5 tie may round either way. Such ties are
# rare: at most 0.1% of the pixels (none moved at these inputs).
ROI_MOVED_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def request_inputs():
    """bench.py's inputs: random 96x96 RGB uint8 frames, face boxes
    [8, 92, 6, 90] ± 2 pixels."""
    rng = np.random.default_rng(7)
    n = CLIPS * T
    frames = rng.integers(0, 256, (n, 96, 96, 3), dtype=np.uint8)
    boxes = (np.tile([8.0, 92.0, 6.0, 90.0], (n, 1)) + rng.uniform(-2, 2, (n, 4))
             ).astype(np.float32)
    return frames, boxes


def _model(dtype: str):
    """A small ViViT with the benchmark's seeded weights (every leaf drawn,
    as ``benchmarks/weights.py`` draws them) and those weights."""
    cfg = ViViTConfig(dtype=dtype, **SMALL)
    with torch.device("meta"):
        model = ViViT(cfg)
    params = weights.from_seed(model.state_dict(), SEED, "cpu")
    model = model.to_empty(device="cpu")
    model.load_state_dict(params)
    return model.eval(), params, cfg


def _reference(params, cfg, frames, boxes, mode="float32"):
    rcfg = {"tubelet_size": cfg.tubelet_size, "num_layers": cfg.num_layers,
            "num_heads": cfg.num_heads, "num_frames": cfg.num_frames,
            "image_size": cfg.image_size}
    return ref.request(ref.ViViT(params, rcfg, Numerics(mode)), torch.from_numpy(frames),
                       torch.from_numpy(boxes))[0]


def _gaps(got: np.ndarray, want: torch.Tensor):
    gap = (torch.from_numpy(got) - want).abs() / want.std(dim=-1, keepdim=True)
    return float(gap.max()), float(gap.mean())


def test_roi_matches_the_reference(request_inputs):
    frames, boxes = request_inputs
    f, b = torch.from_numpy(frames), torch.from_numpy(boxes)
    got = mouth_roi_pipeline(f, b)[..., 0].to(torch.int16)
    want = ref.mouth_roi(f, b).to(torch.int16)
    assert got.shape == want.shape == (CLIPS * T, 32, 32)
    moved = (got - want).abs()
    assert int(moved.max()) <= 1
    assert float((moved > 0).float().mean()) <= ROI_MOVED_SHARE


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predict_frames_matches_the_reference(dtype, request_inputs):
    frames, boxes = request_inputs
    model, params, cfg = _model(dtype)
    got = train_vivit.predict_frames(model, frames, boxes)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == (CLIPS, cfg.num_classes)
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, rtol=1e-5)
    want = _reference(params, cfg, frames, boxes)
    max_gap, mean_gap = _gaps(got, want)
    if dtype == "float32":
        assert max_gap <= F32_MAX_GAP, max_gap
    else:
        assert max_gap <= BF16_MAX_GAP and mean_gap <= BF16_MEAN_GAP, (max_gap, mean_gap)
        # the precision below bf16 does not pass the same limits
        ctrl_max, ctrl_mean = _gaps(_reference(params, cfg, frames, boxes, "fp8").numpy(), want)
        assert ctrl_max > BF16_MAX_GAP or ctrl_mean > BF16_MEAN_GAP, (ctrl_max, ctrl_mean)


def test_predict_frames_is_predict_step_on_the_roi(request_inputs):
    """The entry is the ROI pipeline at ``pre``'s settings, then
    ``predict_step`` on clips of ``num_frames`` frames."""
    frames, boxes = request_inputs
    model, _, _ = _model("float32")
    pre = PreprocessConfig(clahe_clip_limit=2.0, clahe_grid=(4, 4))
    roi = mouth_roi_pipeline(torch.from_numpy(frames), torch.from_numpy(boxes),
                             pre.lip_crop_size, pre.model_input_size, pre.clahe_clip_limit,
                             pre.clahe_grid)
    want = train_vivit.predict_step(model, roi.reshape(CLIPS, T, 32, 32, 1))
    got = train_vivit.predict_frames(model, frames, boxes, pre)
    np.testing.assert_array_equal(got, want.numpy())


def _tiny_program():
    cell = "vivit_serve_b384"
    wl = harness.load_json(harness.BENCH / "workloads" / f"{cell}.json")
    co = harness.load_json(harness.BENCH / "configs" / f"{wl['config']}.tiny.json")
    mo = harness.load_json(harness.BENCH / "traffic" / f"{wl['traffic']}.tiny.json")
    return harness.make_program(harness.load_cell(cell, co, mo), SEED, "cpu"), wl["limits"]


@pytest.mark.parametrize("inverted", [False, True])
def test_benchmark_holds_each_roi_frame(inverted, monkeypatch):
    """``vivit_serve_b384``'s comparison reads the ROI that the served
    request fed the classifier: equal to the reference's on a sound
    request, and with one frame's ROI inverted (a fault the log-probs of a
    few hundred clips can hide) about that frame's share of the pixels,
    over the cell's limit."""
    import faults

    program, limits = _tiny_program()
    if inverted:
        monkeypatch.setattr(train_vivit, "mouth_roi_pipeline",
                            faults.altered_frames(train_vivit.mouth_roi_pipeline))
    req = program.request(0)
    out = program.serve(req)
    assert out.roi.dtype == torch.uint8 and out.roi.shape == (req.n_frames, 32, 32)
    got = program.compare(req, out, program.reference_output(req, "float32"))
    if inverted:
        assert 0.9 / req.n_frames <= got["roi_far_share"] <= 1.0 / req.n_frames
        assert got["roi_far_share"] > limits["roi_far_share"]
    else:
        assert got["roi_far_share"] == 0.0
        assert all(got[k] <= limits[k] for k in limits), got


def test_benchmark_flops_match_the_count_of_the_entry():
    """``vivit_serve_b384``'s ``Program.model_flops`` (from the shapes)
    against ``utils/flops.flops_detail``'s model count of the served call,
    at the benchmark's CPU test sizes."""
    program, _ = _tiny_program()
    req = program.request(0)
    counted = flops.flops_detail(program.serve, req)["model"]
    assert 0.99 <= program.model_flops(req) / counted <= 1.01
