"""The benchmark's arithmetic: the percentile, the busy share of an
overlapping timeline, rooflines and MFU from counts, and its FLOP counts
against torch.utils.flop_counter on the references."""
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import tiny  # noqa: F401  (puts benchmarks/ on sys.path)
import devtrace
import harness
import peaks
import weights
from reference import image, unet_audio, wav2lip
from reference.nn import Numerics


def test_p90_and_quantiles():
    lat = [float(i) for i in range(1, 101)]
    assert harness.quantile(lat, 0.9) == pytest.approx(90.1)
    assert harness.quantile([5.0], 0.9) == 5.0
    assert harness.quantile([3.0, 1.0, 2.0], 0.5) == 2.0
    reader = harness.load_module("metrics", "p90_ms")
    ctx = types.SimpleNamespace(window=harness.Window(latencies_s=[x / 1e3 for x in lat]))
    assert reader.read(ctx) == pytest.approx(90.1)


def _slice(ops, host=(), launches=None):
    spans = [devtrace.HostOp("bench/request", 0.0, 100.0, 1)]
    return devtrace.Slice(0.0, 100.0, [devtrace.DeviceOp(*o) for o in ops], spans + list(host),
                          launches or {}, 1, frames=4, units=1)


def test_idle_share_counts_overlaps_once():
    sl = _slice([("k1", "kernel", 10.0, 30.0, 1), ("k2", "kernel", 20.0, 40.0, 2),
                 ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 35.0, 50.0, 3),
                 ("k3", "kernel", 70.0, 80.0, 4)])
    assert sl.busy_s == pytest.approx(50e-6)
    idle = harness.load_module("metrics", "idle_pct").read(types.SimpleNamespace(slice=sl))
    assert idle == pytest.approx(50.0)
    assert harness.load_module("metrics", "launches_per_frame").read(
        types.SimpleNamespace(slice=sl)) == 1.0
    copy = harness.load_module("metrics", "copy_ms_per_frame").read(types.SimpleNamespace(slice=sl))
    assert copy == pytest.approx(15e-3 / 4)
    gaps = dict(sl.breakdown()["idle_gaps"])
    assert gaps["bench/request"] == pytest.approx(50e-6)


def test_parse_clips_to_the_slice_and_matches_launches():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "bench/request", "ts": 100, "dur": 100, "tid": 7},
        {"ph": "X", "cat": "user_annotation", "name": "int8/im2col", "ts": 110, "dur": 10, "tid": 7},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 112, "dur": 1, "tid": 7,
         "args": {"correlation": 5}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 130, "dur": 1, "tid": 7,
         "args": {"correlation": 6}},
        {"ph": "X", "cat": "kernel", "name": "copy_kernel", "ts": 115, "dur": 20, "args": {"correlation": 5}},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::mm_sm90_kernel<>", "ts": 140,
         "dur": 80, "args": {"correlation": 6}},
    ]
    sl = devtrace.parse(events)
    assert sl.window_s == pytest.approx(100e-6)
    assert [op.name for op in sl.launched_in(["int8/"])] == ["copy_kernel"]
    assert sl.seconds(sl.matching(["mm_sm90_kernel"])) == pytest.approx(60e-6)   # clipped at 200


def test_roofline_and_mfu_from_counts():
    assert peaks.least_seconds(2e12, 1.0, "bf16") == pytest.approx(2e12 / 989e12)
    assert peaks.least_seconds(1.0, 3.35e9, "int8") == pytest.approx(1e-3)
    m, n, k = 1024, 512, 4608
    least = peaks.least_seconds(2.0 * m * n * k, m * k + n * k + 4 * m * n, "int8")
    prog = types.SimpleNamespace(request=lambda i: None, int8_products=lambda r: [(m, n, k)] * 3,
                                 attention_calls=lambda r: [(2, 1, 4096, 64, "fwd")],
                                 model_flops=lambda r: 1e12, precision="bf16")
    sl = _slice([("void (anonymous namespace)::mm_sm90_kernel<signed char>", "kernel", 0.0, 50.0, 1),
                 ("void flash_fwd_sm90_kernel<64>", "kernel", 50.0, 60.0, 2)])
    ctx = types.SimpleNamespace(slice=sl, program=prog,
                                window=harness.Window(seconds=2.0, requests=10))
    k6 = harness.load_module("metrics", "k6_roofline_pct").read(ctx)
    assert k6 == pytest.approx(100.0 * 3 * least / 50e-6)
    flash = harness.load_module("metrics", "flash_roofline_pct").read(ctx)
    want = peaks.least_seconds(4.0 * 2 * 4096 ** 2 * 64, 4 * 2 * 4096 * 64 * 2, "bf16")
    assert flash == pytest.approx(100.0 * want / 10e-6)
    mfu = harness.load_module("metrics", "mfu_pct").read(ctx)
    assert mfu == pytest.approx(100.0 * 1e12 * 10 / 2.0 / 989e12)


def test_generator_flops_match_flop_counter():
    from lipreading_video_generation_tpu_torch.models.generator import TalkingFaceGenerator

    width = 0.25
    with torch.device("meta"):
        shapes = TalkingFaceGenerator(width=width).state_dict()
    gen = wav2lip.Generator(weights.from_seed(shapes, 3, "cpu"), Numerics("float32"), width)
    with FlopCounterMode(display=False) as fc:
        gen(torch.randn(2, 80, 16), torch.rand(2, 96, 96, 6))
    counted = sum(2 * 2 * oh * ow * cout * kh * kw * cin
                  for oh, ow, cin, cout, kh, kw in wav2lip.conv_shapes(width))
    assert len(wav2lip.conv_shapes(width)) == 51
    assert fc.get_total_flops() == counted


def test_unet_flops_match_flop_counter():
    cfg_mod = harness.load_module("configs", "unet_audio_128")
    cfg = dict(harness.load_json(harness.BENCH / "configs" / "unet_audio_128.json"))
    cfg.update(harness.load_json(harness.BENCH / "configs" / "unet_audio_128.tiny.json"))
    from lipreading_video_generation_tpu_torch.models.unet_audio import UNetAudio

    with torch.device("meta"):
        shapes = UNetAudio(cfg_mod.diffusion_config(cfg)).state_dict()
    model = unet_audio.UNetAudio(weights.from_seed(shapes, 4, "cpu"), cfg, Numerics("float32"))
    b, s = 3, cfg["im_size"]
    frame = torch.randint(0, 256, (b, 20, 20, 3), dtype=torch.uint8)
    with FlopCounterMode(display=False) as fc:
        cond = model.condition(frame, torch.randn(b, cfg["audio_samples"]))
    with FlopCounterMode(display=False) as resampling:      # the resize's einsums are no model work
        image.resize(frame, (s, s))
    assert fc.get_total_flops() - resampling.get_total_flops() == cfg_mod.condition_flops(cfg, b)
    with FlopCounterMode(display=False) as fc:
        model.denoise(torch.randn(b, 3, s, s), cond, torch.full((b,), 7))
    assert fc.get_total_flops() == cfg_mod.unet_flops(cfg, b)
