"""The port's program spans (``utils/profiling.annotate``): a
``torch.profiler`` range on the profiler's clock while a session runs, no
``record_function`` entered while none does; and the spans the four
benchmarked entries open, in their order and nesting: ``generate_frames``
(float32, dynamic and static int8), ``sample_video``, ``train_step`` and
``predict_frames``. All on the CPU at tiny widths."""
import numpy as np
import pytest
import torch
from torch.profiler import profile

from lipreading_video_generation_tpu_torch.core.config import (
    DiffusionConfig, GanConfig, PreprocessConfig, ViViTConfig)
from lipreading_video_generation_tpu_torch.core.prng import seeded
from lipreading_video_generation_tpu_torch.models.generator import TalkingFaceGenerator
from lipreading_video_generation_tpu_torch.models.unet_audio import UNetAudio
from lipreading_video_generation_tpu_torch.models.vivit import ViViT
from lipreading_video_generation_tpu_torch.pipelines import inference
from lipreading_video_generation_tpu_torch.pipelines import sample_diffusion
from lipreading_video_generation_tpu_torch.pipelines import train_diffusion
from lipreading_video_generation_tpu_torch.pipelines import train_vivit
from lipreading_video_generation_tpu_torch.utils import profiling as tprof

GEN_WIDTH = 0.125
TINY_UNET = dict(im_size=16, base_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                 attention_resolutions=(1, 2), num_heads=2, time_embed_dim=32,
                 audio_embed_dim=32, audio_proj_dim=8, im_cond_channels=4,
                 audio_samples=800, num_timesteps=50, dropout=0.0, dtype="float32")
# the port's span prefixes; the outer range stands for a caller's own (the benchmark's bench/)
PREFIXES = ("lipsync/", "sample/", "train/", "int8/", "lipread/")
OUTER = "caller/request"


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


def _spans(prof):
    """(name, the name of the innermost span or outer range around it) of
    every port span, in the order they opened."""
    out = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.name.startswith(PREFIXES):
            parent = e.cpu_parent
            while parent is not None and not parent.name.startswith(PREFIXES + (OUTER,)):
                parent = parent.cpu_parent
            out.append((e.name, parent.name if parent is not None else None))
    return out


def _traced(fn):
    with profile() as prof:
        with torch.profiler.record_function(OUTER):
            result = fn()
    return result, _spans(prof)


class _CountingRange:
    """Stands in for ``record_function``: counts the ranges entered."""
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1

    def __exit__(self, *exc):
        return False


def test_annotate_is_a_span_of_the_profiler():
    with profile() as prof:
        with tprof.annotate("test-span"):
            out = torch.ones(4).sum()
    assert float(out) == 4.0
    assert "test-span" in {e.key for e in prof.key_averages()}


def test_annotate_range_contains_the_ops_launched_inside_it():
    with profile() as prof:
        with tprof.annotate("test/inside"):
            torch.ones(8).mul(3.0).sum()
        torch.zeros(8).add(1.0)
    events = prof.events()
    span, = [e for e in events if e.name == "test/inside"]
    lo, hi = span.time_range.start, span.time_range.end
    inside = [e for e in events if e.name in ("aten::ones", "aten::mul", "aten::sum")]
    after = [e for e in events if e.name in ("aten::zeros", "aten::add")]
    assert len(inside) == 3 and len(after) == 2
    assert all(lo <= e.time_range.start and e.time_range.end <= hi for e in inside)
    assert all(e.time_range.start >= hi for e in after)
    assert all(e.thread == span.thread for e in inside)


@pytest.mark.parametrize("work", ["annotate", "generate_frames_int8", "predict_frames"])
def test_no_range_is_entered_without_a_profiler(work, monkeypatch, lipsync_request,
                                                lipread_request):
    """With no profiler session, ``annotate`` checks its flag and enters no
    ``record_function``; an int8 request (every span of the lip-sync entry and
    of ``ops/quant``) and a lipreading request enter none either. Inside a
    session the same code does."""
    monkeypatch.setattr(tprof, "record_function", _CountingRange)
    _CountingRange.entered = 0
    if work == "annotate":
        def run():
            with tprof.annotate("test/off"):
                torch.ones(2).sum()
    elif work == "predict_frames":
        def run():
            train_vivit.predict_frames(*lipread_request)
    else:
        def run():
            _generate(lipsync_request, "int8")
    run()
    assert _CountingRange.entered == 0
    with profile():
        run()
    assert _CountingRange.entered > 0


def test_annotate_closes_its_range_on_an_exception():
    with profile() as prof:
        with pytest.raises(ValueError, match="inside"):
            with tprof.annotate("test/raises"):
                torch.ones(2).sum()
                raise ValueError("inside")
        with tprof.annotate("test/after"):
            torch.ones(2).sum()
    names = {e.name: e for e in prof.events()}
    assert names["test/raises"].time_range.end <= names["test/after"].time_range.start
    assert names["test/after"].cpu_parent is None


# ---- the lip-sync entry ----------------------------------------------------------------

@pytest.fixture(scope="module")
def lipsync_request():
    """A tiny generator's state dict and a 6-frame request, served in
    batches of 4 (the last one short)."""
    sd = seeded(lambda: TalkingFaceGenerator(width=GEN_WIDTH), 0).state_dict()
    rng = np.random.default_rng(3)
    n, h, w = 6, 64, 72
    frames = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    boxes = np.tile(np.asarray([8.0, h - 8.0, 8.0, w - 12.0], np.float32), (n, 1))
    mels = rng.standard_normal((n, 80, 16)).astype(np.float32)
    return sd, frames, boxes, mels


MODES = {"float32": {}, "int8": dict(serve_int8=True),
         "int8_static": dict(serve_int8=True, serve_int8_static=True)}


def _generate(request, mode):
    sd, frames, boxes, mels = request
    return inference.generate_frames(sd, frames, boxes, mels,
                                     GanConfig(model_width=GEN_WIDTH, **MODES[mode]),
                                     PreprocessConfig(gen_batch_size=4), model_width=GEN_WIDTH,
                                     device="cpu")


def _int8_convs(width):
    """The generator's convolutions that ``ops/quant`` reroutes."""
    gen = TalkingFaceGenerator(width=width)
    return sum(isinstance(m, torch.nn.Conv2d) and m.groups == 1 and m.dilation == (1, 1)
               for m in gen.modules())


@pytest.mark.parametrize("mode", list(MODES))
def test_generate_frames_opens_its_spans(mode, lipsync_request):
    out, spans = _traced(lambda: _generate(lipsync_request, mode))
    assert out.shape == lipsync_request[1].shape and out.dtype == np.uint8
    batches = 2
    top = [name for name, parent in spans if parent == OUTER]
    stages = ["lipsync/gather", "lipsync/prep", "lipsync/generator", "lipsync/paste",
              "lipsync/fetch"]
    assert top == ["lipsync/build"] + stages * batches + ["lipsync/concat"]
    inner = [(name, parent) for name, parent in spans if parent != OUTER]
    assert {parent for _, parent in inner} <= {"lipsync/generator"}
    weights = sum(name == "int8/weights" for name, _ in inner)
    matmuls = sum(name == "int8/matmul" for name, _ in inner)
    if mode == "float32":
        assert inner == []
    else:
        convs = _int8_convs(GEN_WIDTH)
        assert convs == 51
        assert weights == convs * batches        # each weight quantised once a batch
        assert matmuls == convs * batches
        assert {name for name, _ in inner} == {"int8/weights", "int8/quantise", "int8/im2col",
                                               "int8/matmul", "int8/dequantise"}


# ---- the sampling entry ----------------------------------------------------------------

@pytest.fixture(scope="module")
def unet():
    cfg = DiffusionConfig(**TINY_UNET)
    return cfg, seeded(lambda: UNetAudio(cfg), 1).eval()


@pytest.mark.parametrize("steps", [1, 3])
def test_sample_video_opens_one_step_span_per_ddim_step(steps, unet):
    cfg, model = unet
    rng = np.random.default_rng(4)
    frame = rng.integers(0, 256, (24, 24, 3), dtype=np.uint8)
    audio = rng.standard_normal((2, cfg.audio_samples)).astype(np.float32)
    clip, spans = _traced(lambda: sample_diffusion.sample_video(
        model, frame, audio, cfg, num_inference_steps=steps,
        generator=torch.Generator().manual_seed(5)))
    assert clip.shape == (2, 16, 16, 3) and clip.dtype == torch.uint8
    assert spans == ([("sample/condition", OUTER), ("sample/noise", OUTER)]
                     + [("sample/step", OUTER)] * steps + [("sample/finish", OUTER)])


# ---- the training entry ----------------------------------------------------------------

def test_train_step_opens_one_span_per_phase():
    cfg = DiffusionConfig(**TINY_UNET)
    state = train_diffusion.create_state(cfg, seed=2, device="cpu")
    rng = np.random.default_rng(6)
    batch = {"target_frame": rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8),
             "cond_frame": rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8),
             "audio": rng.standard_normal((2, cfg.audio_samples)).astype(np.float32)}
    metrics, spans = _traced(lambda: train_diffusion.train_step(state, batch, cfg))
    assert np.isfinite(float(metrics["loss"])) and state.step == 1
    assert spans == [(name, OUTER) for name in ("train/prepare", "train/noise", "train/forward",
                                                "train/backward", "train/optimizer")]


# ---- the lipreading entry ----------------------------------------------------------------

@pytest.fixture(scope="module")
def lipread_request():
    """A small bf16 ViViT and a request of 2 clips of five 96x96 frames."""
    model = seeded(lambda: ViViT(ViViTConfig(hidden_size=32, num_layers=2, num_heads=4,
                                             mlp_dim=64, num_classes=8)), 3).eval()
    rng = np.random.default_rng(8)
    frames = rng.integers(0, 256, (10, 96, 96, 3), dtype=np.uint8)
    boxes = np.tile(np.asarray([8.0, 92.0, 6.0, 90.0], np.float32), (10, 1))
    return model, frames, boxes


def test_predict_frames_opens_one_span_per_stage(lipread_request):
    logp, spans = _traced(lambda: train_vivit.predict_frames(*lipread_request))
    assert logp.shape == (2, 8)
    assert spans == [(name, OUTER) for name in ("lipread/upload", "lipread/roi",
                                                "lipread/forward", "lipread/fetch")]
