"""Where the port runs, and what it imports.

Every entry point that takes a ``device`` defaults to the card
(``core.device.default_device``) and raises without one; the other port
tests pass ``device="cpu"``. The port's package and ``chip_smoke.py`` import
torch, never jax, flax, optax, orbax, cv2 or the JAX package.
"""
import ast
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from lipreading_video_generation_tpu_torch import cli as tcli
from lipreading_video_generation_tpu_torch.core import config as tcfg
from lipreading_video_generation_tpu_torch.core import device as tdev
from lipreading_video_generation_tpu_torch.core.prng import seeded
from lipreading_video_generation_tpu_torch.data import loader as tloader
from lipreading_video_generation_tpu_torch.models import face_api as tface
from lipreading_video_generation_tpu_torch.models.s3fd import S3FD as TS3FD
from lipreading_video_generation_tpu_torch.models import word_lm as twlm
from lipreading_video_generation_tpu_torch.models import selftest as tselftest
from lipreading_video_generation_tpu_torch.pipelines import feature_extraction as tfx
from lipreading_video_generation_tpu_torch.pipelines import inference as tinf
from lipreading_video_generation_tpu_torch.pipelines import lipreading_e2e as te2e
from lipreading_video_generation_tpu_torch.pipelines import sentence_eval as tse
from lipreading_video_generation_tpu_torch.pipelines import train_landmark as ttl
from lipreading_video_generation_tpu_torch.pipelines import train_gan as ttg
from lipreading_video_generation_tpu_torch.pipelines import train_syncnet as tts
from lipreading_video_generation_tpu_torch.pipelines import train_classifier as ttc
from lipreading_video_generation_tpu_torch.pipelines import train_diffusion as ttd
from lipreading_video_generation_tpu_torch.pipelines import train_superres as tsr
from lipreading_video_generation_tpu_torch.pipelines import train_vivit as ttv

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "orbax", "cv2", "lipreading_video_generation_tpu")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdev.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdev.resolve_device(None)
    assert tdev.resolve_device("cpu") == torch.device("cpu")


def test_default_device_is_the_card_where_there_is_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tdev.default_device() == torch.device("cuda")
    assert tdev.resolve_device(None) == torch.device("cuda")
    assert tdev.resolve_device(torch.device("cpu")) == torch.device("cpu")


ENTRY_POINTS = [ttd.create_state, ttd.train, ttc.create_state, ttc.train, tsr.create_state,
                tsr.train, tinf.generate_frames, ttv.create_state, ttv.train, tcli.main,
                ttl.create_state, ttl.train, ttl.load_params, twlm.train_word_lm,
                tse.NeuralScorer, tse.fit_default_scorer, tface.FaceAlignment,
                te2e.build_word_clip_dataset, te2e.run, ttg.create_state, ttg.train,
                tts.create_state, tts.train, tinf.lipsync_video, tloader.prefetch_to_device,
                tfx.embed_frames, tfx.create_state, tfx.train, tselftest.selftest_densenet]


@pytest.mark.parametrize("fn", ENTRY_POINTS,
                         ids=lambda f: f"{f.__module__.split('.')[-1]}.{f.__name__}")
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default is None


def test_entry_points_raise_without_cuda_instead_of_stepping_down(no_cuda):
    tiny = tcfg.DiffusionConfig(im_size=16, base_channels=32, channel_mult=(1,),
                                num_res_blocks=1, attention_resolutions=(), audio_samples=800)
    tiny_gan = tcfg.GanConfig(model_width=0.125, batch_size=2)
    gan_set = ["--set", "gan.model_width=0.125", "--set", "gan.batch_size=2"]
    calls = [
        lambda: ttd.create_state(tiny),
        lambda: ttd.train(tiny, lambda: None, num_steps=0),
        lambda: ttc.create_state(tcfg.ClassifierConfig(), tiny),
        lambda: ttc.train(tcfg.ClassifierConfig(), tiny, lambda: None, num_steps=0),
        lambda: tsr.create_state(tcfg.SuperResConfig()),
        lambda: tsr.train(tcfg.SuperResConfig(), lambda: None, num_steps=0),
        lambda: tinf.generate_frames({}, torch.zeros(1, 8, 8, 3, dtype=torch.uint8).numpy(),
                                     torch.zeros(1, 4).numpy(), torch.zeros(1, 80, 16).numpy()),
        lambda: ttv.create_state(tcfg.ViViTConfig(num_layers=1)),
        lambda: ttv.train(tcfg.Config(), lambda: iter([]), num_epochs=0),
        lambda: tcli.main(["train-vivit", "--steps", "1", "--set", "vivit.num_layers=1"]),
        lambda: ttl.create_state(),
        lambda: ttl.train(num_steps=0),
        lambda: twlm.train_word_lm(["a b"], steps=0),
        lambda: tse.NeuralScorer(),
        lambda: tse.fit_default_scorer(["a b"] * 8),
        lambda: tface.FaceAlignment(),
        lambda: te2e.build_word_clip_dataset(tcfg.Config(), []),
        lambda: te2e.run(tcfg.Config(), "/nonexistent"),
        lambda: tcli.main(["train-landmark", "--steps", "0"]),
        lambda: tcli.main(["lipread-e2e", "--data-root", "/nonexistent"]),
        lambda: ttg.create_state(tiny_gan),
        lambda: ttg.train(tiny_gan, lambda: None, num_steps=0),
        lambda: tts.create_state(tiny_gan),
        lambda: tts.train(tiny_gan, lambda: None, num_steps=0),
        lambda: tinf.lipsync_video({}, seeded(TS3FD, 0), "face.mp4", "speech.wav", "out.mp4"),
        lambda: tcli.main(["train-gan", "--synthetic", "--steps", "1"] + gan_set),
        lambda: tcli.main(["train-syncnet", "--synthetic", "--steps", "1"] + gan_set),
        lambda: tcli.main(["eval-gan", "--checkpoint", "/nonexistent", "--synthetic"]
                          + gan_set),
        lambda: tcli.main(["infer-lipsync", "--face", "f.mp4", "--audio", "a.wav", "--out",
                           "o.mp4"] + gan_set),
        lambda: tcli.main(["preprocess-gan", "--data-root", "/nonexistent", "--out", "/x"]),
        lambda: tloader.prefetch_to_device(lambda: None),
        lambda: tcli.main(["build-frame-index", "--data-root", "/nonexistent", "--out", "/x"]),
        lambda: tcli.main(["pack-gan-records", "--synthetic", "--out", "/x"]),
        lambda: tcli.main(["pack-diffusion-records", "--synthetic", "--out", "/x"]),
        lambda: tcli.main(["sample-diffusion", "--out", "/x.png"]),
        lambda: tfx.embed_frames({}, np.zeros((1, 5, 32, 32, 1), np.uint8)),
        lambda: tfx.create_state(tcfg.FeatureTransformerConfig()),
        lambda: tfx.train(tcfg.FeatureTransformerConfig(), np.zeros((4, 5, 1024), np.float32),
                          np.zeros(4, np.int64)),
        lambda: tselftest.selftest_densenet("/x/densenet.pt"),
        lambda: tcli.main(["train-feature-transformer", "--synthetic"]),
        lambda: tcli.main(["port-densenet", "--selftest", "--out", "/x/densenet.pt"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_and_chip_smoke_import_no_jax():
    files = sorted((ROOT / "lipreading_video_generation_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    bad = [(str(f.relative_to(ROOT)), mod) for f in files for mod in _imported_modules(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_port_names_no_file_of_the_jax_package_native_loader():
    """The port builds and loads its own prefetch loader: no file of it
    names the JAX package's ``native/`` directory or the library there."""
    pkg = ROOT / "lipreading_video_generation_tpu_torch"
    files = [f for f in pkg.rglob("*") if f.suffix in (".py", ".cpp", ".cu", ".cuh")]
    files.append(ROOT / "chip_smoke.py")
    assert any(f.name == "prefetch_loader.cpp" for f in files)
    bad = [str(f.relative_to(ROOT)) for f in files
           if any(s in f.read_text() for s in ("native/", "tpu/native"))]
    assert bad == []
