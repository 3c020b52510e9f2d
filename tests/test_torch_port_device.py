"""Where the port runs, and what it imports.

Every entry point that takes a ``device`` defaults to the card
(``core.device.default_device``) and raises without one; the other port
tests pass ``device="cpu"``. The port's package and ``chip_smoke.py`` import
torch, never jax, flax or the JAX package.
"""
import ast
import inspect
from pathlib import Path

import pytest
import torch

from lipreading_video_generation_tpu_torch.core import config as tcfg
from lipreading_video_generation_tpu_torch.core import device as tdev
from lipreading_video_generation_tpu_torch.pipelines import inference as tinf
from lipreading_video_generation_tpu_torch.pipelines import train_classifier as ttc
from lipreading_video_generation_tpu_torch.pipelines import train_diffusion as ttd
from lipreading_video_generation_tpu_torch.pipelines import train_superres as tsr

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "orbax", "lipreading_video_generation_tpu")


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
                tsr.train, tinf.generate_frames]


@pytest.mark.parametrize("fn", ENTRY_POINTS,
                         ids=lambda f: f"{f.__module__.split('.')[-1]}.{f.__name__}")
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default is None


def test_entry_points_raise_without_cuda_instead_of_stepping_down(no_cuda):
    tiny = tcfg.DiffusionConfig(im_size=16, base_channels=32, channel_mult=(1,),
                                num_res_blocks=1, attention_resolutions=(), audio_samples=800)
    calls = [
        lambda: ttd.create_state(tiny),
        lambda: ttd.train(tiny, lambda: None, num_steps=0),
        lambda: ttc.create_state(tcfg.ClassifierConfig(), tiny),
        lambda: ttc.train(tcfg.ClassifierConfig(), tiny, lambda: None, num_steps=0),
        lambda: tsr.create_state(tcfg.SuperResConfig()),
        lambda: tsr.train(tcfg.SuperResConfig(), lambda: None, num_steps=0),
        lambda: tinf.generate_frames({}, torch.zeros(1, 8, 8, 3, dtype=torch.uint8).numpy(),
                                     torch.zeros(1, 4).numpy(), torch.zeros(1, 80, 16).numpy()),
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
