"""The port's lipreading chain end to end — LRS2 tree → word clips → ViViT →
sentence eval, through ``pipelines.lipreading_e2e`` and the CLI's
``lipread-e2e`` / ``train-landmark`` — against the JAX package on a tiny
LRS2 tree written with OpenCV; and ``data.video``."""
import re

import numpy as np
import pytest

import cv2
import torch

from lipreading_video_generation_tpu.core.config import Config as JConfig
from lipreading_video_generation_tpu.data import video as jvideo
from lipreading_video_generation_tpu.data.manifest import build_manifest as jbuild_manifest
from lipreading_video_generation_tpu.pipelines import inference as jinf
from lipreading_video_generation_tpu.pipelines import lipreading_e2e as je2e
from lipreading_video_generation_tpu_torch import cli
from lipreading_video_generation_tpu_torch.core.config import Config, parse_overrides
from lipreading_video_generation_tpu_torch.data import video as tvideo
from lipreading_video_generation_tpu_torch.data.manifest import build_manifest
from lipreading_video_generation_tpu_torch.models import s3fd as ts3fd
from lipreading_video_generation_tpu_torch.models.convert import s3fd_state_dict_from_flax
from lipreading_video_generation_tpu_torch.pipelines import inference as tinf
from lipreading_video_generation_tpu_torch.pipelines import lipreading_e2e as te2e
from test_torch_port_lipread_detect import flax_s3fd_params

TINY_VIVIT = ["vivit.hidden_size=32", "vivit.num_layers=1", "vivit.num_heads=4",
              "vivit.mlp_dim=32", "vivit.dtype=float32", "vivit.batch_size=4"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lrs2_tree(tmp_path_factory):
    """Two LRS2-layout clips of 14 frames of 64×64 (a drawn face on noise)
    with two aligned words each, as ``tests/test_lipreading_e2e.py`` writes
    them."""
    root = tmp_path_factory.mktemp("lrs2")
    rng = np.random.default_rng(0)
    for ci, (w1, w2) in enumerate([("HELLO", "WORLD"), ("HELLO", "AGAIN")]):
        d = root / f"spk{ci}"
        d.mkdir()
        wtr = cv2.VideoWriter(str(d / "00001.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 25.0,
                              (64, 64))
        for _ in range(14):
            img = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
            cv2.circle(img, (32, 32), 20, (180, 150, 130), -1)
            wtr.write(img)
        wtr.release()
        (d / "00001.txt").write_text(f"Text:  {w1} {w2}\n\nConf: 4\n\nWORD START END SCORE\n"
                                     f"{w1} 0.00 0.24 1.0\n{w2} 0.24 0.52 1.0\n")
    return str(root)


def test_build_word_clip_dataset_matches_jax(lrs2_tree, monkeypatch):
    """The same S3FD weights on both sides: face tracks within 1e-3 px;
    equal words, labels, sentence starts, vocab and transcripts; ROI clips
    within the K1 bound of ``tests/test_torch_port_slice.py`` (JAX blends
    the CLAHE LUTs in bf16, the port in float32: at most 2 levels apart,
    ≥ 99% within 1) from the same (JAX's) tracks: each side's own tracks
    differ by float32 noise, which can move a gray value across a histogram
    bin and a tile's LUT entry by a step (ROADMAP §3, PR 1)."""
    params = flax_s3fd_params(0)
    model = ts3fd.S3FD().eval()
    model.load_state_dict(s3fd_state_dict_from_flax(params))
    jtracks, ttracks = [], []
    j_real, t_real = jinf.detect_face_tracks, tinf.detect_face_tracks
    monkeypatch.setattr(jinf, "detect_face_tracks",
                        lambda *a, **k: jtracks.append(j_real(*a, **k)) or jtracks[-1])
    want = je2e.build_word_clip_dataset(
        JConfig(), jbuild_manifest(lrs2_tree, require_transcript=True)[0], s3fd_params=params)
    records = build_manifest(lrs2_tree, require_transcript=True)[0]

    def port_tracks(*a, **k):
        ttracks.append(t_real(*a, **k))
        return torch.tensor(jtracks[len(ttracks) - 1])

    monkeypatch.setattr(tinf, "detect_face_tracks", port_tracks)
    got = te2e.build_word_clip_dataset(Config(), records, s3fd_params=model, device="cpu")
    assert len(jtracks) == len(ttracks) == 2
    for t, j in zip(ttracks, jtracks):
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-3)
    assert got.words == want.words and got.vocab == want.vocab
    assert got.sentence_start_idx == want.sentence_start_idx == [0, 2]
    assert got.transcripts == want.transcripts
    np.testing.assert_array_equal(got.labels, want.labels)
    assert len(got.clips) == len(want.clips) == 4
    for g, w in zip(got.clips, want.clips):
        assert g.shape == w.shape == (5, 32, 32, 1) and g.dtype == np.uint8
    d = np.abs(np.stack(got.clips).astype(np.int32) - np.stack(want.clips).astype(np.int32))
    assert d.max() <= 2 and (d <= 1).mean() >= 0.99, (d.max(), (d <= 1).mean())


def test_run_reads_frames_through_the_seam_and_an_s3fd_checkpoint(lrs2_tree, tmp_path):
    """``run`` on the CPU: records' frames come through ``read_frames``
    (a record whose reader raises is skipped), the detector from a
    ``torch.save``d state dict in ``s3fd.pth``'s layout; word and sentence
    accuracies in [0, 1]."""
    sd = ts3fd.S3FD().state_dict()
    torch.save(sd, tmp_path / "s3fd.pt")
    read = []

    def read_frames(path):
        read.append(path)
        if "spk1" in path:
            raise OSError("unreadable")
        return tvideo.read_video_frames(path)

    cfg = parse_overrides(Config(), TINY_VIVIT)
    state, stats = te2e.run(cfg, lrs2_tree, num_epochs=1, s3fd_checkpoint=str(tmp_path / "s3fd.pt"),
                            read_frames=read_frames, device="cpu")
    assert len(read) == 2
    assert 0.0 <= stats["accuracy"] <= 1.0 and 0.0 <= stats["sentence_accuracy"] <= 1.0
    assert state.model.cfg.num_classes == 4           # [UNK] HELLO WORLD AGAIN


def test_cli_train_landmark_then_lipread_e2e(lrs2_tree, tmp_path, capsys):
    """``train-landmark --out`` then ``lipread-e2e --landmark-checkpoint``
    through ``cli.main(..., device="cpu")``: the landmark params round-trip
    and both accuracies print, in [0, 1]."""
    out = str(tmp_path / "lm")
    assert cli.main(["train-landmark", "--steps", "2", "--batch-size", "4", "--out", out],
                    device="cpu") == 0
    assert f"saved landmark params → {out}" in capsys.readouterr().out
    argv = ["lipread-e2e", "--data-root", lrs2_tree, "--epochs", "1",
            "--landmark-checkpoint", out]
    assert cli.main(argv + [a for s in TINY_VIVIT for a in ("--set", s)], device="cpu") == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("word accuracy=")]
    assert len(line) == 1
    word, sentence = map(float, re.findall(r"accuracy=([0-9.]+)", line[0]))
    assert 0.0 <= word <= 1.0 and 0.0 <= sentence <= 1.0


def test_video_io_matches_jax(tmp_path):
    """``write_video`` / ``read_video_frames`` / ``video_frame_count`` and the
    wav IO give what the JAX package's give."""
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (6, 32, 48, 3), dtype=np.uint8)
    path = str(tmp_path / "v.mp4")
    tvideo.write_video(path, frames)
    got, fps = tvideo.read_video_frames(path)
    want, jfps = jvideo.read_video_frames(path)
    np.testing.assert_array_equal(got, want)
    assert fps == jfps == 25.0 and got.shape == frames.shape
    assert tvideo.video_frame_count(path) == jvideo.video_frame_count(path) == 6
    small, _ = tvideo.read_video_frames(path, max_frames=2, resize=(16, 24), to_rgb=False)
    np.testing.assert_array_equal(small, jvideo.read_video_frames(
        path, max_frames=2, resize=(16, 24), to_rgb=False)[0])
    wav = np.sin(np.linspace(0, 40, 8000)).astype(np.float32)
    tvideo.save_wav(str(tmp_path / "a.wav"), wav, sr=8000)
    np.testing.assert_array_equal(tvideo.load_wav(str(tmp_path / "a.wav")),
                                  jvideo.load_wav(str(tmp_path / "a.wav")))
    with pytest.raises(FileNotFoundError):
        tvideo.read_video_frames(str(tmp_path / "missing.mp4"))


def test_video_io_without_opencv_says_what_needs_it(monkeypatch):
    """Where ``cv2`` cannot be imported, decoding raises ``ImportError``
    naming the function and the ``read_frames`` way around it."""
    import importlib

    real = importlib.import_module

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(importlib, "import_module", no_cv2)
    with pytest.raises(ImportError, match="read_video_frames needs OpenCV.*read_frames"):
        tvideo.read_video_frames("x.mp4")
