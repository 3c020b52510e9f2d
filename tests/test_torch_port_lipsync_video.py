"""The port's lip-sync serving entry point, ``lipsync_video``, against the JAX
package's on a tiny clip: 8 frames of 64×64 (a drawn face on noise) written
as an mp4 with OpenCV, a 0.32 s wav, the generator at width 0.125 and S3FD
on the same weights (numpy-made, in each Flax module's tree). JAX reads the
file; the port reads the same file, or is handed the decoded frames through
its ``read_frames`` seam, and keeps its output through ``write_video``. Also
the input conditioning (``prepare_input_frames``: resize factor, rotation,
crop, a still image) bit for bit, and the port's own knobs and guards.

Bounds: face boxes within 1e-2 px (float32 noise of two VGG16s and box
decodes); output frames within 2 gray levels, at least 99% within 1 (the
generator's float32 output, resized into boxes that differ by that noise,
rounded to uint8).
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lipreading_video_generation_tpu.core.config import GanConfig as JGanCfg
from lipreading_video_generation_tpu.models.generator import TalkingFaceGenerator as JGen
from lipreading_video_generation_tpu.data.manifest import ClipRecord as JClipRecord
from lipreading_video_generation_tpu.pipelines import inference as jinf
from lipreading_video_generation_tpu.pipelines import offline_preprocess as jpre
from lipreading_video_generation_tpu_torch.core.config import GanConfig
from lipreading_video_generation_tpu_torch.data import video as tvideo
from lipreading_video_generation_tpu_torch.data.manifest import ClipRecord, build_manifest
from lipreading_video_generation_tpu_torch.models import convert
from lipreading_video_generation_tpu_torch.models import s3fd as ts3fd
from lipreading_video_generation_tpu_torch.ops import matmul_cuda as tmm
from lipreading_video_generation_tpu_torch.pipelines import inference as tinf
from lipreading_video_generation_tpu_torch.pipelines import offline_preprocess as tpre

HW, N, WIDTH = 64, 8, 0.125


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


def _s3fd_params(seed: int) -> dict:
    """Weights in the Flax ``S3FD``'s tree, made with numpy (the detection
    tests' recipe: HWIO kernels ~ N(0, 1/fan_in), the classifier heads at 3×
    so that the face scores spread, small biases, the L2Norm scales at their
    init)."""
    rng = np.random.default_rng(seed)
    params = {}
    with torch.device("meta"):
        shapes = ts3fd.S3FD().state_dict()
    for name, p in shapes.items():
        mod, leaf = name.rsplit(".", 1)
        if p.ndim == 4:
            o, i, kh, kw = p.shape
            std = np.sqrt(1.0 / (i * kh * kw)) * (3.0 if mod.endswith("_conf") else 1.0)
            params.setdefault(mod, {})["kernel"] = (
                std * rng.standard_normal((kh, kw, i, o))).astype(np.float32)
        elif leaf == "bias":
            params[mod]["bias"] = (0.01 * rng.standard_normal(p.shape)).astype(np.float32)
        else:
            scale = dict((n, c) for n, _, c in ts3fd._NORMS)[mod]
            params[mod] = {"weight": np.full(p.shape, scale, np.float32)}
    return params


def _gen_params(seed: int) -> dict:
    """The Flax generator's param tree (``jax.eval_shape`` of its init),
    filled from seeded numpy."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(JGen(width=WIDTH).init, jax.random.key(0),
                            jnp.zeros((1, 80, 16, 1)), jnp.zeros((1, 96, 96, 6)))["params"]

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            v = rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name.endswith("['scale']"):
            v = 1.0 + 0.05 * rng.standard_normal(leaf.shape)
        else:
            v = 0.05 * rng.standard_normal(leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """face.mp4 (8 frames of 64×64, a face drawn on noise, moving), speech.wav
    (0.32 s), and the weights."""
    root = tmp_path_factory.mktemp("lipsync")
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (N, HW, HW, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:HW, 0:HW]
    for t in range(N):
        frames[t][((xx - 30 - t) / 18) ** 2 + ((yy - 30) / 24) ** 2 <= 1] = (190, 160, 140)
    face = str(root / "face.mp4")
    tvideo.write_video(face, frames, 25.0)
    wav = str(root / "speech.wav")
    t = np.arange(int(16000 * N / 25)) / 16000
    tvideo.save_wav(wav, (0.3 * np.sin(2 * np.pi * 220 * t)
                          + 0.05 * rng.standard_normal(len(t))).astype(np.float32))
    s3fd = ts3fd.S3FD().eval()
    s3fd_params = _s3fd_params(0)
    s3fd.load_state_dict(convert.s3fd_state_dict_from_flax(s3fd_params))
    gen_params = _gen_params(1)
    return {"root": root, "face": face, "wav": wav, "s3fd": s3fd, "s3fd_params": s3fd_params,
            "gen_params": gen_params,
            "gen_sd": convert.generator_state_dict_from_flax(gen_params)}


# JAX's S3FD detection compiled as one program (op by op it costs ~20 s of CPU)
_JAX_DETECT = jax.jit(jinf.detect_faces, static_argnums=(0,),
                      static_argnames=("score_threshold", "nms_threshold"))


@pytest.fixture(scope="module")
def jax_result(clip):
    """JAX's ``lipsync_video`` on the clip, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinf, "detect_faces", _JAX_DETECT)
        return jinf.lipsync_video(clip["gen_params"], clip["s3fd_params"], clip["face"],
                                  clip["wav"], str(clip["root"] / "jax.mp4"),
                                  JGanCfg(model_width=WIDTH), model_width=WIDTH)


def _port(clip, **kw):
    kw.setdefault("gan_cfg", GanConfig(model_width=WIDTH))
    return tinf.lipsync_video(clip["gen_sd"], clip["s3fd"], clip["face"], clip["wav"],
                              str(clip["root"] / "port.mp4"), model_width=WIDTH,
                              device="cpu", **kw)


def _frames_close(got, want):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert got.shape == want.shape and got.dtype == np.uint8
    assert d.max() <= 2 and (d <= 1).mean() >= 0.99, (d.max(), (d <= 1).mean())


def test_lipsync_video_matches_jax(clip, jax_result):
    """The file path on both sides: the same frame count (the audio's length
    at the video's fps), boxes and output frames; the silent video is written
    and muxed with ffmpeg where it is installed, as JAX's."""
    got = _port(clip)
    assert isinstance(got, tinf.InferenceResult)
    assert len(got.frames) == len(jax_result.frames) == N
    np.testing.assert_allclose(got.boxes, np.asarray(jax_result.boxes), rtol=0, atol=1e-2)
    _frames_close(got.frames, jax_result.frames)
    assert got.muxed == jax_result.muxed
    assert (clip["root"] / "port.mp4").exists()
    assert not (clip["root"] / "port.mp4.silent.mp4").exists()
    assert not (clip["root"] / "port.mp4.wav").exists()


def test_lipsync_video_from_memory(clip, jax_result):
    """Frames handed over by ``read_frames`` and kept by a ``write_video``
    that writes no file: the same result as JAX's, ``muxed`` False, nothing
    on disk."""
    frames, fps = tvideo.read_video_frames(clip["face"])
    kept = {}

    def keep(path, out, fps_out):
        kept.update(path=path, frames=out, fps=fps_out)

    out = str(clip["root"] / "memory.mp4")
    got = tinf.lipsync_video(clip["gen_sd"], clip["s3fd"], "in-memory", clip["wav"], out,
                             GanConfig(model_width=WIDTH), model_width=WIDTH, device="cpu",
                             read_frames=lambda path, *conditioning: (frames, fps),
                             write_video=keep)
    assert kept["fps"] == fps and kept["frames"] is got.frames and not got.muxed
    assert not (clip["root"] / "memory.mp4").exists()
    np.testing.assert_allclose(got.boxes, np.asarray(jax_result.boxes), rtol=0, atol=1e-2)
    _frames_close(got.frames, jax_result.frames)


def test_lipsync_video_knobs_and_guards(clip, monkeypatch):
    """``static_frame`` repeats the first frame; dynamic int8 runs every
    generator conv through K6's plain version on the CPU; a non-finite mel
    is refused; the 1×1 mesh of one process gives the same frames."""
    seen = {}
    real = tinf.detect_face_tracks

    def spy(s3fd, frames, *a, **kw):
        seen["frames"] = np.asarray(frames)
        return real(s3fd, frames, *a, **kw)

    monkeypatch.setattr(tinf, "detect_face_tracks", spy)
    res = _port(clip, static_frame=True, nosmooth=True, pads=(0, 0, 0, 0))
    assert len(res.frames) == N and all(np.array_equal(f, seen["frames"][0])
                                        for f in seen["frames"])
    before = tmm.int8_matmul.launch_count
    float_out = _port(clip).frames
    int8_out = _port(clip, gan_cfg=GanConfig(model_width=WIDTH, serve_int8=True)).frames
    assert tmm.int8_matmul.launch_count == before       # the CPU runs the plain version
    assert np.abs(int8_out.astype(np.float32) - float_out).mean() < 8
    monkeypatch.setattr(tvideo, "load_wav", lambda *a: np.full(5120, np.nan, np.float32))
    with pytest.raises(ValueError, match="NaN/inf"):
        _port(clip)
    from lipreading_video_generation_tpu_torch.parallel.mesh import build_mesh

    monkeypatch.undo()
    np.testing.assert_array_equal(_port(clip, mesh_spec=build_mesh()).frames, float_out)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(resize_factor=2),
    dict(rotate=True, crop=(2, -1, 3, 40)),
    dict(resize_factor=2, rotate=True, crop=(0, 20, 5, -1)),
], ids=["plain", "resize", "rotate_crop", "all"])
def test_prepare_input_frames_matches_jax(clip, kw):
    args = (kw.get("resize_factor", 1), kw.get("rotate", False), kw.get("crop", (0, -1, 0, -1)))
    got, fps = tinf.prepare_input_frames(clip["face"], *args)
    want, jfps = jinf.prepare_input_frames(clip["face"], *args)
    assert fps == jfps and got.dtype == np.uint8 and np.array_equal(got, want)


def test_still_image_input_matches_jax(clip):
    import cv2

    path = str(clip["root"] / "still.png")
    cv2.imwrite(path, np.random.default_rng(2).integers(0, 256, (30, 20, 3), np.uint8))
    got, fps = tinf.prepare_input_frames(path)
    want, jfps = jinf.prepare_input_frames(path)
    assert got.shape == (1, 30, 20, 3) and np.array_equal(got, want) and fps == jfps == 25.0
    with pytest.raises(FileNotFoundError):
        tinf.prepare_input_frames(str(clip["root"] / "missing.png"))


def test_process_clip_matches_jax(clip, tmp_path, monkeypatch):
    """One LRS2-style clip (mp4, sidecar wav, transcript) through both
    packages' ``process_clip``: the same crops (the boxes' integer parts),
    wav and transcript; the port's ``preprocess_dataset`` shards and counts
    like JAX's (a missing video fails, is counted, and does not stop it)."""
    import shutil

    data = tmp_path / "lrs2" / "spk"
    data.mkdir(parents=True)
    shutil.copyfile(clip["face"], data / "00001.mp4")
    shutil.copyfile(clip["wav"], data / "00001.wav")
    (data / "00001.txt").write_text("Text:  HELLO THERE\nConf:  5\n")
    records, _ = build_manifest(str(tmp_path / "lrs2"))
    rec = records[0]
    monkeypatch.setattr(jinf, "detect_faces", _JAX_DETECT)
    want = jpre.process_clip(clip["s3fd_params"], JClipRecord(
        rec.clip_id, rec.video_path, rec.transcript_path), str(tmp_path / "jax"))
    got = tpre.process_clip(clip["s3fd"], rec, str(tmp_path / "port"))
    import cv2

    names = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == names and "text.txt" in names and "audio.wav" in names
    for name in names:
        if name.endswith(".jpg"):
            assert np.array_equal(cv2.imread(os.path.join(got, name)),
                                  cv2.imread(os.path.join(want, name))), name
        else:
            with open(os.path.join(got, name), "rb") as a, open(os.path.join(want, name),
                                                                 "rb") as b:
                assert a.read() == b.read(), name
    missing = ClipRecord("spk/00002", str(data / "00002.mp4"))
    ok_failed = tpre.preprocess_dataset(clip["s3fd"], [rec, missing, rec],
                                        str(tmp_path / "all"), host_id=0, num_hosts=2)
    assert ok_failed == (2, 0)
    assert tpre.preprocess_dataset(clip["s3fd"], [rec, missing], str(tmp_path / "all"),
                                   host_id=1, num_hosts=2) == (0, 1)
    assert tpre.shard_for_host(list(range(7)), 1, 3) == jpre.shard_for_host(list(range(7)), 1, 3)
