"""The diffusion side of the port's ``data/datasets`` against the JAX
package's, on mp4s written with OpenCV here and through the frame-source
seams (``frame_count=``, ``read_frames=``) that serve where OpenCV is
absent; and the port's PNG writer against OpenCV's."""
import dataclasses
import pickle

import cv2
import numpy as np
import pytest

from lipreading_video_generation_tpu.data import datasets as jdata
from lipreading_video_generation_tpu_torch.core.config import DiffusionConfig
from lipreading_video_generation_tpu_torch.data import datasets as tdata
from lipreading_video_generation_tpu_torch.data import video as tvideo

CFG = DiffusionConfig(audio_samples=1200)


def _write_clip(root, name, frames, seed, wav=True):
    """A 48x40 mp4 of ``frames`` random frames at 25 fps and, with ``wav``,
    a sidecar wav as long as the clip."""
    root.mkdir(parents=True, exist_ok=True)
    path = str(root / f"{name}.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (48, 40))
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        w.write(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8))
    w.release()
    if wav:
        tvideo.save_wav(str(root / f"{name}.wav"),
                        rng.standard_normal(640 * frames).astype(np.float32))
    return path


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos") / "spk"
    return [_write_clip(root, "a", 20, 0), _write_clip(root, "b", 15, 1),
            _write_clip(root, "c", 9, 2, wav=False)]


@pytest.fixture(scope="module")
def decoded(clips):
    """Each clip's frames and fps as OpenCV decodes them (the seams' source)."""
    return {p: tvideo.read_video_frames(p) for p in clips}


def _tuples(items):
    return [(it.video_path, it.frame_start, it.frame_end) for it in items]


def test_build_frame_index_equals_jax(clips, decoded):
    want = _tuples(jdata.build_frame_index(clips, step=6))
    assert want and _tuples(tdata.build_frame_index(clips, step=6)) == want
    seam = tdata.build_frame_index(clips, step=6, frame_count=lambda p: len(decoded[p][0]))
    assert _tuples(seam) == want
    assert _tuples(tdata.build_frame_index(clips, step=4)) == _tuples(
        jdata.build_frame_index(clips, step=4))


@dataclasses.dataclass
class Reference:
    """An item of the reference's own index pickles: another class with the
    same three attributes."""

    video_path: str
    frame_start: int
    frame_end: int


def test_frame_index_pickles_are_interchangeable(clips, tmp_path):
    items = tdata.build_frame_index(clips)
    tdata.save_frame_index(items, str(tmp_path / "t.pkl"))
    jdata.save_frame_index(jdata.build_frame_index(clips), str(tmp_path / "j.pkl"))
    assert (tmp_path / "t.pkl").read_bytes() == (tmp_path / "j.pkl").read_bytes()
    assert tdata.load_frame_index(str(tmp_path / "j.pkl")) == items
    assert _tuples(jdata.load_frame_index(str(tmp_path / "t.pkl"))) == _tuples(items)
    mixed = [items[0], list(_tuples(items)[1]), Reference(*_tuples(items)[2])]
    with open(tmp_path / "m.pkl", "wb") as f:
        pickle.dump(mixed, f)
    assert tdata.load_frame_index(str(tmp_path / "m.pkl")) == items[:3]


@pytest.mark.parametrize("n,train,val,seed", [(100, 0.8, 0.1, 1), (37, 0.6, 0.2, 5)])
def test_split_records_equals_jax(n, train, val, seed):
    got, want = (m.split_records(list(range(n)), train, val, seed) for m in (tdata, jdata))
    assert got == want
    assert sorted(sum(got, [])) == list(range(n))


@pytest.mark.parametrize("seam", [False, True])
def test_diffusion_pair_sampler_equals_jax(clips, decoded, seam):
    """The same index and seed: the same batches (a clip without a sidecar
    wav has silence), decoded by OpenCV or handed in through read_frames."""
    items = jdata.build_frame_index(clips, step=4)
    kw = {"read_frames": decoded.__getitem__} if seam else {}
    tsamp = tdata.DiffusionPairSampler(tdata.build_frame_index(clips, step=4), 1200, 3, seed=7,
                                       cache_size=2, **kw)
    jsamp = jdata.DiffusionPairSampler(items, 1200, 3, seed=7, cache_size=2)
    for _ in range(3):
        got, want = tsamp.sample_batch(4), jsamp.sample_batch(4)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(tsamp._cache) <= 2


@pytest.mark.parametrize("seam", [False, True])
def test_condition_from_video_equals_jax(clips, decoded, seam, tmp_path):
    kw = {"read_frames": decoded.__getitem__} if seam else {}
    for path in clips[:2]:
        got, want = tdata.condition_from_video(path, CFG, **kw), jdata.condition_from_video(
            path, CFG)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        got = tdata.condition_windows_from_video(path, CFG, 5, **kw)
        want = jdata.condition_windows_from_video(path, CFG, 5)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].shape == (5, 1200) and got[2] == want[2]
    wav = str(tmp_path / "explicit.wav")
    tvideo.save_wav(wav, np.random.default_rng(3).standard_normal(4000).astype(np.float32))
    got = tdata.condition_from_video(clips[2], CFG, audio_path=wav, **kw)
    np.testing.assert_array_equal(got[1], jdata.condition_from_video(clips[2], CFG,
                                                                     audio_path=wav)[1])


def test_clip_without_audio_raises_naming_ffmpeg(clips, monkeypatch):
    monkeypatch.setattr(tvideo, "FFMPEG", None)
    with pytest.raises(ValueError, match="install ffmpeg"):
        tdata.condition_from_video(clips[2], CFG)


def test_load_full_video_sample_equals_jax(clips, tmp_path):
    txt = tmp_path / "t.txt"
    txt.write_text("Text:  HELLO THERE\n\nConf: 4\n")
    for path, transcript in ((clips[0], str(txt)), (clips[2], None)):
        got = tdata.load_full_video_sample(path, transcript)
        want = jdata.load_full_video_sample(path, transcript)
        assert got["text"] == want["text"] and got["fps"] == want["fps"]
        np.testing.assert_array_equal(got["frames"], want["frames"])
        np.testing.assert_array_equal(got["audio"], want["audio"])


def test_png_decodes_under_opencv_to_what_imwrite_wrote(tmp_path):
    img = np.random.default_rng(4).integers(0, 256, (33, 21, 3), dtype=np.uint8)
    tvideo.write_png(str(tmp_path / "port.png"), img)
    cv2.imwrite(str(tmp_path / "cv2.png"), img[:, :, ::-1])
    ours = cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED)
    theirs = cv2.imread(str(tmp_path / "cv2.png"), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours[:, :, ::-1], img)
    tvideo.write_image(str(tmp_path / "x.jpg"), img)    # other formats: OpenCV
    assert cv2.imread(str(tmp_path / "x.jpg")).shape == (33, 21, 3)
    with pytest.raises(ValueError, match="uint8"):
        tvideo.write_png(str(tmp_path / "bad.png"), img.astype(np.float32))
