"""Packed records of the port (``lipreading_video_generation_tpu_torch.data.
records``) against the JAX package's: the same bytes from the same samples
and seeds, records of either package read back by the other, the feed's
routes, looping and the trailing partial batch.

The JAX package reads the port's records by its plain route only: its
native loader builds in place in the JAX package's tree, which two test
processes must not do at once."""
import filecmp
import os

import numpy as np
import pytest

from lipreading_video_generation_tpu.data import datasets as jdata
from lipreading_video_generation_tpu.data import records as jrec
from lipreading_video_generation_tpu_torch.data import datasets as tdata
from lipreading_video_generation_tpu_torch.data import records as trec


def _clips():
    return tdata.synthetic_gan_clips(n_clips=3, frames=18, img=16, seed=1)


def _gan_sample(rng, t=5, hw=16, wav=700, text=0):
    s = {"window": rng.integers(0, 256, (t, hw, hw, 3), dtype=np.uint8),
         "wrong_window": rng.integers(0, 256, (t, hw, hw, 3), dtype=np.uint8),
         "start_frame": np.int32(rng.integers(0, 20)),
         "wav": rng.standard_normal(wav).astype(np.float32)}
    if text:
        s["text_tokens"] = rng.integers(0, 30, text).astype(np.int32)
    return s


def _tensor_sample(rng):
    return {"cond_frame": rng.integers(0, 256, (16, 16, 3), dtype=np.uint8),
            "target_frame": rng.integers(0, 256, (16, 16, 3), dtype=np.uint8),
            "audio": rng.standard_normal(100).astype(np.float32)}


SPECS = {
    "gan": (lambda m: m.GanRecordSpec(5, 16, 16, 600), lambda r: _gan_sample(r)),
    "gan_text": (lambda m: m.GanRecordSpec(5, 16, 16, 700, max_text_len=12),
                 lambda r: _gan_sample(r, text=12)),
    "diffusion": (lambda m: m.diffusion_record_spec(16, 100), _tensor_sample),
    "tensor": (lambda m: m.TensorRecordSpec(fields=(("x", (2, 3), "float32"),
                                                    ("y", (), "int32"))),
               lambda r: {"x": r.standard_normal((2, 3)).astype(np.float32),
                          "y": np.int32(7)}),
}


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_spec_bytes_equal_jax(kind, tmp_path):
    """pack → the JAX spec's bytes (the GAN wav cut to wav_len), unpack
    gives the sample back, and records_spec.json is the same file, which
    load_spec reads back into the same spec on either side."""
    make, sample_fn = SPECS[kind]
    tspec, jspec = make(trec), make(jrec)
    sample = sample_fn(np.random.default_rng(0))
    raw = tspec.pack(sample)
    assert raw == jspec.pack(sample) and len(raw) == tspec.record_bytes == jspec.record_bytes
    out = tspec.unpack(np.frombuffer(raw, np.uint8))
    for k, v in jspec.unpack(np.frombuffer(raw, np.uint8)).items():
        np.testing.assert_array_equal(out[k], v, err_msg=k)
        assert out[k].dtype == v.dtype and out[k].flags.c_contiguous
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tspec.save(str(tmp_path / "t"))
    jspec.save(str(tmp_path / "j"))
    assert filecmp.cmp(tmp_path / "t" / trec.SPEC_FILENAME, tmp_path / "j" / jrec.SPEC_FILENAME,
                       shallow=False)
    assert trec.load_spec(str(tmp_path / "j")) == tspec


@pytest.mark.parametrize("kind,bad", [("gan", {"window": np.zeros((4, 16, 16, 3), np.uint8)}),
                                      ("diffusion", {"cond_frame": np.zeros((8, 8, 3), np.uint8)})])
def test_shape_mismatch_raises(kind, bad):
    make, sample_fn = SPECS[kind]
    sample = dict(sample_fn(np.random.default_rng(0)), **bad)
    with pytest.raises(ValueError, match="shape"):
        make(trec).pack(sample)


def _same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False), n
    return names


def test_write_gan_records_equal_jax(tmp_path):
    """The same clips and sampler seed: the same files, byte for byte (the
    probe draw included)."""
    clips = _clips()
    tspec = trec.write_gan_records(tdata.GanWindowSampler(clips, seed=3), str(tmp_path / "t"), 5)
    jspec = jrec.write_gan_records(jdata.GanWindowSampler(
        [jdata.GanClip(c.frames, c.wav) for c in clips], seed=3), str(tmp_path / "j"), 5)
    assert _same_tree(tmp_path / "t", tmp_path / "j") == [f"{i:06d}.rec" for i in range(5)] + [
        trec.SPEC_FILENAME]
    assert tspec.record_bytes == jspec.record_bytes


class _PairSampler:
    """Frame pairs at ``res`` (bigger than the train size, as videos are) and
    80-sample audio, from ``np.random.default_rng(seed)``."""

    def __init__(self, seed=0, res=16):
        self.rng, self.res = np.random.default_rng(seed), res

    def sample_batch(self, n):
        r = self.res
        return {"cond_frame": self.rng.integers(0, 256, (n, r, r, 3), dtype=np.uint8),
                "target_frame": self.rng.integers(0, 256, (n, r, r, 3), dtype=np.uint8),
                "audio": self.rng.standard_normal((n, 80)).astype(np.float32)}


def test_write_diffusion_records_equal_jax_at_train_size(tmp_path):
    trec.write_diffusion_records(_PairSampler(5), str(tmp_path / "t"), 4, im_size=16)
    jrec.write_diffusion_records(_PairSampler(5), str(tmp_path / "j"), 4, im_size=16)
    _same_tree(tmp_path / "t", tmp_path / "j")


def test_write_diffusion_records_resized_within_one_level_of_jax(tmp_path):
    """160 → 128 on the CPU: uint8 ties of the two resizes may round apart
    by one level (ROADMAP §3, known differences); the audio is equal."""
    trec.write_diffusion_records(_PairSampler(6, 160), str(tmp_path / "t"), 2, im_size=128)
    jrec.write_diffusion_records(_PairSampler(6, 160), str(tmp_path / "j"), 2, im_size=128)
    spec = trec.load_spec(str(tmp_path / "t"))
    for pt, pj in zip(trec.record_paths(str(tmp_path / "t")),
                      jrec.record_paths(str(tmp_path / "j"))):
        a, b = (spec.unpack(np.fromfile(p, np.uint8)) for p in (pt, pj))
        np.testing.assert_array_equal(a["audio"], b["audio"])
        for k in ("cond_frame", "target_frame"):
            assert a[k].shape == (128, 128, 3)
            assert np.abs(a[k].astype(int) - b[k].astype(int)).max() <= 1, k


def _samples(batches):
    return [{k: v[i] for k, v in b.items()} for b in batches for i in range(len(b["window"]))]


def _key(s):
    return b"".join(np.ascontiguousarray(v).tobytes() for _, v in sorted(s.items()))


@pytest.mark.parametrize("native", [True, False])
def test_jax_records_read_back_through_the_port(tmp_path, native):
    """Records written by the JAX package (with a transcript section)
    through the port's feed: in file order by plain reads, as a multiset by
    the native loader's threads; the route is counted."""
    d = str(tmp_path / "recs")
    jclips = jdata.synthetic_gan_clips(n_clips=3, frames=18, img=16, seed=2, with_text=True)
    jspec = jrec.write_gan_records(jdata.GanWindowSampler(jclips, seed=0, with_text=True), d, 7)
    assert jspec.max_text_len > 0
    want = [jspec.unpack(np.fromfile(p, np.uint8)) for p in jrec.record_paths(d)]
    before = dict(trec.iter_record_batches.route_counts)
    batches = list(trec.iter_record_batches(d, 3, loop=False, prefer_native=native,
                                            num_threads=3))
    route = "native" if native else "plain"
    assert trec.iter_record_batches.route_counts[route] == before[route] + 1
    assert [len(b["window"]) for b in batches] == [3, 3, 1]
    assert batches[0]["text_tokens"].dtype == np.int32
    got = _samples(batches)
    if native:
        assert sorted(map(_key, got)) == sorted(map(_key, want))
    else:
        assert list(map(_key, got)) == list(map(_key, want))


def test_port_records_read_back_through_jax(tmp_path):
    d = str(tmp_path / "recs")
    tspec = trec.write_gan_records(tdata.GanWindowSampler(_clips(), seed=4), d, 4)
    want = [tspec.unpack(np.fromfile(p, np.uint8)) for p in trec.record_paths(d)]
    got = _samples(jrec.iter_record_batches(d, 2, loop=False, prefer_native=False))
    assert list(map(_key, got)) == list(map(_key, want))
    native = _samples(trec.iter_record_batches(d, 2, loop=False, num_threads=1))
    assert list(map(_key, native)) == list(map(_key, want))


@pytest.mark.parametrize("native", [True, False])
def test_loop_and_trailing_partial_batch(tmp_path, native):
    """``loop`` goes round the files for ever in whole batches; without it
    the last batch holds the rest; an empty directory raises."""
    d = str(tmp_path / "recs")
    trec.write_diffusion_records(_PairSampler(1), d, 5, im_size=16)
    looped = trec.iter_record_batches(d, 2, prefer_native=native, num_threads=1)
    sizes = [len(next(looped)["audio"]) for _ in range(6)]
    looped.close()
    assert sizes == [2] * 6
    once = trec.iter_record_batches(d, 2, loop=False, prefer_native=native)
    assert [len(b["audio"]) for b in once] == [2, 2, 1]
    (tmp_path / "empty").mkdir()
    trec.TensorRecordSpec(fields=()).save(str(tmp_path / "empty"))
    with pytest.raises(ValueError, match="no .rec files"):
        next(trec.iter_record_batches(str(tmp_path / "empty"), 2))
