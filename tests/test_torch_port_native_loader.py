"""The port's native prefetch loader (``data/native_loader``, built with g++
from ``csrc/prefetch_loader.cpp`` into the port's ``_build/``) and the feed
that hands batches out on a device (``data/loader.prefetch_to_device``)."""
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from lipreading_video_generation_tpu_torch.data import loader as tloader
from lipreading_video_generation_tpu_torch.data import native_loader as nl

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _built():
    if not nl.native_available():
        pytest.skip("no C++ compiler (g++ or c++) here")


def _write_records(tmp_path, n=12, shape=(5, 8, 8, 1)):
    rng = np.random.default_rng(0)
    paths, arrays = [], []
    for i in range(n):
        arr = rng.integers(0, 256, shape, dtype=np.uint8)
        p = str(tmp_path / f"rec{i}.bin")
        nl.write_record_file(p, arr)
        paths.append(p)
        arrays.append(arr)
    return paths, arrays


def test_builds_under_the_port_and_not_the_jax_package():
    lib = nl._lib()
    assert Path(lib._name) == nl.LIB_PATH == (
        ROOT / "lipreading_video_generation_tpu_torch" / "_build" / "libprefetch.so")
    assert nl.SRC == ROOT / "lipreading_video_generation_tpu_torch" / "csrc" / "prefetch_loader.cpp"
    assert "lipreading_video_generation_tpu/" not in str(nl.LIB_PATH.relative_to(ROOT))


def test_reads_all_records_exactly(tmp_path):
    paths, arrays = _write_records(tmp_path)
    with nl.NativePrefetchLoader(paths, (5, 8, 8, 1), np.uint8, num_threads=3) as loader:
        got = dict(iter(loader))
    assert sorted(got) == list(range(len(paths)))
    for i, arr in enumerate(arrays):
        np.testing.assert_array_equal(got[i], arr)


def test_float32_records(tmp_path):
    arr = np.linspace(0, 1, 24, dtype=np.float32).reshape(2, 3, 4)
    p = str(tmp_path / "f.bin")
    nl.write_record_file(p, arr)
    with nl.NativePrefetchLoader([p], (2, 3, 4), np.float32) as loader:
        (_, got), = list(iter(loader))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("what", ["missing", "short"])
def test_failed_read_raises(tmp_path, what):
    paths, _ = _write_records(tmp_path, n=2)
    bad = tmp_path / "bad.bin"
    if what == "short":
        bad.write_bytes(b"\0" * 10)
    paths.append(str(bad))
    with nl.NativePrefetchLoader(paths, (5, 8, 8, 1)) as loader:
        with pytest.raises(IOError, match="bad.bin"):
            list(iter(loader))


def test_bounded_queue_backpressure(tmp_path):
    """More records than the ring holds: the producers wait, none is dropped."""
    paths, arrays = _write_records(tmp_path, n=20)
    with nl.NativePrefetchLoader(paths, (5, 8, 8, 1), capacity=2, num_threads=4) as loader:
        got = dict(iter(loader))
    assert sorted(got) == list(range(20))
    for i, arr in enumerate(arrays):
        np.testing.assert_array_equal(got[i], arr)


def test_no_compiler_means_no_native_route_and_a_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(nl, "find_compiler", lambda: None)
    monkeypatch.setattr(nl, "LIB_PATH", tmp_path / "none.so")
    assert not nl.native_available()
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        nl.build()
    monkeypatch.undo()
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(nl, "SRC", bad)
    monkeypatch.setattr(nl, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(nl, "LIB_PATH", tmp_path / "bad.so")
    with pytest.raises(RuntimeError, match="failed on"):
        nl.build()
    assert os.listdir(tmp_path) == ["bad.cpp"]   # no half-built library left behind


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.integers(0, 256, (2, 4, 4, 3), dtype=np.uint8),
             "a": rng.standard_normal((2, 7)).astype(np.float32)[:, ::-1]} for _ in range(n)]


def test_prefetch_to_device_hands_out_tensors_equal_to_the_host_batches():
    host = _batches(5)
    it = iter(host)
    got = list(tloader.prefetch_to_device(lambda: next(it), device="cpu", depth=2))
    assert len(got) == 5
    for g, h in zip(got, host):
        for k in h:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), h[k])
    feed = iter(host)
    assert len(list(tloader.prefetch_to_device(lambda: next(feed), num_batches=3,
                                               device="cpu"))) == 3
    ends = iter(host[:2] + [None] + host[2:])
    assert len(list(tloader.prefetch_to_device(lambda: next(ends), device="cpu"))) == 2


def test_prefetch_to_device_raises_the_producers_error_and_refuses_a_mesh():
    def broken():
        raise KeyError("no such clip")

    with pytest.raises(KeyError, match="no such clip"):
        list(tloader.prefetch_to_device(broken, device="cpu"))
    # a mesh: each rank copies its rows; the 1×1 mesh copies every row
    from lipreading_video_generation_tpu_torch.parallel.mesh import build_mesh

    with pytest.raises(KeyError, match="no such clip"):
        list(tloader.prefetch_to_device(broken, spec=build_mesh(), device="cpu"))
    batches = iter([{"x": np.arange(6).reshape(3, 2)}] * 2)
    got = list(tloader.prefetch_to_device(lambda: next(batches), spec=build_mesh(),
                                          device="cpu"))
    assert len(got) == 2 and all(torch.equal(b["x"], torch.arange(6).reshape(3, 2))
                                 for b in got)


def test_closing_the_feed_stops_its_producer():
    """Once ``close()`` returns, the producer has ended: ``batch_fn`` is not
    called again."""
    calls = []
    feed = tloader.host_prefetch(lambda: calls.append(1) or {"x": np.zeros(1)}, depth=2)
    next(feed)
    feed.close()
    n = len(calls)
    time.sleep(0.2)
    assert len(calls) == n
