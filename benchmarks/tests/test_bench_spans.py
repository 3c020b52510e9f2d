"""The readers of the program's own spans (``program_spans.py`` and the six
metrics on it): hand-computed values on a hand-built Chrome trace, a kernel
launched from another thread inside a span's time included; and a tiny
run of each cell, whose span metrics come out as a number or not at all."""
import time
import types

import pytest

import tiny
import devtrace
import harness
import program_spans

SPAN_METRICS = ("rebuild_ms_per_request", "host_io_ms_per_frame", "int8_weights_ms_per_request",
                "denoise_idle_pct", "backward_idle_pct", "optimizer_ms_per_step")
MAIN, AUTOGRAD = 7, 9


def _host(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _kernel(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _launch(ts, corr, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "tid": tid, "args": {"correlation": corr}}


EVENTS = [
    _host("bench/request", 0, 1000),
    _host("lipsync/build", 10, 50),                # 50 us
    _host("lipsync/gather", 60, 40),               # 40
    _host("int8/weights", 120, 10), _host("int8/weights", 140, 10),
    _host("lipsync/fetch", 200, 60),               # 60
    _host("sample/step", 300, 100), _host("sample/step", 400, 100),
    _host("train/backward", 600, 100),
    _host("train/optimizer", 700, 80),
    _host("lipsync/concat", 900, 100),             # 100
    _host("lipsync/build", 0, 500, tid=AUTOGRAD),  # another thread's: not the program's span
    _launch(150, 6), _kernel("k_tail", 205, 25, 6),     # the batch's last kernel: fetch waits
    _launch(210, 7), _kernel("Memcpy DtoH (Device -> Pageable)", 230, 20, 7, "gpu_memcpy"),
    _launch(310, 1), _kernel("k_a", 320, 30, 1),
    _launch(330, 2), _kernel("k_b", 340, 80, 2),
    _launch(470, 3), _kernel("Memcpy DtoH (Device -> Pageable)", 480, 40, 3, "gpu_memcpy"),
    _launch(640, 4, tid=AUTOGRAD), _kernel("k_backward", 650, 40, 4),
    _launch(1050, 5), _kernel("k_late", 1100, 100, 5),   # after the slice
]


@pytest.fixture
def ctx():
    sl = devtrace.parse(EVENTS)
    sl.frames, sl.units = 8, 2
    return types.SimpleNamespace(slice=sl)


def _read(name, ctx):
    return harness.load_module("metrics", name).read(ctx)


def test_span_wall_times(ctx):
    assert _read("rebuild_ms_per_request", ctx) == pytest.approx(0.050 / 2)
    # fetch 200-260 less k_tail's 205-230 (its copy 230-250 counts)
    assert _read("host_io_ms_per_frame", ctx) == pytest.approx((0.040 + 0.035 + 0.100) / 8)
    assert _read("int8_weights_ms_per_request", ctx) == pytest.approx(0.020 / 2)
    assert _read("optimizer_ms_per_step", ctx) == pytest.approx(0.080 / 2)


def test_span_idle_shares_count_device_work_from_any_thread(ctx):
    # sample/step: union 300-500; k_a with k_b cover 320-420, the copy 480-500
    assert _read("denoise_idle_pct", ctx) == pytest.approx(100.0 * (200 - 120) / 200)
    # train/backward 600-700; k_backward (650-690) was launched from the autograd thread
    assert _read("backward_idle_pct", ctx) == pytest.approx(100.0 * (100 - 40) / 100)
    assert [op.name for op in ctx.slice.launched_in(["train/backward"])] == []


def test_breakdown_names_gaps_by_the_program_spans(ctx):
    # idle 0-205, 250-320, 420-480, 520-650, 690-1000, each named by the
    # innermost main-thread range at its middle
    gaps = dict(ctx.slice.breakdown()["idle_gaps"])
    assert gaps == pytest.approx({"bench/request": (205 + 70 + 130 + 310) * 1e-6,
                                  "sample/step": 60e-6})


def test_readers_without_their_spans():
    bare = devtrace.parse([_host("bench/step", 0, 100), _launch(5, 1), _kernel("k", 10, 20, 1)])
    bare.frames, bare.units = 8, 1
    for name in SPAN_METRICS:
        assert _read(name, types.SimpleNamespace(slice=bare)) is None
        assert _read(name, types.SimpleNamespace(slice=None)) is None
    spans_only = devtrace.parse([_host("bench/step", 0, 100), _host("train/backward", 10, 50)])
    assert program_spans.idle_pct(spans_only, ["train/backward"]) is None     # no device op


CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_run_reads_the_span_metrics(cell):
    """On the CPU the spans are traced but no device op is: the wall times
    read, the idle shares are left out. A seed of its own: the trace file
    is named by cell and seed, and other tests run these cells at
    ``tiny.SEED``."""
    co, mo = tiny.overrides(cell)
    out = harness.run_cell(cell, tiny.SEED + 1, 0.5, True, time.perf_counter(), device="cpu",
                           config_overrides=co, mix_overrides=mo)
    listed = {m["name"] for m in harness.listed_metrics(cell)["per_layer"]}
    got = {k: v["value"] for k, v in out["metrics"].items() if k in SPAN_METRICS}
    assert all(isinstance(v, float) and v >= 0 for v in got.values()), got
    assert set(got) == listed & {"rebuild_ms_per_request", "host_io_ms_per_frame",
                                 "int8_weights_ms_per_request", "optimizer_ms_per_step"}
