"""A later change adds a configuration, a cell, a traffic mix and a
per-layer metric as new files and new BENCHMARK.json entries only: here in
a copy of the benchmark in a temporary directory, run on the CPU, by the
harness and by the CPU tests themselves."""
import json
import os
import shutil
import subprocess
import sys

import pytest

import harness


@pytest.fixture(scope="module")
def extended(tmp_path_factory):
    """The copy, with the new files and entries; returns its root."""
    root = tmp_path_factory.mktemp("extended")
    bench = root / "benchmarks"
    shutil.copytree(harness.BENCH, bench, ignore=shutil.ignore_patterns("out", "__pycache__"))
    bm = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "wav2lip_gen_96.json").read_text())
    cfg.update(name="gen_small", width=0.25, gen_batch_size=4)
    (bench / "configs" / "gen_small.json").write_text(json.dumps(cfg))
    (bench / "configs" / "gen_small.tiny.json").write_text(json.dumps({"gen_batch_size": 2}))
    (bench / "configs" / "gen_small.py").write_text(
        "import harness\nProgram = harness.load_module('configs', 'wav2lip_gen_96').Program\n")
    mix = json.loads((bench / "traffic" / "lipsync_256f_f32.json").read_text())
    mix.update(frames=5, frame_hw=[40, 48], box=[6, 30, 10, 40], box_jitter=1, warmup_requests=1,
               trace_requests=1)
    (bench / "traffic" / "small_5f_f32.json").write_text(json.dumps(mix))
    (bench / "traffic" / "small_5f_f32.tiny.json").write_text(json.dumps({"frames": 3}))
    wl = json.loads((bench / "workloads" / "lipsync_f32_256.json").read_text())
    wl.update(config="gen_small", traffic="small_5f_f32")
    (bench / "workloads" / "small_cell.json").write_text(json.dumps(wl))
    (bench / "metrics" / "requests_in_slice.py").write_text(
        "def read(ctx):\n    return ctx.slice.units if ctx.slice is not None else None\n")
    bm["configs"].append({"name": "gen_small", "source": "https://example.org/gen_small",
                          "file": "benchmarks/configs/gen_small.json", "reduced": [], "why": "test"})
    bm["workloads"].append({"name": "small_cell", "config": "gen_small",
                            "traffic": "small_5f_f32", "chips": 1, "why": "test"})
    for m in bm["end_to_end"] + bm["per_layer"]:
        if "workloads" in m and "lipsync_f32_256" in m["workloads"]:
            m["workloads"].append("small_cell")
    bm["per_layer"].append({"name": "requests_in_slice", "unit": "requests", "better": "higher",
                            "source": "device_trace", "layer": "test", "moves": "frames_per_s",
                            "workloads": ["small_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bm))
    return root


def _python(root, *args):
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))
    return subprocess.run([sys.executable, *args], cwd=root, capture_output=True, text=True,
                          env=env, timeout=600)


def test_new_files_only(extended):
    code = ("import sys, time, json; sys.path.insert(0, 'benchmarks'); import harness; "
            "print(json.dumps(harness.run_cell('small_cell', 9, 0.3, True, time.perf_counter(), "
            "device='cpu')))")
    out = _python(extended, "-c", code)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["compared"]
    assert result["metrics"]["requests_in_slice"]["value"] == 1
    assert "launches_per_frame" not in result["metrics"]       # nothing on a device to count


def test_new_cell_passes_the_cpu_tests_unedited(extended):
    """The CPU tests find the new cell's test sizes by name: its files
    test and its sound run, as for every cell."""
    out = _python(extended, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                  "benchmarks/tests/test_bench_files.py", "benchmarks/tests/test_bench_run.py",
                  "-k", "small_cell and (cells_found_by_name or sound_run)")
    assert out.returncode == 0, (out.stdout + out.stderr)[-3000:]
    assert "2 passed" in out.stdout, out.stdout[-2000:]
