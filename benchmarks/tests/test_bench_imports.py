"""What a run may load and where it may run: no module of JAX or of the
JAX package; references that import nothing of the program; run.py refuses
without a card and in a directory that holds only BENCHMARK.json and the
benchmark's files."""
import ast
import json
import os
import shutil
import subprocess
import sys

import tiny
import harness

PORT = "lipreading_video_generation_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_references_import_nothing_of_the_program():
    for path in sorted((harness.BENCH / "reference").glob("*.py")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {PORT, *harness.FORBIDDEN}, (path.name, tops)
        assert tops <= {"__future__", "contextlib", "math", "typing", "numpy", "torch", "reference"}
    code = ("import sys; sys.path.insert(0, %r); import reference.wav2lip, reference.unet_audio; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(harness.BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert PORT not in out.stdout and "'jax'" not in out.stdout


def test_no_jax_module_in_a_run():
    """A whole run of every cell at the test size in a fresh process, then
    the loaded modules' top-level names."""
    code = f"""
import sys, time
sys.path.insert(0, {str(harness.BENCH / 'tests')!r})
import tiny, harness
for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]:
    co, mo = tiny.overrides(w["name"])
    harness.run_cell(w["name"], 3, 0.2, True, time.perf_counter(), device="cpu",
                     config_overrides=co, mix_overrides=mo)
print("FOUND", harness.forbidden_modules(), "port" if {PORT!r} in sys.modules else "")
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND [] port" in out.stdout


def test_run_refuses_without_a_card_or_the_port(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    cell = json.loads((tmp_path / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    import torch

    for cwd in (tmp_path,) if torch.cuda.is_available() else (tmp_path, harness.ROOT):
        out = subprocess.run([sys.executable, "benchmarks/run.py", "--workload", cell, "--seed",
                              "5", "--seconds", "1", "--trace", "0"], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout.strip() == ""
