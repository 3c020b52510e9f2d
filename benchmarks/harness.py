"""The benchmark's runner: finds a cell's files by name, runs it once and
assembles the result line.

A cell ``<cell>`` is ``workloads/<cell>.json``: its configuration
(``configs/<config>.json`` for the sizes, ``configs/<config>.py`` for the
program's entry, the plain reference and the FLOP count), its traffic mix
(``traffic/<mix>.json``, read by the driver it names, ``drivers/<driver>.py``),
the reference's numerics, the limits of the numbers that decide ``correct``,
and the TF32 setting. Each metric ``<name>`` that ``BENCHMARK.json`` lists
for the cell is read by ``metrics/<name>.py``'s ``read(ctx)``, which returns
a number or None (nothing to read: the metric is then left out).
Nothing here names a configuration, a mix or a metric.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
OUT = BENCH / "out"
# the port's package lives at the checkout's root; the references and the
# trace reader beside this file
for _p in (str(ROOT), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# top-level module names that may not be loaded by a run of the port
FORBIDDEN = ("jax", "jaxlib", "flax", "lipreading_video_generation_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` of the benchmark, loaded as ``bench_<kind>_<name>``."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    mod_name = f"bench_{kind}_{name}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    config_module: ModuleType
    driver: ModuleType


def load_cell(name: str, config_overrides: Optional[dict] = None,
              mix_overrides: Optional[dict] = None) -> Cell:
    """The cell's files, found by its name; ``*_overrides`` replace keys of
    the configuration and the mix (the CPU tests' small sizes)."""
    wl = load_json(BENCH / "workloads" / f"{name}.json")
    cfg = load_json(BENCH / "configs" / f"{wl['config']}.json")
    cfg.update(config_overrides or {})
    mix = load_json(BENCH / "traffic" / f"{wl['traffic']}.json")
    mix.update(mix_overrides or {})
    return Cell(name, wl, cfg, mix, load_module("configs", wl["config"]),
                load_module("drivers", mix["driver"]))


def make_program(cell: Cell, seed: int, device: str):
    """The cell's program: the class its mix's ``entry`` names in the
    configuration's module (``Program`` by default)."""
    return getattr(cell.config_module, cell.mix.get("entry", "Program"))(
        cell.config, cell.mix, seed, device)


def listed_metrics(cell: str, benchmark: Optional[dict] = None) -> Dict[str, List[dict]]:
    """The end-to-end and per-layer entries of ``BENCHMARK.json`` that apply
    to ``cell``: those without ``workloads`` and those that name it."""
    bm = benchmark if benchmark is not None else load_json(ROOT / "BENCHMARK.json")
    return {kind: [m for m in bm[kind] if "workloads" not in m or cell in m["workloads"]]
            for kind in ("end_to_end", "per_layer")}


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is a forbidden one."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def quantile(values: List[float], q: float) -> float:
    """The ``q`` quantile of ``values``, linear between order statistics."""
    s = sorted(values)
    if not s:
        raise ValueError("quantile of no values")
    pos = q * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


@dataclasses.dataclass
class Window:
    """What the measured window did: each completed request's latency and
    frames, its length, and the outputs kept for the comparison."""
    seconds: float = 0.0
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    frames: int = 0
    attempted: int = 0
    failed: int = 0
    requests: int = 0
    kept: List[Any] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Context:
    """What a metric reader sees."""
    program: Any
    window: Window
    setup_s: float
    peak_bytes: int
    slice: Any = None              # devtrace.Slice of the profiled requests or steps


def worst_numbers(program, kept: List[Any], mode: str, control: Optional[str] = None):
    """The largest of each number compared over ``kept`` [(request, output)]:
    each output against the program's ``reference_output`` in ``mode``, by
    its ``compare``; with ``control``, also the control's output of the same
    request (the reference computed in that mode, put in the program's
    place). → (the program's numbers, the control's or None)."""
    worst: List[Dict[str, float]] = [{}, {}]
    for req, out in kept:
        ref_out = program.reference_output(req, mode)
        outs = [out]
        if control is not None:
            outs.append(program.reference_output(req, control).cpu().numpy())
        for numbers, got in zip(worst, outs):
            for k, v in program.compare(req, got, ref_out).items():
                numbers[k] = max(numbers.get(k, v), v)
    return worst[0], (worst[1] if control is not None else None)


def set_tf32(enabled: bool) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled


def cache_dirs() -> None:
    """Kernel caches the program or torch might write go inside the checkout,
    at fixed paths."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(OUT / "cache" / sub))


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float, *,
             device: str = "cuda", config_overrides: Optional[dict] = None,
             mix_overrides: Optional[dict] = None,
             benchmark: Optional[dict] = None) -> Dict[str, Any]:
    """One run of ``name``: set-up, the window, with ``trace`` a profiled
    slice, the comparison with the reference. Returns the result line's
    object. ``t_start`` is when the process started to set up."""
    import time

    import torch

    cache_dirs()
    cell = load_cell(name, config_overrides, mix_overrides)
    listed = listed_metrics(name, benchmark)
    set_tf32(bool(cell.workload["tf32"]))
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    phases = {"import": time.perf_counter() - t_start}
    torch.zeros(1, device=device)      # the CUDA context
    sync()
    phases["context"] = time.perf_counter() - t_start
    program = make_program(cell, seed, device)
    sync()
    phases["program"] = time.perf_counter() - t_start
    cell.driver.warm_up(program, cell.mix)
    sync()
    setup_s = time.perf_counter() - t_start
    print("set-up, s since start: " + ", ".join(f"{k} {v:.2f}" for k, v in phases.items())
          + f", warm-up {setup_s:.2f}", file=sys.stderr)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    window = cell.driver.window(program, cell.mix, seed, seconds)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    trace_slice = None
    if trace:
        import devtrace

        trace_slice = devtrace.profile_slice(lambda: cell.driver.traced(program, cell.mix),
                                    OUT / f"{name}.{seed}.trace.json", device)
    if hasattr(program, "release"):     # the program's state, freed before the reference runs
        program.release()
    if hasattr(program, "check"):       # a training step: what its first steps recorded
        numbers = program.check(cell.workload["reference"])
    else:
        numbers = worst_numbers(program, window.kept, cell.workload["reference"])[0]
    limits = cell.workload["limits"]
    correct = (window.failed == 0 and window.requests > 0
               and all(numbers[k] <= limits[k] for k in limits))
    ctx = Context(program, window, setup_s, peak, trace_slice)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in listed[kind]:
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace_slice is not None:
        dev["busy_s"] = trace_slice.busy_s
        dev["window_s"] = trace_slice.window_s
    out = {"correct": bool(correct), "attempted": window.attempted, "failed": window.failed,
           "metrics": metrics, "device": dev}
    if trace_slice is not None:
        out["breakdown"] = trace_slice.breakdown()
    out["compared"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return out
