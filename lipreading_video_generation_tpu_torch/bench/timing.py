"""Device time of a call, without the host work of launching it; builds of
one kernel source with compile-time flags, for timing its parts."""
from __future__ import annotations

import ctypes
import subprocess

import torch


def graph_ms(fn, n: int = 50, replays: int = 5) -> float:
    """Device time of one call of ``fn``, ms: ``n`` calls captured in a CUDA
    graph, the graph replayed ``replays`` times between two events. No host
    work of the calls is in it: what a kernel launched from a loop on the
    host cannot show when its call costs more host time than it runs."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (n * replays)


def build_variants(source: str, builds: dict) -> dict:
    """Compile ``csrc/<source>`` once for each build of ``builds`` (name ->
    its ``-D`` flags), all at once, into ``_build/phases/`` and return each
    build's library (name -> ``ctypes.CDLL``)."""
    from ..ops import _build

    out_dir = _build.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = source.rsplit(".", 1)[0]
    procs = {name: subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, "-shared",
         "-o", str(out_dir / f"{stem}_{name}.so"), str(_build.CSRC_DIR / source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in builds.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name!r} build of {source}:\n{log}")
        libs[name] = ctypes.CDLL(str(out_dir / f"{stem}_{name}.so"))
    return libs
