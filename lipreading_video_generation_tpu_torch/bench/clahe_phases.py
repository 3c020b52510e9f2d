"""Where does the time of K1's packed route go, phase by phase?

``ncu`` does not run on every machine with an H100, so this takes its place
for ``csrc/clahe_packed.cu``: the source is compiled several times with
nvcc, with the kernel's compile-time cuts (``-DCLAHE_PACKED_STOP``,
``-DCLAHE_PACKED_NO_SCAN``), and every build is timed on the same images:

- ``setup``: counters zeroed, row and column tables made (and the launch);
- ``histogram``: set-up, then the bins and the packed histograms;
- ``no_blend``: everything but the blend (so the LUT scan is
  ``no_blend - histogram``);
- ``no_scan``: everything but the LUT scan (the blend is
  ``no_scan - histogram``);
- ``full``: the kernel as it ships.

The images are the ViViT path's batch-384 request, (1920, 48, 48) float32 in
[0, 255], grid (8, 8), 256 bins, clip 0.2 (L = 1). Each build is timed by a
CUDA graph of 50 launches replayed 5 times between two events (device time,
none of the host's), twice in turns.

    python -m lipreading_video_generation_tpu_torch.bench.clahe_phases

Prints one line of JSON: the ms of each build in each turn, the card and its
power limit as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

from ..ops import _build
from ..ops.clahe_cuda import _PACKED_ARGTYPES, clahe_packed_layout, clahe_reference
from .timing import graph_ms

# build -> its -D flags
_BUILDS = {
    "setup": ["-DCLAHE_PACKED_STOP=1"],
    "histogram": ["-DCLAHE_PACKED_STOP=2"],
    "no_blend": ["-DCLAHE_PACKED_STOP=3"],
    "no_scan": ["-DCLAHE_PACKED_NO_SCAN"],
    "full": [],
}


def _build_all() -> dict:
    """Compile each build of the packed route (all at once) into
    ``_build/phases/`` and return its entry point."""
    source = _build.CSRC_DIR / "clahe_packed.cu"
    out_dir = _build.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, "-I", str(_build.CSRC_DIR), "-shared",
         "-o", str(out_dir / f"{name}.so"), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in _BUILDS.items()}
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name!r} build:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).lvg_clahe_packed_f32
        fn.argtypes = _PACKED_ARGTYPES
        fns[name] = fn
    return fns


def run(seed: int = 0) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("clahe_phases times kernels on a CUDA device; none is available")
    n, h, w, grid, nbins = 1920, 48, 48, (8, 8), 256
    x = torch.from_numpy(np.random.default_rng(seed).uniform(0, 255, (n, h, w))
                         .astype(np.float32)).cuda()
    out = torch.empty_like(x)
    lay = clahe_packed_layout(h, w, grid, nbins)
    args = (x.data_ptr(), out.data_ptr(), None, n, h, w, *grid, nbins, 1.0, lay["group"],
            lay["lane_words"], lay["tile_words"], lay["smem"])
    fns = _build_all()

    def launcher(fn):
        return lambda: _build.check(fn(*args, torch.cuda.current_stream().cuda_stream),
                                    "clahe_phases")

    launcher(fns["full"])()
    torch.cuda.synchronize()
    err = (out - clahe_reference(x, 0.2, grid, nbins)).abs().max().item()
    if not err <= 1e-2:
        raise AssertionError(f"the full build is off the plain version by {err}")
    turns = [{name: graph_ms(launcher(fn)) for name, fn in fns.items()} for _ in range(2)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    return {"shape": [n, h, w], "grid": list(grid), "nbins": nbins, "max_abs_err": err,
            "ms": turns, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi[:1]}


def main() -> None:
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
