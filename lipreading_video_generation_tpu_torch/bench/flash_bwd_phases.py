"""Where does the time of K4 and K5's "tiled" kernels go?

``ncu`` does not run on every machine with an H100, so this takes its place
for the tiled kernels of ``csrc/flash_bwd.cu``, as ``clahe_phases`` does for
K1: the source is compiled several times with nvcc, with the kernels'
compile-time cuts, and every build is timed on the same inputs:

- ``full``: the kernels as they ship;
- ``copy_at_top``: the next tile's copies issued right after the tile's
  first barrier, not after the first pair of products;
- ``no_stream``: only the first tile is staged (no L2 streaming of the
  other operand; every tile computes on the first);
- ``no_products``: the product loops run no step (staging, P and dS,
  barriers);
- ``no_products_no_stream``: neither (what is left: the block's set-up,
  the elementwise steps, the barriers, the stores).

The inputs are ``flash_bwd_timing``'s at (2, 1, 4096, 64): the float32
U-Net's attention at 64x64, as (B, H, S, D) views of column slices of one
fused qkv tensor. Each build is timed by a CUDA graph of 20 launches replayed
5 times between two events (device time), twice in turns; the full build is
held against ``flash_backward_reference`` first.

    python -m lipreading_video_generation_tpu_torch.bench.flash_bwd_phases

Prints one line of JSON: the ms of each kernel of each build in each turn,
and the card and its power limit as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from ..ops import _build
from ..ops import attention as att
from . import flash_bwd_timing
from .timing import graph_ms

SHAPE = (2, 1, 4096, 64)
# build -> its -D flags
_BUILDS = {
    "full": [],
    "copy_at_top": ["-DFLASH_BWD_COPY_AT_TOP"],
    "no_stream": ["-DFLASH_BWD_NO_STREAM"],
    "no_products": ["-DFLASH_BWD_NO_PRODUCTS"],
    "no_products_no_stream": ["-DFLASH_BWD_NO_PRODUCTS", "-DFLASH_BWD_NO_STREAM"],
}


def _build_all() -> dict:
    """Compile each build of ``csrc/flash_bwd.cu`` (all at once) into
    ``_build/phases/`` and return its library."""
    source = _build.CSRC_DIR / "flash_bwd.cu"
    out_dir = _build.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, "-shared",
         "-o", str(out_dir / f"flash_bwd_{name}.so"), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in _BUILDS.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name!r} build:\n{log}")
        libs[name] = ctypes.CDLL(str(out_dir / f"flash_bwd_{name}.so"))
    return libs


def run(seed: int = 0) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("flash_bwd_phases times kernels on a CUDA device; none is available")
    q, k, v, do, lse, delta = flash_bwd_timing.inputs(SHAPE, seed)
    libs = _build_all()
    want = att.flash_backward_reference(q, k, v, do, lse, delta)
    errs = {}
    for kernel in ("dkv", "dq"):
        launch = flash_bwd_timing.c_entry_launcher(att, kernel, q, k, v, do, lse, delta,
                                                   lib=libs["full"])
        launch()
        torch.cuda.synchronize()
        refs = want[1:] if kernel == "dkv" else want[:1]     # want is (dQ, dK, dV)
        errs[kernel] = max(((g - r).abs().max() / r.abs().max()).item()
                           for g, r in zip(launch.outs, refs))
    if not max(errs.values()) <= 1e-4:
        raise AssertionError(f"the full build is off the plain version: {errs}")
    turns = []
    for _ in range(2):
        turns.append({name: {kernel: graph_ms(flash_bwd_timing.c_entry_launcher(
            att, kernel, q, k, v, do, lse, delta, lib=lib), flash_bwd_timing.GRAPH_LAUNCHES)
            for kernel in ("dkv", "dq")} for name, lib in libs.items()})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    return {"shape": list(SHAPE), "max_rel_err": errs, "ms": turns,
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi[:1]}


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
