"""Where does the time of K3's "tiled" kernel go, and what did its 8x4
micro-tiles buy?

As ``flash_bwd_phases`` does for K4 and K5, ``csrc/flash_fwd.cu`` is
compiled several times with nvcc, with the tiled kernel's compile-time cuts
and trials, and every build is timed on the same inputs:

- ``full``: the kernel as it ships (8 query rows a thread, 8x4
  micro-tiles, 64-row blocks, up to head dim 128);
- ``rows4``: 4 query rows a thread (4x4 micro-tiles, 32-row blocks), the
  first build's tiles;
- ``no_stream``: only the block's first key tile is staged (every tile
  computes on it: no L2 streaming of K and V);
- ``no_products``: the two product loops run no step (staging, softmax,
  barriers);
- ``no_products_no_stream``: neither.

The inputs are ``flash_bwd_timing``'s at (2, 1, 4096, 64) and
(2, 1, 16384, 64): the float32 U-Net's attention at 64x64 and its heaviest
at 128x128, as (B, H, S, D) views of column slices of one fused qkv tensor.
Each build splits the key axis as ``flash_fwd_splits`` does for its own
blocks: the shipped tiles into 2 runs at 4096 tokens (128 row blocks), 1 at
16384; ``rows4`` into 1 (its 256 and 1,024 row blocks fill the card). Each
build is timed by a CUDA graph of 20 launches (with the combine's where it
splits) replayed 5 times between two events (device time), twice in turns;
the full and the rows4 builds are held against ``flash_reference`` first.
Then the full and the rows4 builds are timed the same way at each number
of key splits of ``SPLIT_GRID``, at (2, 1, 4096, 64) and (2, 1, 1024, 128):
what ``flash_fwd_splits``' choice and the 8x4 tiles were chosen from.

    python -m lipreading_video_generation_tpu_torch.bench.flash_fwd_phases

Prints one line of JSON: the ms of each build at each shape in each turn,
the ms of the two builds by key splits, and the card and its power limit as
``nvidia-smi`` gives them.
"""
from __future__ import annotations

import json
import subprocess

import torch

from ..ops import attention as att
from . import flash_fwd_timing
from .flash_bwd_timing import GRAPH_LAUNCHES, inputs
from .timing import build_variants, graph_ms

SHAPES = ((2, 1, 4096, 64), (2, 1, 16384, 64))
# shape -> the numbers of key splits at which the full and rows4 builds are timed
SPLIT_GRID = {(2, 1, 4096, 64): (1, 2, 3, 4), (2, 1, 1024, 128): (1, 2, 4, 5, 8, 16)}
# build -> its -D flags
_BUILDS = {
    "full": [],
    "rows4": ["-DFLASH_FWD_ROWS4"],
    "no_stream": ["-DFLASH_FWD_NO_STREAM"],
    "no_products": ["-DFLASH_FWD_NO_PRODUCTS"],
    "no_products_no_stream": ["-DFLASH_FWD_NO_PRODUCTS", "-DFLASH_FWD_NO_STREAM"],
}


def _splits(name: str, shape) -> int:
    """The key splits of a build at ``shape``: the port's rule, but 1 for
    ``rows4``, whose 32-row blocks fill the card at both shapes."""
    b, h, s, d = shape
    return 1 if name == "rows4" else att.flash_fwd_splits(b * h, s, s, d)


def run(seed: int = 0) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("flash_fwd_phases times kernels on a CUDA device; none is available")
    libs = build_variants("flash_fwd.cu", _BUILDS)
    errs, turns = {}, [{}, {}]
    for shape in SHAPES:
        key = ",".join(map(str, shape))
        q, k, v = inputs(shape, seed)[:3]
        want, _ = att.flash_reference(q, k, v)
        for name in ("full", "rows4"):
            launch = flash_fwd_timing.c_entry_launcher(att, q, k, v, n_split=_splits(name, shape),
                                                       lib=libs[name])
            launch()
            torch.cuda.synchronize()
            errs[f"{name} {key}"] = flash_fwd_timing._err(launch.out, want)
        if not max(errs.values()) <= 1e-4:
            raise AssertionError(f"a build is off the plain version: {errs}")
        for turn in turns:
            turn[key] = {name: graph_ms(flash_fwd_timing.c_entry_launcher(
                att, q, k, v, n_split=_splits(name, shape), lib=lib), GRAPH_LAUNCHES)
                for name, lib in libs.items()}
        del q, k, v, want
    by_splits = {}
    for shape, splits in SPLIT_GRID.items():
        q, k, v = inputs(shape, seed)[:3]
        by_splits[",".join(map(str, shape))] = {
            name: {n: graph_ms(flash_fwd_timing.c_entry_launcher(
                att, q, k, v, n_split=n, lib=libs[name]), GRAPH_LAUNCHES) for n in splits}
            for name in ("full", "rows4")}
        del q, k, v
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    return {"max_err": errs, "ms": turns, "ms_by_splits": by_splits,
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi[:1]}


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
