#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``lipreading_video_generation_tpu_torch``'s ported paths on random
weights made from a seed, and checks every hand-written kernel on them:

- the lipreader's serving path — mouth-ROI preprocessing, then the ViViT
  word-classifier forward — at the ``ViViTConfig`` defaults (12 layers,
  hidden 256, 8 heads, MLP 1024, bf16, 64 classes); its attention is the
  small-MHA kernel K2, in bf16 the tensor-core one
  (``csrc/small_mha_sm90.cu``);
- diffusion sampling — uint8 condition frame + raw audio → native audio
  encoder → conditioning map → DDIM / DPM++ denoise steps of the U-Net →
  uint8 frames — at the ``DiffusionConfig`` defaults (128×128, base 64,
  channel_mult (1,2,4), 2 res blocks, attention at ds 1/2/4, 1 head, bf16);
  its attention is the flash forward K3, in bf16 the tensor-core kernel
  (``csrc/flash_fwd_sm90.cu``);
- diffusion training — uint8 target/condition frames + raw audio →
  ``prepare_batch`` → q-sample → U-Net forward in train mode (dropout 0.1)
  → ε-MSE → backward through the flash backward kernels (in bf16 the
  tensor-core ones, ``csrc/flash_bwd_sm90.cu``) → Adam → EMA — at the same
  defaults, batch 8;
- the super-resolution stage (``SuperResConfig`` defaults: training, then
  the two-stage cascade) and classifier guidance (``ClassifierConfig``
  defaults: training, then a guided request), the other two users of the
  flash backward;
- lip-sync serving — host uint8 frames, face boxes and mel windows →
  ``pipelines.inference.generate_frames`` (crop, mask, the talking-face
  generator, paste back) → host uint8 frames — at the ``GanConfig`` /
  ``PreprocessConfig`` defaults (width 1.0, 96×96 faces, batches of 128), in
  float, dynamic int8 and static int8; in the int8 modes each of the
  generator's 51 convolutions is one launch of the int8 matmul kernel K6,
  by its tensor-core route (``csrc/int8_mm_sm90.cu``);
- the int8 lipreader (``predict_step_int8``: K6 once per Linear) and the K6
  microbench (``bench.microbench_int8``: both of K6's type pairs at 4096³).

Phases (each prints lines tagged with its name; any failure raises and the
script exits non-zero without printing a result):

1. device  — needs CUDA; prints the card, the device count and
   ``nvidia-smi --query-gpu=name,power.limit``.
2. build   — builds the kernels from ``csrc/*.cu`` with nvcc, one process
   per source; prints the build time, ptxas' register and shared-memory
   report and each kernel's dynamic shared memory.
3. kernels — each kernel against its plain torch version on the card
   (K1 CLAHE, on both routes, at the main path's and 23 more shapes, grids
   up to 17 x 17, 3 to 20,000 bins, clip 0.2, 2.0 and 2.5: its LUTs equal
   the plain version's and the output within 1e-2 gray levels where L is an
   integer and nbins a power of two, else LUTs within one level and output
   within 1 + 1e-2; the route and equal bits of two launches at each; then
   ``ops/image.clahe`` at grid (16, 16), 128 and 512 bins and 360 x 640
   frames; K2 small MHA: 2e-2 abs/rel in
   bf16 (the tensor-core kernel, also at S = 1, 16, 17 and 128, on qkv
   slices, and the CUDA-core kernel for an unaligned view and S past 128),
   1e-5 in float32, each with its route and equal bits of two launches, and
   its gradient at 1e-4 in float32; K3 flash
   forward: O within 1e-2 in bf16 (one output ulp at |O| ≤ 1; the
   tensor-core kernel also rounds P to bf16 before P·V, 2^-9 a term, and
   its error against the plain version that rounds P there is printed
   beside), 1e-4 in float32, lse within 1e-4; K4/K5 flash backward: each gradient within
   1e-2 of its largest value in bf16 (P and dS rounded to bf16 before the
   float32 sums, then one rounding of the gradient) against the plain
   version with float32 P, 1e-4 in float32; for K3, K4 and K5 aligned bf16
   inputs must take the tensor-core kernels and float32, unaligned ones or
   head dims above 256 the CUDA-core kernels, two launches must give equal
   bits, and head dims 320 and 512 and more than 65,535 (batch, head)
   pairs run forward and backward, and head dims 640 and 1024 (above 512 the
   CUDA-core kernels walk d in slices of 256) in float32 and bf16; K6 matmul: int8 exactly equal, bf16 within 1e-3 of the
   largest |C| (the output is the unrounded float32 sum; only the order of
   summation differs), every serving shape and the tile edges by the
   tensor-core route, odd depths, a row-major int8 B and an unaligned view
   by the mma.sync route, more than 65,535 x 64 columns, equal bits of two
   launches), at the shapes the paths give them.
4. serve   — 3 requests of 8 clips and 3 of 384 clips (5 frames each, 96×96
   RGB uint8 frames and face boxes as in bench.py), host frames in, host
   logits out; every request must launch K1 once (by the packed route) and
   K2 once per layer (by the tensor-core route), and give finite logits; a
   ``torch.profiler`` breakdown of a batch-384 request, with K1's device
   time; the batch-8 requests must agree with the same model
   and inputs run on the CPU (the plain path). Then one batch-384 request
   through ``predict_step_int8``: K6 once per Linear (50, by the
   tensor-core route), K1 and K2 as before, held against ``predict_step`` on
   the same ROIs, and its profile.
5. diffuse — one warm-up and 3 timed ``sample_video`` requests of 4 frames
   × 10 DDIM steps, and one with DPM++(2M); each must launch K3 16 times a
   step (all by the tensor-core route) and K2 4 times, and return finite (4, 128, 128, 3) uint8 frames;
   a ``torch.profiler`` breakdown of one request (device busy share,
   K2/K3 shares); the full 500-step DDPM chain at batch 1; then the card against the CPU
   plain path at the full channel plan but 64×64, batch 1, 2 DDIM steps,
   same initial noise.
6. train   — ``train_step`` at the ``DiffusionConfig`` defaults, batch 8:
   one warm-up and 5 timed steps, each launching K3, K4 and K5 16 times and
   K2 4 times (K3, K4 and K5 by the tensor-core route), with finite loss, params
   and EMA and an EMA that moves; a ``torch.profiler`` breakdown of one
   step (device busy share, K2-K5 shares); 10
   steps on one batch with fixed t and noise must end below the first
   loss; one float32 step at the full channel plan but 64×64, batch 2,
   dropout 0, card against the CPU plain path (loss within 1e-4 relative,
   the whole gradient within 1e-3 relative L2).
7. superres — 3 ``train_superres.train_step``s at the ``SuperResConfig``
   defaults, batch 8 (6 AttentionBlocks of 1024 tokens, d=192), then one
   ``sample_cascade`` request: base at ``DiffusionConfig(im_size=64)``, 4
   frames × 10 DDIM steps, SR 50 DDIM steps → finite (4, 128, 128, 3).
8. guidance — 5 ``train_classifier.train_step``s at the
   ``ClassifierConfig`` defaults on ``synthetic_batch`` (batch 32,
   128×128), then a guided ``sample_video`` of 4 frames × 10 DDIM steps
   (label 2, scale 5): K4/K5 twice a step.
9. lipsync — ``generate_frames`` on the serving bench's inputs (256 frames
   of 360×640, boxes [40,300,180,430] ± 4, standard-normal mels): one
   warm-up and 3 timed requests each in float, dynamic int8 and static
   int8; uint8 frames of the input's shape, untouched outside the boxes;
   K6 exactly once per convolution per batch in the int8 modes (51 × 2, all
   by the tensor-core route) and never in float; the generator's int8 output against its float output
   (PSNR); a batch-8 float request against the CPU; a profile of one
   dynamic int8 request (device busy share, device time by int8 stage).
10. microbench — ``bench.microbench_int8.run``: K6 in bf16 and in int8
   (B row-major and B a (N, K) weight transposed) and the library's calls
   on the same operands at 4096³, after its own checks.
11. timing — request and train-step times, frames/s, each kernel's
   CUDA-event time beside its plain version's at the main-path shapes, the
   one PyTorch call that computes the same function where there is one
   (``scaled_dot_product_attention`` and its backward, at all three U-Net
   shapes beside K3 and beside K4 + K5, ``torch._int_mm``,
   ``torch.matmul``; yardsticks, used on no path), each kernel's bound
   (the larger of its bytes over 3.35 TB/s and its operations over the
   tensor-core peak of its type) and its share of it, K1, K2, K3 and K6 also
   through their C entry points in a loop (without the wrappers' host work),
   and K1 on 64 frames of 360 x 640 (its tiled route).

The line before the last is ``nvidia-smi``'s name and power limit; before
it, one JSON object with the kernels; the last line is the result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Run from the repository root: ``python3 chip_smoke.py``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import time

import numpy as np
import torch

SEED = 0
TOL_K1 = 1e-2        # gray levels: exact LUTs, float32 blend rounding only
TOL_K2_BF16 = 2e-2   # one bf16 rounding of P and of O, sums in another order
TOL_K2_F32 = 1e-5
TOL_GRAD = 1e-4
# bf16 card vs bf16 CPU through 12 blocks (other summation order, other
# bf16 rounding points) on ROIs that may differ by a gray level here and
# there: logits agree within 5e-2 abs + 5e-2 relative.
TOL_LOGITS = 5e-2
CLIP_FRAMES = 5
TOL_K3_BF16 = 1e-2   # float32 inside on both sides; O may round to the next bf16
TOL_K3_F32 = 1e-4
TOL_LSE = 1e-4
# bf16 card (cuDNN convs, K3, K2) vs bf16 CPU (other conv and GEMM kernels,
# plain attention) through 2 DDIM steps of the 64×64 U-Net: bf16 rounds at
# other points on each side; frames in [0, 1] agree within 2e-2 (3.8e-3
# measured on an H100).
TOL_FRAMES = 2e-2
DIFF_FRAMES, DIFF_STEPS = 4, 10
# K4/K5 against flash_backward_reference: max|d| over the largest |gradient|.
# float32 inside on both sides, sums in another order; in bf16 each gradient
# is rounded once (2^-8 of the value).
TOL_BWD_BF16 = 1e-2
TOL_BWD_F32 = 1e-4
TRAIN_BATCH = 8
# float32 train step, card (cuDNN without TF32, K3/K4/K5) vs CPU (plain):
# summation order only, through ~90 layers and their backward.
TOL_TRAIN_LOSS = 1e-4      # relative
TOL_TRAIN_GRAD = 1e-3      # relative L2 of the whole gradient
# K6 bf16 against a float32 matmul of the same bf16 values: exact products,
# float32 sums in another order; of the largest |C|. int8 must be equal.
TOL_K6_BF16 = 1e-3
# int8 ViViT against the bf16 one on the same ROIs (tests/test_quant.py's
# bounds for the JAX package's tiny float32 model).
INT8_TOP1_AGREE = 0.9
INT8_LOGPROB = 0.25
# int8 generator output in [0, 1] against the float output, same weights
# (tests/test_quant.py's bounds: dynamic 30 dB, static 28 dB).
PSNR_DYNAMIC, PSNR_STATIC = 30.0, 28.0
LIPSYNC_FRAMES, LIPSYNC_HW = 256, (360, 640)
# float32 generator, card (cuDNN without TF32) vs CPU: summation order only,
# so a frame value moves by at most one gray level, and rarely.
LIPSYNC_EQUAL_SHARE = 0.999
# H100 SXM peaks the bounds are stated against (NVIDIA's data sheet, dense)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_name_power()
    # Full float32 matmuls and convolutions in every plain version.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"{name}; device_count={torch.cuda.device_count()}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; tf32 off")
    return {"name": name, "count": torch.cuda.device_count(), "smi": smi}


def phase_build() -> None:
    from lipreading_video_generation_tpu_torch.ops import _build

    lib = _build.build(force=True)
    _build.load()
    log("build", f"{lib} from {[p.name for p in _build.sources()]} in "
        f"{_build.build_info['seconds']:.1f} s")
    notes = 0
    for line in str(_build.build_info["log"]).splitlines():
        if "(C75" in line:      # ptxas' notes on the wgmma kernels: counted, not listed
            notes += 1
        elif ("ptxas info" in line and ("registers" in line or "Compiling" in line
                                        or "smem" in line)) or "spill" in line or "arning" in line:
            log("build", line.strip())
    log("build", f"{notes} ptxas notes (C75xx: a warpgroup.arrive or warpgroup.wait injected around "
        "the asynchronous products)")
    from lipreading_video_generation_tpu_torch.ops.attention import (
        _small_mha_smem_bytes, flash_bwd_smem_bytes, flash_smem_bytes)

    from lipreading_video_generation_tpu_torch.ops.clahe_cuda import clahe_packed_layout

    log("build", f"dynamic shared memory per block at the main-path shapes: K1 packed route "
        f"{clahe_packed_layout(48, 48, (8, 8), 256)['smem']} B (8x8 tiles of 256 8-bit counters, "
        "2,304 bins, row and column tables), K2 "
        f"{_small_mha_smem_bytes(80, 32)} B (S=80, d=32), "
        f"{_small_mha_smem_bytes(11, 96)} B (S=11, d=96)"
        + "".join(f"; K3 {what} " + ", ".join(
            f"{flash_smem_bytes(d, route)} B (head dim {d})" for d in dims)
            for route, what, dims in (("sm90", "tensor-core route (bf16 tiles)", (64, 128, 256)),
                                      ("cuda_core", "CUDA-core route (float tiles)",
                                       (64, 128, 256, 512, 1024))))
        + "".join(f"; {name} {what} " + ", ".join(
            f"{flash_bwd_smem_bytes(d, kern, route)} B (head dim {d})" for d in dims)
            for route, what, dims in (("sm90", "tensor-core route (bf16 tiles)", (64, 128, 256)),
                                      ("cuda_core", "CUDA-core route (float tiles)",
                                       (64, 128, 256, 512, 1024)))
            for name, kern in (("K4", "dkv"), ("K5", "dq")))
        + "; K6 tensor-core route 4 stages of (128 + N tile) rows of 128 bytes, their 8 "
        "mbarriers + 1 KB: "
        + ", ".join(f"{4 * (128 + bn) * 128 + 1024 + 64} B (N tile {bn})" for bn in (8, 64, 256))
        + ", mma.sync route 15360 B static (128 and 64 rows of 80 bytes); K2 tensor-core route "
        "two buffers of Q, K, V rows of 2 d_pad + 16 bytes: "
        f"{2 * 3 * 80 * (2 * 32 + 16)} B (S=80, d=32), {2 * 3 * 16 * (2 * 128 + 16)} B (S=11, d=96)")


def _uniform(shape, lo, hi, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(
        "cuda", dtype)


# K1 cases (shape, grid, nbins, clip, route, most LUT entries that may
# differ): the main path's and the first card check's two; the packed
# route's edges (16 x 16 tiles, 128 and 8 bins, clip 2.0 where L is still 1,
# 121 pixels a tile where area * nbins^2 is just below 2^23); the CPU tests'
# (512 bins, tiles of 4,096 and 920 pixels, clip 0.2, 2.0 and 2.5), frames of
# 360 x 640, and the tiled route's edges: padding that spans more than the
# last tile, 20,000 bins (three passes of 8,192), 17 x 17 tiles, 100 and 3
# bins, a single pixel, integer L above 1 (exact sums: equal LUTs), clip 10.
# Where L is not an integer or nbins not a power of two a level next to a
# rounding tie may move by one: the last entry bounds how many do, at twice
# the most that seeds 0-3 gave on the card, plus 2 (PERF.md, §6)
K1_CASES = [((1920, 48, 48), (8, 8), 256, 0.2, "packed", 0), ((3, 50, 46), (8, 8), 256, 0.2, "tiled", 0),
            ((2, 64, 64), (4, 4), 256, 0.2, "tiled", 0), ((2, 64, 64), (4, 4), 256, 2.5, "tiled", 2),
            ((5, 48, 48), (8, 8), 256, 2.0, "packed", 0), ((2, 48, 48), (16, 16), 256, 0.2, "packed", 0),
            ((2, 48, 48), (16, 16), 256, 2.0, "packed", 0), ((2, 48, 48), (8, 8), 128, 0.2, "packed", 0),
            ((2, 48, 48), (8, 8), 8, 0.2, "packed", 0), ((2, 88, 88), (8, 8), 256, 0.2, "packed", 0),
            ((2, 48, 48), (8, 8), 512, 2.5, "tiled", 0), ((2, 128, 128), (2, 2), 256, 2.5, "tiled", 0),
            ((2, 128, 128), (2, 2), 256, 0.2, "tiled", 2), ((1, 180, 320), (8, 8), 256, 2.0, "tiled", 2),
            ((1, 180, 320), (8, 8), 256, 0.2, "tiled", 0), ((2, 360, 640), (8, 8), 256, 0.2, "tiled", 2),
            ((2, 360, 640), (8, 8), 256, 2.5, "tiled", 2), ((3, 5, 5), (4, 4), 256, 0.2, "tiled", 0),
            ((2, 48, 48), (8, 8), 20000, 0.2, "tiled", 135110), ((2, 48, 48), (17, 17), 256, 2.0, "tiled", 0),
            ((2, 48, 48), (8, 8), 100, 0.2, "tiled", 116), ((2, 48, 48), (8, 8), 3, 2.0, "tiled", 2),
            ((2, 1, 1), (1, 1), 256, 0.2, "tiled", 0), ((2, 49, 47), (3, 5), 256, 2.0, "tiled", 2),
            ((2, 48, 48), (8, 8), 8, 2.0, "tiled", 0), ((2, 64, 64), (4, 4), 16, 2.0, "tiled", 0),
            ((2, 48, 48), (8, 8), 256, 10.0, "tiled", 2)]


def k1_exact(shape, grid, nbins: int, clip: float) -> bool:
    """True where L is an integer and nbins a power of two: every partial sum
    of the CDF is exact, whatever the order of the sums."""
    th, tw = -(-shape[-2] // grid[0]), -(-shape[-1] // grid[1])
    limit = float(np.float32(max(1.0, clip * th * tw / nbins)))
    return limit.is_integer() and nbins & (nbins - 1) == 0


def check_clahe() -> float:
    """K1 at every case of ``K1_CASES`` against the plain version: the route,
    equal bits over two launches, and the LUTs (``clahe_cuda(luts=...)``
    against ``clahe_luts_reference``). Where the sums are exact
    (``k1_exact``) the LUTs must be equal and the output within TOL_K1.
    Elsewhere every LUT entry within 1 level, no more entries off than the
    case allows, and the output within 1 + TOL_K1. Then images that do not
    start on 16 bytes (the tiled route), and ``ops/image.clahe`` at shapes
    the one-block-an-image kernel refused. Returns the largest |d| of the
    exact cases."""
    from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl
    from lipreading_video_generation_tpu_torch.ops import image as im

    worst = 0.0
    for shape, grid, nbins, clip, route, max_diff in K1_CASES:
        x = _uniform(shape, 0, 255, SEED)
        if cl.clahe_route(shape[1], shape[2], grid, nbins, clip) != route:
            raise AssertionError(f"K1 {shape} {grid} {nbins} clip {clip}: route "
                                 f"{cl.clahe_route(shape[1], shape[2], grid, nbins, clip)}, "
                                 f"want {route}")
        luts = torch.empty(shape[0], grid[0] * grid[1], nbins, device="cuda")
        before = dict(cl.clahe_cuda.route_counts)
        got = cl.clahe_cuda(x, clip, grid, nbins, luts=luts)
        again = cl.clahe_cuda(x, clip, grid, nbins)
        torch.cuda.synchronize()
        took = {r: n - before[r] for r, n in cl.clahe_cuda.route_counts.items() if n != before[r]}
        if took != {route: 2}:
            raise AssertionError(f"K1 {shape} {grid} {nbins}: routes {took}, want {route}")
        if not torch.equal(got, again):
            raise AssertionError(f"K1 {shape} {grid} {nbins}: two launches gave different bits")
        exact = k1_exact(shape, grid, nbins, clip)
        if exact != (max_diff == 0):
            raise AssertionError(f"K1 {shape} {grid} {nbins} clip {clip}: the case's bound "
                                 f"{max_diff} does not fit its sums (exact: {exact})")
        err = (got - cl.clahe_reference(x, clip, grid, nbins)).abs().max().item()
        lut_d = (luts - cl.clahe_luts_reference(x, clip, grid, nbins)).abs()
        n_diff, lut_err = int((lut_d > 0).sum().item()), lut_d.max().item()
        tol = TOL_K1 if exact else 1 + TOL_K1
        log("kernels", f"K1 clahe {shape} grid {grid} nbins {nbins} clip {clip}"
            f"{' (exact sums)' if exact else ''}, route {route}: max|d| {err:.3g} (tol {tol}); "
            f"LUT entries that differ {n_diff} of {lut_d.numel()} (at most {max_diff}), by at "
            f"most {lut_err:g} (want {'0' if exact else '<= 1'}); two launches equal bits")
        if not (err <= tol and lut_err <= (0 if exact else 1) and n_diff <= max_diff):
            raise AssertionError(f"K1 {shape} {grid} {nbins} clip {clip}: max|d| {err}, LUT "
                                 f"{lut_err}, {n_diff} entries differ (at most {max_diff})")
        if exact:
            worst = max(worst, err)
    # an image that does not start on 16 bytes: the packed route reads float4s
    base = _uniform((2 * 48 * 48 + 1,), 0, 255, SEED)
    x = base[1:].view(2, 48, 48)
    before = dict(cl.clahe_cuda.route_counts)
    got = cl.clahe_cuda(x, 0.2, (8, 8))
    err = (got - cl.clahe_reference(x, 0.2, (8, 8))).abs().max().item()
    if cl.clahe_cuda.route_counts["tiled"] != before["tiled"] + 1 or not err <= TOL_K1:
        raise AssertionError(f"K1 on images at an odd address: routes "
                             f"{cl.clahe_cuda.route_counts}, max|d| {err}")
    # ops/image.clahe on the card at shapes the one-block-an-image kernel refused
    for shape, kw in (((2, 48, 48), {"grid": (16, 16)}), ((2, 48, 48), {"nbins": 128}),
                      ((2, 48, 48), {"nbins": 512}), ((2, 360, 640), {})):
        x = _uniform(shape, 0, 255, SEED + 1).round().to(torch.uint8)
        got = im.clahe(x, **kw)
        want = cl.clahe_reference(x, **kw)
        if got.dtype != torch.uint8 or (got.int() - want.int()).abs().max().item() > 1:
            raise AssertionError(f"im.clahe {shape} {kw}: dtype {got.dtype}, off the plain version")
    log("kernels", "K1 on images 4 bytes off 16: route tiled, max|d| "
        f"{err:.3g}; im.clahe on the card at grid (16, 16), nbins 128 and 512, and (2, 360, 640): "
        "uint8 out, within one level of the plain version (rounding of the float32 blend)")
    return worst


def phase_kernels() -> dict:
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl

    errs = {"clahe": check_clahe(), "small_mha": 0.0, "flash_attention": 0.0}

    # K2: the ViViT's, the audio encoder's and a causal shape in bf16 (the
    # tensor-core kernel) and float32 (the CUDA-core kernel); the tensor-core
    # kernel's edges: S = 1, 16, 17 and 128 (its largest), causal and not, head
    # dims 8, 64 and 128, more heads than blocks at once; column slices of one
    # qkv tensor, as the models pass them; a bf16 view that starts 8 bytes
    # into its rows, which 16-byte copies cannot read (CUDA-core kernel)
    bf16, f32 = torch.bfloat16, torch.float32
    k2_cases = [(384, 80, 256, 8, False, bf16, "sm90", ""),
                (DIFF_FRAMES, 11, 768, 8, False, bf16, "sm90", ""),         # audio encoder
                (2, 33, 64, 4, True, bf16, "sm90", ""),
                (2, 33, 64, 4, True, f32, "cuda_core", ""),
                (384, 80, 256, 8, False, bf16, "sm90", "qkv"),
                (3, 33, 64, 4, True, bf16, "cuda_core", "unaligned")]
    k2_cases += [(3, s, 64, 4, causal, bf16, "sm90", "")
                 for s in (1, 16, 17) for causal in (False, True)]
    k2_cases += [(2, 128, 256, 4, causal, bf16, "sm90", "") for causal in (False, True)]
    k2_cases += [(2, 128, 256, 2, True, bf16, "sm90", ""), (5, 40, 16, 2, False, bf16, "sm90", ""),
                 (3000, 16, 64, 4, True, bf16, "sm90", ""),
                 (2, 160, 64, 1, False, bf16, "cuda_core", "")]              # S past 128
    for (b, s, e, h, causal, dtype, route, layout) in k2_cases:
        tol = TOL_K2_BF16 if dtype == bf16 else TOL_K2_F32
        if layout == "qkv":
            q, k, v = _uniform((b, s, 3 * e), -2, 2, SEED, dtype).chunk(3, dim=-1)
        elif layout == "unaligned":
            q, k, v = (_uniform((b, s, e + 8), -2, 2, SEED + i, dtype)[..., 4:4 + e]
                       for i in range(3))
        else:
            q, k, v = (_uniform((b, s, e), -2, 2, SEED + i, dtype) for i in range(3))
        before = dict(att.small_mha.route_counts)
        got = att.small_mha(q, k, v, h, causal)
        again = att.small_mha(q, k, v, h, causal)
        torch.cuda.synchronize()
        took = {r: n - before[r] for r, n in att.small_mha.route_counts.items() if n != before[r]}
        if took != {route: 2}:
            raise AssertionError(f"K2 ({b},{s},{e}) H={h} {dtype} {layout}: routes {took}, want "
                                 f"{route}")
        if not torch.equal(got, again):
            raise AssertionError(f"K2 ({b},{s},{e}) H={h} {dtype}: two launches gave different bits")
        want = att._mha_einsum(q, k, v, h, causal)
        err = (got.float() - want.float()).abs().max().item()
        log("kernels", f"K2 small_mha ({b},{s},{e}) H={h} causal={causal} {dtype}"
            f"{' (' + layout + ')' if layout else ''}, route {route}: "
            f"max|d| {err:.3g} (tol {tol} abs/rel); two launches equal bits")
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        errs["small_mha"] = max(errs["small_mha"], err)

    q, k, v = (_uniform((2, 33, 64), -2, 2, SEED + 10 + i).requires_grad_() for i in range(3))
    cot = _uniform((2, 33, 64), -1, 1, SEED + 13)
    (att.small_mha(q, k, v, 4) * cot).sum().backward()
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    (att._mha_einsum(*ref, 4, False) * cot).sum().backward()
    torch.cuda.synchronize()
    for t, r in zip((q, k, v), ref):
        torch.testing.assert_close(t.grad, r.grad, rtol=TOL_GRAD, atol=TOL_GRAD)
    log("kernels", f"K2 small_mha gradient (2,33,64) H=4 f32 matches autograd "
        f"through _mha_einsum (tol {TOL_GRAD})")

    # small causal / ragged / cross / fully-masked-row shapes (q, s_k, causal)
    small = [((2, 3, 192, 32), 192, True), ((2, 3, 160, 40), 320, True),
             ((2, 3, 200, 16), 200, False), ((1, 2, 160, 128), 320, False),
             ((1, 2, 256, 256), 256, True), ((1, 2, 200, 64), 150, True)]
    # head dims above 256 (the CUDA-core kernels in both types, at the tokens
    # a U-Net block of 512 channels has at ds 4; above 512 the sliced
    # kernels, d = 640 as JAX pads it to 768 and d = 1024, causal and
    # ragged too) and more than 65,535 (batch, head) pairs (one case a route)
    wide_heads = [((1, 1, 1024, d), 1024, False, dt, "cuda_core")
                  for d in (320, 512, 640, 1024) for dt in (f32, bf16)]
    wide_heads += [((1, 2, 300, d), 260, True, dt, "cuda_core")
                   for d in (640, 1024) for dt in (f32, bf16)]
    many_heads = [((4097, 17, 132, 16), 132, True, bf16, "sm90"),
                  ((2048, 33, 132, 16), 132, False, f32, "cuda_core")]

    def flash_inputs(q_shape, s_k, dtype, unaligned, seed):
        """q, k, v and a cotangent; ``unaligned``: columns 4..d+3 of rows of
        d + 8, a view that starts 8 bytes into its rows."""
        b, h, s_q, d = q_shape
        wide = d + 8 if unaligned else d
        q = _uniform((b, h, s_q, wide), -2, 2, seed, dtype)
        k, v = (_uniform((b, h, s_k, wide), -2, 2, seed + 1 + i, dtype) for i in range(2))
        do = _uniform((b, h, s_q, wide), -1, 1, seed + 3, dtype)
        return [t[..., 4:4 + d] if unaligned else t for t in (q, k, v, do)]

    # K3: the U-Net's three shapes (batch 2), scripts/profile_flash_dpad.py's
    # two, the small cases in float32 (the CUDA-core kernel) and in bf16 (the
    # tensor-core kernel), a bf16 view that starts 8 bytes into its rows,
    # which 16-byte copies cannot read (it must take the CUDA-core kernel),
    # head dims 320 and 512, and more than 65,535 (batch, head) pairs
    k3_cases = ([((2, 1, 16384, 64), 16384, False, bf16, "sm90"),
                 ((2, 1, 4096, 128), 4096, False, bf16, "sm90"),
                 ((2, 1, 1024, 256), 1024, False, bf16, "sm90"),
                 ((1, 1, 16384, 64), 16384, False, bf16, "sm90"),
                 ((1, 1, 512, 64), 512, False, f32, "cuda_core")]
                + [c + (f32, "cuda_core") for c in small] + [c + (bf16, "sm90") for c in small]
                + [((2, 2, 300, 64), 300, True, bf16, "cuda_core")] + wide_heads + many_heads)
    for (q_shape, s_k, causal, dtype, route) in k3_cases:
        unaligned = q_shape == (2, 2, 300, 64)
        q, k, v, _ = flash_inputs(q_shape, s_k, dtype, unaligned, SEED)
        before = dict(att.flash_attention.route_counts)
        got_o, got_lse = att.flash_attention(q, k, v, causal, return_lse=True)
        again_o, again_lse = att.flash_attention(q, k, v, causal, return_lse=True)
        torch.cuda.synchronize()
        took = {r: n - before[r] for r, n in att.flash_attention.route_counts.items()
                if n != before[r]}
        if took != {route: 2}:
            raise AssertionError(f"K3 q{q_shape} {dtype}: routes {took}, want {route}")
        if not (torch.equal(got_o, again_o) and torch.equal(got_lse, again_lse)):
            raise AssertionError(f"K3 q{q_shape} {dtype}: two launches gave different bits")
        want_o, want_lse = att.flash_reference(q, k, v, causal)
        err = (got_o.float() - want_o.float()).abs().max().item()
        err_lse = (got_lse - want_lse).abs().max().item()
        # float32 P on both sides, or (tensor-core route) P rounded to bf16
        # before P.V: 2^-9 relative a term, averaging out over a row, under
        # the one rounding of O to bf16 that both carry
        tol = TOL_K3_BF16 if dtype == torch.bfloat16 else TOL_K3_F32
        note = ""
        if route == "sm90":
            want_p, _ = att.flash_reference(q, k, v, causal, p_dtype=torch.bfloat16)
            note = (f"; against the plain version with bf16 P "
                    f"{(got_o.float() - want_p.float()).abs().max().item():.3g}")
            del want_p
        log("kernels", f"K3 flash_attention q{q_shape} s_k={s_k} causal={causal} {dtype}"
            f"{' (view 8 bytes into its rows)' if unaligned else ''}, route {route}: "
            f"O max|d| {err:.3g} (tol {tol} abs/rel){note}, lse max|d| {err_lse:.3g} "
            f"(tol {TOL_LSE} abs/rel); two launches equal bits")
        torch.testing.assert_close(got_o.float(), want_o.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(got_lse, want_lse, rtol=TOL_LSE, atol=TOL_LSE)
        errs["flash_attention"] = max(errs["flash_attention"], err)
        del q, k, v, got_o, got_lse, again_o, again_lse, want_o, want_lse

    # K4/K5: the U-Net's three shapes (batch 2), the super-resolution U-Net's
    # (d=192, padded to 256), the classifier's (2 heads, d=64), and small
    # causal / ragged / cross / fully-masked-row cases in float32 (the
    # CUDA-core kernels) and in bf16 (the tensor-core kernels), and a bf16
    # view that starts 8 bytes into its rows, which 16-byte copies cannot
    # read: it must take the CUDA-core kernels; head dims 320 and 512; more
    # than 65,535 (batch, head) pairs. Every lse comes from K3 by the route
    # of the same inputs, so the pair forward + backward is held
    cases = ([((2, 1, 16384, 64), 16384, False, torch.bfloat16, "sm90"),
              ((2, 1, 4096, 128), 4096, False, torch.bfloat16, "sm90"),
              ((2, 1, 1024, 256), 1024, False, torch.bfloat16, "sm90"),
              ((2, 1, 1024, 192), 1024, False, torch.bfloat16, "sm90"),
              ((2, 2, 1024, 64), 1024, False, torch.bfloat16, "sm90"),
              ((1, 1, 512, 64), 512, False, torch.float32, "cuda_core")]
             + [c + (torch.float32, "cuda_core") for c in small]
             + [c + (torch.bfloat16, "sm90") for c in small]
             + [((2, 2, 300, 64), 300, True, torch.bfloat16, "cuda_core")]
             + wide_heads + many_heads)
    errs["flash_bwd_dkv"] = errs["flash_bwd_dq"] = 0.0
    for (q_shape, s_k, causal, dtype, route) in cases:
        unaligned = q_shape == (2, 2, 300, 64)
        q, k, v, do = flash_inputs(q_shape, s_k, dtype, unaligned, SEED + 20)
        o, lse = att.flash_attention(q, k, v, causal, return_lse=True)
        delta = (do.float() * o.float()).sum(-1)
        before = dict(att.flash_bwd_dkv.route_counts), dict(att.flash_bwd_dq.route_counts)
        dk, dv = att.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        dq = att.flash_bwd_dq(q, k, v, do, lse, delta, causal)
        dk2, dv2 = att.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        dq2 = att.flash_bwd_dq(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        for fn, was in zip((att.flash_bwd_dkv, att.flash_bwd_dq), before):
            took = {r: n - was[r] for r, n in fn.route_counts.items() if n != was[r]}
            if took != {route: 2}:
                raise AssertionError(f"K4/K5 q{q_shape} {dtype}: routes {took}, want {route}")
        if not (torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)):
            raise AssertionError(f"K4/K5 q{q_shape} {dtype}: two launches gave different bits")
        want = att.flash_backward_reference(q, k, v, do, lse, delta, causal)
        # the plain version rounding P and dS where the tensor-core kernels do
        want_p = (att.flash_backward_reference(q, k, v, do, lse, delta, causal,
                                               p_dtype=torch.bfloat16)
                  if route == "sm90" else want)
        tol = TOL_BWD_BF16 if dtype == torch.bfloat16 else TOL_BWD_F32
        rel, rel_p = [], []
        for got, ref, ref_p, name in zip((dq, dk, dv), want, want_p, ("dq", "dk", "dv")):
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError(f"K4/K5 {name}: {got.shape} {got.dtype}, want "
                                     f"{ref.shape} {ref.dtype}")
            diff = (got.float() - ref.float()).abs().max().item()
            rel.append(diff / ref.float().abs().max().item())
            rel_p.append((got.float() - ref_p.float()).abs().max().item()
                         / ref.float().abs().max().item())
            errs["flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"] = max(
                errs["flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"], diff)
        log("kernels", f"K4/K5 flash backward q{q_shape} s_k={s_k} causal={causal} {dtype}"
            f"{' (view 8 bytes into its rows)' if unaligned else ''}, route {route}: "
            f"max|d|/max|ref| dq {rel[0]:.3g} dk {rel[1]:.3g} dv {rel[2]:.3g} (tol {tol})"
            + (f"; against the plain version with bf16 P and dS dq {rel_p[0]:.3g} dk "
               f"{rel_p[1]:.3g} dv {rel_p[2]:.3g}" if route == "sm90" else "")
            + "; two launches equal bits")
        if not max(rel) <= tol:
            raise AssertionError(f"K4/K5 q{q_shape} s_k={s_k}: {rel} > {tol}")
        del q, k, v, do, o, lse, delta, dq, dk, dv, dq2, dk2, dv2, want, want_p

    # under autograd, on column slices of one qkv as the U-Net calls it, and
    # rows that see no key (causal, s_q > s_k) against attention_reference
    qkv = _uniform((2, 4096, 3 * 128), -2, 2, SEED + 30, torch.bfloat16).requires_grad_()
    cot = _uniform((2, 4096, 128), -1, 1, SEED + 31, torch.bfloat16)
    (att.mha(*qkv.chunk(3, dim=-1), 1).float() * cot.float()).sum().backward()
    q, k, v = (t.detach().reshape(2, 4096, 1, 128).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    o, lse = att.flash_reference(q, k, v)
    do = cot.reshape(2, 4096, 1, 128).transpose(1, 2)
    want = att.flash_backward_reference(q, k, v, do, lse, (do.float() * o.float()).sum(-1))
    want = torch.cat([g.transpose(1, 2).reshape(2, 4096, 128) for g in want], dim=-1)
    rel = ((qkv.grad.float() - want.float()).abs().max() / want.float().abs().max()).item()
    log("kernels", f"K3+K4+K5 under autograd on qkv slices (2,4096,3x128) bf16: "
        f"max|d|/max|ref| {rel:.3g} (tol {TOL_BWD_BF16})")
    if not rel <= TOL_BWD_BF16:
        raise AssertionError(f"flash autograd on qkv slices: {rel} > {TOL_BWD_BF16}")
    q = _uniform((1, 2, 200, 32), -2, 2, SEED + 32).requires_grad_()
    k, v = (_uniform((1, 2, 150, 32), -2, 2, SEED + 33 + i).requires_grad_() for i in range(2))
    cot = _uniform((1, 2, 200, 32), -1, 1, SEED + 35)
    (att.flash_attention(q, k, v, causal=True) * cot).sum().backward()
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    (att.attention_reference(*ref, causal=True) * cot).sum().backward()
    err = max((t.grad - r.grad).abs().max().item() for t, r in zip((q, k, v), ref))
    log("kernels", f"K4/K5 causal q 200 kv 150 (50 rows see no key) f32: gradients vs "
        f"autograd through attention_reference max|d| {err:.3g} (tol {TOL_BWD_F32})")
    for t, r in zip((q, k, v), ref):
        torch.testing.assert_close(t.grad, r.grad, rtol=TOL_BWD_F32, atol=TOL_BWD_F32)
    # the same in bf16 (the tensor-core kernels) against autograd through
    # attention_reference on the float32 values of the same bf16 inputs
    lo = [t.detach().to(torch.bfloat16).requires_grad_() for t in (q, k, v)]
    was = att.flash_bwd_dkv.route_counts["sm90"], att.flash_bwd_dq.route_counts["sm90"]
    (att.flash_attention(*lo, causal=True).float() * cot).sum().backward()
    if (att.flash_bwd_dkv.route_counts["sm90"], att.flash_bwd_dq.route_counts["sm90"]) != (
            was[0] + 1, was[1] + 1):
        raise AssertionError("the bf16 backward did not take the tensor-core kernels")
    ref = [t.detach().float().requires_grad_() for t in lo]
    (att.attention_reference(*ref, causal=True) * cot).sum().backward()
    rel = max(((t.grad.float() - r.grad).abs().max() / r.grad.abs().max()).item()
              for t, r in zip(lo, ref))
    log("kernels", f"K4/K5 causal q 200 kv 150 (50 rows see no key) bf16, route sm90: gradients "
        f"vs autograd through attention_reference in float32 max|d|/max|ref| {rel:.3g} "
        f"(tol {TOL_BWD_BF16})")
    if not rel <= TOL_BWD_BF16:
        raise AssertionError(f"bf16 blind rows: {rel} > {TOL_BWD_BF16}")
    errs.update(check_matmul())
    return errs


def _int8(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).to("cuda")


# K6's shapes (M, K, N). As int8 serving calls it (K padded to 16 by im2col,
# B a strided view of the (N, K) weight): the generator's 7x7 stem, mel stem,
# last 3x3, 1x1 bottleneck, last 1x1 and largest conv, M cut to 65,536 rows
# where it was 1,179,648 or 163,840; the ViViT's qkv, MLP-in and MLP-out.
K6_SERVING_SHAPES = [(65536, 304, 16), (65536, 16, 32), (65536, 720, 32), (128, 4608, 512),
                     (65536, 32, 3), (65536, 1440, 64),
                     (30720, 256, 768), (30720, 256, 1024), (30720, 1024, 256)]
# Row-major B, depths that are no multiple of 16 (the element-wise loads of
# the mma.sync kernel): the stems before padding and ragged shapes.
K6_ROW_MAJOR_SHAPES = [(65536, 294, 16), (65536, 9, 32), (257, 131, 67), (5, 9, 3)]
# The tensor-core kernel's edges, B the (N, K) weight transposed: M, N and K
# one above and one below a tile, a single element of C, and more columns
# than the mma.sync kernel's grid takes (65,535 x 64).
K6_EDGE_SHAPES = [(129, 144, 72), (255, 4608, 8), (1, 16, 1), (2, 16, 65535 * 64 + 8)]


def check_matmul() -> dict:
    from lipreading_video_generation_tpu_torch.ops import matmul_cuda as mm

    errs = {"int8_matmul": 0.0, "bf16_matmul": 0.0}
    # (shape, layout of B, route of int8, route of bf16)
    cases = ([(shape, "transposed", "sm90", "sm90") for shape in K6_SERVING_SHAPES]
             + [(shape, "row_major", "mma_sync", "mma_sync") for shape in K6_ROW_MAJOR_SHAPES]
             # the microbench's operands: a row-major bf16 B is the tensor-core
             # kernel's MN-major operand, a row-major int8 B has none there
             + [((4096, 4096, 4096), "row_major", "mma_sync", "sm90"),
                ((4096, 4096, 4096), "transposed", "sm90", "sm90")]
             + [(shape, "transposed", "sm90", "sm90") for shape in K6_EDGE_SHAPES]
             # views that start one element into wider rows: no 16-byte copies
             + [((300, 64, 48), "unaligned", "mma_sync", "mma_sync")])
    for (m, k, n), layout, route8, route16 in cases:
        pad = 16 if layout == "unaligned" else 0

        def operands(make_a, make_b):
            a = make_a((m, k + pad))[:, 1:1 + k] if pad else make_a((m, k))
            if layout == "row_major":
                return a, make_b((k, n))
            b = make_b((n, k + pad))
            return a, (b[:, 1:1 + k] if pad else b).t()

        a8, b8 = operands(lambda sh: _int8(sh, SEED + 60), lambda sh: _int8(sh, SEED + 61))
        a16, b16 = operands(lambda sh: _uniform(sh, -1, 1, SEED + 62, torch.bfloat16),
                            lambda sh: _uniform(sh, -1, 1, SEED + 63, torch.bfloat16))
        before = dict(mm.int8_matmul.route_counts), dict(mm.bf16_matmul.route_counts)
        got, again = mm.int8_matmul(a8, b8), mm.int8_matmul(a8, b8)
        got16, again16 = mm.bf16_matmul(a16, b16), mm.bf16_matmul(a16, b16)
        torch.cuda.synchronize()
        for fn, was, route in zip((mm.int8_matmul, mm.bf16_matmul), before, (route8, route16)):
            took = {r: c - was[r] for r, c in fn.route_counts.items() if c != was[r]}
            if took != {route: 2}:
                raise AssertionError(f"K6 {fn.__name__} ({m},{k},{n}) B {layout}: routes {took}, "
                                     f"want {route}")
        if not (torch.equal(got, again) and torch.equal(got16, again16)):
            raise AssertionError(f"K6 ({m},{k},{n}) B {layout}: two launches gave different bits")
        want = mm.matmul_reference(a8, b8)
        err8 = (got - want).abs().max().item()
        want16 = mm.matmul_reference(a16, b16)
        err16 = (got16 - want16).abs().max().item()
        bound16 = TOL_K6_BF16 * want16.abs().max().item()
        log("kernels", f"K6 matmul ({m} x {k} x {n}) B {layout}, routes int8 {route8} / bf16 "
            f"{route16}: int8 max|d| {err8} (must be 0), bf16 max|d| {err16:.3g} (tol "
            f"{bound16:.3g} = {TOL_K6_BF16} of max|C|); two launches equal bits")
        if got.dtype != torch.int32 or got16.dtype != torch.float32:
            raise AssertionError(f"K6 output types {got.dtype}, {got16.dtype}")
        if err8 != 0 or not err16 <= bound16:
            raise AssertionError(f"K6 ({m},{k},{n}): int8 max|d| {err8}, bf16 {err16} > {bound16}")
        errs["int8_matmul"] = max(errs["int8_matmul"], float(err8))
        errs["bf16_matmul"] = max(errs["bf16_matmul"], err16)
        del a8, b8, got, again, want, a16, b16, got16, again16, want16
    return errs


def flax_vivit_params(cfg, seed: int) -> dict:
    """Random weights in the Flax ViViT's tree and shapes (the card's
    machine has no flax): Dense kernels ~ N(0, 1/fan_in), small biases,
    LayerNorm scales near 1."""
    rng = np.random.default_rng(seed)
    e = cfg.hidden_size

    def dense(n_in, n_out):
        return {"kernel": rng.standard_normal((n_in, n_out)).astype(np.float32)
                / math.sqrt(n_in),
                "bias": 0.02 * rng.standard_normal(n_out).astype(np.float32)}

    def norm(n):
        return {"scale": 1 + 0.05 * rng.standard_normal(n).astype(np.float32),
                "bias": 0.05 * rng.standard_normal(n).astype(np.float32)}

    tt, th, tw = cfg.tubelet_size
    n_tokens = (cfg.num_frames // tt) * (cfg.image_size // th) * (cfg.image_size // tw)
    params = {"TubeletEmbed_0": {"proj": dense(tt * th * tw * cfg.num_channels, e)},
              "pos_embedding": 0.02 * rng.standard_normal((1, n_tokens, e)).astype(np.float32)}
    for i in range(cfg.num_layers):
        params[f"block_{i}"] = {
            "LayerNorm_0": norm(e), "qkv": dense(e, 3 * e), "proj": dense(e, e),
            "LayerNorm_1": norm(e),
            "MLP_0": {"Dense_0": dense(e, cfg.mlp_dim), "Dense_1": dense(cfg.mlp_dim, e)}}
    params["LayerNorm_0"] = norm(e)
    params["head"] = dense(e, cfg.num_classes)
    return params


def request_inputs(n_clips: int, seed: int):
    """bench.py's inputs: random 96×96 RGB uint8 frames, face boxes
    [8, 92, 6, 90] ± 2."""
    rng = np.random.default_rng(seed)
    n = n_clips * CLIP_FRAMES
    frames = rng.integers(0, 256, (n, 96, 96, 3), dtype=np.uint8)
    boxes = (np.tile([8.0, 92.0, 6.0, 90.0], (n, 1))
             + rng.uniform(-2, 2, (n, 4))).astype(np.float32)
    return frames, boxes


def serve(model, frames: np.ndarray, boxes: np.ndarray, device):
    """One request: host frames and boxes in, host logits (and ROI) out."""
    from lipreading_video_generation_tpu_torch.core.config import PreprocessConfig
    from lipreading_video_generation_tpu_torch.pipelines.preprocess import mouth_roi_pipeline

    cfg, pre = model.cfg, PreprocessConfig()
    f = torch.from_numpy(frames).to(device)
    b = torch.from_numpy(boxes).to(device)
    roi = mouth_roi_pipeline(f, b, pre.lip_crop_size, pre.model_input_size,
                             pre.clahe_clip_limit, pre.clahe_grid)  # (B·T, 32, 32, 1)
    clips = roi.reshape(-1, cfg.num_frames, cfg.image_size, cfg.image_size, 1)
    logits = model(clips.to(torch.float32) / 255.0)
    return logits.cpu(), roi.cpu()


def serve_int8_request(model, frames: np.ndarray, boxes: np.ndarray) -> dict:
    """One request through ``predict_step_int8`` (host frames in, host
    log-probs out) and the same through ``predict_step``; returns the int8
    request's launches."""
    from lipreading_video_generation_tpu_torch.core.config import PreprocessConfig
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl
    from lipreading_video_generation_tpu_torch.ops import matmul_cuda as mm
    from lipreading_video_generation_tpu_torch.pipelines import train_vivit as tv
    from lipreading_video_generation_tpu_torch.pipelines.preprocess import mouth_roi_pipeline

    cfg, pre = model.cfg, PreprocessConfig()

    def request(step):
        roi = mouth_roi_pipeline(torch.from_numpy(frames).to("cuda"),
                                 torch.from_numpy(boxes).to("cuda"), pre.lip_crop_size,
                                 pre.model_input_size, pre.clahe_clip_limit, pre.clahe_grid)
        clips = roi.reshape(-1, cfg.num_frames, cfg.image_size, cfg.image_size, 1)
        return step(model, clips).cpu()

    n_linear = sum(isinstance(m, torch.nn.Linear) for m in model.modules())
    request(tv.predict_step_int8)                                  # warm-up
    before = (cl.clahe_cuda.launch_count, att.small_mha.launch_count,
              mm.int8_matmul.launch_count)
    routed = att.small_mha.route_counts["sm90"], mm.int8_matmul.route_counts["sm90"]
    t0 = time.perf_counter()
    q = request(tv.predict_step_int8)
    q_s = time.perf_counter() - t0
    d = (cl.clahe_cuda.launch_count - before[0], att.small_mha.launch_count - before[1],
         mm.int8_matmul.launch_count - before[2])
    if d != (1, cfg.num_layers, n_linear):
        raise AssertionError(f"int8 request launched K1/K2/K6 {d}, want "
                             f"(1, {cfg.num_layers}, {n_linear})")
    by_tc = (att.small_mha.route_counts["sm90"] - routed[0],
             mm.int8_matmul.route_counts["sm90"] - routed[1])
    if by_tc != (cfg.num_layers, n_linear):
        raise AssertionError(f"int8 request: K2/K6 launches by the tensor-core route {by_tc}, "
                             f"want ({cfg.num_layers}, {n_linear})")
    t0 = time.perf_counter()
    f = request(tv.predict_step)
    f_s = time.perf_counter() - t0
    if mm.int8_matmul.launch_count - before[2] != n_linear:
        raise AssertionError("predict_step launched K6")
    agree = (q.argmax(-1) == f.argmax(-1)).float().mean().item()
    worst = (q - f).abs().max().item()
    log("serve", f"predict_step_int8, batch {len(q)}: K1 1, K2 {cfg.num_layers}, K6 {n_linear} "
        f"launches, K2 and K6 all by the tensor-core route; against predict_step on the same ROIs: top-1 agreement {agree:.4f} "
        f"(want >= {INT8_TOP1_AGREE}), max |d log-prob| {worst:.4f} (want < {INT8_LOGPROB}); "
        f"request {q_s * 1e3:.3f} ms int8, {f_s * 1e3:.3f} ms bf16")
    if not (torch.isfinite(q).all() and agree >= INT8_TOP1_AGREE and worst < INT8_LOGPROB):
        raise AssertionError(f"int8 ViViT: agreement {agree}, max |d log-prob| {worst}")
    _profile_step("serve", lambda: request(tv.predict_step_int8), "int8 request")
    return {"clahe": d[0], "small_mha": d[1], "int8_matmul": d[2]}


K1_PROFILED_MS = []   # K1's device time in the profiled batch-384 ViViT request


def phase_serve(dev: dict) -> dict:
    from lipreading_video_generation_tpu_torch.core.config import ViViTConfig
    from lipreading_video_generation_tpu_torch.models.convert import vivit_state_dict_from_flax
    from lipreading_video_generation_tpu_torch.models.vivit import ViViT
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl

    cfg = ViViTConfig(num_classes=64)
    state = vivit_state_dict_from_flax(flax_vivit_params(cfg, SEED))
    model = ViViT(cfg).eval()
    model.load_state_dict(state)
    cpu_model = ViViT(cfg).eval()
    cpu_model.load_state_dict(state)
    model = model.to("cuda")
    n_params = sum(p.numel() for p in model.parameters())
    log("serve", f"ViViT defaults: layers={cfg.num_layers} hidden={cfg.hidden_size} "
        f"heads={cfg.num_heads} mlp={cfg.mlp_dim} dtype={cfg.dtype} "
        f"classes={cfg.num_classes}; {n_params} params from seeded numpy via "
        "vivit_state_dict_from_flax")

    inputs = {8: request_inputs(8, SEED), 384: request_inputs(384, SEED)}
    times = {8: [], 384: []}
    with torch.inference_mode():
        for n_clips in inputs:                           # warm-up: cuBLAS, allocator
            serve(model, *inputs[n_clips], "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        for n_clips in (8, 8, 8, 384, 384, 384):
            k1, k2 = cl.clahe_cuda.launch_count, att.small_mha.launch_count
            t0 = time.perf_counter()
            logits, roi = serve(model, *inputs[n_clips], "cuda")
            times[n_clips].append(time.perf_counter() - t0)
            d1, d2 = cl.clahe_cuda.launch_count - k1, att.small_mha.launch_count - k2
            if (d1, d2) != (1, cfg.num_layers):
                raise AssertionError(f"request of {n_clips} clips launched K1 {d1}x and "
                                     f"K2 {d2}x, want 1 and {cfg.num_layers}")
            if logits.shape != (n_clips, cfg.num_classes) or not torch.isfinite(logits).all():
                raise AssertionError(f"bad logits {tuple(logits.shape)} for {n_clips} clips")
        launches = {"clahe": cl.clahe_cuda.launch_count,
                    "small_mha": att.small_mha.launch_count}
        if cl.clahe_cuda.route_counts != {"packed": launches["clahe"], "tiled": 0}:
            raise AssertionError(f"serve: K1 took the routes {cl.clahe_cuda.route_counts}, "
                                 "want all packed")
        peak = torch.cuda.max_memory_allocated()
        _all_by_tensor_cores("serve", att.small_mha)
        log("serve", f"6 requests: launches K1={launches['clahe']} K2={launches['small_mha']} "
            f"(1 and {cfg.num_layers} per request; K1 routes {cl.clahe_cuda.route_counts}, K2 "
            f"routes {att.small_mha.route_counts}); "
            "logits finite")
        # where the time of a batch-384 request goes
        busy_ms = _profile_step("serve", lambda: serve(model, *inputs[384], "cuda"), "request")
        k1_ms, k1_n = _profile_step.own["K1"]
        if k1_n != 1:
            raise AssertionError(f"the profiled request ran {k1_n} K1 kernels, want 1")
        log("serve", f"K1 in the profiled batch-384 request: {k1_ms:.4f} ms of device time, one "
            "launch by the packed route (the one-block-an-image kernel it replaced: 0.094 ms) on "
            f"{dev['smi']}")
        K1_PROFILED_MS.append(k1_ms)

        gpu_logits, gpu_roi = serve(model, *inputs[8], "cuda")
        cpu_logits, cpu_roi = serve(cpu_model, *inputs[8], "cpu")
    d = (gpu_roi.int() - cpu_roi.int()).abs()
    within1 = (d <= 1).float().mean().item()
    log("serve", f"batch 8, card vs CPU plain path: ROI max|d| {d.max().item()} levels, "
        f"{within1:.5f} within 1 (want >= 0.99); logits max|d| "
        f"{(gpu_logits - cpu_logits).abs().max().item():.4g} of max|logit| "
        f"{cpu_logits.abs().max().item():.4g} (tol {TOL_LOGITS} abs + rel)")
    if within1 < 0.99:
        raise AssertionError(f"ROI card vs CPU: only {within1} within 1 level")
    torch.testing.assert_close(gpu_logits, cpu_logits, rtol=TOL_LOGITS, atol=TOL_LOGITS)

    for name, count in serve_int8_request(model, *inputs[384]).items():
        launches[name] = launches.get(name, 0) + count

    per_req = statistics.median(times[384])
    log("serve", f"request times ({dev['smi']}): batch 8 "
        f"{[round(t * 1e3, 3) for t in times[8]]} ms; batch 384 "
        f"{[round(t * 1e3, 3) for t in times[384]]} ms; batch 384 median "
        f"{per_req * 1e3:.3f} ms = {384 * CLIP_FRAMES / per_req:.1f} frames/s (the profiled "
        f"request's {busy_ms:.3f} ms of kernels and copies are {busy_ms / (per_req * 1e3):.3f} "
        f"of it); peak device memory {peak / 2**20:.1f} MiB")
    return launches


def flax_unet_audio_params(cfg, seed: int) -> dict:
    """Random weights in the tree and shapes of the Flax ``UNetAudio(cfg)``
    (native audio encoder; the card's machine has no flax): conv and Dense
    kernels ~ N(0, 1/fan_in), the layers Flax zero-initialises (each
    ResBlock's second conv, each attention projection, the output conv) at
    a fifth of that so that they still act, small biases, norm scales near 1."""
    from lipreading_video_generation_tpu_torch.models.audio_encoder import num_tokens
    from lipreading_video_generation_tpu_torch.models.unet import plan

    rng = np.random.default_rng(seed)

    def kernel(shape, fan_in, gain=1.0):
        return (gain * rng.standard_normal(shape) / math.sqrt(fan_in)).astype(np.float32)

    def bias(n):
        return (0.02 * rng.standard_normal(n)).astype(np.float32)

    def dense(n_in, n_out, gain=1.0):
        return {"kernel": kernel((n_in, n_out), n_in, gain), "bias": bias(n_out)}

    def conv(kh, kw, c_in, c_out, gain=1.0):
        return {"kernel": kernel((kh, kw, c_in, c_out), kh * kw * c_in, gain), "bias": bias(c_out)}

    def norm(n):
        return {"scale": (1 + 0.05 * rng.standard_normal(n)).astype(np.float32),
                "bias": (0.05 * rng.standard_normal(n)).astype(np.float32)}

    e = cfg.audio_embed_dim
    enc = {"Conv_0": {"kernel": kernel((5, 80, e // 2), 5 * 80), "bias": bias(e // 2)},
           "Conv_1": {"kernel": kernel((3, e // 2, e), 3 * e // 2), "bias": bias(e)},
           "LayerNorm_0": norm(e), "LayerNorm_1": norm(e),
           "pos_embedding": (0.02 * rng.standard_normal(
               (1, num_tokens(cfg.audio_samples), e))).astype(np.float32)}
    for i in range(4):
        enc[f"block_{i}"] = {"LayerNorm_0": norm(e), "qkv": dense(e, 3 * e), "proj": dense(e, e),
                             "LayerNorm_1": norm(e),
                             "MLP_0": {"Dense_0": dense(e, 4 * e), "Dense_1": dense(4 * e, e)}}
    base, ted = cfg.base_channels, cfg.time_embed_dim
    c_in = cfg.im_channels + cfg.audio_proj_dim + cfg.im_cond_channels
    unet = {"Dense_0": dense(base, ted), "Dense_1": dense(ted, ted),
            "Conv_0": conv(3, 3, c_in, base),
            "GroupNorm_0": norm(base * cfg.channel_mult[0]),
            "Conv_1": conv(3, 3, base * cfg.channel_mult[0], cfg.im_channels, 0.2)}
    count = {"res": 0, "attn": 0, "down": 0, "up": 0}
    names = {"res": "ResBlock", "attn": "AttentionBlock", "down": "Downsample", "up": "Upsample"}
    for step in plan(base, cfg.channel_mult, cfg.num_res_blocks, cfg.attention_resolutions):
        kind = step[0]
        if kind not in names:
            continue
        name = f"{names[kind]}_{count[kind]}"
        count[kind] += 1
        if kind == "res":
            ci, co = step[1], step[2]
            p = {"GroupNorm_0": norm(ci), "Conv_0": conv(3, 3, ci, co), "Dense_0": dense(ted, 2 * co),
                 "GroupNorm_1": norm(co), "Conv_1": conv(3, 3, co, co, 0.2)}
            if ci != co:
                p["Conv_2"] = conv(1, 1, ci, co)
        elif kind == "attn":
            c = step[1]
            p = {"GroupNorm_0": norm(c), "qkv": dense(c, 3 * c), "proj": dense(c, c, 0.2)}
        else:
            p = {"Conv_0": conv(3, 3, step[1], step[1])}
        unet[name] = p
    return {"audio_encoder": enc, "audio_proj": dense(e, cfg.audio_proj_dim),
            "im_cond_conv": conv(1, 1, cfg.im_channels, cfg.im_cond_channels), "unet": unet}


def diffusion_inputs(cfg, n_frames: int, seed: int):
    """A random 160×160 RGB uint8 condition frame (resized to im_size on the
    way in) and ``n_frames`` random 4000-sample audio windows."""
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (160, 160, 3), dtype=np.uint8)
    audio = rng.standard_normal((n_frames, cfg.audio_samples)).astype(np.float32)
    return frame, audio


def _load_unet_audio(cfg, state, device):
    from lipreading_video_generation_tpu_torch.models.unet_audio import UNetAudio

    model = UNetAudio(cfg).eval()
    model.load_state_dict(state)
    return model.to(device)


def phase_diffuse(dev: dict) -> dict:
    import dataclasses

    from lipreading_video_generation_tpu_torch.core.config import DiffusionConfig
    from lipreading_video_generation_tpu_torch.models.convert import (
        unet_audio_state_dict_from_flax)
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl
    from lipreading_video_generation_tpu_torch.ops.image import denormalize_to_uint8
    from lipreading_video_generation_tpu_torch.pipelines.sample_diffusion import (
        sample, sample_video)

    cfg = DiffusionConfig()
    state = unet_audio_state_dict_from_flax(flax_unet_audio_params(cfg, SEED), cfg)
    model = _load_unet_audio(cfg, state, "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    n_attn = sum(type(m).__name__ == "AttentionBlock" for m in model.modules())
    if n_attn != 16:
        raise AssertionError(f"{n_attn} AttentionBlocks at the defaults, want 16")
    log("diffuse", f"DiffusionConfig defaults: {cfg.im_size}x{cfg.im_size}, base "
        f"{cfg.base_channels}, channel_mult {cfg.channel_mult}, {cfg.num_res_blocks} res "
        f"blocks, attention at ds {cfg.attention_resolutions} ({n_attn} AttentionBlocks), "
        f"{cfg.num_heads} head, {cfg.dtype}, native audio encoder; {n_params} params from "
        "seeded numpy via unet_audio_state_dict_from_flax")
    frame, audio = diffusion_inputs(cfg, DIFF_FRAMES, SEED)
    gen = torch.Generator("cuda")

    def request(sampler):
        return sample_video(model, frame, audio, cfg, num_inference_steps=DIFF_STEPS,
                            sampler=sampler, generator=gen.manual_seed(SEED))

    # warm-up (cuDNN, allocator): the same request through ``sample`` with
    # float frames out, which must be finite (uint8 frames cannot show a NaN)
    cond = torch.as_tensor(frame)[None].expand((DIFF_FRAMES,) + frame.shape)
    warm, _ = sample(model, cond, audio, cfg, num_inference_steps=DIFF_STEPS,
                     snapshot_every=cfg.num_timesteps + 1, generator=gen.manual_seed(SEED))
    if not bool(torch.isfinite(warm).all()):
        raise AssertionError("diffusion request gave non-finite frames")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    times = []
    for sampler in ("ddim", "ddim", "ddim", "dpmpp"):
        k1, k2, k3 = (cl.clahe_cuda.launch_count, att.small_mha.launch_count,
                      att.flash_attention.launch_count)
        t0 = time.perf_counter()
        out = request(sampler).cpu()
        times.append(time.perf_counter() - t0)
        d = (cl.clahe_cuda.launch_count - k1, att.small_mha.launch_count - k2,
             att.flash_attention.launch_count - k3)
        if d != (0, 4, n_attn * DIFF_STEPS):
            raise AssertionError(f"{sampler} request launched K1/K2/K3 {d}, want "
                                 f"(0, 4, {n_attn * DIFF_STEPS})")
        if out.dtype != torch.uint8 or tuple(out.shape) != (DIFF_FRAMES, 128, 128, 3):
            raise AssertionError(f"bad frames {out.dtype} {tuple(out.shape)}")
        if sampler == "ddim":     # same seed as the warm-up: the same frames
            same = (out.int() - denormalize_to_uint8(warm).cpu().int()).abs().max().item()
            if same > 1:
                raise AssertionError(f"ddim request differs from its float warm-up by {same}")
    launches = {"small_mha": att.small_mha.launch_count,
                "flash_attention": att.flash_attention.launch_count}
    peak = torch.cuda.max_memory_allocated()
    _all_by_tensor_cores("diffuse", att.flash_attention, att.small_mha)
    log("diffuse", f"4 requests (ddim x3, dpmpp) of {DIFF_FRAMES} frames x {DIFF_STEPS} "
        f"steps: launches K1=0 K2={launches['small_mha']} K3={launches['flash_attention']} "
        f"(4 and {n_attn}x{DIFF_STEPS} per request; K3 routes "
        f"{att.flash_attention.route_counts}, K2 routes {att.small_mha.route_counts}); uint8 frames "
        f"{tuple(out.shape)}, pixel mean {out.float().mean().item():.2f}")

    # where the time of a DDIM request goes
    busy_ms = _profile_step("diffuse", lambda: request("ddim").cpu(), "request")

    # the full DDPM ancestral chain (500 steps) at batch 1
    k2, k3 = att.small_mha.launch_count, att.flash_attention.launch_count
    t0 = time.perf_counter()
    chain = sample_video(model, frame, audio[:1], cfg, generator=gen.manual_seed(SEED)).cpu()
    chain_s = time.perf_counter() - t0
    d = (att.small_mha.launch_count - k2, att.flash_attention.launch_count - k3)
    if d != (4, n_attn * cfg.num_timesteps) or tuple(chain.shape) != (1, 128, 128, 3):
        raise AssertionError(f"DDPM chain launched K2/K3 {d}, gave {tuple(chain.shape)}")
    _all_by_tensor_cores("diffuse", att.flash_attention)
    log("diffuse", f"full DDPM chain, batch 1, {cfg.num_timesteps} steps: {chain_s:.3f} s "
        f"({cfg.num_timesteps / chain_s:.2f} frame-steps/s), K2={d[0]} K3={d[1]} launches "
        f"(K3 routes {att.flash_attention.route_counts}), "
        f"uint8 frame pixel mean {chain.float().mean().item():.2f}")

    # the card against the CPU plain path: 64x64, batch 1, 2 DDIM steps
    cfg64 = dataclasses.replace(cfg, im_size=64)
    noise = np.random.default_rng(SEED + 1).standard_normal((1, 64, 64, 3)).astype(np.float32)
    outs = {}
    for device in ("cuda", "cpu"):
        m = _load_unet_audio(cfg64, state, device)
        x0, _ = sample(m, frame[None], audio[:1], cfg64, num_inference_steps=2, noise=noise)
        outs[device] = x0.cpu()
        del m
    diff = (outs["cuda"] - outs["cpu"]).abs()
    log("diffuse", f"64x64, batch 1, 2 DDIM steps, card vs CPU plain path: frames max|d| "
        f"{diff.max().item():.4g}, mean|d| {diff.mean().item():.4g} (tol {TOL_FRAMES} abs); "
        f"finite {bool(torch.isfinite(outs['cuda']).all())}")
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=0, atol=TOL_FRAMES)

    per_req = statistics.median(times[:3])
    log("diffuse", f"request times ({dev['smi']}): ddim {[round(t * 1e3, 3) for t in times[:3]]} "
        f"ms, dpmpp {times[3] * 1e3:.3f} ms; ddim median {per_req * 1e3:.3f} ms = "
        f"{DIFF_FRAMES * DIFF_STEPS / per_req:.2f} denoise frame-steps/s (the profiled "
        f"request's {busy_ms:.3f} ms of kernels are {busy_ms / (per_req * 1e3):.3f} of it); "
        f"peak device memory {peak / 2**20:.1f} MiB")
    return launches


def _counts() -> dict:
    from lipreading_video_generation_tpu_torch.ops import attention as att

    return {"small_mha": att.small_mha.launch_count,
            "flash_attention": att.flash_attention.launch_count,
            "flash_bwd_dkv": att.flash_bwd_dkv.launch_count,
            "flash_bwd_dq": att.flash_bwd_dq.launch_count}


def _zero_counts() -> None:
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl
    from lipreading_video_generation_tpu_torch.ops import matmul_cuda as mm

    for fn in (cl.clahe_cuda, att.small_mha, att.flash_attention, att.flash_bwd_dkv,
               att.flash_bwd_dq, mm.int8_matmul, mm.bf16_matmul):
        fn.launch_count = 0
        if hasattr(fn, "route_counts"):
            fn.route_counts = dict.fromkeys(fn.route_counts, 0)


def _all_by_tensor_cores(phase: str, *fns) -> None:
    """Every launch of ``fns`` since ``_zero_counts`` took the tensor-core
    route (``route_counts`` beside ``launch_count``)."""
    for fn in fns:
        others = sum(n for r, n in fn.route_counts.items() if r != "sm90")
        if fn.route_counts["sm90"] != fn.launch_count or others or fn.launch_count < 1:
            raise AssertionError(f"{phase}: {fn.__name__} took the routes {fn.route_counts} in "
                                 f"{fn.launch_count} launches, want all by the tensor cores")


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counts().items()}


def train_batch(cfg, n: int, seed: int, size: int = 160) -> dict:
    """Random ``size``×``size`` RGB uint8 target and condition frames
    (resized to im_size on the way in) and ``n`` random audio windows."""
    rng = np.random.default_rng(seed)
    return {"target_frame": rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            "cond_frame": rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            "audio": rng.standard_normal((n, cfg.audio_samples)).astype(np.float32)}


# kernel-name fragments of the hand-written kernels, for the profiles
KERNEL_NAMES = {"K1": "clahe_", "K2": "small_mha_", "K3": "flash_fwd_",
                "K4": "flash_bwd_dkv", "K5": "flash_bwd_dq", "K6": "::mm_"}


def _profiled(fn):
    """Run ``fn`` (and wait for the card) under ``torch.profiler``: wall ms,
    the events, and the device's kernels and copies as (name, ms, count),
    heaviest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in events
                      if e.device_type == DeviceType.CUDA), key=lambda r: -r[1])
    return wall_ms, events, kernels


def _profile_step(phase: str, step, what: str = "step") -> float:
    """One step (or request) under ``torch.profiler``: wall time, device
    time of all kernels and copies (busy share), the share of each
    hand-written kernel, and the heaviest kernels by name. Returns the
    device time, ms; ``_profile_step.own`` keeps each hand-written kernel's
    (ms, launches) of the last profile."""
    wall_ms, _, kernels = _profiled(step)
    # the int8 stages' ranges carry their kernels' device time: not a second time
    stages = [r for r in kernels if r[0].startswith("int8/")]
    kernels = [r for r in kernels if not r[0].startswith("int8/")]
    busy_ms = sum(ms for _, ms, _ in kernels)
    if busy_ms <= 0:
        raise AssertionError(f"{phase} profile: no device time")
    own = {k: (sum(ms for name, ms, _ in kernels if frag in name),
               sum(n for name, _, n in kernels if frag in name))
           for k, frag in KERNEL_NAMES.items()}
    rest = busy_ms - sum(ms for ms, _ in own.values())
    _profile_step.own = own
    log(phase, f"profile of one {what}: wall {wall_ms:.3f} ms under the profiler, device kernels "
        f"and copies {busy_ms:.3f} ms in {sum(c for _, _, c in kernels)} launches (busy share "
        f"{busy_ms / wall_ms:.3f}); "
        + ", ".join(f"{k} {ms:.3f} ms ({ms / busy_ms:.1%}, {n}x)" for k, (ms, n) in own.items()
                    if n)
        + f", all else {rest:.3f} ms ({rest / busy_ms:.1%})"
        + ("; by int8 stage " + ", ".join(f"{name[5:]} {ms:.3f} ms ({ms / busy_ms:.1%})"
                                          for name, ms, _ in sorted(stages)) if stages else ""))
    for name, ms, count in kernels[:8]:
        log(phase, f"  {ms:9.3f} ms {count:5d}x {name[:110]}")
    return busy_ms


def _finite(module) -> bool:
    return all(bool(torch.isfinite(p).all()) for p in module.parameters())


def _diffusion_state_dict(cfg):
    from lipreading_video_generation_tpu_torch.models.convert import (
        unet_audio_state_dict_from_flax)

    return unet_audio_state_dict_from_flax(flax_unet_audio_params(cfg, SEED), cfg)


def _grad_step(cfg, state_dict, batch, t, noise, device):
    """ε-MSE and the whole flattened gradient of one step of a fresh
    float32 train state on ``device``, at the given t and noise."""
    from lipreading_video_generation_tpu_torch.pipelines import train_diffusion as ttd

    state = ttd.create_state(cfg, seed=SEED, device=device)
    state.model.load_state_dict(state_dict)
    prep = ttd.prepare_batch(batch, cfg, device)
    tt, nn_ = ttd.draw_t_noise(state, prep["target"], cfg.num_timesteps, t, noise)
    noisy = state.scheduler.add_noise(prep["target"], nn_, tt)
    loss = ttd.noise_mse(state.model(noisy, prep["cond"], prep["audio"], tt), nn_)
    loss.backward()
    return loss.item(), torch.cat([p.grad.flatten().double().cpu()
                                   for p in state.model.parameters()])


def phase_train(dev: dict) -> dict:
    import dataclasses

    from lipreading_video_generation_tpu_torch.core.config import DiffusionConfig
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.pipelines import train_diffusion as ttd

    cfg = DiffusionConfig()
    sd = _diffusion_state_dict(cfg)
    state = ttd.create_state(cfg, seed=SEED, device="cuda")
    state.model.load_state_dict(sd)
    state.ema.load_state_dict(sd)
    n_params = sum(p.numel() for p in state.model.parameters())
    log("train", f"DiffusionConfig defaults, batch {TRAIN_BATCH}, dropout {cfg.dropout}, "
        f"lr {cfg.learning_rate}, Adam (0.9, 0.999, 1e-8), EMA {state.ema_rate}; {n_params} "
        "float32 params from seeded numpy via unet_audio_state_dict_from_flax")
    ttd.train_step(state, train_batch(cfg, TRAIN_BATCH, SEED + 2), cfg)      # warm-up
    torch.cuda.synchronize()
    ema0 = [e.detach().clone() for e in state.ema.parameters()]
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    times, losses = [], []
    for i in range(5):
        batch = train_batch(cfg, TRAIN_BATCH, SEED + 3 + i)
        before = _counts()
        t0 = time.perf_counter()
        losses.append(ttd.train_step(state, batch, cfg)["loss"].item())
        times.append(time.perf_counter() - t0)
        d = _delta(before)
        want = {"small_mha": 4, "flash_attention": 16, "flash_bwd_dkv": 16, "flash_bwd_dq": 16}
        if d != want:
            raise AssertionError(f"train step launched {d}, want {want}")
    launches = _counts()
    _all_by_tensor_cores("train", att.flash_attention, att.flash_bwd_dkv, att.flash_bwd_dq,
                         att.small_mha)
    peak = torch.cuda.max_memory_allocated()
    ema_moved = sum(int(not torch.equal(e, e0)) for e, e0 in zip(state.ema.parameters(), ema0))
    if not (np.isfinite(losses).all() and _finite(state.model) and _finite(state.ema)):
        raise AssertionError(f"non-finite loss, params or EMA: losses {losses}")
    if ema_moved == 0:
        raise AssertionError("the EMA did not move in 5 steps")
    log("train", f"5 steps: losses {[round(x, 5) for x in losses]}; launches per step K2 4 "
        f"K3 16 K4 16 K5 16 (total {launches}; K2, K3, K4 and K5 all by the tensor-core route); "
        f"params and EMA finite; EMA moved in "
        f"{ema_moved}/{len(ema0)} tensors")

    busy_ms = _profile_step("train", lambda: ttd.train_step(
        state, train_batch(cfg, TRAIN_BATCH, SEED + 8), cfg)["loss"].item())

    # 10 steps on one batch at fixed t and noise: the loss must fall
    rng = np.random.default_rng(SEED + 9)
    batch = train_batch(cfg, TRAIN_BATCH, SEED + 10)
    t = rng.integers(0, cfg.num_timesteps, TRAIN_BATCH)
    noise = rng.standard_normal((TRAIN_BATCH, cfg.im_size, cfg.im_size, 3)).astype(np.float32)
    fixed = [ttd.train_step(state, batch, cfg, t, noise)["loss"].item() for _ in range(10)]
    log("train", f"10 steps on one batch, fixed t and noise: losses "
        f"{[round(x, 5) for x in fixed]}")
    if not fixed[-1] < fixed[0]:
        raise AssertionError(f"loss did not fall on a fixed batch: {fixed}")
    del state

    # one float32 step, card against the CPU plain path: full channel plan,
    # 64x64 (frames already at 64x64: no resize to round differently), batch 2
    cfg32 = dataclasses.replace(cfg, im_size=64, dtype="float32", dropout=0.0)
    batch = train_batch(cfg32, 2, SEED + 11, size=64)
    t = np.array([17, 402])
    noise = np.random.default_rng(SEED + 12).standard_normal((2, 64, 64, 3)).astype(np.float32)
    (l_gpu, g_gpu), (l_cpu, g_cpu) = (_grad_step(cfg32, sd, batch, t, noise, d)
                                      for d in ("cuda", "cpu"))
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_rel = ((g_gpu - g_cpu).norm() / g_cpu.norm()).item()
    log("train", f"float32 step at 64x64, batch 2, card vs CPU plain path: loss {l_gpu:.7g} vs "
        f"{l_cpu:.7g} (rel {loss_rel:.3g}, tol {TOL_TRAIN_LOSS}); whole gradient rel L2 "
        f"{grad_rel:.3g} (tol {TOL_TRAIN_GRAD}); tf32 off")
    if not (loss_rel <= TOL_TRAIN_LOSS and grad_rel <= TOL_TRAIN_GRAD):
        raise AssertionError(f"float32 step card vs CPU: loss rel {loss_rel}, grad rel {grad_rel}")

    step_s = statistics.median(times)
    log("train", f"step times ({dev['smi']}): {[round(x * 1e3, 3) for x in times]} ms; median "
        f"{step_s * 1e3:.3f} ms = {TRAIN_BATCH / step_s:.2f} trained frames/s (the profiled "
        f"step's {busy_ms:.3f} ms of kernels are {busy_ms / (step_s * 1e3):.3f} of it); peak "
        f"device memory {peak / 2**20:.1f} MiB")
    return {"launches": launches, "step_ms": step_s * 1e3, "peak_mib": peak / 2**20}


def phase_superres(dev: dict) -> dict:
    import dataclasses

    from lipreading_video_generation_tpu_torch.core.config import DiffusionConfig, SuperResConfig
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.pipelines import train_superres as tsr
    from lipreading_video_generation_tpu_torch.pipelines.sample_diffusion import sample_cascade

    scfg = SuperResConfig()
    state = tsr.create_state(scfg, seed=SEED, device="cuda")
    n_attn = sum(type(m).__name__ == "AttentionBlock" for m in state.model.modules())
    log("superres", f"SuperResConfig defaults: {scfg.low_size}->{scfg.im_size}, base "
        f"{scfg.base_channels}, channel_mult {scfg.channel_mult}, {scfg.num_res_blocks} res "
        f"blocks, attention at ds {scfg.attention_resolutions} ({n_attn} AttentionBlocks, "
        f"{(scfg.im_size // 4) ** 2} tokens, d={scfg.base_channels * 4}), {scfg.dtype}; "
        f"{sum(p.numel() for p in state.model.parameters())} params (seeded Flax-style init)")
    _zero_counts()
    losses, times = [], []
    for i in range(3):
        batch = {"target_frame": np.random.default_rng(SEED + 40 + i).integers(
            0, 256, (TRAIN_BATCH, 160, 160, 3), dtype=np.uint8)}
        before = _counts()
        t0 = time.perf_counter()
        losses.append(tsr.train_step(state, batch, scfg)["loss"].item())
        times.append(time.perf_counter() - t0)
        d = _delta(before)
        want = {"small_mha": 0, "flash_attention": n_attn, "flash_bwd_dkv": n_attn,
                "flash_bwd_dq": n_attn}
        if d != want:
            raise AssertionError(f"SR train step launched {d}, want {want}")
    if not (np.isfinite(losses).all() and _finite(state.model)):
        raise AssertionError(f"SR training: non-finite loss or params ({losses})")
    _all_by_tensor_cores("superres", att.flash_attention, att.flash_bwd_dkv, att.flash_bwd_dq)
    log("superres", f"3 train steps at batch {TRAIN_BATCH}: losses "
        f"{[round(x, 5) for x in losses]}, times {[round(x * 1e3, 3) for x in times]} ms "
        f"({dev['smi']}); K3/K4/K5 {n_attn} each a step, all by the tensor-core route")

    base_cfg = dataclasses.replace(DiffusionConfig(), im_size=scfg.low_size)
    base = _load_unet_audio(base_cfg, _diffusion_state_dict(base_cfg), "cuda")
    frame, audio = diffusion_inputs(base_cfg, DIFF_FRAMES, SEED)
    cond = torch.as_tensor(frame)[None].expand((DIFF_FRAMES,) + frame.shape)
    sr_model = state.ema.eval()
    before = _counts()
    t0 = time.perf_counter()
    high, low = sample_cascade(base, cond, audio, base_cfg, sr_model, scfg,
                               num_inference_steps=DIFF_STEPS,
                               generator=torch.Generator("cuda").manual_seed(SEED))
    high = high.cpu()
    cascade_s = time.perf_counter() - t0
    d = _delta(before)
    want_k3 = 16 * DIFF_STEPS + n_attn * scfg.sr_inference_steps
    if tuple(high.shape) != (DIFF_FRAMES, 128, 128, 3) or tuple(low.shape) != (
            DIFF_FRAMES, 64, 64, 3) or not bool(torch.isfinite(high).all()):
        raise AssertionError(f"cascade gave {tuple(high.shape)} / {tuple(low.shape)}")
    if d["flash_attention"] != want_k3:
        raise AssertionError(f"cascade launched {d}, want K3 {want_k3}")
    _all_by_tensor_cores("superres", att.flash_attention)
    log("superres", f"sample_cascade: base 64x64 {DIFF_FRAMES} frames x {DIFF_STEPS} DDIM "
        f"steps, SR {scfg.sr_inference_steps} DDIM steps -> {tuple(high.shape)} in "
        f"[{high.min().item():.3f}, {high.max().item():.3f}], finite; K3 launches "
        f"{d['flash_attention']}, routes since the first train step "
        f"{att.flash_attention.route_counts}; {cascade_s * 1e3:.3f} ms ({dev['smi']})")
    return {"launches": _counts()}


def phase_guidance(dev: dict) -> dict:
    from lipreading_video_generation_tpu_torch.core.config import (
        ClassifierConfig, DiffusionConfig)
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.pipelines import train_classifier as ttc
    from lipreading_video_generation_tpu_torch.pipelines.sample_diffusion import sample_video

    ccfg, dcfg = ClassifierConfig(), DiffusionConfig()
    state = ttc.create_state(ccfg, dcfg, seed=SEED, device="cuda")
    n_attn = sum(type(m).__name__ == "AttentionBlock" for m in state.model.modules())
    log("guidance", f"ClassifierConfig defaults: {ccfg.num_classes} classes, base "
        f"{ccfg.base_channels}, channel_mult {ccfg.channel_mult}, attention at ds "
        f"{ccfg.attention_resolutions} ({n_attn} AttentionBlocks, {ccfg.num_heads} heads), "
        f"{ccfg.dtype}, {dcfg.im_size}x{dcfg.im_size}, batch {ccfg.batch_size}")
    _zero_counts()
    rng = np.random.default_rng(SEED + 50)
    metrics = []
    for _ in range(5):
        before = _counts()
        m = ttc.train_step(state, ttc.synthetic_batch(rng, ccfg, dcfg), ccfg, dcfg)
        metrics.append((round(m["loss"].item(), 5), round(m["accuracy"].item(), 4)))
        d = _delta(before)
        want = {"small_mha": 0, "flash_attention": n_attn, "flash_bwd_dkv": n_attn,
                "flash_bwd_dq": n_attn}
        if d != want:
            raise AssertionError(f"classifier train step launched {d}, want {want}")
    if not (np.isfinite([x for x, _ in metrics]).all() and _finite(state.model)):
        raise AssertionError(f"classifier training: non-finite loss or params ({metrics})")
    log("guidance", f"5 train steps (loss, accuracy): {metrics}")

    model = _load_unet_audio(dcfg, _diffusion_state_dict(dcfg), "cuda")
    frame, audio = diffusion_inputs(dcfg, DIFF_FRAMES, SEED)
    gen = torch.Generator("cuda")
    plain = sample_video(model, frame, audio, dcfg, num_inference_steps=DIFF_STEPS,
                         generator=gen.manual_seed(SEED)).cpu()
    before = _counts()
    t0 = time.perf_counter()
    guided = sample_video(model, frame, audio, dcfg, num_inference_steps=DIFF_STEPS,
                          classifier_cfg=ccfg, classifier_params=state.model.state_dict(),
                          class_label=2, guidance_scale=5.0,
                          generator=gen.manual_seed(SEED)).cpu()
    guided_s = time.perf_counter() - t0
    d = _delta(before)
    want = {"small_mha": 4, "flash_attention": (16 + n_attn) * DIFF_STEPS,
            "flash_bwd_dkv": n_attn * DIFF_STEPS, "flash_bwd_dq": n_attn * DIFF_STEPS}
    if d != want:
        raise AssertionError(f"guided request launched {d}, want {want}")
    if guided.dtype != torch.uint8 or tuple(guided.shape) != (DIFF_FRAMES, 128, 128, 3):
        raise AssertionError(f"bad guided frames {guided.dtype} {tuple(guided.shape)}")
    moved = (guided.int() - plain.int()).abs().float().mean().item()
    if moved == 0:
        raise AssertionError("guidance changed nothing")
    _all_by_tensor_cores("guidance", att.flash_attention, att.flash_bwd_dkv, att.flash_bwd_dq,
                         att.small_mha)
    log("guidance", f"guided sample_video (label 2, scale 5), {DIFF_FRAMES} frames x "
        f"{DIFF_STEPS} DDIM steps: launches {d} ({n_attn} K4/K5 a step; K3, K4 and K5 all by "
        f"the tensor-core route since the first classifier step); mean |guided - "
        f"unguided| {moved:.3f} levels; {guided_s * 1e3:.3f} ms ({dev['smi']})")
    return {"launches": _counts()}


def flax_generator_params(width: float, seed: int) -> dict:
    """Random weights in the tree and shapes of the Flax
    ``TalkingFaceGenerator(width=width)`` (the card's machine has no flax):
    conv kernels (kh, kw, in, out) ~ N(0, 1/fan_in), small biases, GroupNorm
    scales near 1. The shapes come from the port's own module, the tree from
    the bridge's map of Flax module paths."""
    from lipreading_video_generation_tpu_torch.models.convert import generator_flax_module_names
    from lipreading_video_generation_tpu_torch.models.generator import TalkingFaceGenerator

    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {name: tuple(m.weight.shape) for name, m in
                  TalkingFaceGenerator(width=width).named_modules() if hasattr(m, "weight")}
    params: dict = {}
    for flax_path, name in generator_flax_module_names().items():
        c_out, c_in, kh, kw = shapes[name]
        *parents, leaf = flax_path.split("/")
        node = params
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = {"kernel": (rng.standard_normal((kh, kw, c_in, c_out))
                                 / math.sqrt(kh * kw * c_in)).astype(np.float32),
                      "bias": (0.02 * rng.standard_normal(c_out)).astype(np.float32)}
        if leaf == "Conv_0" and parents[-1].startswith("ConvBlock"):
            node["GroupNorm_0"] = {
                "scale": (1 + 0.05 * rng.standard_normal(c_out)).astype(np.float32),
                "bias": (0.05 * rng.standard_normal(c_out)).astype(np.float32)}
    return params


def lipsync_inputs(n: int, seed: int):
    """scripts/bench_lipsync_serving.py's inputs: random 360×640 RGB uint8
    frames, face boxes [40, 300, 180, 430] ± 4, standard-normal mel windows."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n,) + LIPSYNC_HW + (3,), dtype=np.uint8)
    boxes = (np.tile([40.0, 300.0, 180.0, 430.0], (n, 1)).astype(np.float32)
             + rng.uniform(-4, 4, (n, 4)).astype(np.float32))
    mels = rng.standard_normal((n, 80, 16)).astype(np.float32)
    return frames, boxes, mels


def _psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    return 10.0 * math.log10(1.0 / max(((a - b) ** 2).mean().item(), 1e-12))


def _profile_request(mode: str, request) -> None:
    """One lip-sync request under ``torch.profiler``: wall time, device time
    of all kernels and copies (busy share), device time by int8 stage (the
    ``int8/...`` ranges of ``ops/quant.py`` carry the time of the kernels
    launched inside them) and the heaviest kernels by name."""
    wall_ms, events, kernels = _profiled(request)
    stages = {e.key: e.device_time_total / 1e3 for e in events if e.key.startswith("int8/")}
    kernels = [r for r in kernels if r[0] not in stages]
    busy_ms = sum(ms for _, ms, _ in kernels)
    if busy_ms <= 0 or len(stages) != (4 if mode != "float" else 0):
        raise AssertionError(f"{mode} profile: device time {busy_ms} ms, stages {stages}")
    k6_ms = sum(ms for name, ms, _ in kernels if KERNEL_NAMES["K6"] in name)
    k6_n = sum(n for name, _, n in kernels if KERNEL_NAMES["K6"] in name)
    log("lipsync", f"profile of one {mode} request: wall {wall_ms:.3f} ms under the profiler, "
        f"device kernels and copies {busy_ms:.3f} ms in {sum(c for _, _, c in kernels)} launches "
        f"(busy share {busy_ms / wall_ms:.3f}); K6's kernels by name {k6_ms:.3f} ms ({k6_n}x)"
        + ("; by int8 stage " + ", ".join(f"{k[5:]} {v:.3f} ms ({v / busy_ms:.1%})"
                                          for k, v in sorted(stages.items()))
           + f"; all else {busy_ms - sum(stages.values()):.3f} ms" if stages else ""))
    for name, ms, count in kernels[:8]:
        log("lipsync", f"  {ms:9.3f} ms {count:5d}x {name[:110]}")


def phase_lipsync(dev: dict) -> dict:
    import dataclasses

    from lipreading_video_generation_tpu_torch.core.config import GanConfig, PreprocessConfig
    from lipreading_video_generation_tpu_torch.models.convert import (
        generator_state_dict_from_flax)
    from lipreading_video_generation_tpu_torch.models.generator import TalkingFaceGenerator
    from lipreading_video_generation_tpu_torch.ops import matmul_cuda as mm
    from lipreading_video_generation_tpu_torch.ops import quant
    from lipreading_video_generation_tpu_torch.pipelines import inference as inf

    gcfg, pre = GanConfig(), PreprocessConfig()
    sd_cpu = generator_state_dict_from_flax(flax_generator_params(gcfg.model_width, SEED))
    sd = {k: v.to("cuda") for k, v in sd_cpu.items()}
    n_convs = sum(k.endswith("conv.weight") or k.endswith("out_conv.weight") for k in sd)
    if n_convs != 51:
        raise AssertionError(f"{n_convs} convolutions in the generator, want 51")
    frames, boxes, mels = lipsync_inputs(LIPSYNC_FRAMES, SEED)
    n_batches = -(-LIPSYNC_FRAMES // pre.gen_batch_size)
    log("lipsync", f"GanConfig/PreprocessConfig defaults: width {gcfg.model_width}, faces "
        f"{gcfg.img_size}x{gcfg.img_size}, batches of {pre.gen_batch_size}, float32; "
        f"{sum(v.numel() for v in sd.values())} params in {n_convs} convs from seeded numpy via "
        f"generator_state_dict_from_flax; {LIPSYNC_FRAMES} frames of {LIPSYNC_HW} "
        f"({n_batches} batches)")
    modes = {"float": gcfg,
             "int8_dynamic": dataclasses.replace(gcfg, serve_int8=True),
             "int8_static": dataclasses.replace(gcfg, serve_int8=True, serve_int8_static=True)}
    y1, y2 = int(boxes[:, 0].min()), int(math.ceil(boxes[:, 1].max()))
    x1, x2 = int(boxes[:, 2].min()), int(math.ceil(boxes[:, 3].max()))
    outside = np.ones(LIPSYNC_HW, bool)
    outside[y1:y2 + 1, x1:x2 + 1] = False
    result = {"launches": 0, "ms": {}, "peak_mib": {}}
    outs = {}
    for mode, cfg in modes.items():
        inf.generate_frames(sd, frames, boxes, mels, cfg, pre)            # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        times = []
        for _ in range(3):
            before = mm.int8_matmul.launch_count
            t0 = time.perf_counter()
            out = inf.generate_frames(sd, frames, boxes, mels, cfg, pre)
            times.append(time.perf_counter() - t0)
            d = mm.int8_matmul.launch_count - before
            want = n_convs * n_batches if cfg.serve_int8 else 0
            if d != want:
                raise AssertionError(f"{mode} request launched K6 {d}x, want {want}")
            if out.dtype != np.uint8 or out.shape != frames.shape:
                raise AssertionError(f"{mode}: bad frames {out.dtype} {out.shape}")
            if not np.array_equal(out[:, outside], frames[:, outside]):
                raise AssertionError(f"{mode}: pixels outside every box changed")
            if np.array_equal(out, frames):
                raise AssertionError(f"{mode}: no face was pasted in")
        result["launches"] += mm.int8_matmul.launch_count
        if cfg.serve_int8:
            _all_by_tensor_cores("lipsync", mm.int8_matmul)
        peak = torch.cuda.max_memory_allocated()
        med = statistics.median(times)
        result["ms"][mode], result["peak_mib"][mode] = med * 1e3, peak / 2**20
        outs[mode] = out
        fps = LIPSYNC_FRAMES / med
        log("lipsync", f"{mode}: requests {[round(t * 1e3, 3) for t in times]} ms, median "
            f"{med * 1e3:.3f} ms = {fps:.1f} frames/s = {fps / gcfg.fps:.2f} x real time at "
            f"{gcfg.fps:g} fps; K6 launches a request {want} ({n_convs} x {n_batches}), routes "
            f"{mm.int8_matmul.route_counts}; frames "
            f"{out.shape} uint8, untouched outside the boxes; peak device memory "
            f"{peak / 2**20:.1f} MiB ({dev['smi']})")
    for mode in ("int8_dynamic", "int8_static"):
        d = np.abs(outs[mode].astype(np.float32) - outs["float"].astype(np.float32))
        log("lipsync", f"{mode} frames against float frames: mean |d| over the face boxes "
            f"{d[:, y1:y2 + 1, x1:x2 + 1].mean():.3f} gray levels, max {d.max():.0f}")

    # the generator's [0, 1] output on the first batch: int8 against float
    with torch.device("cuda"):
        gen = TalkingFaceGenerator(width=gcfg.model_width).eval()
    gen.load_state_dict(sd)
    idx = slice(0, pre.gen_batch_size)
    with torch.inference_mode():
        x = inf.gen_input_prep(torch.from_numpy(frames[idx]).to("cuda").float(),
                               torch.from_numpy(boxes[idx]).to("cuda"), gcfg.img_size)
        mel = torch.from_numpy(mels[idx]).to("cuda")[..., None]
        f = gen(mel, x)
        dyn = quant.quantized_apply(gen, mel, x)
        before = mm.int8_matmul.launch_count
        scales = quant.calibrate_activation_scales(gen, [(mel, x)])
        scales = {k: v * 1.05 for k, v in scales.items()}        # generate_frames' headroom
        if mm.int8_matmul.launch_count != before or len(scales) != n_convs:
            raise AssertionError("the calibration pass launched K6 or missed a conv")
        static = quant.quantized_apply(gen, mel, x, act_scales=scales)
    if not (torch.isfinite(f).all() and torch.isfinite(dyn).all() and torch.isfinite(static).all()):
        raise AssertionError("the generator gave non-finite output")
    psnr_d, psnr_s = _psnr(dyn, f), _psnr(static, f)
    log("lipsync", f"generator output in [0,1], batch {pre.gen_batch_size}, int8 against float on "
        f"the same weights: dynamic PSNR {psnr_d:.2f} dB (want > {PSNR_DYNAMIC}), mean |d| "
        f"{(dyn - f).abs().mean().item():.5f}; static ({len(scales)} scales x 1.05) PSNR "
        f"{psnr_s:.2f} dB (want > {PSNR_STATIC}), mean |d| {(static - f).abs().mean().item():.5f}")
    if not (psnr_d > PSNR_DYNAMIC and psnr_s > PSNR_STATIC):
        raise AssertionError(f"int8 generator PSNR: dynamic {psnr_d}, static {psnr_s}")
    del gen, x, mel, f, dyn, static

    # a float request at batch 8, the card against the CPU
    small = slice(0, 8)
    got = inf.generate_frames(sd, frames[small], boxes[small], mels[small], gcfg, pre)
    want = inf.generate_frames(sd_cpu, frames[small], boxes[small], mels[small], gcfg, pre,
                               device="cpu")
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    equal = float((d == 0).mean())
    log("lipsync", f"float request of 8 frames, card vs CPU: max |d| {d.max()} gray level, "
        f"{equal:.6f} equal (want max 1 and >= {LIPSYNC_EQUAL_SHARE}); tf32 off")
    if d.max() > 1 or equal < LIPSYNC_EQUAL_SHARE:
        raise AssertionError(f"float lip-sync card vs CPU: max {d.max()}, equal {equal}")

    # where the time of a float and of a dynamic int8 request goes
    for mode in ("float", "int8_dynamic"):
        _profile_request(mode, lambda: inf.generate_frames(sd, frames, boxes, mels, modes[mode],
                                                           pre))
    return result


def phase_microbench() -> dict:
    """K6's own entry point: both type pairs at 4096³ beside the library."""
    from lipreading_video_generation_tpu_torch.bench import microbench_int8
    from lipreading_video_generation_tpu_torch.ops import matmul_cuda as mm

    _zero_counts()
    res = microbench_int8.run(size=4096, iters=10, seed=SEED)
    launches = {"int8_matmul": mm.int8_matmul.launch_count,
                "bf16_matmul": mm.bf16_matmul.launch_count}
    want = {"k6_bf16": "sm90", "k6_int8": "mma_sync", "k6_int8_kmajor": "sm90"}
    if res["routes"] != want or mm.bf16_matmul.route_counts["mma_sync"] or (
            mm.int8_matmul.route_counts["sm90"] != mm.int8_matmul.route_counts["mma_sync"]):
        raise AssertionError(f"microbench routes {res['routes']}, {mm.int8_matmul.route_counts}, "
                             f"{mm.bf16_matmul.route_counts}; want {want}")
    log("microbench", f"4096^3: K6 bf16 {res['k6_bf16_ms']:.4f} ms (B row-major, route sm90), "
        f"torch.matmul bf16 {res['torch_matmul_bf16_ms']:.4f} ms; K6 int8, B the (N,K) weight "
        f"transposed (route sm90) {res['k6_int8_kmajor_ms']:.4f} ms, torch._int_mm on the same "
        f"{res['torch_int_mm_kmajor_ms']:.4f} ms; K6 int8, B row-major (route mma_sync) "
        f"{res['k6_int8_ms']:.4f} ms, torch._int_mm {res['torch_int_mm_ms']:.4f} ms; launches "
        f"{launches}, routes int8 {mm.int8_matmul.route_counts} bf16 "
        f"{mm.bf16_matmul.route_counts}")
    return {"launches": launches, "result": res}


def _event_ms(fn, n: int) -> float:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def _plain_vs_kernel(plain, kernel, n: int, n_kernel: int = 0):
    """Warm up both, then time them in turns (plain, kernel, kernel, plain):
    ``n`` calls a turn, ``n_kernel`` for the kernel's where it is given."""
    plain(), kernel()
    torch.cuda.synchronize()
    nk = n_kernel or n
    p1, k1, k2, p2 = (_event_ms(plain, n), _event_ms(kernel, nk),
                      _event_ms(kernel, nk), _event_ms(plain, n))
    return (k1 + k2) / 2, (p1 + p2) / 2, (p1, k1, k2, p2)


def _bound(n_bytes: float, n_ops: float, kind: str) -> dict:
    """The least time the card could take: the larger of the bytes (each
    input read once, each output written once) over the memory rate and the
    operations over the tensor-core peak of their type."""
    by_bytes, by_ops = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_OPS_S[kind] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _attention_bound(b: int, h: int, s: int, d: int, ops_per_sd: float, n_tensors: int) -> dict:
    """bf16 attention at (b, h, s, d): ``n_tensors`` (b, h, s, d) tensors and
    the float32 lse move; ``ops_per_sd``·b·h·s²·d operations."""
    return _bound(n_tensors * b * h * s * d * 2 + b * h * s * 4, ops_per_sd * b * h * s * s * d,
                  "bf16")


def _flash_fwd_sm90_launcher(q, k, v):
    """A function that launches the tensor-core K3 on (B, H, S, D) bf16 q, k,
    v through its C entry point, into outputs allocated here, once: what
    ``ops/attention._flash_launch`` does, without its host work per call and
    without its count."""
    import ctypes

    from lipreading_video_generation_tpu_torch.ops import _build

    b, h, s_q, d = q.shape
    out = torch.empty(b, s_q, h, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty(b, h, s_q, dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, out) for st in t.stride()[:3]))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn = _build.kernel("lvg_flash_fwd_sm90", [vp] * 5 + [i32] * 5
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i32, vp])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, h, s_q,
            k.shape[2], d, strides, 1.0 / math.sqrt(d), 0)

    def launch():
        _build.check(fn(*args, torch.cuda.current_stream().cuda_stream), "flash_attention (sm90)")

    return launch


def _small_mha_sm90_launcher(q, k, v, num_heads: int):
    """The same for the tensor-core K2 on (B, S, E) bf16 q, k, v: what
    ``ops/attention._small_mha_launch`` does, without its host work per call
    and without its count."""
    import ctypes

    from lipreading_video_generation_tpu_torch.ops import _build

    b, s, e = q.shape
    d = e // num_heads
    out = torch.empty(b, s, e, dtype=q.dtype, device=q.device)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = _build.kernel("lvg_small_mha_sm90", [vp] * 4 + [i32] + [i64] * 6 + [i32] * 3
                       + [ctypes.c_float, i32, vp])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), v.stride(0), v.stride(1), s, num_heads, d,
            1.0 / math.sqrt(d), 0)

    def launch():
        _build.check(fn(*args, torch.cuda.current_stream().cuda_stream), "small_mha (sm90)")

    launch.out = out   # the kernel writes it: it lives as long as the launcher
    return launch


def _clahe_launcher(x, clip_limit: float = 0.2, grid=(8, 8), nbins: int = 256):
    """The same for K1's packed route on (N, H, W) float32 images: what
    ``ops/clahe_cuda.clahe_cuda`` launches, without its host work per call
    and without its count."""
    from lipreading_video_generation_tpu_torch.ops import _build
    from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl

    n, h, w = x.shape
    lay = cl.clahe_packed_layout(h, w, grid, nbins, clip_limit)
    out = torch.empty_like(x)
    fn = _build.kernel("lvg_clahe_packed_f32", cl._PACKED_ARGTYPES)
    args = (x.data_ptr(), out.data_ptr(), None, n, h, w, grid[0], grid[1], nbins, 1.0,
            lay["group"], lay["lane_words"], lay["tile_words"], lay["smem"])

    def launch():
        _build.check(fn(*args, torch.cuda.current_stream().cuda_stream), "clahe_cuda (packed)")

    launch.out = out   # the kernel writes it: it lives as long as the launcher
    return launch


def _mm_sm90_launcher(a, b):
    """The same for the tensor-core K6 on (M, K) and (K, N) int8 or bf16
    operands that ``matmul_route`` sends to it."""
    import ctypes

    from lipreading_video_generation_tpu_torch.ops import _build

    int8 = a.dtype == torch.int8
    out = torch.empty((a.shape[0], b.shape[1]), dtype=torch.int32 if int8 else torch.float32,
                      device=a.device)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = _build.kernel("lvg_mm_sm90_int8" if int8 else "lvg_mm_sm90_bf16",
                       [vp] * 3 + [i32] * 3 + [i64] * 3 + [vp])
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], b.shape[1], a.shape[1],
            a.stride(0), b.stride(0), b.stride(1))

    def launch():
        _build.check(fn(*args, torch.cuda.current_stream().cuda_stream), "matmul (sm90)")

    launch.out = out
    return launch


def phase_timing(dev: dict, microbench: dict) -> dict:
    import torch.nn.functional as F

    from lipreading_video_generation_tpu_torch.bench.microbench_int8 import make_operands
    from lipreading_video_generation_tpu_torch.bench.timing import graph_ms
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl
    from lipreading_video_generation_tpu_torch.ops import matmul_cuda as mm

    x = _uniform((384 * CLIP_FRAMES, 48, 48), 0, 255, SEED)
    _zero_counts()
    with torch.inference_mode():
        k1_ms, k1_plain, raw1 = _plain_vs_kernel(
            lambda: cl.clahe_reference(x, 0.2, (8, 8)),
            lambda: cl.clahe_cuda(x, 0.2, (8, 8)), 20)
        # the kernel alone: the C entry point in a loop, output allocated once,
        # and the same calls replayed from a CUDA graph (device time only)
        k1_alone = _event_ms(_clahe_launcher(x), 200)
        k1_graph = graph_ms(_clahe_launcher(x), 50)
        # whole frames, as contrast_boost will give them: the tiled route
        frames = _uniform((64, 360, 640), 0, 255, SEED)
        k1f_ms, k1f_plain, raw1f = _plain_vs_kernel(
            lambda: cl.clahe_reference(frames, 0.2, (8, 8)),
            lambda: cl.clahe_cuda(frames, 0.2, (8, 8)), 3, 20)
        if cl.clahe_cuda.route_counts != {"packed": 41, "tiled": 41}:
            raise AssertionError(f"the timed K1 launches took the routes {cl.clahe_cuda.route_counts}")
        del frames
        # K2 as the main path calls it: q/k/v column slices of one qkv tensor
        q, k, v = _uniform((384, 80, 768), -2, 2, SEED, torch.bfloat16).chunk(3, dim=-1)
        k2_ms, k2_plain, raw2 = _plain_vs_kernel(
            lambda: att._mha_einsum(q, k, v, 8, False),
            lambda: att.small_mha(q, k, v, 8), 20)
        if att.small_mha.route_counts["cuda_core"]:
            raise AssertionError("the timed K2 launches did not all take the tensor-core kernel")
        q4, k4, v4 = (t.reshape(384, 80, 8, 32).transpose(1, 2) for t in (q, k, v))
        F.scaled_dot_product_attention(q4, k4, v4)
        k2_lib = _event_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), 20)
        # the kernel alone, as for K3 below: the C entry point in a loop
        k2_alone = _event_ms(_small_mha_sm90_launcher(q, k, v, 8), 100)
        # K3 at the U-Net's three shapes, batch DIFF_FRAMES, as the U-Net
        # calls it: (B, 1, S, D) views of column slices of one qkv tensor
        k3, k3_lib, k3_alone = {}, {}, {}
        for s, d in ((16384, 64), (4096, 128), (1024, 256)):
            qkv = _uniform((DIFF_FRAMES, s, 3 * d), -2, 2, SEED, torch.bfloat16)
            q, k, v = (t.reshape(DIFF_FRAMES, s, 1, d).transpose(1, 2)
                       for t in qkv.chunk(3, dim=-1))
            before = att.flash_attention.route_counts["sm90"]
            k3[(s, d)] = _plain_vs_kernel(lambda: att.flash_reference(q, k, v),
                                          lambda: att.flash_attention(q, k, v), 3, 20)
            if att.flash_attention.route_counts["sm90"] != before + 41:
                raise AssertionError("the timed K3 launches did not take the tensor-core kernel")
            F.scaled_dot_product_attention(q, k, v)
            k3_lib[(s, d)] = _event_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
            # the kernel alone: at the small shapes a call's host time (two
            # allocations, the route, ctypes), not its kernel, is what the
            # events above see, so the C entry point is also called in a loop
            # on outputs allocated once
            k3_alone[(s, d)] = _event_ms(_flash_fwd_sm90_launcher(q, k, v), 50)
            del qkv, q, k, v
    for (s, d), (ms, plain, raw) in k3.items():
        flops = 4.0 * DIFF_FRAMES * s * s * d
        bound = _attention_bound(DIFF_FRAMES, 1, s, d, 4, 4)["bound_ms"]
        log("timing", f"K3 flash_attention ({DIFF_FRAMES},1,{s},{d}) bf16, route sm90: kernel "
            f"{ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s; bound {bound:.4f} ms, {bound / ms:.1%} "
            f"of it), plain {plain:.4f} ms (plain,kernel,kernel,plain = "
            f"{[round(t, 4) for t in raw]}), the library's forward (SDPA) {k3_lib[(s, d)]:.4f} ms: "
            f"{ms / k3_lib[(s, d)]:.2f} x; the C entry point in a loop, outputs allocated once: "
            f"{k3_alone[(s, d)]:.4f} ms ({flops / k3_alone[(s, d)] / 1e9:.2f} TFLOP/s) on "
            f"{dev['smi']}")
    n_img = 384 * CLIP_FRAMES * 48 * 48
    k1_bound = _bound(2 * n_img * 4, 0, "bf16")["bound_ms"]
    k1f_bound = _bound(2 * 64 * 360 * 640 * 4, 0, "bf16")["bound_ms"]
    log("timing", f"K1 clahe (1920,48,48) f32 grid (8,8) clip 0.2, route packed: through clahe_cuda "
        f"{k1_ms:.4f} ms ({k1_bound / k1_ms:.1%} of the bound {k1_bound:.4f} ms by bytes), the C "
        f"entry point in a loop, output allocated once {k1_alone:.4f} ms "
        f"({k1_bound / k1_alone:.1%} of the bound), the same calls from a CUDA graph "
        f"{k1_graph:.4f} ms ({k1_bound / k1_graph:.1%} of the bound; the one-block-an-image "
        "kernel it replaced: 0.0985 ms through its wrapper), "
        f"plain {k1_plain:.4f} ms (plain,kernel,kernel,plain = {[round(t, 4) for t in raw1]}); "
        f"(64,360,640) grid (8,8), route tiled: {k1f_ms:.4f} ms ({k1f_bound / k1f_ms:.1%} of the "
        f"bound {k1f_bound:.4f} ms), plain {k1f_plain:.4f} ms (plain,kernel,kernel,plain = "
        f"{[round(t, 4) for t in raw1f]}) on {dev['smi']}")
    k2_bound = _attention_bound(384, 8, 80, 32, 4, 4)["bound_ms"]
    log("timing", f"K2 small_mha (384,80,256) H=8 bf16, route sm90: kernel {k2_ms:.4f} ms (bound "
        f"{k2_bound:.4f} ms by bytes, {k2_bound / k2_ms:.1%} of it), plain "
        f"{k2_plain:.4f} ms (plain,kernel,kernel,plain = {[round(t, 4) for t in raw2]}), the "
        f"library's forward (SDPA) {k2_lib:.4f} ms: {k2_ms / k2_lib:.2f} x; the C entry point in a "
        f"loop, output allocated once: {k2_alone:.4f} ms ({k2_bound / k2_alone:.1%} of the bound) "
        f"on {dev['smi']}")
    # K4 and K5 at the same shapes, each against the part of the plain
    # backward that gives its outputs
    bwd, bwd_lib = {}, {}
    for s, d in ((16384, 64), (4096, 128), (1024, 256)):
        qkv = _uniform((DIFF_FRAMES, s, 3 * d), -2, 2, SEED, torch.bfloat16)
        q, k, v = (t.reshape(DIFF_FRAMES, s, 1, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        do = _uniform((DIFF_FRAMES, s, d), -1, 1, SEED + 1, torch.bfloat16).reshape(
            DIFF_FRAMES, s, 1, d).transpose(1, 2)
        with torch.no_grad():
            o, lse = att.flash_attention(q, k, v, return_lse=True)
            delta = (do.float() * o.float()).sum(-1)
            bwd[("dkv", s, d)] = _plain_vs_kernel(
                lambda: att.flash_backward_reference(q, k, v, do, lse, delta, dq=False),
                lambda: att.flash_bwd_dkv(q, k, v, do, lse, delta), 3, 20)
            bwd[("dq", s, d)] = _plain_vs_kernel(
                lambda: att.flash_backward_reference(q, k, v, do, lse, delta, dkv=False),
                lambda: att.flash_bwd_dq(q, k, v, do, lse, delta), 3, 20)
        # the library's whole backward (dQ, dK and dV in one call)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves)
        torch.autograd.grad(out, leaves, do, retain_graph=True)
        bwd_lib[(s, d)] = _event_ms(
            lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 20)
        del leaves, out
        del qkv, q, k, v, do, o, lse, delta
    for (kern, s, d), (ms, plain, raw) in bwd.items():
        ops_per_sd, n_tensors = (8, 6) if kern == "dkv" else (6, 5)
        flops = float(ops_per_sd) * DIFF_FRAMES * s * s * d
        bound = _attention_bound(DIFF_FRAMES, 1, s, d, ops_per_sd, n_tensors)["bound_ms"]
        name = "K4 flash_bwd_dkv" if kern == "dkv" else "K5 flash_bwd_dq"
        log("timing", f"{name} ({DIFF_FRAMES},1,{s},{d}) bf16, route sm90: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.2f} TFLOP/s; bound {bound:.4f} ms, {bound / ms:.1%} of it), "
            f"plain {plain:.4f} ms (plain,kernel,kernel,plain = {[round(t, 4) for t in raw]}) "
            f"on {dev['smi']}")
    for (s, d), lib in bwd_lib.items():
        both = bwd[("dkv", s, d)][0] + bwd[("dq", s, d)][0]
        log("timing", f"K4 + K5 ({DIFF_FRAMES},1,{s},{d}) bf16: {both:.4f} ms against the "
            f"library's backward (SDPA, dQ, dK, dV in one call) {lib:.4f} ms: {both / lib:.2f} x "
            f"on {dev['smi']}")
    log("timing", f"library calls at the same shapes ({dev['smi']}): "
        f"F.scaled_dot_product_attention (384,8,80,32) {k2_lib:.4f} ms, "
        + ", ".join(f"({DIFF_FRAMES},1,{s},{d}) {ms:.4f} ms" for (s, d), ms in k3_lib.items()))
    bwd_lib = bwd_lib[(16384, 64)]

    # K6 int8 as int8 serving calls it (B the (N, K) weight transposed), at the
    # generator's largest product, the ViViT's qkv product, the generator's
    # mel stem and its 1x1 bottleneck (8 tiles for all SMs and a long K), each
    # beside torch._int_mm and through the C entry point alone; bf16 and int8 at the microbench's 4096^3 (kernel and
    # library times from its run)
    k6 = {}
    for m, kk, n in ((128 * 96 * 96, 1440, 64), (30720, 256, 768), (65536, 16, 32),
                     (128, 4608, 512)):
        a8, w8 = _int8((m, kk), SEED + 70), _int8((n, kk), SEED + 71)
        before = mm.int8_matmul.route_counts["sm90"]
        ms, plain, raw = _plain_vs_kernel(lambda: mm.matmul_reference(a8, w8.t()),
                                          lambda: mm.int8_matmul(a8, w8.t()), 3, 20)
        if mm.int8_matmul.route_counts["sm90"] != before + 41:
            raise AssertionError("the timed K6 launches did not take the tensor-core kernel")
        w8_rows = w8.t().contiguous()
        torch._int_mm(a8, w8_rows)
        lib = _event_ms(lambda: torch._int_mm(a8, w8_rows), 20)
        alone = _event_ms(_mm_sm90_launcher(a8, w8.t()), 50)
        bound = _bound(m * kk + kk * n + m * n * 4, 2.0 * m * kk * n, "int8")
        k6[(m, kk, n)] = dict(ms=ms, plain_ms=plain, library_ms=lib, **bound)
        log("timing", f"K6 int8_matmul ({m} x {kk} x {n}), B the (N,K) weight transposed, route "
            f"sm90: kernel {ms:.4f} ms ({2.0 * m * kk * n / ms / 1e9:.2f} TOP/s, "
            f"{(m * kk + m * n * 4) / ms / 1e6:.1f} GB/s of A and C; bound {bound['bound_ms']:.4f} "
            f"ms by {bound['bound_by']}, {bound['bound_ms'] / ms:.1%} of it), plain (float64 "
            f"matmul) {plain:.4f} ms (plain,kernel,kernel,plain = {[round(t, 4) for t in raw]}), "
            f"torch._int_mm {lib:.4f} ms: {ms / lib:.2f} x; the C entry point in a loop, output "
            f"allocated once: {alone:.4f} ms ({bound['bound_ms'] / alone:.1%} of the bound) on "
            f"{dev['smi']}")
        del a8, w8, w8_rows
    mb = microbench["result"]
    ops = make_operands(4096, SEED, "cuda")
    mm.matmul_reference(ops["a16"], ops["b16"])
    bf16_plain = _event_ms(lambda: mm.matmul_reference(ops["a16"], ops["b16"]), 5)
    alone16 = _event_ms(_mm_sm90_launcher(ops["a16"], ops["b16"]), 20)
    alone8 = _event_ms(_mm_sm90_launcher(ops["a8"], ops["b8_kmajor"]), 20)
    del ops
    bound16 = _bound(2 * 4096 * 4096 * 2 + 4096 * 4096 * 4, 2.0 * 4096 ** 3, "bf16")
    bound8 = _bound(2 * 4096 * 4096 + 4096 * 4096 * 4, 2.0 * 4096 ** 3, "int8")
    log("timing", f"K6 at 4096^3 (routes {mb['routes']}): bf16, B row-major: kernel "
        f"{mb['k6_bf16_ms']:.4f} ms (bound {bound16['bound_ms']:.4f} ms by operations, "
        f"{bound16['bound_ms'] / mb['k6_bf16_ms']:.1%} of it; C entry point alone {alone16:.4f} "
        f"ms), plain (float32 matmul of the upcast operands, tf32 off) {bf16_plain:.4f} ms, "
        f"torch.matmul bf16 {mb['torch_matmul_bf16_ms']:.4f} ms: "
        f"{mb['k6_bf16_ms'] / mb['torch_matmul_bf16_ms']:.2f} x; int8, B the (N,K) weight "
        f"transposed: kernel {mb['k6_int8_kmajor_ms']:.4f} ms (bound {bound8['bound_ms']:.4f} ms "
        f"by operations, {bound8['bound_ms'] / mb['k6_int8_kmajor_ms']:.1%} of it; C entry point "
        f"alone {alone8:.4f} ms), torch._int_mm {mb['torch_int_mm_kmajor_ms']:.4f} ms; int8, B "
        f"row-major (mma.sync kernel): kernel {mb['k6_int8_ms']:.4f} ms, torch._int_mm "
        f"{mb['torch_int_mm_ms']:.4f} ms on {dev['smi']}")
    m, kk, n = 128 * 96 * 96, 1440, 64

    # the JSON line carries K3, K4 and K5 at the U-Net's FLOP-heaviest shape
    return {
        "clahe": dict(ms=k1_ms, plain_ms=k1_plain, library_ms=None, c_entry_ms=k1_alone,
                      c_entry_graph_ms=k1_graph,
                      profiled_ms_in_request=K1_PROFILED_MS[-1],
                      frames_64x360x640=dict(route="tiled", ms=k1f_ms, plain_ms=k1f_plain,
                                             bound_ms=k1f_bound),
                      **_bound(2 * n_img * 4, 0, "bf16")),
        "small_mha": dict(ms=k2_ms, plain_ms=k2_plain, library_ms=k2_lib,
                          **_attention_bound(384, 8, 80, 32, 4, 4)),
        "flash_attention": dict(ms=k3[(16384, 64)][0], plain_ms=k3[(16384, 64)][1],
                                library_ms=k3_lib[(16384, 64)],
                                **_attention_bound(DIFF_FRAMES, 1, 16384, 64, 4, 4)),
        # K4 reads q, k, v, dO and writes dK, dV; K5 reads the four and writes
        # dQ; both read lse and delta. The library call covers both kernels.
        "flash_bwd_dkv": dict(ms=bwd[("dkv", 16384, 64)][0], plain_ms=bwd[("dkv", 16384, 64)][1],
                              library_ms=bwd_lib, library_covers="flash_bwd_dkv+flash_bwd_dq",
                              **_attention_bound(DIFF_FRAMES, 1, 16384, 64, 8, 6)),
        "flash_bwd_dq": dict(ms=bwd[("dq", 16384, 64)][0], plain_ms=bwd[("dq", 16384, 64)][1],
                             library_ms=bwd_lib, library_covers="flash_bwd_dkv+flash_bwd_dq",
                             **_attention_bound(DIFF_FRAMES, 1, 16384, 64, 6, 5)),
        "int8_matmul": k6[(m, kk, n)],
        "bf16_matmul": dict(ms=mb["k6_bf16_ms"], plain_ms=bf16_plain,
                            library_ms=mb["torch_matmul_bf16_ms"], **bound16),
    }



def main() -> None:
    dev = phase_device()
    phase_build()
    errs = phase_kernels()
    served = phase_serve(dev)
    diffused = phase_diffuse(dev)
    trained = phase_train(dev)["launches"]
    superres = phase_superres(dev)["launches"]
    guided = phase_guidance(dev)["launches"]
    lipsync = phase_lipsync(dev)
    microbench = phase_microbench()
    paths = (diffused, trained, superres, guided)
    launches = {"clahe": served["clahe"],
                "small_mha": served["small_mha"] + sum(p["small_mha"] for p in paths),
                "int8_matmul": (served["int8_matmul"] + lipsync["launches"]
                                + microbench["launches"]["int8_matmul"]),
                "bf16_matmul": microbench["launches"]["bf16_matmul"]}
    for name in ("flash_attention", "flash_bwd_dkv", "flash_bwd_dq"):
        launches[name] = sum(p.get(name, 0) for p in paths)
    times = phase_timing(dev, microbench)
    pkg = "lipreading_video_generation_tpu_torch"
    jax_pkg = "lipreading_video_generation_tpu"
    sources = {  # name: (CUDA source, the TPU kernel it replaces)
        "clahe": ("clahe_packed.cu", f"{jax_pkg}/ops/clahe_pallas.py:102"),
        "small_mha": ("small_mha_sm90.cu", f"{jax_pkg}/ops/attention.py:570"),
        "flash_attention": ("flash_fwd_sm90.cu", f"{jax_pkg}/ops/attention.py:66"),
        "flash_bwd_dkv": ("flash_bwd_sm90.cu", f"{jax_pkg}/ops/attention.py:216"),
        "flash_bwd_dq": ("flash_bwd_sm90.cu", f"{jax_pkg}/ops/attention.py:272"),
        "int8_matmul": ("int8_mm_sm90.cu", "scripts/microbench_int8_pallas.py:44"),
        "bf16_matmul": ("int8_mm_sm90.cu", "scripts/microbench_int8_pallas.py:44"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        kern = {"name": name, "route": "cuda", "source": f"{pkg}/csrc/{source}",
                "replaces": replaces, "launches": launches[name], "max_abs_err": errs[name],
                **times[name]}
        if name == "flash_attention":
            kern["also_replaces"] = "scripts/profile_flash_dpad.py:37"
            kern["route_detail"] = (
                "sm90: wgmma on bf16 tiles, cp.async rings (aligned bf16 inputs up to head dim "
                "256; timed here and on the sampling and training paths); cuda_core: "
                f"{pkg}/csrc/flash_fwd.cu (float32, unaligned inputs, head dims above 256, in slices of "
                "256 columns)")
        if name.startswith("flash_bwd"):
            kern["route_detail"] = (
                "sm90: wgmma on bf16 tiles, cp.async ring (aligned bf16 inputs up to head dim "
                f"256; timed here and on the training path); cuda_core: {pkg}/csrc/flash_bwd.cu "
                "(float32, unaligned inputs, head dims above 256, in slices of 256 columns)")
        if name == "clahe":
            kern["route_detail"] = (
                "packed: one block an image, 8-bit counters packed in shared memory, an integer "
                "LUT scan written over them (L = 1, nbins a power of two up to 256, tiles of at "
                "most 255 pixels: the main path's (1920,48,48), timed here and on the ViViT "
                "path); tiled: "
                f"{pkg}/csrc/clahe.cu (a block a tile writes its LUT to a device workspace, a "
                "block a row blends; any other shape, e.g. frames of 360x640)")
        if name == "small_mha":
            kern["route_detail"] = (
                "sm90: mma.sync on bf16 tiles, double-buffered cp.async (aligned bf16 inputs, up "
                "to 128 tokens, head dim up to 128; timed here and on the ViViT, sampling and "
                f"training paths); cuda_core: {pkg}/csrc/small_mha.cu (float32, longer "
                "sequences, unaligned inputs)")
        if name.endswith("_matmul"):
            kern["route_detail"] = (
                "sm90: wgmma on swizzled tiles, a TMA ring kept full by a producer warpgroup, "
                "persistent blocks (rows of A and "
                "B on 16-byte boundaries, K contiguous, or N contiguous for a bf16 B; timed here "
                f"and on the int8 serving paths); mma_sync: {pkg}/csrc/int8_mm.cu (a row-major "
                "int8 B, odd row strides, element strides, unaligned views)")
        if kern["launches"] < 1:
            raise AssertionError(f"kernel {name} never ran on the main path")
        kernels.append(kern)
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_name_power())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                             "count": dev["count"]}}), flush=True)


if __name__ == "__main__":
    main()
