#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``lipreading_video_generation_tpu_torch``'s main path — the serving
path of the lipreader: mouth-ROI preprocessing, then the ViViT
word-classifier forward — at the ``ViViTConfig`` defaults (12 layers,
hidden 256, 8 heads, MLP 1024, bf16, 64 classes) on random weights made
from a seed, and checks every hand-written kernel on that path.

Phases (each prints lines tagged with its name; any failure raises and the
script exits non-zero without printing a result):

1. device  — needs CUDA; prints the card, the device count and
   ``nvidia-smi --query-gpu=name,power.limit``.
2. build   — builds the kernels from ``csrc/*.cu`` with nvcc; prints the
   build time and ptxas' register and shared-memory report.
3. kernels — each kernel against its plain torch version on the card
   (K1 CLAHE: max |Δ| ≤ 1e-2 gray levels; K2 small MHA: 2e-2 abs/rel in
   bf16, 1e-5 in float32, and its gradient at 1e-4 in float32).
4. serve   — 3 requests of 8 clips and 3 of 384 clips (5 frames each, 96×96
   RGB uint8 frames and face boxes as in bench.py), host frames in, host
   logits out; every request must launch K1 once and K2 once per layer, and
   give finite logits; the batch-8 requests must agree with the same model
   and inputs run on the CPU (the plain path).
5. timing  — request time and frames/s, each kernel's CUDA-event time
   beside its plain version's at the main-path shapes, peak device memory.

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
    for line in str(_build.build_info["log"]).splitlines():
        if "ptxas info" in line and ("registers" in line or "Compiling" in line
                                     or "smem" in line):
            log("build", line.strip())
    from lipreading_video_generation_tpu_torch.ops.attention import _small_mha_smem_bytes

    log("build", f"dynamic shared memory per block at the main-path shapes: K1 "
        f"{8 * 8 * 256 * 4} B (8x8 tiles of 256 int32 bins), K2 "
        f"{_small_mha_smem_bytes(80, 32)} B (S=80, d=32)")


def _uniform(shape, lo, hi, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(
        "cuda", dtype)


def phase_kernels() -> dict:
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl

    errs = {"clahe": 0.0, "small_mha": 0.0}
    for shape, grid in [((1920, 48, 48), (8, 8)), ((3, 50, 46), (8, 8)),
                        ((2, 64, 64), (4, 4))]:
        x = _uniform(shape, 0, 255, SEED)
        got = cl.clahe_cuda(x, 0.2, grid)
        torch.cuda.synchronize()
        err = (got - cl.clahe_reference(x, 0.2, grid)).abs().max().item()
        log("kernels", f"K1 clahe {shape} grid {grid}: max|d| {err:.3g} (tol {TOL_K1})")
        if not err <= TOL_K1:
            raise AssertionError(f"K1 clahe {shape}: max|d| {err} > {TOL_K1}")
        errs["clahe"] = max(errs["clahe"], err)

    for (b, s, e, h, causal, dtype, tol) in [
            (384, 80, 256, 8, False, torch.bfloat16, TOL_K2_BF16),
            (2, 33, 64, 4, True, torch.bfloat16, TOL_K2_BF16),
            (2, 33, 64, 4, True, torch.float32, TOL_K2_F32)]:
        q, k, v = (_uniform((b, s, e), -2, 2, SEED + i, dtype) for i in range(3))
        got = att.small_mha(q, k, v, h, causal)
        torch.cuda.synchronize()
        want = att._mha_einsum(q, k, v, h, causal)
        err = (got.float() - want.float()).abs().max().item()
        log("kernels", f"K2 small_mha ({b},{s},{e}) H={h} causal={causal} {dtype}: "
            f"max|d| {err:.3g} (tol {tol} abs/rel)")
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
        cl.clahe_cuda.launch_count = 0
        att.small_mha.launch_count = 0
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
        peak = torch.cuda.max_memory_allocated()
        log("serve", f"6 requests: launches K1={launches['clahe']} K2={launches['small_mha']} "
            f"(1 and {cfg.num_layers} per request); logits finite")

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

    per_req = statistics.median(times[384])
    log("serve", f"request times ({dev['smi']}): batch 8 "
        f"{[round(t * 1e3, 3) for t in times[8]]} ms; batch 384 "
        f"{[round(t * 1e3, 3) for t in times[384]]} ms; batch 384 median "
        f"{per_req * 1e3:.3f} ms = {384 * CLIP_FRAMES / per_req:.1f} frames/s; "
        f"peak device memory {peak / 2**20:.1f} MiB")
    return launches


def _event_ms(fn, n: int) -> float:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def _plain_vs_kernel(plain, kernel, n: int):
    """Warm up both, then time them in turns (plain, kernel, kernel, plain)."""
    plain(), kernel()
    torch.cuda.synchronize()
    p1, k1, k2, p2 = (_event_ms(plain, n), _event_ms(kernel, n),
                      _event_ms(kernel, n), _event_ms(plain, n))
    return (k1 + k2) / 2, (p1 + p2) / 2, (p1, k1, k2, p2)


def phase_timing(dev: dict) -> dict:
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl

    x = _uniform((384 * CLIP_FRAMES, 48, 48), 0, 255, SEED)
    with torch.inference_mode():
        k1_ms, k1_plain, raw1 = _plain_vs_kernel(
            lambda: cl.clahe_reference(x, 0.2, (8, 8)),
            lambda: cl.clahe_cuda(x, 0.2, (8, 8)), 20)
        # K2 as the main path calls it: q/k/v column slices of one qkv tensor
        q, k, v = _uniform((384, 80, 768), -2, 2, SEED, torch.bfloat16).chunk(3, dim=-1)
        k2_ms, k2_plain, raw2 = _plain_vs_kernel(
            lambda: att._mha_einsum(q, k, v, 8, False),
            lambda: att.small_mha(q, k, v, 8), 20)
    log("timing", f"K1 clahe (1920,48,48) f32: kernel {k1_ms:.4f} ms, plain {k1_plain:.4f} ms "
        f"(plain,kernel,kernel,plain = {[round(t, 4) for t in raw1]}) on {dev['smi']}")
    log("timing", f"K2 small_mha (384,80,256) H=8 bf16: kernel {k2_ms:.4f} ms, plain "
        f"{k2_plain:.4f} ms (plain,kernel,kernel,plain = {[round(t, 4) for t in raw2]}) "
        f"on {dev['smi']}")
    return {"clahe": (k1_ms, k1_plain), "small_mha": (k2_ms, k2_plain)}


def main() -> None:
    dev = phase_device()
    phase_build()
    errs = phase_kernels()
    launches = phase_serve(dev)
    times = phase_timing(dev)
    pkg = "lipreading_video_generation_tpu_torch"
    kernels = [
        {"name": "clahe", "route": "cuda", "source": f"{pkg}/csrc/clahe.cu",
         "replaces": "lipreading_video_generation_tpu/ops/clahe_pallas.py:102",
         "launches": launches["clahe"], "max_abs_err": errs["clahe"],
         "ms": times["clahe"][0], "plain_ms": times["clahe"][1]},
        {"name": "small_mha", "route": "cuda", "source": f"{pkg}/csrc/small_mha.cu",
         "replaces": "lipreading_video_generation_tpu/ops/attention.py:570",
         "launches": launches["small_mha"], "max_abs_err": errs["small_mha"],
         "ms": times["small_mha"][0], "plain_ms": times["small_mha"][1]},
    ]
    for kern in kernels:
        if kern["launches"] < 1:
            raise AssertionError(f"kernel {kern['name']} never ran on the main path")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_name_power())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                             "count": dev["count"]}}), flush=True)


if __name__ == "__main__":
    main()
