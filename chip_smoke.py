#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``lipreading_video_generation_tpu_torch``'s ported paths on random
weights made from a seed, and checks every hand-written kernel on them:

- the lipreader's serving path — mouth-ROI preprocessing, then the ViViT
  word-classifier forward — at the ``ViViTConfig`` defaults (12 layers,
  hidden 256, 8 heads, MLP 1024, bf16, 64 classes);
- diffusion sampling — uint8 condition frame + raw audio → native audio
  encoder → conditioning map → DDIM / DPM++ denoise steps of the U-Net →
  uint8 frames — at the ``DiffusionConfig`` defaults (128×128, base 64,
  channel_mult (1,2,4), 2 res blocks, attention at ds 1/2/4, 1 head, bf16);
- diffusion training — uint8 target/condition frames + raw audio →
  ``prepare_batch`` → q-sample → U-Net forward in train mode (dropout 0.1)
  → ε-MSE → backward through the flash backward kernels → Adam → EMA — at
  the same defaults, batch 8;
- the super-resolution stage (``SuperResConfig`` defaults: training, then
  the two-stage cascade) and classifier guidance (``ClassifierConfig``
  defaults: training, then a guided request), the other two users of the
  flash backward.

Phases (each prints lines tagged with its name; any failure raises and the
script exits non-zero without printing a result):

1. device  — needs CUDA; prints the card, the device count and
   ``nvidia-smi --query-gpu=name,power.limit``.
2. build   — builds the kernels from ``csrc/*.cu`` with nvcc, one process
   per source; prints the build time, ptxas' register and shared-memory
   report and each kernel's dynamic shared memory.
3. kernels — each kernel against its plain torch version on the card
   (K1 CLAHE: max |Δ| ≤ 1e-2 gray levels; K2 small MHA: 2e-2 abs/rel in
   bf16, 1e-5 in float32, and its gradient at 1e-4 in float32; K3 flash
   forward: O within 1e-2 in bf16 (one output ulp at |O| ≤ 1), 1e-4 in
   float32, lse within 1e-4; K4/K5 flash backward: each gradient within
   1e-2 of its largest value in bf16 (one rounding of the gradient), 1e-4
   in float32), at the shapes the paths give them.
4. serve   — 3 requests of 8 clips and 3 of 384 clips (5 frames each, 96×96
   RGB uint8 frames and face boxes as in bench.py), host frames in, host
   logits out; every request must launch K1 once and K2 once per layer, and
   give finite logits; the batch-8 requests must agree with the same model
   and inputs run on the CPU (the plain path).
5. diffuse — one warm-up and 3 timed ``sample_video`` requests of 4 frames
   × 10 DDIM steps, and one with DPM++(2M); each must launch K3 16 times a
   step and K2 4 times, and return finite (4, 128, 128, 3) uint8 frames;
   the full 500-step DDPM chain at batch 1; then the card against the CPU
   plain path at the full channel plan but 64×64, batch 1, 2 DDIM steps,
   same initial noise.
6. train   — ``train_step`` at the ``DiffusionConfig`` defaults, batch 8:
   one warm-up and 5 timed steps, each launching K3, K4 and K5 16 times and
   K2 4 times, with finite loss, params and EMA and an EMA that moves; 10
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
9. timing  — request and train-step times, frames/s, each kernel's
   CUDA-event time beside its plain version's at the main-path shapes,
   peak device memory.

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
    from lipreading_video_generation_tpu_torch.ops.attention import (
        _small_mha_smem_bytes, flash_bwd_smem_bytes, flash_smem_bytes)

    log("build", f"dynamic shared memory per block at the main-path shapes: K1 "
        f"{8 * 8 * 256 * 4} B (8x8 tiles of 256 int32 bins), K2 "
        f"{_small_mha_smem_bytes(80, 32)} B (S=80, d=32), "
        f"{_small_mha_smem_bytes(11, 96)} B (S=11, d=96); K3 "
        + ", ".join(f"{flash_smem_bytes(d)} B (head dim {d})" for d in (64, 128, 256))
        + "; K4 " + ", ".join(f"{flash_bwd_smem_bytes(d, 'dkv')} B (head dim {d})"
                             for d in (64, 128, 256))
        + "; K5 " + ", ".join(f"{flash_bwd_smem_bytes(d, 'dq')} B (head dim {d})"
                             for d in (64, 128, 256)))


def _uniform(shape, lo, hi, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(
        "cuda", dtype)


def phase_kernels() -> dict:
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl

    errs = {"clahe": 0.0, "small_mha": 0.0, "flash_attention": 0.0}
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
            (DIFF_FRAMES, 11, 768, 8, False, torch.bfloat16, TOL_K2_BF16),  # audio encoder
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

    # K3: the U-Net's three shapes (batch 2), scripts/profile_flash_dpad.py's
    # two, and small causal / ragged / cross / fully-masked-row cases
    for (q_shape, s_k, causal, dtype) in [
            ((2, 1, 16384, 64), 16384, False, torch.bfloat16),
            ((2, 1, 4096, 128), 4096, False, torch.bfloat16),
            ((2, 1, 1024, 256), 1024, False, torch.bfloat16),
            ((1, 1, 16384, 64), 16384, False, torch.bfloat16),
            ((1, 1, 512, 64), 512, False, torch.float32),
            ((2, 3, 192, 32), 192, True, torch.float32),
            ((2, 3, 160, 40), 320, True, torch.float32),
            ((2, 3, 200, 16), 200, False, torch.float32),
            ((1, 2, 160, 128), 320, False, torch.float32),
            ((1, 2, 200, 64), 150, True, torch.float32)]:
        b, h, s_q, d = q_shape
        q = _uniform(q_shape, -2, 2, SEED, dtype)
        k, v = (_uniform((b, h, s_k, d), -2, 2, SEED + 1 + i, dtype) for i in range(2))
        got_o, got_lse = att.flash_attention(q, k, v, causal, return_lse=True)
        torch.cuda.synchronize()
        want_o, want_lse = att.flash_reference(q, k, v, causal)
        err = (got_o.float() - want_o.float()).abs().max().item()
        err_lse = (got_lse - want_lse).abs().max().item()
        tol = TOL_K3_BF16 if dtype == torch.bfloat16 else TOL_K3_F32
        log("kernels", f"K3 flash_attention q{q_shape} s_k={s_k} causal={causal} {dtype}: "
            f"O max|d| {err:.3g} (tol {tol} abs/rel), lse max|d| {err_lse:.3g} "
            f"(tol {TOL_LSE} abs/rel)")
        torch.testing.assert_close(got_o.float(), want_o.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(got_lse, want_lse, rtol=TOL_LSE, atol=TOL_LSE)
        errs["flash_attention"] = max(errs["flash_attention"], err)
        del q, k, v, got_o, got_lse, want_o, want_lse

    # K4/K5: the U-Net's three shapes (batch 2), the super-resolution U-Net's
    # (d=192, padded to 256), the classifier's (2 heads, d=64), and small
    # float32 causal / ragged / cross / fully-masked-row cases
    errs["flash_bwd_dkv"] = errs["flash_bwd_dq"] = 0.0
    for (q_shape, s_k, causal, dtype) in [
            ((2, 1, 16384, 64), 16384, False, torch.bfloat16),
            ((2, 1, 4096, 128), 4096, False, torch.bfloat16),
            ((2, 1, 1024, 256), 1024, False, torch.bfloat16),
            ((2, 1, 1024, 192), 1024, False, torch.bfloat16),
            ((2, 2, 1024, 64), 1024, False, torch.bfloat16),
            ((1, 1, 512, 64), 512, False, torch.float32),
            ((2, 3, 192, 32), 192, True, torch.float32),
            ((2, 3, 160, 40), 320, True, torch.float32),
            ((2, 3, 200, 16), 200, False, torch.float32),
            ((1, 2, 160, 128), 320, False, torch.float32),
            ((1, 2, 256, 256), 256, True, torch.float32),
            ((1, 2, 200, 64), 150, True, torch.float32)]:
        b, h, s_q, d = q_shape
        q = _uniform(q_shape, -2, 2, SEED + 20, dtype)
        k, v = (_uniform((b, h, s_k, d), -2, 2, SEED + 21 + i, dtype) for i in range(2))
        do = _uniform(q_shape, -1, 1, SEED + 23, dtype)
        o, lse = att.flash_attention(q, k, v, causal, return_lse=True)
        delta = (do.float() * o.float()).sum(-1)
        dk, dv = att.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        dq = att.flash_bwd_dq(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        want = att.flash_backward_reference(q, k, v, do, lse, delta, causal)
        tol = TOL_BWD_BF16 if dtype == torch.bfloat16 else TOL_BWD_F32
        rel = []
        for got, ref, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError(f"K4/K5 {name}: {got.shape} {got.dtype}, want "
                                     f"{ref.shape} {ref.dtype}")
            diff = (got.float() - ref.float()).abs().max().item()
            rel.append(diff / ref.float().abs().max().item())
            errs["flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"] = max(
                errs["flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"], diff)
        log("kernels", f"K4/K5 flash backward q{q_shape} s_k={s_k} causal={causal} {dtype}: "
            f"max|d|/max|ref| dq {rel[0]:.3g} dk {rel[1]:.3g} dv {rel[2]:.3g} (tol {tol})")
        if not max(rel) <= tol:
            raise AssertionError(f"K4/K5 q{q_shape} s_k={s_k}: {rel} > {tol}")
        del q, k, v, do, o, lse, delta, dq, dk, dv, want

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
    cl.clahe_cuda.launch_count = 0
    att.small_mha.launch_count = 0
    att.flash_attention.launch_count = 0
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
    log("diffuse", f"4 requests (ddim x3, dpmpp) of {DIFF_FRAMES} frames x {DIFF_STEPS} "
        f"steps: launches K1=0 K2={launches['small_mha']} K3={launches['flash_attention']} "
        f"(4 and {n_attn}x{DIFF_STEPS} per request); uint8 frames "
        f"{tuple(out.shape)}, pixel mean {out.float().mean().item():.2f}")

    # the full DDPM ancestral chain (500 steps) at batch 1
    k2, k3 = att.small_mha.launch_count, att.flash_attention.launch_count
    t0 = time.perf_counter()
    chain = sample_video(model, frame, audio[:1], cfg, generator=gen.manual_seed(SEED)).cpu()
    chain_s = time.perf_counter() - t0
    d = (att.small_mha.launch_count - k2, att.flash_attention.launch_count - k3)
    if d != (4, n_attn * cfg.num_timesteps) or tuple(chain.shape) != (1, 128, 128, 3):
        raise AssertionError(f"DDPM chain launched K2/K3 {d}, gave {tuple(chain.shape)}")
    log("diffuse", f"full DDPM chain, batch 1, {cfg.num_timesteps} steps: {chain_s:.3f} s "
        f"({cfg.num_timesteps / chain_s:.2f} frame-steps/s), K2={d[0]} K3={d[1]} launches, "
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
        f"{DIFF_FRAMES * DIFF_STEPS / per_req:.2f} denoise frame-steps/s; "
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

    for fn in (cl.clahe_cuda, att.small_mha, att.flash_attention, att.flash_bwd_dkv,
               att.flash_bwd_dq):
        fn.launch_count = 0


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counts().items()}


def train_batch(cfg, n: int, seed: int, size: int = 160) -> dict:
    """Random ``size``×``size`` RGB uint8 target and condition frames
    (resized to im_size on the way in) and ``n`` random audio windows."""
    rng = np.random.default_rng(seed)
    return {"target_frame": rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            "cond_frame": rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            "audio": rng.standard_normal((n, cfg.audio_samples)).astype(np.float32)}


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
    peak = torch.cuda.max_memory_allocated()
    ema_moved = sum(int(not torch.equal(e, e0)) for e, e0 in zip(state.ema.parameters(), ema0))
    if not (np.isfinite(losses).all() and _finite(state.model) and _finite(state.ema)):
        raise AssertionError(f"non-finite loss, params or EMA: losses {losses}")
    if ema_moved == 0:
        raise AssertionError("the EMA did not move in 5 steps")
    log("train", f"5 steps: losses {[round(x, 5) for x in losses]}; launches per step K2 4 "
        f"K3 16 K4 16 K5 16 (total {launches}); params and EMA finite; EMA moved in "
        f"{ema_moved}/{len(ema0)} tensors")

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
        f"{step_s * 1e3:.3f} ms = {TRAIN_BATCH / step_s:.2f} trained frames/s; peak device "
        f"memory {peak / 2**20:.1f} MiB")
    return {"launches": launches, "step_ms": step_s * 1e3, "peak_mib": peak / 2**20}


def phase_superres(dev: dict) -> dict:
    import dataclasses

    from lipreading_video_generation_tpu_torch.core.config import DiffusionConfig, SuperResConfig
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
    log("superres", f"3 train steps at batch {TRAIN_BATCH}: losses "
        f"{[round(x, 5) for x in losses]}, times {[round(x * 1e3, 3) for x in times]} ms "
        f"({dev['smi']}); K3/K4/K5 {n_attn} each a step")

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
    log("superres", f"sample_cascade: base 64x64 {DIFF_FRAMES} frames x {DIFF_STEPS} DDIM "
        f"steps, SR {scfg.sr_inference_steps} DDIM steps -> {tuple(high.shape)} in "
        f"[{high.min().item():.3f}, {high.max().item():.3f}], finite; K3 launches "
        f"{d['flash_attention']}; {cascade_s * 1e3:.3f} ms ({dev['smi']})")
    return {"launches": _counts()}


def phase_guidance(dev: dict) -> dict:
    from lipreading_video_generation_tpu_torch.core.config import (
        ClassifierConfig, DiffusionConfig)
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
    log("guidance", f"guided sample_video (label 2, scale 5), {DIFF_FRAMES} frames x "
        f"{DIFF_STEPS} DDIM steps: launches {d} ({n_attn} K4/K5 a step); mean |guided - "
        f"unguided| {moved:.3f} levels; {guided_s * 1e3:.3f} ms ({dev['smi']})")
    return {"launches": _counts()}


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
        # K3 at the U-Net's three shapes, batch DIFF_FRAMES, as the U-Net
        # calls it: (B, 1, S, D) views of column slices of one qkv tensor
        k3 = {}
        for s, d in ((16384, 64), (4096, 128), (1024, 256)):
            qkv = _uniform((DIFF_FRAMES, s, 3 * d), -2, 2, SEED, torch.bfloat16)
            q, k, v = (t.reshape(DIFF_FRAMES, s, 1, d).transpose(1, 2)
                       for t in qkv.chunk(3, dim=-1))
            k3[(s, d)] = _plain_vs_kernel(lambda: att.flash_reference(q, k, v),
                                          lambda: att.flash_attention(q, k, v), 3)
            del qkv, q, k, v
    for (s, d), (ms, plain, raw) in k3.items():
        flops = 4.0 * DIFF_FRAMES * s * s * d
        log("timing", f"K3 flash_attention ({DIFF_FRAMES},1,{s},{d}) bf16: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain:.4f} ms (plain,kernel,kernel,plain "
            f"= {[round(t, 4) for t in raw]}) on {dev['smi']}")
    log("timing", f"K1 clahe (1920,48,48) f32: kernel {k1_ms:.4f} ms, plain {k1_plain:.4f} ms "
        f"(plain,kernel,kernel,plain = {[round(t, 4) for t in raw1]}) on {dev['smi']}")
    log("timing", f"K2 small_mha (384,80,256) H=8 bf16: kernel {k2_ms:.4f} ms, plain "
        f"{k2_plain:.4f} ms (plain,kernel,kernel,plain = {[round(t, 4) for t in raw2]}) "
        f"on {dev['smi']}")
    # K4 and K5 at the same shapes, each against the part of the plain
    # backward that gives its outputs
    bwd = {}
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
                lambda: att.flash_bwd_dkv(q, k, v, do, lse, delta), 3)
            bwd[("dq", s, d)] = _plain_vs_kernel(
                lambda: att.flash_backward_reference(q, k, v, do, lse, delta, dkv=False),
                lambda: att.flash_bwd_dq(q, k, v, do, lse, delta), 3)
        del qkv, q, k, v, do, o, lse, delta
    for (kern, s, d), (ms, plain, raw) in bwd.items():
        flops = (8.0 if kern == "dkv" else 6.0) * DIFF_FRAMES * s * s * d
        name = "K4 flash_bwd_dkv" if kern == "dkv" else "K5 flash_bwd_dq"
        log("timing", f"{name} ({DIFF_FRAMES},1,{s},{d}) bf16: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain:.4f} ms (plain,kernel,kernel,plain "
            f"= {[round(t, 4) for t in raw]}) on {dev['smi']}")
    # the JSON line carries K3, K4 and K5 at the U-Net's FLOP-heaviest shape
    return {"clahe": (k1_ms, k1_plain), "small_mha": (k2_ms, k2_plain),
            "flash_attention": k3[(16384, 64)][:2],
            "flash_bwd_dkv": bwd[("dkv", 16384, 64)][:2],
            "flash_bwd_dq": bwd[("dq", 16384, 64)][:2]}


def main() -> None:
    dev = phase_device()
    phase_build()
    errs = phase_kernels()
    served = phase_serve(dev)
    diffused = phase_diffuse(dev)
    trained = phase_train(dev)["launches"]
    superres = phase_superres(dev)["launches"]
    guided = phase_guidance(dev)["launches"]
    paths = (diffused, trained, superres, guided)
    launches = {"clahe": served["clahe"],
                "small_mha": served["small_mha"] + sum(p["small_mha"] for p in paths)}
    for name in ("flash_attention", "flash_bwd_dkv", "flash_bwd_dq"):
        launches[name] = sum(p.get(name, 0) for p in paths)
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
        {"name": "flash_attention", "route": "cuda", "source": f"{pkg}/csrc/flash_fwd.cu",
         "replaces": "lipreading_video_generation_tpu/ops/attention.py:66",
         "also_replaces": "scripts/profile_flash_dpad.py:37",
         "launches": launches["flash_attention"], "max_abs_err": errs["flash_attention"],
         "ms": times["flash_attention"][0], "plain_ms": times["flash_attention"][1]},
        {"name": "flash_bwd_dkv", "route": "cuda", "source": f"{pkg}/csrc/flash_bwd.cu",
         "replaces": "lipreading_video_generation_tpu/ops/attention.py:216",
         "launches": launches["flash_bwd_dkv"], "max_abs_err": errs["flash_bwd_dkv"],
         "ms": times["flash_bwd_dkv"][0], "plain_ms": times["flash_bwd_dkv"][1]},
        {"name": "flash_bwd_dq", "route": "cuda", "source": f"{pkg}/csrc/flash_bwd.cu",
         "replaces": "lipreading_video_generation_tpu/ops/attention.py:272",
         "launches": launches["flash_bwd_dq"], "max_abs_err": errs["flash_bwd_dq"],
         "ms": times["flash_bwd_dq"][0], "plain_ms": times["flash_bwd_dq"][1]},
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
