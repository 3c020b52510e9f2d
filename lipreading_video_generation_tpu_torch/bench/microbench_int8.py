"""How fast is the int8 / bf16 matmul kernel K6 on this card?

Port of ``scripts/microbench_int8_pallas.py``: the same four rows at 4096³ —
K6 in bf16 and in int8 (``ops/matmul_cuda``), and the library's
``torch.matmul`` (bf16) and ``torch._int_mm`` (int8) as yardsticks — with
the script's row-major operands, plus the int8 product as int8 serving calls
it: B a (N, K) weight taken as its transpose, K contiguous, the only layout
the integer tensor-core instruction of ``csrc/int8_mm_sm90.cu`` reads (the
row-major int8 B runs ``csrc/int8_mm.cu``; ``result["routes"]`` says which
kernel each row took), again beside ``torch._int_mm`` on the same operands.
All after the same spot checks: the int8 product equal and the bf16 product within
rtol 0.1 / atol 1.0 on a 4×4 corner, and here also the whole of both
products against ``matmul_reference`` (int8 equal; bf16 within 1e-3 of the
largest |C|: the output is the unrounded float32 sum, so only the order of
summation differs).

Timing: CUDA events around ``iters`` launches queued on one stream, after a
warm-up; the launches run back to back in order, which is all the chaining
a stream needs. The TPU script instead folds each output into the next input
inside one jitted loop and times with the host clock; that is a device of
its remote-dispatch harness (identical dispatches are served from a cache
there, and nothing blocks), and is not copied.

Run on a machine with an NVIDIA GPU:

    python -m lipreading_video_generation_tpu_torch.bench.microbench_int8 [--size 4096]

Prints one line per row (six) and a last line of JSON with every number.
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Dict

import numpy as np
import torch

from ..core.device import default_device
from ..ops.matmul_cuda import bf16_matmul, int8_matmul, matmul_reference, matmul_route

BF16_REL_TOL = 1e-3   # of the largest |C|


def event_ms(fn: Callable[[], object], iters: int) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` launches queued back to
    back, by CUDA events."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def make_operands(size: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The script's operands: bf16 N(0, 0.1²), int8 uniform in [-4, 4]."""
    rng = np.random.default_rng(seed)
    a16 = torch.from_numpy((rng.standard_normal((size, size)) * 0.1).astype(np.float32))
    b16 = torch.from_numpy((rng.standard_normal((size, size)) * 0.1).astype(np.float32))
    a8 = torch.from_numpy(rng.integers(-4, 5, (size, size)).astype(np.int8))
    b8 = torch.from_numpy(rng.integers(-4, 5, (size, size)).astype(np.int8))
    b8 = b8.to(device)
    return {"a16": a16.to(device, torch.bfloat16), "b16": b16.to(device, torch.bfloat16),
            "a8": a8.to(device), "b8": b8,
            # the same matrix stored as a (N, K) weight: K contiguous
            "b8_kmajor": b8.t().contiguous().t()}


def check(ops: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The spot checks and the whole-product checks; raises on a miss."""
    got16, want16 = bf16_matmul(ops["a16"], ops["b16"]), matmul_reference(ops["a16"], ops["b16"])
    got8, want8 = int8_matmul(ops["a8"], ops["b8"]), matmul_reference(ops["a8"], ops["b8"])
    if not torch.equal(int8_matmul(ops["a8"], ops["b8_kmajor"]), want8):
        raise AssertionError("int8 product with a K-major B differs from the plain one")
    torch.cuda.synchronize()
    torch.testing.assert_close(got16[:4, :4], want16[:4, :4], rtol=0.1, atol=1.0)
    if not torch.equal(got8[:4, :4], want8[:4, :4]):
        raise AssertionError("int8 4x4 corner differs from the plain product")
    err8 = (got8 - want8).abs().max().item()
    err16 = (got16 - want16).abs().max().item()
    bound16 = BF16_REL_TOL * want16.abs().max().item()
    if err8 != 0:
        raise AssertionError(f"int8 product differs from the plain one by up to {err8}")
    if not err16 <= bound16:
        raise AssertionError(f"bf16 product: max|d| {err16} > {bound16}")
    return {"int8_max_abs_err": err8, "bf16_max_abs_err": err16, "bf16_bound": bound16}


def run(size: int = 4096, iters: int = 20, seed: int = 0) -> Dict[str, object]:
    """Check, then time the four rows at ``size``³. Needs a CUDA device."""
    device = default_device()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False     # the plain bf16 product in full float32
    try:
        ops = make_operands(size, seed, device)
        result: Dict[str, object] = {"size": size, "iters": iters,
                                     "device": torch.cuda.get_device_name(0)}
        result.update(check(ops))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    rows = {
        "k6_bf16": lambda: bf16_matmul(ops["a16"], ops["b16"]),
        "k6_int8": lambda: int8_matmul(ops["a8"], ops["b8"]),
        "k6_int8_kmajor": lambda: int8_matmul(ops["a8"], ops["b8_kmajor"]),
        "torch_matmul_bf16": lambda: torch.matmul(ops["a16"], ops["b16"]),
        "torch_int_mm": lambda: torch._int_mm(ops["a8"], ops["b8"]),
        "torch_int_mm_kmajor": lambda: torch._int_mm(ops["a8"], ops["b8_kmajor"]),
    }
    result["routes"] = {
        name: matmul_route(a.dtype, size, size, size, a.stride(), b.stride(), a.data_ptr(),
                           b.data_ptr())
        for name, (a, b) in {"k6_bf16": (ops["a16"], ops["b16"]), "k6_int8": (ops["a8"], ops["b8"]),
                             "k6_int8_kmajor": (ops["a8"], ops["b8_kmajor"])}.items()}
    flop = 2.0 * size ** 3
    for name, fn in rows.items():
        fn()                                          # warm-up
        torch.cuda.synchronize()
        ms = event_ms(fn, iters)
        result[f"{name}_ms"] = ms
        print(f"{name} {size}^3: {ms:.4f} ms/op  {flop / ms / 1e9:.1f} T(FL)OP/s", flush=True)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(json.dumps(run(args.size, args.iters, args.seed)))


if __name__ == "__main__":
    main()
