"""How fast is the int8 / bf16 matmul kernel K6 on this card?

Port of ``scripts/microbench_int8_pallas.py``: the same four rows at 4096³ —
K6 in bf16 and in int8 (``ops/matmul_cuda``), and the library's
``torch.matmul`` (bf16) and ``torch._int_mm`` (int8) as yardsticks — with
the script's row-major operands, plus the int8 product as int8 serving calls
it: B a (N, K) weight taken as its transpose, K contiguous, which the
wgmma kernel of ``csrc/int8_mm_sm90.cu`` reads as it lies (a row-major int8 B
is first packed to K-major rows by ``csrc/int8_mm.cu``: route "packed";
``result["routes"]`` says which route each row took), again beside
``torch._int_mm`` on the same operands. All after the same spot checks: the
int8 product equal and the bf16 product within rtol 0.1 / atol 1.0 on a 4×4
corner, and here also the whole of both products against
``matmul_reference`` (int8 equal; bf16 within 1e-3 of the largest |C|: the
output is the unrounded float32 sum, so only the order of summation
differs).

Timing (``run``): CUDA events around ``iters`` launches queued on one
stream, after a warm-up; the launches run back to back in order, which is
all the chaining a stream needs. The TPU script instead folds each output
into the next input inside one jitted loop and times with the host clock;
that is a device of its remote-dispatch harness (identical dispatches are
served from a cache there, and nothing blocks), and is not copied.

``graph_rows`` times, from a CUDA graph of 20 calls (device time only),
the shapes that take the "packed" route: 4096³ with B row-major (int8, and
bf16, which stays on "sm90"), ``chip_smoke.py``'s row-major shapes with odd
depths and an unaligned view (int8 and bf16), and ``int8_dense``'s operands
at the ViViT's Dense shapes (the activations (M, in), the quantised (in, out)
kernel row-major); each through the wrapper, and where a pack runs also the
packs alone and the product alone on the packed copies (at 4096³ also the
pack of B in turns from four copies of it, more than L2 holds), beside
``torch._int_mm`` (int8, where it takes the shape) or ``torch.matmul``
(bf16) on the same operands.

Run on a machine with an NVIDIA GPU:

    python lipreading_video_generation_tpu_torch/bench/microbench_int8.py \\
        [--package-root DIR] [--size 4096] [--out FILE]

``--package-root`` times the port found under DIR (a checkout of another
commit, which may predate the pack: its wrapper is timed alone), so that two
commits compare on one card, each in a process of its own. Prints one line
per row and a last line of JSON with every number.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np
import torch

BF16_REL_TOL = 1e-3   # of the largest |C|
GRAPH_LAUNCHES = 20
# (M, K, N): chip_smoke.py's K6_ROW_MAJOR_SHAPES (the generator's stems
# before padding and ragged shapes) and its unaligned view
ROW_MAJOR_SHAPES = [(65536, 294, 16), (65536, 9, 32), (257, 131, 67), (5, 9, 3)]
UNALIGNED_SHAPE = (300, 64, 48)
# int8_dense at the ViViT's Dense products (models/vivit.py: MLP in and out)
DENSE_SHAPES = [(30720, 256, 768), (30720, 1024, 256)]
PEAK = {torch.int8: 1979e12, torch.bfloat16: 989e12}   # dense tensor-core rates
HBM = 3.35e12                                           # bytes/s


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
    from lipreading_video_generation_tpu_torch.ops.matmul_cuda import (bf16_matmul, int8_matmul,
                                                                       matmul_reference)

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
    """Check, then time the rows at ``size``³. Needs a CUDA device."""
    from lipreading_video_generation_tpu_torch.core.device import default_device
    from lipreading_video_generation_tpu_torch.ops.matmul_cuda import (bf16_matmul, int8_matmul,
                                                                       matmul_route)

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


def _operands(dtype, m: int, k: int, n: int, layout: str, seed: int):
    """A (m, k) and B (k, n) on the card: "row_major" (both contiguous; B
    also int8_dense's (in, out) kernel) or "unaligned" (views that start one
    element into rows 16 elements wider, B an (N, K) weight transposed)."""
    rng = np.random.default_rng(seed)

    def draw(shape):
        if dtype == torch.int8:
            return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).cuda()
        return torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).cuda().to(dtype)

    if layout == "row_major":
        return draw((m, k)), draw((k, n))
    return draw((m, k + 16))[:, 1:1 + k], draw((n, k + 16))[:, 1:1 + k].t()


def _sm90_launcher(a: torch.Tensor, b: torch.Tensor):
    """The wgmma kernel's C entry point on operands it reads as they lie,
    into an output allocated once: the product alone."""
    from lipreading_video_generation_tpu_torch.ops import _build

    int8 = a.dtype == torch.int8
    out = torch.empty((a.shape[0], b.shape[1]), dtype=torch.int32 if int8 else torch.float32,
                      device=a.device)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = _build.kernel("lvg_mm_sm90_int8" if int8 else "lvg_mm_sm90_bf16",
                       [vp] * 3 + [i32] * 3 + [i64] * 3 + [vp])
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], b.shape[1], a.shape[1],
            a.stride(0), b.stride(0), b.stride(1))

    def launch():
        _build.check(fn(*args, torch.cuda.current_stream().cuda_stream), "matmul (sm90)")

    launch.out = out
    return launch


def work(dtype, m: int, k: int, n: int) -> dict:
    """The product's bound: operands read once, C written once (4 bytes an
    element), 2·M·N·K operations at the tensor cores' dense rate."""
    size = 1 if dtype == torch.int8 else 2
    bytes_ = (m * k + k * n) * size + m * n * 4
    by_ops = 2.0 * m * n * k / PEAK[dtype] * 1e3
    by_bytes = bytes_ / HBM * 1e3
    return {"bound_ms": max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes"}


def graph_rows(seed: int = 0, size: int = 4096) -> List[dict]:
    """Each shape of the module docstring's list from a CUDA graph of
    ``GRAPH_LAUNCHES`` calls: the wrapper (its route), and where the package
    has a pack and the route packs, the packs alone and the product alone;
    the library's call on the same operands; the wrapper's largest
    difference from ``matmul_reference``. Needs a CUDA device."""
    from lipreading_video_generation_tpu_torch.bench.timing import graph_ms
    from lipreading_video_generation_tpu_torch.ops import matmul_cuda as mm

    cases = [("4096^3", torch.int8, (size, size, size), "row_major"),
             ("4096^3", torch.bfloat16, (size, size, size), "row_major")]
    for dtype in (torch.int8, torch.bfloat16):
        cases += [("row_major", dtype, shape, "row_major") for shape in ROW_MAJOR_SHAPES]
        cases.append(("unaligned", dtype, UNALIGNED_SHAPE, "unaligned"))
    cases += [("int8_dense", torch.int8, shape, "row_major") for shape in DENSE_SHAPES]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    try:
        for i, (name, dtype, (m, k, n), layout) in enumerate(cases):
            a, b = _operands(dtype, m, k, n, layout, seed + i)
            wrapper = mm.int8_matmul if dtype == torch.int8 else mm.bf16_matmul
            route = mm.matmul_route(dtype, m, n, k, a.stride(), b.stride(), a.data_ptr(),
                                    b.data_ptr())
            got, want = wrapper(a, b), mm.matmul_reference(a, b)
            err = (got - want).abs().max().item()
            tol = 0.0 if dtype == torch.int8 else BF16_REL_TOL * want.abs().max().item()
            if not err <= tol:
                raise AssertionError(f"K6 {name} {dtype} ({m},{k},{n}): max|d| {err} > {tol}")
            row = dict(name=name, dtype=str(dtype).split(".")[-1], shape=[m, k, n],
                       layout=layout, route=route, max_abs_err=err,
                       ms=graph_ms(lambda: wrapper(a, b), GRAPH_LAUNCHES), **work(dtype, m, k, n))
            if hasattr(mm, "pack_k_major") and route == "packed":
                pack_a, pack_b = mm._packs(dtype, m, n, k, a.stride(), b.stride(), a.data_ptr(),
                                           b.data_ptr())

                def packs():
                    pa = mm.pack_k_major(a) if pack_a else a
                    return pa, (mm.pack_k_major(b.t()).t() if pack_b else b)

                pa, pb = packs()
                size_ = 1 if dtype == torch.int8 else 2
                row["packs"] = [name_ for name_, on in (("A", pack_a), ("B", pack_b)) if on]
                row["pack_paths"] = [mm.pack_path(dtype, t.stride(), t.data_ptr())
                                     for t, on in ((a, pack_a), (b.t(), pack_b)) if on]
                row["pack_ms"] = graph_ms(packs, GRAPH_LAUNCHES)
                row["pack_bound_ms"] = 2 * size_ * (m * k * pack_a + n * k * pack_b) / HBM * 1e3
                row["product_ms"] = graph_ms(_sm90_launcher(pa, pb), GRAPH_LAUNCHES)
                if pack_b and not pack_a and b.numel() >= 1 << 24:
                    # the pack of B in turns from four copies (64 MB and up,
                    # more than the 50 MB L2): its source read from memory
                    copies, turn = [b] + [b.clone() for _ in range(3)], iter(range(1 << 30))
                    row["pack_4_sources_ms"] = graph_ms(
                        lambda: mm.pack_k_major(copies[next(turn) % 4].t()), GRAPH_LAUNCHES)
                    del copies
            row["library"] = "torch._int_mm" if dtype == torch.int8 else "torch.matmul"
            try:
                lib = (lambda: torch._int_mm(a, b)) if dtype == torch.int8 else (
                    lambda: torch.matmul(a, b))
                row["library_ms"] = graph_ms(lib, GRAPH_LAUNCHES)
            except RuntimeError as e:          # _int_mm's own shape rules
                row["library_ms"], row["library_refused"] = None, str(e).splitlines()[0]
            rows.append(row)
            del a, b, got, want
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package-root", default=str(Path(__file__).resolve().parents[2]),
                    help="directory holding the lipreading_video_generation_tpu_torch to time")
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.package_root).resolve()))
    from lipreading_video_generation_tpu_torch.ops import matmul_cuda as mm

    result = run(args.size, args.iters, args.seed)
    result["graph_rows"] = graph_rows(args.seed, args.size)
    for r in result["graph_rows"]:
        parts = "".join(f", {key} {r[key]:.4f} ms"
                        for key in ("pack_ms", "pack_4_sources_ms", "product_ms") if key in r)
        lib = "refused" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"{r['name']} {r['dtype']} {tuple(r['shape'])} {r['layout']} route {r['route']}: "
              f"{r['ms']:.4f} ms from a graph{parts}; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}); {r['library']} {lib}; max|d| {r['max_abs_err']:.3g}",
              flush=True)
    result["package"] = str(Path(mm.__file__).resolve().parents[1])
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
