"""How fast is K2's CUDA-core route (``csrc/small_mha.cu``) at the float32
shapes of the port's main paths?

Each shape is timed four ways on the card, after a warm-up:

- through ``ops/attention.small_mha``, its host work included: CUDA events
  around a loop of calls (every call counted on the "cuda_core" route);
- through the C entry point in a loop, the output allocated and the
  arguments converted to their C types once (the function is called
  without ctypes' per-call conversion), the stream read each call;
- the same launches replayed from a CUDA graph of 20 (device time only:
  what a launch costs the card, without the host that issues it);
- ``F.scaled_dot_product_attention`` in float32 on the same inputs from a
  CUDA graph of 20 calls: the library's device time, likewise.

Plus the plain version (``_mha_einsum``) in a loop, the kernel's largest
difference from it, and the bytes and operations of a call (each input
read once, the output written once; a causal row counts only the keys it
sees). ``chip_smoke.py [timing]`` calls ``run`` and turns those into
bounds.

Run on a machine with an NVIDIA GPU:

    python lipreading_video_generation_tpu_torch/bench/small_mha_timing.py \\
        [--package-root DIR] [--out FILE]

``--package-root`` times the port found under DIR (a checkout of another
commit, whose C entry point may predate the variant argument), so that two
commits compare on one card, each in a process of its own. Prints one
line per shape and a last line of JSON with every number.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

# (name, (B, S, E), heads, causal, layout): "qkv" = column slices of one
# (B, S, 3E) projection, as the model passes them; "" = three tensors
SHAPES = (
    ("word_lm", (100, 31, 64), 4, True, "qkv"),                  # models/word_lm.py:58
    ("avhubert", (16, 5, 768), 12, False, ""),                   # models/avhubert.py:117
    ("expert_encoder", (16, 5, 256), 4, False, "qkv"),           # models/layers.py:297
    ("expert_decoder", (16, 48, 256), 4, True, "qkv"),           # models/lip_expert.py:155
    ("feature_transformer", (64, 5, 1024), 2, False, "qkv"),     # models/layers.py:297
)
GRAPH_LAUNCHES = 20


def inputs(shape, layout: str, seed: int):
    """q, k, v on the card, uniform in [-2, 2) from ``seed``."""
    b, s, e = shape

    def uniform(shape_, seed_):
        rng = np.random.default_rng(seed_)
        return torch.from_numpy(rng.uniform(-2, 2, shape_).astype(np.float32)).to("cuda")

    if layout == "qkv":
        return uniform((b, s, 3 * e), seed).chunk(3, dim=-1)
    return tuple(uniform((b, s, e), seed + i) for i in range(3))


def work(shape, heads: int, causal: bool) -> dict:
    """Bytes (q, k, v read once, O written once, float32) and operations
    (2 a multiply-add of QKᵀ and of P·V, over the keys each row sees)."""
    b, s, e = shape
    pairs = s * (s + 1) // 2 if causal else s * s
    return {"bytes": 4 * b * s * e * 4, "ops": 4.0 * b * pairs * e}


def c_entry_launcher(att, q, k, v, heads: int, causal: bool):
    """A function that launches the CUDA-core K2 on q, k, v through its C
    entry point, into an output allocated here, once: what
    ``_small_mha_launch`` does without its host work and its count. An
    older port's entry point takes no variant."""
    from lipreading_video_generation_tpu_torch.ops import _build

    b, s, e = q.shape
    d = e // heads
    out = torch.empty(b, s, e, dtype=q.dtype, device=q.device)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    argtypes = [vp] * 4 + [i32] + [i64] * 6 + [i32] * 3 + [ctypes.c_float, i32]
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, q.stride(0),
            q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1), s, heads, d,
            1.0 / math.sqrt(d), int(causal)]
    if hasattr(att, "small_mha_variant"):
        variant = att.small_mha_variant(q.dtype, s, d, [t.stride()[:2] for t in (q, k, v)],
                                        [t.data_ptr() for t in (q, k, v)])
        argtypes.append(i32)
        args.append(att._SMALL_MHA_VARIANTS.index(variant))
    # a handle of its own, without argtypes: the arguments go as the C
    # objects made here, the stream as a c_void_p made each call
    fn = _build.load()["lvg_small_mha_f32"]
    fn.restype = ctypes.c_int
    c_args = [ctype(a) for ctype, a in zip(argtypes, args)]
    # the raw handle of the current stream (the capture stream under a CUDA
    # graph), without building a torch Stream object each call
    raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    device = q.device.index

    def launch():
        stream = (raw_stream(device) if raw_stream is not None
                  else torch.cuda.current_stream().cuda_stream)
        rc = fn(*c_args, vp(stream))
        if rc:
            _build.check(rc, "small_mha (cuda_core)")

    launch.out = out   # the kernel writes it: it lives as long as the launcher
    return launch


def _event_ms(fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def run(seed: int = 0, n: int = 100) -> dict:
    """Every shape of ``SHAPES``: a dict a shape name (see the module
    docstring), in ms."""
    import torch.nn.functional as F

    from lipreading_video_generation_tpu_torch.bench.timing import graph_ms
    from lipreading_video_generation_tpu_torch.ops import attention as att

    if not torch.cuda.is_available():
        raise RuntimeError("small_mha_timing needs an NVIDIA GPU")
    out = {}
    with torch.inference_mode():
        for name, shape, heads, causal, layout in SHAPES:
            q, k, v = inputs(shape, layout, seed)
            b, s, e = shape
            d = e // heads
            if att.small_mha_route(q.dtype, s, d, [t.stride()[:2] for t in (q, k, v)],
                                   [t.data_ptr() for t in (q, k, v)]) != "cuda_core":
                raise AssertionError(f"K2 {name}: not on the cuda_core route")
            got = att.small_mha(q, k, v, heads, causal)
            want = att._mha_einsum(q, k, v, heads, causal)
            err = (got - want).abs().max().item()
            before = att.small_mha.route_counts["cuda_core"]
            wrapper = _event_ms(lambda: att.small_mha(q, k, v, heads, causal), n // 2)
            counted = att.small_mha.route_counts["cuda_core"] - before
            if counted != n // 2 + 1:
                raise AssertionError(f"K2 {name}: {counted} cuda_core launches, want {n // 2 + 1}")
            plain = _event_ms(lambda: att._mha_einsum(q, k, v, heads, causal), n // 2)
            launch = c_entry_launcher(att, q, k, v, heads, causal)
            c_entry = _event_ms(launch, n)
            graph = graph_ms(launch, GRAPH_LAUNCHES)
            if not torch.equal(launch.out, got):
                raise AssertionError(f"K2 {name}: the C entry point's output is not the wrapper's")
            q4, k4, v4 = (t.reshape(b, s, heads, d).transpose(1, 2) for t in (q, k, v))
            sdpa = graph_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal),
                            GRAPH_LAUNCHES)
            variant = (att.small_mha_variant(q.dtype, s, d, [t.stride()[:2] for t in (q, k, v)],
                                             [t.data_ptr() for t in (q, k, v)])
                       if hasattr(att, "small_mha_variant") else "one kernel")
            out[name] = dict(shape=list(shape), heads=heads, causal=causal, layout=layout,
                             variant=variant, wrapper_ms=wrapper, c_entry_ms=c_entry,
                             graph_ms=graph, sdpa_graph_ms=sdpa, plain_ms=plain,
                             max_abs_err=err, **work(shape, heads, causal))
            del q, k, v, q4, k4, v4, got, want, launch
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-root", default=str(Path(__file__).resolve().parents[2]),
                    help="directory holding the lipreading_video_generation_tpu_torch to time")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.package_root).resolve()))
    from lipreading_video_generation_tpu_torch.ops import attention as att

    res = run(args.seed)
    card = torch.cuda.get_device_name(0)
    for name, r in res.items():
        print(f"{name} {tuple(r['shape'])} H={r['heads']} causal={r['causal']} {r['variant']}: "
              f"small_mha {r['wrapper_ms']:.4f} ms, C entry point {r['c_entry_ms']:.4f} ms, "
              f"graph {r['graph_ms']:.4f} ms, SDPA graph {r['sdpa_graph_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, max|d| {r['max_abs_err']:.3g} on {card}")
    line = json.dumps({"package": str(Path(att.__file__).resolve().parents[1]), "card": card,
                       "shapes": res})
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
