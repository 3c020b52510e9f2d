"""How fast are K4 and K5's float32 CUDA-core kernels (``csrc/flash_bwd.cu``)
at the float32 U-Net's attention shapes, in each of their variants?

At each shape of ``SHAPES`` — (B, H, S, D) views of column slices of one
fused qkv tensor, as the U-Net passes them, with the lse of K3's forward —
it measures on the card, after a warm-up:

- both variants ("tiled" and "general") of K4 (dK, dV) and K5 (dQ) through
  their C entry points, replayed from a CUDA graph of ``GRAPH_LAUNCHES``
  launches (device time only; outputs allocated once);
- the variant the port picks also through ``flash_bwd_dkv`` /
  ``flash_bwd_dq``, its host work included (CUDA events around a loop; the
  launches are counted by variant);
- the plain version (``flash_backward_reference``, the part that gives
  each kernel's outputs) in a loop;
- SDPA float32's backward (dQ, dK and dV in one ``torch.autograd.grad``),
  from a CUDA graph of ``GRAPH_LAUNCHES`` calls where its capture works,
  else from CUDA events around a loop, and, at the first shape, the names
  of the kernels it runs (``torch.profiler``, in a process of its own:
  ``--sdpa-kernels``, so that no earlier work of the caller's process
  stands in the profiler's way);

with the largest difference of each variant from the plain version (over
the largest |gradient|), the bits of the C entry point against the
wrapper's, and the bytes (each input read once, each output written once)
and operations of a call. ``chip_smoke.py [timing]`` calls ``run`` and
turns those into bounds.

Run on a machine with an NVIDIA GPU:

    python lipreading_video_generation_tpu_torch/bench/flash_bwd_timing.py
    python -m lipreading_video_generation_tpu_torch.bench.flash_bwd_timing \\
        --sdpa-kernels 2,1,4096,64

Prints one line per shape and kernel and a last line of JSON (with
``--sdpa-kernels``, only the kernels SDPA's backward runs at that shape).
The "general" variant is the kernels the "tiled" one was measured against,
so both are timed in one process on the same inputs.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# (name, (B, H, S, D)): the float32 U-Net's three attention shapes at 64x64
# (batch 2), then its heaviest at the 128x128 defaults
SHAPES = (("s4096_d64", (2, 1, 4096, 64)), ("s1024_d128", (2, 1, 1024, 128)),
          ("s256_d256", (2, 1, 256, 256)), ("s16384_d64", (2, 1, 16384, 64)))
GRAPH_LAUNCHES = 20
VARIANTS = ("tiled", "general")


def inputs(shape, seed: int):
    """q, k, v: (B, H, S, D) views of column slices of one (B, S, 3 D)
    float32 tensor, dO likewise of a (B, S, D) one, uniform from ``seed``;
    lse from K3 (the port's flash forward) and delta = Σ dO·O."""
    from lipreading_video_generation_tpu_torch.ops import attention as att

    b, h, s, d = shape
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.uniform(-2, 2, (b, s, 3 * h * d)).astype(np.float32)).cuda()
    do = torch.from_numpy(rng.uniform(-1, 1, (b, s, h * d)).astype(np.float32)).cuda()
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    do = do.reshape(b, s, h, d).transpose(1, 2)
    with torch.no_grad():
        o, lse = att.flash_attention(q, k, v, return_lse=True)
        delta = (do * o).sum(-1)
    return q, k, v, do, lse, delta


def work(kernel: str, shape) -> dict:
    """Bytes (q, k, v, dO read and the gradients written, float32, plus lse
    and delta) and operations (2 a multiply-add: K4 four products of
    S x S x D, K5 three) of one non-causal call."""
    b, h, s, d = shape
    tensor, rows = b * h * s * d * 4, b * h * s * 4
    n_tensors, products = (6, 4) if kernel == "dkv" else (5, 3)
    return {"bytes": n_tensors * tensor + 2 * rows, "ops": 2.0 * products * b * h * s * s * d}


def c_entry_launcher(att, kernel: str, q, k, v, do, lse, delta, causal: bool = False,
                     variant: str = "tiled", lib=None):
    """A function that launches the CUDA-core K4 (``kernel`` "dkv") or K5
    ("dq") on float32 inputs through its C entry point with ``variant``,
    into outputs allocated here, once (``launch.outs``): what
    ``_flash_bwd_launch`` does without its host work and its count. Raises
    (``_build.check``) where the entry point refuses the variant. ``lib``:
    another build's library (``flash_bwd_phases``); default the port's."""
    from lipreading_video_generation_tpu_torch.ops import _build

    b, h, s_q, d = q.shape
    s_k = k.shape[2]

    def grad_like(x):
        return torch.empty(x.shape[0], x.shape[2], x.shape[1], x.shape[3], dtype=x.dtype,
                           device=x.device).transpose(1, 2)

    outs = (grad_like(k), grad_like(v)) if kernel == "dkv" else (grad_like(q),)
    tensors = (q, k, v, do) + outs
    strides = (ctypes.c_longlong * (3 * len(tensors)))(
        *(st for t in tensors for st in t.stride()[:3]))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    # the arguments as C objects made once; the stream as a c_void_p made
    # each call (a handle of its own, without argtypes)
    c_args = [*(vp(t.data_ptr()) for t in (q, k, v, do, lse, delta) + outs),
              *(i32(x) for x in (b, h, s_q, s_k, d)), strides,
              ctypes.c_float(1.0 / math.sqrt(d)), i32(int(causal)),
              i32(att._FLASH_BWD_VARIANTS.index(variant))]
    fn = (lib or _build.load())[f"lvg_flash_bwd_{kernel}_f32"]
    fn.restype = ctypes.c_int
    raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    device = q.device.index

    def launch():
        stream = (raw_stream(device) if raw_stream is not None
                  else torch.cuda.current_stream().cuda_stream)
        rc = fn(*c_args, vp(stream))
        if rc:
            _build.check(rc, f"flash backward ({kernel}, cuda_core, {variant})")

    launch.outs = outs   # the kernel writes them: they live as long as the launcher
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


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def sdpa_backward_ms(q, k, v, do, n: int = GRAPH_LAUNCHES):
    """SDPA float32's backward (dQ, dK, dV) on the same inputs: (ms, how).
    The forward runs on a side stream, so that its backward nodes run on the
    stream a CUDA graph then captures (as ``make_graphed_callables`` does);
    where the capture fails, CUDA events around a loop on the default
    stream."""
    import torch.nn.functional as F

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves)
        for _ in range(2):
            torch.autograd.grad(out, leaves, do, retain_graph=True)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(n):
                torch.autograd.grad(out, leaves, do, retain_graph=True)
        graph.replay()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            graph.replay()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / (5 * n), "graph"
    except RuntimeError as err:      # the capture is timed another way, and says so
        torch.cuda.synchronize()
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves)
        ms = _event_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), n)
        return ms, f"events ({type(err).__name__}: {str(err)[:80]})"


def profiled_kernels(fn) -> list:
    """(name, device ms, launches) of the kernels one call of ``fn`` runs
    (after a call to warm up), from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    host = {e.key for e in events if e.device_type == DeviceType.CPU}
    return sorted(((e.key, e.device_time_total / 1e3, e.count) for e in events
                   if e.device_type == DeviceType.CUDA and e.key not in host),
                  key=lambda r: -r[1])


def sdpa_backward_kernels(q, k, v, do) -> list:
    """The kernels SDPA float32's backward runs (``profiled_kernels``)."""
    import torch.nn.functional as F

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves)
    return profiled_kernels(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))


def sdpa_kernels_in_own_process(
        shape, module: str = "lipreading_video_generation_tpu_torch.bench.flash_bwd_timing"
) -> list:
    """What ``python -m module --sdpa-kernels`` lists at ``shape`` (by
    default this module's: ``sdpa_backward_kernels``), in a fresh Python
    process."""
    root = Path(__file__).resolve().parents[2]
    out = subprocess.run(
        [sys.executable, "-m", module, "--sdpa-kernels", ",".join(map(str, shape))],
        cwd=root, capture_output=True, text=True, timeout=300, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def run(seed: int = 0, shapes=SHAPES) -> dict:
    """Every shape of ``shapes``: a dict a shape name (see the module
    docstring), times in ms."""
    from lipreading_video_generation_tpu_torch.bench.timing import graph_ms
    from lipreading_video_generation_tpu_torch.ops import attention as att

    if not torch.cuda.is_available():
        raise RuntimeError("flash_bwd_timing needs an NVIDIA GPU")
    out = {}
    for i, (name, shape) in enumerate(shapes):
        q, k, v, do, lse, delta = inputs(shape, seed + i)
        b, h, s, d = shape
        row = {"shape": list(shape)}
        with torch.no_grad():
            for kernel, wrapper in (("dkv", att.flash_bwd_dkv), ("dq", att.flash_bwd_dq)):
                args = (q, k, v, do, lse, delta)
                plain_fn = (lambda: att.flash_backward_reference(*args, dq=False)) \
                    if kernel == "dkv" else \
                    (lambda: att.flash_backward_reference(*args, dkv=False))
                want = [g for g in plain_fn() if g is not None]
                got = wrapper(*args)
                got = list(got) if kernel == "dkv" else [got]
                picked = att.flash_bwd_variant(q.dtype, d, [t.stride()[:3] for t in (q, k, v, do)],
                                               [t.data_ptr() for t in (q, k, v, do)])
                counts = wrapper.variant_counts
                before = dict(counts)
                n_wrap = 20 if s <= 4096 else 5
                wrapper_ms = _event_ms(lambda: wrapper(*args), n_wrap)
                took = {vv: n - before[vv] for vv, n in counts.items() if n != before[vv]}
                plain_ms = _event_ms(plain_fn, 5 if s <= 4096 else 2)
                kern = dict(picked=picked, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                            wrapper_launches=took, wrapper_err=max(
                                _rel(g, w) for g, w in zip(got, want)),
                            **work(kernel, shape))
                for variant in VARIANTS:
                    launch = c_entry_launcher(att, kernel, q, k, v, do, lse, delta,
                                              variant=variant)
                    launch()
                    torch.cuda.synchronize()
                    err = max(_rel(g, w) for g, w in zip(launch.outs, want))
                    again = [o.clone() for o in launch.outs]
                    ms = graph_ms(launch, GRAPH_LAUNCHES)
                    equal = all(torch.equal(a, o) for a, o in zip(again, launch.outs))
                    if variant == picked and not all(torch.equal(a, g)
                                                     for a, g in zip(again, got)):
                        raise AssertionError(f"{name} {kernel}: the C entry point's {variant} "
                                             "output is not the wrapper's")
                    kern[variant] = dict(graph_ms=ms, max_rel_err=err, equal_bits=equal)
                    del launch, again
                row[kernel] = kern
                del want, got
        row["sdpa_bwd_ms"], row["sdpa_timed"] = sdpa_backward_ms(q, k, v, do)
        if i == 0:
            row["sdpa_bwd_kernels"] = sdpa_kernels_in_own_process(shape)
        out[name] = row
        del q, k, v, do, lse, delta
        torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sdpa-kernels", metavar="B,H,S,D",
                    help="only list the kernels SDPA float32's backward runs at this shape "
                         "(one line of JSON: name, device ms, launches)")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from lipreading_video_generation_tpu_torch.ops import attention as att

    if args.sdpa_kernels:
        q, k, v, do, _, _ = inputs(tuple(int(x) for x in args.sdpa_kernels.split(",")), 0)
        print(json.dumps([[n_, round(ms, 4), c] for n_, ms, c in
                          sdpa_backward_kernels(q, k, v, do)]))
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    res = run()
    card = torch.cuda.get_device_name(0)
    for name, r in res.items():
        for kernel in ("dkv", "dq"):
            kr = r[kernel]
            print(f"{name} {tuple(r['shape'])} {kernel}: "
                  + ", ".join(f"{v} graph {kr[v]['graph_ms']:.4f} ms (err {kr[v]['max_rel_err']:.3g})"
                              for v in VARIANTS if v in kr)
                  + f"; wrapper ({kr['picked']}) {kr['wrapper_ms']:.4f} ms; plain "
                  f"{kr['plain_ms']:.4f} ms; SDPA backward {r['sdpa_bwd_ms']:.4f} ms "
                  f"({r['sdpa_timed']}) on {card}")
        if "sdpa_bwd_kernels" in r:
            print(f"{name}: SDPA float32's backward runs {r['sdpa_bwd_kernels']}")
    print(json.dumps({"package": str(Path(att.__file__).resolve().parents[1]), "card": card,
                      "shapes": res}))


if __name__ == "__main__":
    main()
