"""How fast is K3's float32 CUDA-core kernel (``csrc/flash_fwd.cu``) at the
float32 U-Net's attention shapes, in each of its variants?

At each shape of ``flash_bwd_timing.SHAPES`` — (B, H, S, D) views of column
slices of one fused qkv tensor, as the U-Net passes them — it measures on
the card, after a warm-up:

- both variants ("tiled" and "general") through the C entry points,
  replayed from a CUDA graph of ``GRAPH_LAUNCHES`` launches (device time
  only; outputs allocated once), the combine kernel's launch inside the
  graph where the "tiled" kernel splits the key axis;
- the "tiled" kernel at other numbers of key splits (``SPLITS``, up to the
  key tiles) the same way, so that ``flash_fwd_splits``' choice is held
  against ``n_split = 1`` on the same inputs;
- the variant the port picks also through ``flash_attention``, its host
  work included (CUDA events around a loop; the launches are counted by
  variant, and the combine's launches);
- the plain version (``flash_reference``) in a loop;
- SDPA float32's forward from a CUDA graph of ``GRAPH_LAUNCHES`` calls and,
  at the first shape, the names of the kernels it runs (``torch.profiler``,
  in a process of its own: ``--sdpa-kernels``);

with the largest difference of each variant's O and lse from the plain
version's, the bits of two launches and of the C entry point against the
wrapper's, where the key axis is split the partials against
``flash_partials_reference`` and the combine kernel's output against
``flash_combine_reference`` on the kernel's own partials, and the bytes
(q, k, v read once, O and lse written once) and operations of a call.
``chip_smoke.py [timing]`` calls ``run`` and turns those into bounds.

Run on a machine with an NVIDIA GPU:

    python -m lipreading_video_generation_tpu_torch.bench.flash_fwd_timing
    python -m lipreading_video_generation_tpu_torch.bench.flash_fwd_timing \\
        --sdpa-kernels 2,1,4096,64

Prints one line per shape and a last line of JSON (with ``--sdpa-kernels``,
only the kernels SDPA's forward runs at that shape).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import sys
from pathlib import Path

import torch

from .flash_bwd_timing import (GRAPH_LAUNCHES, SHAPES, VARIANTS, _event_ms, inputs,
                               profiled_kernels, sdpa_kernels_in_own_process)

SPLITS = (1, 2, 4, 8, 16)


def work(shape) -> dict:
    """Bytes (q, k, v read and O written, float32, and the lse) and
    operations (2 a multiply-add: S = Q·Kᵀ and P·V, S x S x D each) of one
    non-causal call."""
    b, h, s, d = shape
    return {"bytes": 4 * b * h * s * d * 4 + b * h * s * 4, "ops": 4.0 * b * h * s * s * d}


def c_entry_launcher(att, q, k, v, causal: bool = False, variant: str = "tiled",
                     n_split: int = 1, lib=None):
    """A function that launches the CUDA-core K3 on float32 inputs through
    its C entry point with ``variant`` and ``n_split`` (and, where that is
    above 1, the combine kernel through its own), into outputs allocated
    here, once (``launch.out``, ``launch.lse``; the partials
    ``launch.parts`` = (m, l, acc)): what ``_flash_launch`` does without its
    host work and its counts. Raises (``_build.check``) where an entry point
    refuses. ``lib``: another build's library (``flash_fwd_phases``);
    default the port's."""
    from lipreading_video_generation_tpu_torch.ops import _build

    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    out = torch.empty(b, s_q, h, d, device=q.device).transpose(1, 2)
    lse = torch.empty(b, h, s_q, device=q.device)
    parts = None
    if n_split > 1:
        parts = (torch.empty(n_split, b, h, s_q, device=q.device),
                 torch.empty(n_split, b, h, s_q, device=q.device),
                 torch.empty(n_split, b, h, s_q, d, device=q.device))
    tensors = (q, k, v, out)
    strides = (ctypes.c_longlong * 12)(*(st for t in tensors for st in t.stride()[:3]))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    # the arguments as C objects made once; the stream as a c_void_p made
    # each call (a handle of its own, without argtypes)
    c_args = [*(vp(t.data_ptr()) for t in tensors + (lse,)),
              *(i32(x) for x in (b, h, s_q, s_k, d)), strides,
              ctypes.c_float(1.0 / math.sqrt(d)), i32(int(causal)),
              i32(att._FLASH_FWD_VARIANTS.index(variant)), i32(n_split),
              *(vp(None if parts is None else parts[j].data_ptr()) for j in (2, 0, 1))]
    lib = lib or _build.load()
    fn, combine = lib["lvg_flash_fwd_f32"], lib["lvg_flash_fwd_combine"]
    fn.restype = combine.restype = ctypes.c_int
    if parts is not None:
        comb_args = [*(vp(t.data_ptr()) for t in (parts[2], parts[0], parts[1], out, lse)),
                     *(i32(x) for x in (b, h, s_q, d, n_split)),
                     (ctypes.c_longlong * 3)(*out.stride()[:3])]
    raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    device = q.device.index

    def stream():
        return vp(raw_stream(device) if raw_stream is not None
                  else torch.cuda.current_stream().cuda_stream)

    def launch_combine():
        rc = combine(*comb_args, stream())
        if rc:
            _build.check(rc, "flash_fwd_combine")

    def launch():
        rc = fn(*c_args, stream())
        if rc:
            _build.check(rc, f"flash_attention (cuda_core, {variant}, {n_split} splits)")
        if parts is not None:
            launch_combine()

    launch.out, launch.lse, launch.parts = out, lse, parts   # they live as long as the launcher
    launch.combine = launch_combine if parts is not None else None
    return launch


def combine_work(shape, n_split: int) -> dict:
    """Bytes (the partials read, O and lse written, float32) and operations
    (2 a multiply-add of acc and l) of one combine of ``n_split`` splits."""
    b, h, s, d = shape
    rows = b * h * s
    return {"bytes": 4 * rows * (n_split * (d + 2) + d + 1), "ops": 2.0 * n_split * rows * (d + 1)}


def _err(got, want) -> float:
    """max |got − want| over max(1, max |want|)."""
    return ((got - want).abs().max() / max(1.0, want.abs().max().item())).item()


def _partials_err(att, q, k, v, launch, n_split: int) -> dict:
    """The kernel's partials against ``flash_partials_reference`` (m, l and
    acc each by ``_err``; m where it is finite on both sides, which it is
    exactly where the plain version's is), and the combine kernel's output
    on them against ``flash_combine_reference`` on the same partials."""
    m, l, acc = launch.parts
    want_m, want_l, want_acc = att.flash_partials_reference(q, k, v, n_split=n_split)
    finite = torch.isfinite(want_m)
    if not torch.equal(finite, torch.isfinite(m)):
        raise AssertionError("the tiled kernel's -inf partials are not the plain version's")
    o_ref, lse_ref = att.flash_combine_reference(m, l, acc)
    return {"m": _err(m[finite], want_m[finite]), "l": _err(l, want_l),
            "acc": _err(acc, want_acc), "combine_o": _err(launch.out, o_ref),
            "combine_lse": _err(launch.lse, lse_ref)}


def run(seed: int = 0, shapes=SHAPES) -> dict:
    """Every shape of ``shapes``: a dict a shape name (see the module
    docstring), times in ms."""
    import torch.nn.functional as F

    from lipreading_video_generation_tpu_torch.bench.timing import graph_ms
    from lipreading_video_generation_tpu_torch.ops import attention as att

    if not torch.cuda.is_available():
        raise RuntimeError("flash_fwd_timing needs an NVIDIA GPU")
    out = {}
    for i, (name, shape) in enumerate(shapes):
        q, k, v = inputs(shape, seed + i)[:3]
        b, h, s, d = shape
        with torch.no_grad():
            want_o, want_lse = att.flash_reference(q, k, v)
            plain_ms = _event_ms(lambda: att.flash_reference(q, k, v), 5 if s <= 4096 else 2)
            tensors = (q, k, v, torch.empty(b, s, h, d, device=q.device).transpose(1, 2))
            picked = att.flash_fwd_variant(q.dtype, d, [t.stride()[:3] for t in tensors],
                                           [t.data_ptr() for t in tensors])
            n_split = att.flash_fwd_splits(b * h, s, s, d)
            got_o, got_lse = att.flash_attention(q, k, v, return_lse=True)
            before = dict(att.flash_attention.variant_counts), att.flash_fwd_combine.launch_count
            n_wrap = 20 if s <= 4096 else 5
            wrapper_ms = _event_ms(lambda: att.flash_attention(q, k, v), n_wrap)
            took = {vv: n - before[0][vv] for vv, n in att.flash_attention.variant_counts.items()
                    if n != before[0][vv]}
            row = dict(shape=list(shape), picked=picked, n_split=n_split, wrapper_ms=wrapper_ms,
                       wrapper_launches=took,
                       wrapper_combines=att.flash_fwd_combine.launch_count - before[1],
                       plain_ms=plain_ms, **work(shape))
            for variant in VARIANTS:
                splits = n_split if variant == "tiled" else 1
                launch = c_entry_launcher(att, q, k, v, variant=variant, n_split=splits)
                launch()
                torch.cuda.synchronize()
                o1, lse1 = launch.out.clone(), launch.lse.clone()
                ms = graph_ms(launch, GRAPH_LAUNCHES)
                rec = dict(graph_ms=ms, n_split=splits, o_err=_err(launch.out, want_o),
                           lse_err=_err(launch.lse, want_lse),
                           equal_bits=torch.equal(o1, launch.out) and torch.equal(lse1, launch.lse))
                if variant == picked and not (torch.equal(o1, got_o) and torch.equal(lse1, got_lse)):
                    raise AssertionError(f"{name}: the C entry point's {variant} output is not "
                                         "the wrapper's")
                if splits > 1:
                    rec["partials_err"] = _partials_err(att, q, k, v, launch, splits)
                    # the combine kernel alone, and its plain version, on these partials
                    rec["combine_ms"] = graph_ms(launch.combine, GRAPH_LAUNCHES)
                    rec["combine_plain_ms"] = _event_ms(
                        lambda: att.flash_combine_reference(*launch.parts), 5)
                    rec["combine_work"] = combine_work(shape, splits)
                row[variant] = rec
                del launch
            # where the rule splits, the other numbers of splits up to the key tiles
            tiles = -(-s // att._flash_fwd_tiled_tiles(d)[1])
            others = {n for n in SPLITS if n <= tiles} if n_split > 1 else set()
            row["tiled_splits_ms"] = {
                n: (row["tiled"]["graph_ms"] if n == n_split else graph_ms(
                    c_entry_launcher(att, q, k, v, n_split=n), GRAPH_LAUNCHES))
                for n in sorted({n_split} | others)}
            row["sdpa_fwd_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                                          GRAPH_LAUNCHES)
        if i == 0:
            row["sdpa_fwd_kernels"] = sdpa_kernels_in_own_process(
                shape, "lipreading_video_generation_tpu_torch.bench.flash_fwd_timing")
        out[name] = row
        del q, k, v, want_o, want_lse, got_o, got_lse
        torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sdpa-kernels", metavar="B,H,S,D",
                    help="only list the kernels SDPA float32's forward runs at this shape "
                         "(one line of JSON: name, device ms, launches)")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch.nn.functional as F

    from lipreading_video_generation_tpu_torch.ops import attention as att

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.sdpa_kernels:
        q, k, v = inputs(tuple(int(x) for x in args.sdpa_kernels.split(",")), 0)[:3]
        with torch.no_grad():
            kernels = profiled_kernels(lambda: F.scaled_dot_product_attention(q, k, v))
        print(json.dumps([[n_, round(ms, 4), c] for n_, ms, c in kernels]))
        return
    res = run()
    card = torch.cuda.get_device_name(0)
    for name, r in res.items():
        print(f"{name} {tuple(r['shape'])}: "
              + ", ".join(f"{v} graph {r[v]['graph_ms']:.4f} ms ({r[v]['n_split']} splits; O err "
                          f"{r[v]['o_err']:.3g})" for v in VARIANTS)
              + f"; tiled by splits {r['tiled_splits_ms']}; wrapper ({r['picked']}) "
              f"{r['wrapper_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms; SDPA forward "
              f"{r['sdpa_fwd_ms']:.4f} ms on {card}")
        if "sdpa_fwd_kernels" in r:
            print(f"{name}: SDPA float32's forward runs {r['sdpa_fwd_kernels']}")
    print(json.dumps({"package": str(Path(att.__file__).resolve().parents[1]), "card": card,
                      "shapes": res}))


if __name__ == "__main__":
    main()
