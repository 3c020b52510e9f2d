"""FLOP accounting and MFU of the port.

Port of ``lipreading_video_generation_tpu/utils/flops.py``: a count of the
FLOPs one call does, split into ``model`` (the algorithm's products: the
numerator of MFU) and ``hw`` (what the hardware multiplies, padding and
recompute included: the numerator of HFU), and ``mfu_report``, which turns a
count and a time into a share of the card's peak.

What is counted, and how it differs from the JAX package:

- Torch ops are counted by ``torch.utils.flop_counter``'s formulas
  (``FlopCounterMode``): matrix products, convolutions and their backward,
  SDPA. Elementwise ops, reductions, softmax and the optimizer's update count
  nothing; XLA's cost model counts them, so the JAX package's total is
  higher by their share (0.944-0.987 of it at the ViViT's shapes, 2 and 12
  layers).
- The hand-written kernels K1-K6 are ``ctypes`` calls the dispatch mode
  cannot see. Each wrapper reports its launch through ``record`` (one check
  of ``running`` when no count runs: no launch, sync or allocation), with
  ``model`` by the JAX package's rules and ``hw`` from the kernel's own
  tiles (the formulas beside each hook). On the CPU a wrapper's plain
  version runs under ``plain_version``, which reports the kernel's work and
  hides the plain version's own products from the count, so that they are
  not counted twice.
- K1 (CLAHE) counts 0: it does integer histograms and a lookup, in the
  kernel and in its plain version alike. The JAX kernel declares its one-hot
  matmuls as FLOPs (``pl.CostEstimate``), about 159 MFLOP a 48x48 image.
- K2's backward recomputes its forward through ``_mha_einsum``; those
  products count in ``hw`` only (``recompute``).

Three pieces of the JAX module are not ported: ``_hlo_flops_of_lowered``
and ``_scan_extra_hlo_flops`` read XLA's cost model and patch its scan
trip counts (torch runs every trip of a loop, so trip counts come out right
without a correction); the jaxpr walk (``_walk_jaxpr_pallas``) is replaced by
the wrappers' hooks; and its max over ``cond`` branches is not needed,
because only the branch that runs is counted. Every count runs ``fn``
eagerly, once; nothing counts inside a CUDA graph.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["FlopCount", "attention_flops", "compiled_flops", "conv2d_flops",
           "device_peak_tflops", "flops_detail", "kernel_flops", "matmul_flops", "mfu_report",
           "plain_version", "recompute", "record", "running"]

# bf16 dense peak TFLOP/s of one card by a part of its name
# (torch.cuda.get_device_name; NVIDIA's H100 datasheet, without sparsity).
# LVG_PEAK_TFLOPS overrides it, as in the JAX package.
_PEAK_TFLOPS_BF16 = (
    ("H100 PCIe", 756.0),
    ("H100 80GB HBM3", 989.4),
    ("H100 SXM", 989.4),
)


def _device_name(device) -> Optional[str]:
    """The CUDA card's name, or None for the CPU (or no card)."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(device)


def device_peak_tflops(device: Union[torch.device, str, int, None] = None) -> Optional[float]:
    """Peak bf16 TFLOP/s of one card (``device``, default the current CUDA
    device), or None on the CPU or a card not listed."""
    env = os.environ.get("LVG_PEAK_TFLOPS")
    if env:
        return float(env)
    name = _device_name(device)
    if name is None:
        return None
    for key, peak in _PEAK_TFLOPS_BF16:
        if key in name:
            return peak
    return None


# the counts running, innermost last: what the kernel wrappers check
running: list = []


class FlopCount:
    """A count of the FLOPs run inside ``with FlopCount() as c:``.

    ``c.model`` and ``c.hw`` are the totals; ``c.kernels`` maps each
    hand-written kernel's wrapper name (``small_mha``, ``flash_attention``,
    ...) to its ``{"launches", "model", "hw"}`` (on the CPU, the calls of its
    plain version in its place)."""

    def __init__(self):
        self.kernels: Dict[str, Dict[str, int]] = {}
        self._counter = FlopCounterMode(display=False)
        self._hidden = 0          # products of plain versions, not counted
        self._recomputed = 0      # products of a recompute, counted in hw only

    def __enter__(self) -> "FlopCount":
        _no_capture()
        self._counter.__enter__()
        running.append(self)
        return self

    def __exit__(self, *exc) -> None:
        running.remove(self)
        self._counter.__exit__(*exc)

    @property
    def products(self) -> int:
        return self._counter.get_total_flops()

    @property
    def model(self) -> int:
        return (self.products - self._hidden - self._recomputed
                + sum(k["model"] for k in self.kernels.values()))

    @property
    def hw(self) -> int:
        return self.products - self._hidden + sum(k["hw"] for k in self.kernels.values())

    def detail(self) -> Dict[str, Any]:
        return {"model": self.model, "hw": self.hw,
                "kernels": {name: dict(k) for name, k in self.kernels.items()}}


def _no_capture() -> None:
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("flops: a count cannot see the replays of a CUDA graph; count the "
                           "calls eagerly")


def record(name: str, model: int, hw: int) -> None:
    """One launch of the hand-written kernel ``name`` doing ``model`` and
    ``hw`` FLOPs, into every running count. Wrappers call it only when
    ``running`` is not empty."""
    _no_capture()
    for count in running:
        k = count.kernels.setdefault(name, {"launches": 0, "model": 0, "hw": 0})
        k["launches"] += 1
        k["model"] += int(model)
        k["hw"] += int(hw)


@contextlib.contextmanager
def _hidden_region(kernels: Callable[[], Dict[str, Tuple[int, int]]], attr: str):
    inner = FlopCounterMode(display=False)
    with inner:
        yield
    for count in running:
        setattr(count, attr, getattr(count, attr) + inner.get_total_flops())
    for name, (model, hw) in kernels().items():
        record(name, model, hw)


_IDLE = contextlib.nullcontext()


def plain_version(kernels: Callable[[], Dict[str, Tuple[int, int]]]):
    """Context for a kernel's plain version run in its place (on the CPU):
    while a count runs, the products inside are not counted, and
    ``kernels()`` ({wrapper name: (model, hw)}) is recorded instead, one
    launch each. Nothing happens when no count runs."""
    if not running:
        return _IDLE
    return _hidden_region(kernels, "_hidden")


def recompute():
    """Context for a forward recomputed in a backward: its products count in
    ``hw`` and not in ``model``."""
    if not running:
        return _IDLE
    return _hidden_region(dict, "_recomputed")


def flops_detail(fn, *args, **kwargs) -> Dict[str, Any]:
    """{model, hw, kernels} of one call ``fn(*args, **kwargs)``, which this
    runs (eagerly, once): forward, backward and optimizer work, whatever
    ``fn`` does. ``model`` is the MFU numerator: the products of torch ops
    plus the algorithmic products inside the hand-written kernels; ``hw`` is
    the HFU numerator: the kernels' padded tiles and the backward's
    recomputes added; ``kernels`` is ``FlopCount.kernels``."""
    with FlopCount() as count:
        fn(*args, **kwargs)
    return count.detail()


def compiled_flops(fn, *args, **kwargs) -> int:
    """The ``model`` FLOPs of one call of ``fn`` (``flops_detail``, which
    runs ``fn`` once; the JAX package's name, where it lowered a jitted
    function instead)."""
    return flops_detail(fn, *args, **kwargs)["model"]


def kernel_flops(fn, *args, **kwargs) -> Tuple[int, int]:
    """(model, hw) FLOPs inside the hand-written kernels (or their plain
    versions on the CPU) of one call of ``fn``, which this runs: the
    counterpart of the JAX package's ``pallas_flops``."""
    kernels = flops_detail(fn, *args, **kwargs)["kernels"].values()
    return sum(k["model"] for k in kernels), sum(k["hw"] for k in kernels)


def mfu_report(
    flops_per_step: Optional[Any],
    sec_per_step: float,
    n_chips: int = 1,
) -> Dict[str, Any]:
    """{model_tflops, achieved_tflops_per_sec, mfu[, hw_tflops, hfu]} for a
    bench record. MFU = model flops / time / (n_chips · peak); HFU uses the
    hardware count (kernel padding + backward recompute included) when
    ``flops_per_step`` is a ``flops_detail`` dict. Entries None when
    unknown."""
    hw = None
    if isinstance(flops_per_step, dict):
        hw = flops_per_step.get("hw")
        flops_per_step = flops_per_step.get("model")
    if not flops_per_step or sec_per_step <= 0:
        return {"model_tflops": None, "achieved_tflops_per_sec": None, "mfu": None}
    achieved = flops_per_step / sec_per_step / 1e12
    peak = device_peak_tflops()
    out = {
        "model_tflops": round(flops_per_step / 1e12, 4),
        "achieved_tflops_per_sec": round(achieved, 2),
        "mfu": round(achieved / (peak * n_chips), 4) if peak else None,
    }
    if hw and hw > flops_per_step * 1.01:
        out["hw_tflops"] = round(hw / 1e12, 4)
        if peak:
            out["hfu"] = round(hw / sec_per_step / 1e12 / (peak * n_chips), 4)
    return out


# ---------------------------------------------------------------------------
# analytic counts (hand counts of the dominant terms)
# ---------------------------------------------------------------------------

def conv2d_flops(batch: int, out_h: int, out_w: int, cin: int, cout: int,
                 kh: int, kw: int) -> float:
    """2·MACs of a 2-D convolution."""
    return 2.0 * batch * out_h * out_w * cout * kh * kw * cin


def matmul_flops(m: int, n: int, k: int) -> float:
    return 2.0 * m * n * k


def attention_flops(batch: int, seq: int, dim: int) -> float:
    """QK^T + AV for one self-attention (softmax/elementwise ignored)."""
    return 2.0 * (2.0 * batch * seq * seq * dim)
