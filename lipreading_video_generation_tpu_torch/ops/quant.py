"""Int8 post-training quantisation for serving (dynamic and static modes).

Port of ``lipreading_video_generation_tpu/ops/quant.py``. The arithmetic is
the JAX package's:

- **Weights**: symmetric int8 per output channel, no zero point,
  ``scale = max(|w|, 1e-8) / 127``, ``w_q = clip(round(w / scale), ±127)``.
- **Activations**: symmetric int8 per tensor, with the scale from the
  tensor's own ``max|x|`` (**dynamic**) or fixed beforehand by
  ``calibrate_activation_scales`` (**static**). 0 maps to 0, so a
  convolution's zero padding stays exact in the integer domain.
- **Accumulation** in int32, dequantised by ``x_scale * w_scale``; the bias
  is added afterwards in float32; the result is cast to the module's compute
  dtype. ``round`` is half to even and ``x / scale`` a true float32 division
  on both sides, so the same float inputs give the same integers as JAX.

Every integer product goes through ``ops/matmul_cuda.int8_matmul`` (the
kernel K6 on a CUDA tensor, its plain version on the CPU): ``int8_dense``
directly, ``int8_conv`` as im2col — the quantised NHWC activation is copied
into an (B·OH·OW, kh·kw·C) int8 matrix whose depth is padded with zeros to a
multiple of 16, so that the wgmma kernel's tensor maps read both operands as
they lie (route "sm90"), as they read a served ``Linear``'s (N, K) weight.
``int8_dense`` quantises a (in, out) kernel, a row-major B: its products take
route "packed" (the weight copied to K-major rows by ``pack_k_major``, then
the same wgmma kernel).
PyTorch has neither an int8 convolution nor an integer ``matmul`` on a CUDA
device, so there is no other path, and none is taken on a failure.

Where the JAX package intercepts Flax's ``nn.Conv`` / ``nn.Dense`` calls,
the port's own layers (``models/layers.Linear`` and ``Conv2d``, which every
conv and Linear of the port is) ask ``active()`` in their ``forward``. The
rules are JAX's: only ``Linear`` and 2-D, ungrouped, undilated, zero-padded
convs are rerouted; ``Conv1d`` and anything else runs in float. Static
scales are keyed by the module's ``named_modules()`` path in the model the
context was opened for. While a context is open each module's quantised
weight is computed once and kept.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.profiler import record_function

from .matmul_cuda import int8_matmul

__all__ = ["quantize_channelwise", "int8_conv", "int8_dense", "int8_serving",
           "quantized_apply", "calibrate_activation_scales", "active"]

# depth of the im2col matrix and of the quantised weights, padded with zeros
# to this many int8 values: rows on 16-byte boundaries, which the wgmma
# kernel's tensor maps read without a pack
_K_ALIGN = 16

Padding = Union[str, Sequence[Tuple[int, int]]]


def quantize_channelwise(w: torch.Tensor, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8: (w_q int8, scale float32), where ``scale``
    keeps ``axis`` and reduces every other dim (kept as size 1).
    w ≈ w_q * scale."""
    wf = w.to(torch.float32)
    reduce_axes = [i for i in range(w.ndim) if i != axis % w.ndim]
    amax = torch.amax(wf.abs(), dim=reduce_axes, keepdim=True) if reduce_axes else wf.abs()
    scale = torch.clamp(amax, min=1e-8) / _const(127.0, w.device)
    w_q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return w_q, scale


def _const(value: float, device) -> torch.Tensor:
    """A float32 scalar on ``device``: dividing by it is a true division (a
    CUDA tensor divided by a Python number is multiplied by the reciprocal,
    one rounding more than JAX makes)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _quantized_values(x: torch.Tensor, act_scale,
                      reduce: Optional[Callable] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(clip(round(x / s), ±127) as float32, s): ``s`` from ``max|x|`` when
    ``act_scale`` is None (on the device, no host read; ``reduce`` takes
    that max to the global batch's in a data-parallel request, as JAX's
    SPMD max is), else ``act_scale``."""
    xf = x.to(torch.float32)
    if act_scale is None:
        lo, hi = torch.aminmax(xf)
        m = torch.maximum(-lo, hi)
        if reduce is not None:
            m = reduce(m)
        s = torch.clamp(m, min=1e-8) / _const(127.0, x.device)
    else:
        s = torch.as_tensor(act_scale, dtype=torch.float32).to(x.device)
    return torch.div(xf, s).round_().clamp_(-127, 127), s


def _dynamic_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 with a run-time max-abs scale."""
    q, s = _quantized_values(x, None)
    return q.to(torch.int8), s


def _quantize_with_scale(x: torch.Tensor, s) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 with a fixed (calibrated) scale."""
    q, s = _quantized_values(x, s)
    return q.to(torch.int8), s


def _pad_depth(k: int) -> int:
    return -(-k // _K_ALIGN) * _K_ALIGN


def _explicit_padding(padding: Padding, size: Tuple[int, int], kernel: Tuple[int, int],
                      strides: Tuple[int, int]) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((top, bottom), (left, right)) for "VALID", "SAME" (XLA's split: the
    odd pixel goes to the end) or explicit pairs."""
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding == "SAME":
        pads = []
        for n, k, s in zip(size, kernel, strides):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads.append((total // 2, total - total // 2))
        return pads[0], pads[1]
    if isinstance(padding, str):
        raise ValueError(f"int8_conv: unknown padding {padding!r}")
    (pt, pb), (pl, pr) = padding
    return (int(pt), int(pb)), (int(pl), int(pr))


def _im2col(q: torch.Tensor, kh: int, kw: int, strides: Tuple[int, int],
            pads: Tuple[Tuple[int, int], Tuple[int, int]]):
    """Integer-valued float (B, H, W, C) (any strides) → the int8 patch
    matrix (B·OH·OW, pad16(kh·kw·C)), depth ordered (kh, kw, C) with zeros
    behind, and (B, OH, OW)."""
    b, h, w, c = q.shape
    (pt, pb), (pl, pr) = pads
    sh, sw = strides
    hp, wp = h + pt + pb, w + pl + pr
    oh, ow = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    if oh <= 0 or ow <= 0:
        raise ValueError(f"int8_conv: kernel ({kh}, {kw}) does not fit input ({h}, {w}) "
                         f"with padding {pads}")
    # one pass: cast to int8, NHWC-contiguous, inside the zero border
    if pt or pb or pl or pr:
        xp = torch.zeros((b, hp, wp, c), dtype=torch.int8, device=q.device)
        xp[:, pt:pt + h, pl:pl + w].copy_(q)
    else:
        xp = torch.empty((b, h, w, c), dtype=torch.int8, device=q.device).copy_(q)
    m, k = b * oh * ow, kh * kw * c
    kp = _pad_depth(k)
    if kh == kw == sh == sw == 1 and kp == k:
        return xp.view(m, k), (b, oh, ow)
    cols = torch.empty((m, kp), dtype=torch.int8, device=q.device)
    if kp != k:
        cols[:, k:].zero_()
    s_b, s_h, s_w, s_c = xp.stride()
    patches = xp.as_strided((b, oh, ow, kh, kw, c), (s_b, s_h * sh, s_w * sw, s_h, s_w, s_c))
    cols.as_strided((b, oh, ow, kh, kw, c),
                    (oh * ow * kp, ow * kp, kp, kw * c, c, 1)).copy_(patches)
    return cols, (b, oh, ow)


def _conv_weight(kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """HWIO float kernel → (int8 (O, pad16(kh·kw·I)) with depth ordered
    (kh, kw, I) and zeros behind, float32 scales (O,))."""
    kh, kw, ci, co = kernel.shape
    w_q, w_scale = quantize_channelwise(kernel, axis=-1)
    k = kh * kw * ci
    w_nk = torch.zeros((co, _pad_depth(k)), dtype=torch.int8, device=kernel.device)
    w_nk[:, :k] = w_q.reshape(k, co).t()
    return w_nk, w_scale.reshape(co)


def _dequantize(acc: torch.Tensor, x_scale: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    out = acc * (x_scale * w_scale)          # int32 · float32 → float32, one pass
    if bias is not None:
        out += bias.to(torch.float32)
    return out.to(out_dtype)


def _conv_quantized(x: torch.Tensor, w_nk: torch.Tensor, w_scale: torch.Tensor,
                    kernel_hw: Tuple[int, int], bias, strides, padding: Padding,
                    out_dtype: torch.dtype, act_scale,
                    reduce: Optional[Callable] = None) -> torch.Tensor:
    kh, kw = kernel_hw
    strides = (int(strides[0]), int(strides[1]))
    pads = _explicit_padding(padding, x.shape[1:3], (kh, kw), strides)
    # the four stages carry profiler labels: PERF.md's breakdown reads them
    with record_function("int8/quantise"):
        q, x_scale = _quantized_values(x, act_scale, reduce)
    with record_function("int8/im2col"):
        cols, (b, oh, ow) = _im2col(q, kh, kw, strides, pads)
    del q
    with record_function("int8/matmul"):
        acc = int8_matmul(cols, w_nk.t())
    del cols
    with record_function("int8/dequantise"):
        return _dequantize(acc, x_scale, w_scale, bias, out_dtype).view(b, oh, ow, -1)


def int8_conv(x: torch.Tensor, kernel: torch.Tensor, bias, strides, padding: Padding,
              out_dtype: Optional[torch.dtype] = None, act_scale=None) -> torch.Tensor:
    """NHWC conv of ``x`` (B, H, W, Cin) with an HWIO ``kernel`` (kh, kw,
    Cin, Cout) through int8 operands and an int32 accumulator: numerically
    ``conv(x, kernel) + bias`` to within the two quantisation roundings (and
    clipping to the calibrated range with ``act_scale``). ``padding``:
    "SAME", "VALID" or ((top, bottom), (left, right))."""
    if x.ndim != 4 or kernel.ndim != 4 or x.shape[-1] != kernel.shape[2]:
        raise ValueError(f"int8_conv takes NHWC x and an HWIO kernel, got {tuple(x.shape)} "
                         f"and {tuple(kernel.shape)}")
    w_nk, w_scale = _conv_weight(kernel)
    return _conv_quantized(x, w_nk, w_scale, kernel.shape[:2], bias, strides, padding,
                           out_dtype or x.dtype, act_scale)


def _dense_quantized(x: torch.Tensor, w_nk: torch.Tensor, w_scale: torch.Tensor, bias,
                     out_dtype: torch.dtype, act_scale,
                     reduce: Optional[Callable] = None) -> torch.Tensor:
    with record_function("int8/quantise"):
        q, x_scale = _quantized_values(x, act_scale, reduce)
        x_q = torch.empty(q.shape, dtype=torch.int8, device=q.device).copy_(q)
    with record_function("int8/matmul"):
        acc = int8_matmul(x_q.view(-1, x.shape[-1]), w_nk.t())
    with record_function("int8/dequantise"):
        return _dequantize(acc, x_scale, w_scale, bias, out_dtype).view(x.shape[:-1] + (-1,))


def int8_dense(x: torch.Tensor, kernel: torch.Tensor, bias,
               out_dtype: Optional[torch.dtype] = None, act_scale=None) -> torch.Tensor:
    """``x @ kernel + bias`` for a (in, out) ``kernel`` with int8 operands and
    int32 accumulation; the kernel's scales are per output feature."""
    if kernel.ndim != 2 or x.shape[-1] != kernel.shape[0]:
        raise ValueError(f"int8_dense takes (..., in) and (in, out), got {tuple(x.shape)} "
                         f"and {tuple(kernel.shape)}")
    w_q, w_scale = quantize_channelwise(kernel, axis=-1)
    return _dense_quantized(x, w_q.t(), w_scale.reshape(-1), bias, out_dtype or x.dtype,
                            act_scale)


class _Serving:
    """What an open ``int8_serving`` or calibration context knows: the
    modules' names, the static scales, and each module's quantised weight."""

    def __init__(self, model: nn.Module, act_scales: Optional[Dict[str, float]],
                 record: bool = False, scale_reducer: Optional[Callable] = None):
        self.names = {id(m): name for name, m in model.named_modules()}
        self.act_scales = act_scales
        self.scale_reducer = scale_reducer
        self.record = record
        self.amax: Dict[str, torch.Tensor] = {}
        self._weights: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._scales: Dict[str, torch.Tensor] = {}

    def _observe(self, module: nn.Module, x: torch.Tensor) -> None:
        name = self.names.get(id(module))
        if name is not None:
            m = x.detach().to(torch.float32).abs().max()
            self.amax[name] = torch.maximum(self.amax[name], m) if name in self.amax else m

    def _act_scale(self, module: nn.Module, device) -> Optional[torch.Tensor]:
        """The module's static scale as a device scalar; None = dynamic."""
        name = self.names.get(id(module))
        if self.act_scales is None or name not in self.act_scales:
            return None
        if name not in self._scales:
            self._scales[name] = torch.tensor(self.act_scales[name], dtype=torch.float32,
                                              device=device)
        return self._scales[name]

    def linear(self, module: nn.Linear, x: torch.Tensor) -> Optional[Callable]:
        """The int8 product of a ``Linear``: ``product(x, bias)``, which the
        layer runs (column-parallel where its weight is a model-axis slice:
        the scales are per output channel, so a slice's integers and scales
        are the whole weight's for its channels, and the activation's scale
        is the whole input's, one process's values); None while calibrating
        (the caller then runs its float path)."""
        if self.record:
            self._observe(module, x)
            return None
        if id(module) not in self._weights:
            w_q, w_scale = quantize_channelwise(module.weight.detach(), axis=0)
            self._weights[id(module)] = (w_q, w_scale.reshape(-1))
        return lambda v, bias: _dense_quantized(
            v, *self._weights[id(module)], _detached(bias), module.compute_dtype,
            self._act_scale(module, v.device), self.scale_reducer)

    def conv(self, module: nn.Module, x: torch.Tensor) -> Optional[Callable]:
        """The int8 product of a conv over (B, C, H, W): ``product(x,
        bias)``, its NHWC result, as ``linear``; None for a conv that is not
        rerouted (1-D, grouped, dilated, non-zero padding mode) and while
        calibrating."""
        if self.record:
            self._observe(module, x)
            return None
        if not (isinstance(module, nn.Conv2d) and module.groups == 1
                and tuple(module.dilation) == (1, 1) and module.padding_mode == "zeros"
                and not isinstance(module.padding, str)):
            return None
        if id(module) not in self._weights:
            self._weights[id(module)] = _conv_weight(module.weight.detach().permute(2, 3, 1, 0))
        ph, pw = module.padding
        return lambda v, bias: _conv_quantized(
            v.permute(0, 2, 3, 1), *self._weights[id(module)], module.kernel_size,
            _detached(bias), module.stride, ((ph, ph), (pw, pw)), module.compute_dtype,
            self._act_scale(module, v.device), self.scale_reducer)


def _detached(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.detach()


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("lvg_int8_serving", default=None)


def active() -> Optional[_Serving]:
    """The open int8 (or calibration) context, if any: what the port's
    ``Linear`` and conv layers ask in ``forward``."""
    return _ACTIVE.get()


@contextlib.contextmanager
def _activate(serving: _Serving):
    token = _ACTIVE.set(serving)
    try:
        yield serving
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def int8_serving(model: nn.Module, act_scales: Optional[Dict[str, float]] = None,
                 scale_reducer: Optional[Callable] = None):
    """Context manager: every forward of ``model`` inside routes its
    ``Linear`` and 2-D conv products through int8 — dynamic activation
    scales by default, the calibrated static scale where ``act_scales``
    (``named_modules()`` path → float, from ``calibrate_activation_scales``)
    has one. ``scale_reducer`` (a max over the ranks that share a batch,
    ``parallel.mesh.data_max``) makes a dynamic scale the global batch's.

    >>> with int8_serving(gen):
    ...     out = gen(mel, faces)
    """
    with _activate(_Serving(model, act_scales, scale_reducer=scale_reducer)):
        yield


def quantized_apply(model: nn.Module, *args, act_scales=None, **kwargs):
    """``model(*args, **kwargs)`` under ``int8_serving``."""
    with int8_serving(model, act_scales):
        return model(*args, **kwargs)


def calibrate_activation_scales(model: nn.Module, batches: Iterable[Sequence]) -> Dict[str, float]:
    """One-time static calibration: run ``model(*batch)`` in float over
    ``batches`` while recording the ``max|x|`` of every ``Linear`` and conv
    input; returns {module path: max(max|x|, 1e-8) / 127} for
    ``int8_serving(model, act_scales=...)``. The maxima stay on the device
    until the end; the scales are Python floats, as in the JAX package."""
    with _activate(_Serving(model, None, record=True)) as serving, torch.no_grad():
        for batch in batches:
            model(*batch)
    return {k: max(float(v), 1e-8) / 127.0 for k, v in serving.amax.items()}
