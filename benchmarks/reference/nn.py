"""Plain layers of the references: convolutions, dense layers, norms and
attention in float32, and the lower precisions the controls run them in.

``Numerics(mode)`` computes every product of a reference:

- ``float32``: float32 with TF32 off (what the benchmark compares against);
- ``tf32``: float32 inputs with TF32 on (the control of a float32 path);
- ``int8`` / ``int4``: symmetric per-tensor activations with the scale from
  their own max|x|, symmetric per-output-channel weights, no zero point,
  round half to even, the integer products summed exactly in float64, then
  ``acc · (x_scale · w_scale) + bias`` in float32 (``int8`` is the served
  int8 path's arithmetic; ``int4`` its control);
- ``fp8``: activations and weights scaled per tensor to e4m3's range, cast
  to ``float8_e4m3fn`` and back, then float32; in a backward their
  gradients likewise through e5m2 (the control of a bf16 path).

Norms use E[x²]−E[x]² clipped at 0 with eps 1e-6, as the served models do.
Nothing here imports the program.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

_E4M3_MAX, _E5M2_MAX = 448.0, 57344.0


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 of cuBLAS and cuDNN set to ``enabled`` inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _round_trip(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``t`` through ``dtype`` with a per-tensor scale to ``top``, back in float32."""
    scale = top / torch.clamp(t.abs().amax().float(), min=1e-30)
    return (t.float() * scale).to(dtype).to(torch.float32) / scale


class _Fp8(torch.autograd.Function):
    """Forward operands in e4m3, their gradients in e5m2, each scaled per
    tensor: the usual recipe of fp8 training."""

    @staticmethod
    def forward(ctx, t):
        return _round_trip(t, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round_trip(g, torch.float8_e5m2, _E5M2_MAX)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(t)


class Numerics:
    MODES = ("float32", "tf32", "int8", "int4", "fp8")

    def __init__(self, mode: str = "float32"):
        if mode not in self.MODES:
            raise ValueError(f"unknown numerics {mode!r} ({', '.join(self.MODES)})")
        self.mode = mode
        self.qmax = {"int8": 127.0, "int4": 7.0}.get(mode)

    def context(self):
        return tf32(self.mode == "tf32")

    def _int_act(self, x: torch.Tensor):
        xf = x.float()
        lo, hi = torch.aminmax(xf)
        s = torch.clamp(torch.maximum(-lo, hi), min=1e-8) / torch.tensor(self.qmax, device=x.device)
        return torch.div(xf, s).round_().clamp_(-self.qmax, self.qmax), s

    def _int_weight(self, w: torch.Tensor):
        wf = w.float()
        amax = wf.abs().amax(dim=tuple(range(1, w.ndim)), keepdim=True)
        s = torch.clamp(amax, min=1e-8) / torch.tensor(self.qmax, device=w.device)
        return torch.clamp(torch.round(wf / s), -self.qmax, self.qmax), s.reshape(-1)

    def conv2d(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], stride=1,
               padding=0) -> torch.Tensor:
        if self.qmax is not None:
            q, xs = self._int_act(x)
            wq, ws = self._int_weight(w)
            acc = F.conv2d(q.double(), wq.double(), None, stride, padding).float()
            out = acc * (xs * ws)[None, :, None, None]
            return out if b is None else out + b.float()[None, :, None, None]
        if self.mode == "fp8":
            x, w = _fp8(x), _fp8(w)
        return F.conv2d(x.float(), w.float(), None if b is None else b.float(), stride, padding)

    def conv1d(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], stride=1,
               padding=0) -> torch.Tensor:
        if self.mode == "fp8":
            x, w = _fp8(x), _fp8(w)
        return F.conv1d(x.float(), w.float(), None if b is None else b.float(), stride, padding)

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
        if self.mode == "fp8":
            x, w = _fp8(x), _fp8(w)
        return F.linear(x.float(), w.float(), None if b is None else b.float())

    def attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                  block: int = 1024) -> torch.Tensor:
        """softmax(QKᵀ/√d)·V over (B, S, E) in ``heads`` heads, by blocks of
        ``block`` query rows so that the scores of a long sequence fit."""
        b, s, e = q.shape
        d = e // heads
        if self.mode == "fp8":
            q, k, v = _fp8(q), _fp8(k), _fp8(v)
        qh = q.float().reshape(b, s, heads, d).transpose(1, 2)
        kh = k.float().reshape(b, k.shape[1], heads, d).transpose(1, 2)
        vh = v.float().reshape(b, v.shape[1], heads, d).transpose(1, 2)
        out = torch.empty_like(qh)
        for i in range(0, s, block):
            scores = torch.einsum("bhqd,bhkd->bhqk", qh[:, :, i:i + block], kh) / math.sqrt(d)
            p = torch.softmax(scores, dim=-1)
            if self.mode == "fp8":
                p = _fp8(p)
            out[:, :, i:i + block] = torch.einsum("bhqk,bhkd->bhqd", p, vh)
        return out.transpose(1, 2).reshape(b, s, e)


def default_groups(c: int) -> int:
    g = min(32, c)
    while c % g:
        g -= 1
    return g


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over (B, C, ...) in ``default_groups(C)`` groups, float32."""
    b, c = x.shape[:2]
    g = default_groups(c)
    xg = x.float().reshape(b, g, -1)
    mean = xg.mean(-1, keepdim=True)
    var = torch.clamp((xg * xg).mean(-1, keepdim=True) - mean * mean, min=0.0)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.ndim - 2)
    return y * weight.float().reshape(shape) + bias.float().reshape(shape)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()
