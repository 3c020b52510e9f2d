"""Ring attention: exact attention with the sequence split over a mesh axis.

Port of ``lipreading_video_generation_tpu/ops/ring_attention.py``. Each rank
of the ring keeps its slice of the queries and merges, block by block, the
K/V slices that travel round the ring (``parallel.mesh.ppermute``, N − 1
hops) into an online-softmax accumulator: O(S/N) score memory a rank. As in
the JAX package it is plain einsums in float32 (no hand-written kernel; the
JAX version has no Pallas call either) and differentiable: the backward
runs the ring the other way.

The port runs one process per GPU, so the inputs are whole on every rank of
the ring (the activations of the replicated compute around the attention):
``ring_attention`` takes this rank's slice of the tokens, runs the ring and
gathers the output back, with backward passes that hand each rank its share
of the gradient (``parallel.mesh.scatter_to`` / ``gather_from``). The batch
rows are already this data rank's own (data parallelism), which is the
JAX package's co-sharding of the batch over ``data`` when the ring runs
over ``model``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..parallel import mesh as pmesh
from .attention import _NEG_INF

__all__ = ["ring_attention", "live_ring_mesh"]


def live_ring_mesh(axis_name: Optional[str]) -> Optional["pmesh.MeshSpec"]:
    """The live mesh (``parallel.mesh.use_mesh``) if it has ``axis_name``
    with more than one rank, else None: model code then runs its local
    attention with the same definition (tests, one GPU)."""
    if axis_name is None:
        return None
    spec = pmesh.live_mesh()
    if pmesh.is_degenerate(spec) or axis_name not in (spec.data_axis, spec.model_axis):
        return None
    return spec if spec.size(axis_name) > 1 else None


def _ring_inner(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, spec, axis_name: str,
                sm_scale: float, causal: bool) -> torch.Tensor:
    """One rank's part: q, k, v are its (B, H, S/N, D) slices. At ring step
    i the rank holds the K/V slice of rank (me − i) mod N, whose key j sits
    at global position src·S_local + j (the causal mask)."""
    n = 1 if pmesh.is_degenerate(spec) else spec.size(axis_name)
    me = 0 if pmesh.is_degenerate(spec) else spec.rank(axis_name)
    qf = q.float()
    b, h, sq, d = qf.shape
    sk = k.shape[2]
    acc = qf.new_zeros((b, h, sq, d))
    m = qf.new_full((b, h, sq, 1), _NEG_INF)
    l = qf.new_zeros((b, h, sq, 1))
    q_pos = me * sq + torch.arange(sq, device=q.device)[:, None]
    k_cur, v_cur = k, v
    for i in range(n):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k_cur.float()) * sm_scale
        if causal:
            src = (me - i) % n
            k_pos = src * sk + torch.arange(sk, device=q.device)[None, :]
            s = s + torch.where(k_pos <= q_pos, 0.0, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v_cur.float())
        m = m_new
        if i < n - 1:       # the JAX loop's last hop returns K/V home unused
            k_cur = pmesh.ppermute(k_cur, spec, axis_name, 1)
            v_cur = pmesh.ppermute(v_cur, spec, axis_name, 1)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis_name: str = "data", sm_scale: Optional[float] = None,
                   causal: bool = False) -> torch.Tensor:
    """Exact attention over (B, H, S, D) inputs, the same on every rank of
    ``axis_name`` of ``mesh`` (a ``MeshSpec``), with the sequence split over
    that axis; returns the (B, H, S, D) output on every rank. ``ValueError``
    when S does not divide by the axis size. Without a group (a 1×1 mesh)
    it is the same computation in one block."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    n = 1 if pmesh.is_degenerate(mesh) else mesh.size(axis_name)
    if q.shape[2] % n:
        raise ValueError(f"sequence {q.shape[2]} not divisible by axis {axis_name}={n}")
    if n == 1:
        return _ring_inner(q, k, v, mesh, axis_name, sm_scale, causal)
    ql, kl, vl = (pmesh.scatter_to(t, mesh, axis_name, 2) for t in (q, k, v))
    out = _ring_inner(ql, kl, vl, mesh, axis_name, sm_scale, causal)
    return pmesh.gather_from(out, mesh, axis_name, 2)


def model_ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                         spec, axis_name: str) -> torch.Tensor:
    """(B, S, E) q, k, v → (B, S, E) through ``ring_attention`` over
    ``num_heads`` heads: the route of ``TransformerBlock`` and the U-Net's
    ``AttentionBlock`` when their ring is live. A ring over the data axis
    needs the batch whole on every data rank (``ValueError`` while a
    sharded batch is live)."""
    if axis_name == spec.data_axis and pmesh.batch_is_sharded():
        raise ValueError(
            f"sequence_axis {axis_name!r} is the data axis, whose ranks hold different rows of "
            f"the batch: run the ring over the model axis")
    b, s, e = q.shape
    hd = e // num_heads
    heads = [t.reshape(b, s, num_heads, hd).transpose(1, 2) for t in (q, k, v)]
    out = ring_attention(*heads, mesh=spec, axis_name=axis_name)
    return out.transpose(1, 2).reshape(b, s, e)
