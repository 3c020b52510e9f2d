"""Box math of the face detector: SSD anchors, encode/decode, IoU, fixed-shape NMS.

Port of ``lipreading_video_generation_tpu/ops/bbox.py``. The decode is
dense over every anchor of every scale, and NMS keeps a static shape (the
top ``max_keep`` slots, then a masked suppression loop of ``max_keep``
steps), batched over images, so a batch of frames costs no host sync. The
JAX package leaves this to XLA, and so it stays plain torch here.

``nms`` takes its top slots with a stable descending sort: ``lax.top_k``
puts the lower index first on ties, and ``torch.topk`` promises no order for
ties. IoU keeps the reference's +1 pixel-area convention, which
``torchvision.ops.nms`` lacks.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "iou_matrix",
    "encode",
    "decode",
    "nms",
    "make_anchor_grid",
    "dense_decode_scale",
]


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., N, 4) and (..., M, 4) x1y1x2y2 boxes → (..., N, M),
    with the +1 pixel-area convention."""
    area_a = (a[..., 2] - a[..., 0] + 1) * (a[..., 3] - a[..., 1] + 1)
    area_b = (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt + 1, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


def encode(matched: torch.Tensor, priors: torch.Tensor,
           variances: Sequence[float] = (0.1, 0.2)) -> torch.Tensor:
    """Ground-truth x1y1x2y2 boxes → (dx, dy, dw, dh) regression targets
    against cxcywh priors."""
    g_cxcy = (matched[..., :2] + matched[..., 2:]) / 2 - priors[..., :2]
    g_cxcy = g_cxcy / (variances[0] * priors[..., 2:])
    g_wh = (matched[..., 2:] - matched[..., :2]) / priors[..., 2:]
    g_wh = torch.log(g_wh) / variances[1]
    return torch.cat([g_cxcy, g_wh], dim=-1)


def decode(loc: torch.Tensor, priors: torch.Tensor,
           variances: Sequence[float] = (0.1, 0.2)) -> torch.Tensor:
    """(..., 4) regression deltas + cxcywh priors → x1y1x2y2 boxes."""
    cxcy = priors[..., :2] + loc[..., :2] * variances[0] * priors[..., 2:]
    wh = priors[..., 2:] * torch.exp(loc[..., 2:] * variances[1])
    mins = cxcy - wh / 2
    maxs = mins + wh
    return torch.cat([mins, maxs], dim=-1)


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float = 0.3,
    max_keep: int = 32,
    score_threshold: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS with a static output shape, over any leading batch dims.

    boxes (..., N, 4), scores (..., N) → (keep_idx (..., max_keep) int64,
    keep_valid (..., max_keep) bool): the ``min(max_keep, N)`` best scores
    above ``score_threshold`` in descending order (ties: lower index
    first), each kept unless a kept higher-scoring box overlaps it by IoU >
    ``iou_threshold``. Slots past N carry index 0 and valid False.
    """
    n = boxes.shape[-2]
    k = min(max_keep, n)
    masked = torch.where(scores > score_threshold, scores,
                         torch.full_like(scores, float("-inf")))
    top_scores, top_idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    top_scores, top_idx = top_scores[..., :k], top_idx[..., :k]
    top_boxes = torch.gather(boxes, -2, top_idx[..., None].expand(top_idx.shape + (4,)))
    valid = torch.isfinite(top_scores)
    over = iou_matrix(top_boxes, top_boxes) > iou_threshold       # (..., k, k)
    keep = torch.zeros_like(valid)
    for i in range(k):
        # box i stays unless a kept box of a higher slot overlaps it
        suppressed = (over[..., :i, i] & keep[..., :i]).any(dim=-1)
        keep[..., i] = valid[..., i] & ~suppressed
    if k < max_keep:
        pad = max_keep - k
        top_idx = torch.nn.functional.pad(top_idx, (0, pad))
        keep = torch.nn.functional.pad(keep, (0, pad))
    return top_idx, keep


def make_anchor_grid(fh: int, fw: int, stride: int, anchor_scale: int = 4) -> np.ndarray:
    """(fh*fw, 4) cxcywh anchors for one S3FD scale: centres at
    stride/2 + i*stride, size anchor_scale*stride."""
    ys = stride / 2 + np.arange(fh) * stride
    xs = stride / 2 + np.arange(fw) * stride
    cy, cx = np.meshgrid(ys, xs, indexing="ij")
    size = np.full_like(cy, float(anchor_scale * stride))
    return np.stack([cx, cy, size, size], axis=-1).reshape(-1, 4).astype(np.float32)


def dense_decode_scale(
    cls_logits: torch.Tensor,
    reg: torch.Tensor,
    stride: int,
    variances: Sequence[float] = (0.1, 0.2),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode one S3FD head densely. cls_logits (B, H, W, 2) [background,
    face], reg (B, H, W, 4) → (boxes (B, H*W, 4) x1y1x2y2, scores (B, H*W))."""
    b, fh, fw, _ = cls_logits.shape
    scores = torch.softmax(cls_logits, dim=-1)[..., 1].reshape(b, fh * fw)
    priors = torch.from_numpy(make_anchor_grid(fh, fw, stride)).to(reg.device)
    boxes = decode(reg.reshape(b, fh * fw, 4), priors[None], variances)
    return boxes, scores
