"""S3FD face detector and its dense decode / NMS pipeline.

Port of ``lipreading_video_generation_tpu/models/s3fd.py``: a VGG16
backbone, fc6/fc7 as convolutions, extra conv6/conv7 stages, L2Norm-scaled
heads at strides 4/8/16/32/64/128 with anchor = 4·stride, and the max-out
background label on the stride-4 head. The parameters carry the names of
the published ``s3fd.pth`` (``conv1_1.weight``, …, ``conv3_3_norm.weight``,
``conv3_3_norm_mbox_conf.bias``), so its ``state_dict`` loads with
``load_state_dict`` as it is.

What the reference net does, and this one keeps:
- ``fc6`` is a 3×3 convolution with padding 3 and no dilation, so the 5×5
  map of a 160×160 frame becomes 9×9 while its anchors still assume stride 32;
- the stride-2 ``conv6_2``/``conv7_2`` pad 1 on every side;
- the max-pools are 2×2 with stride 2 and drop a ragged edge;
- L2Norm divides by ``sqrt(Σx²) + 1e-10`` over the channels.

The module maps (B, 3, H, W) mean-subtracted BGR to 12 NCHW head tensors,
as the published net does; ``decode_detections`` takes them to the JAX
package's NHWC layout. ``detect_faces`` runs a whole batch on the
detector's device (JAX's ``vmap`` over images is the batch dimension of
``ops.bbox.nms``). The convolutions are the library's, as XLA's are in the
JAX package: this path has no TPU kernel.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ..ops import bbox as bbox_ops
from .layers import Conv2d

S3FD_MEAN = np.array([104.0, 117.0, 123.0], dtype=np.float32)  # BGR order
STRIDES = (4, 8, 16, 32, 64, 128)

# (name, in, out, kernel, padding, stride) of the backbone, in order; "pool"
# marks a 2×2 max-pool
_BACKBONE = [
    ("conv1_1", 3, 64, 3, 1, 1), ("conv1_2", 64, 64, 3, 1, 1), "pool",
    ("conv2_1", 64, 128, 3, 1, 1), ("conv2_2", 128, 128, 3, 1, 1), "pool",
    ("conv3_1", 128, 256, 3, 1, 1), ("conv3_2", 256, 256, 3, 1, 1),
    ("conv3_3", 256, 256, 3, 1, 1), "pool",
    ("conv4_1", 256, 512, 3, 1, 1), ("conv4_2", 512, 512, 3, 1, 1),
    ("conv4_3", 512, 512, 3, 1, 1), "pool",
    ("conv5_1", 512, 512, 3, 1, 1), ("conv5_2", 512, 512, 3, 1, 1),
    ("conv5_3", 512, 512, 3, 1, 1), "pool",
    ("fc6", 512, 1024, 3, 3, 1), ("fc7", 1024, 1024, 1, 0, 1),
    ("conv6_1", 1024, 256, 1, 0, 1), ("conv6_2", 256, 512, 3, 1, 2),
    ("conv7_1", 512, 128, 1, 0, 1), ("conv7_2", 128, 256, 3, 1, 2),
]
# (source feature, its channels, classifier channels) of the six heads
_HEADS = [("conv3_3_norm", 256, 4), ("conv4_3_norm", 512, 2), ("conv5_3_norm", 512, 2),
          ("fc7", 1024, 2), ("conv6_2", 512, 2), ("conv7_2", 256, 2)]
_TAPS = ("conv3_3", "conv4_3", "conv5_3", "fc7", "conv6_2", "conv7_2")
_NORMS = (("conv3_3_norm", 256, 10.0), ("conv4_3_norm", 512, 8.0), ("conv5_3_norm", 512, 5.0))


class L2Norm(nn.Module):
    """Per-position L2 normalisation over channels with a learned per-channel
    scale (initialised to ``scale``)."""

    def __init__(self, channels: int, scale: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), float(scale)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + 1e-10
        return x / norm * self.weight[None, :, None, None]


class S3FD(nn.Module):
    """(B, 3, H, W) mean-subtracted BGR → 6 × (cls, reg) NCHW heads."""

    def __init__(self):
        super().__init__()
        for spec in _BACKBONE:
            if spec != "pool":
                name, cin, cout, k, pad, stride = spec
                self.add_module(name, Conv2d(cin, cout, k, stride, pad))
        for name, c, scale in _NORMS:
            self.add_module(name, L2Norm(c, scale))
        for src, c, n_cls in _HEADS:
            self.add_module(f"{src}_mbox_conf", Conv2d(c, n_cls, 3, 1, 1))
            self.add_module(f"{src}_mbox_loc", Conv2d(c, 4, 3, 1, 1))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = {}
        h = x
        for spec in _BACKBONE:
            if spec == "pool":
                h = F.max_pool2d(h, 2, 2)
                continue
            h = F.relu(getattr(self, spec[0])(h))
            if spec[0] in _TAPS:
                taps[spec[0]] = h
        for name, _, _ in _NORMS:
            taps[name] = getattr(self, name)(taps[name[: -len("_norm")]])
        outs = []
        for src, _, _ in _HEADS:
            outs.append(getattr(self, f"{src}_mbox_conf")(taps[src]))
            outs.append(getattr(self, f"{src}_mbox_loc")(taps[src]))
        # max-out background label on the stride-4 head
        cls1 = outs[0]
        bmax = torch.maximum(torch.maximum(cls1[:, 0:1], cls1[:, 1:2]), cls1[:, 2:3])
        outs[0] = torch.cat([bmax, cls1[:, 3:4]], dim=1)
        return outs


def preprocess_input(images_bgr: torch.Tensor) -> torch.Tensor:
    """uint8/float BGR (B, H, W, 3) → mean-subtracted float32 (B, 3, H, W)."""
    mean = torch.from_numpy(S3FD_MEAN).to(images_bgr.device)
    return (images_bgr.to(torch.float32) - mean).permute(0, 3, 1, 2)


def decode_detections(
    outputs: Sequence[torch.Tensor],
    variances: Tuple[float, float] = (0.1, 0.2),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """6 × (cls, reg) NCHW heads → (boxes (B, N, 4), scores (B, N)) over all
    anchors, in the JAX package's order (scale, then row, then column)."""
    all_boxes, all_scores = [], []
    for i in range(6):
        cls, reg = (t.permute(0, 2, 3, 1) for t in outputs[2 * i: 2 * i + 2])
        boxes, scores = bbox_ops.dense_decode_scale(cls, reg, STRIDES[i], variances)
        all_boxes.append(boxes)
        all_scores.append(scores)
    return torch.cat(all_boxes, dim=1), torch.cat(all_scores, dim=1)


@torch.no_grad()
def detect_faces(
    model: S3FD,
    images_bgr: torch.Tensor,
    score_threshold: float = 0.5,
    nms_threshold: float = 0.3,
    max_faces: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched detection on the model's device: (B, H, W, 3) BGR →
    (boxes (B, max_faces, 4) x1y1x2y2, scores (B, max_faces), valid
    (B, max_faces)). NMS keeps candidates above 0.05; a slot is valid when
    NMS kept it and its score is above ``score_threshold``."""
    device = next(model.parameters()).device
    outputs = model(preprocess_input(images_bgr.to(device)))
    boxes, scores = decode_detections(outputs)
    idx, keep = bbox_ops.nms(boxes, scores, nms_threshold, max_keep=max_faces,
                             score_threshold=0.05)
    kept_boxes = torch.gather(boxes, 1, idx[..., None].expand(idx.shape + (4,)))
    kept_scores = torch.gather(scores, 1, idx)
    return kept_boxes, kept_scores, keep & (kept_scores > score_threshold)


def flip_detect(model: S3FD, images_bgr: torch.Tensor, **kwargs
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``detect_faces`` on horizontally flipped images, boxes mirrored back
    (flip test-time augmentation). Same outputs as ``detect_faces``."""
    w = images_bgr.shape[2]
    boxes, scores, valid = detect_faces(model, torch.flip(images_bgr, dims=[2]), **kwargs)
    flipped = torch.stack([w - boxes[..., 2], boxes[..., 1], w - boxes[..., 0], boxes[..., 3]],
                          dim=-1)
    return flipped, scores, valid
