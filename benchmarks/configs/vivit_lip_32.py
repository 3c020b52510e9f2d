"""vivit_lip_32: the ViViT lipreader served by ``predict_frames``, the main path.

The program's entry is ``pipelines.train_vivit.predict_frames`` on the
port's ``ViViT`` (weights from the seed, loaded once at set-up): host RGB
uint8 frames of ``mix["clips"]`` clips of ``num_frames`` frames and their
face boxes → the mouth-ROI preprocessing (crop, luma, CLAHE by K1, resize)
→ the classifier (K2 once a block) → host float32 log-probs. The frames
come from a few distinct sets made on the device from the seed (a
request's frames are host memory, as a decoder would hand them over); the
boxes (``mix["box"]`` ± ``box_jitter`` pixels) from the seed and the
request's index. The reference (``reference/vivit.py``) recomputes each
kept request from the same frames, boxes and weights in float32; the
numbers compared are the largest and the mean gap of a log-prob, each over
the reference's standard deviation of that clip's log-probs across the
classes, so that the limits do not depend on the weights' scale, and the
share of the request's ROI pixels more than one level from the
reference's ROI, which holds the preprocessing at the grain of a pixel
(a frame's ROI wrong in one clip of hundreds moves the log-probs less
than the bf16 classifier's own rounding can). The ROI is the classifier's
input as the timed request fed it, kept by a forward pre-hook on the
model and turned back into uint8 levels after the request's answer is on
the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

import faults
import weights
from reference import vivit as ref
from reference.nn import Numerics


@dataclasses.dataclass
class Served:
    logp: np.ndarray          # (clips, classes) float32 log-probs, the entry's answer
    roi: torch.Tensor         # (clips·T, s, s) uint8: the classifier's input, on the device


@dataclasses.dataclass
class Request:
    index: int
    frames: np.ndarray        # (clips·T, H, W, 3) uint8
    boxes: np.ndarray         # (clips·T, 4) float32 y1y2x1x2 face boxes
    clips: int
    n_frames: int


def vivit_config(cfg: dict):
    from lipreading_video_generation_tpu_torch.core.config import ViViTConfig

    return ViViTConfig(image_size=cfg["image_size"], num_frames=cfg["num_frames"],
                       num_channels=cfg["num_channels"], tubelet_size=tuple(cfg["tubelet_size"]),
                       hidden_size=cfg["hidden_size"], num_layers=cfg["num_layers"],
                       num_heads=cfg["num_heads"], mlp_dim=cfg["mlp_dim"], dropout=0.0,
                       num_classes=cfg["num_classes"], dtype=cfg["precision"])


def preprocess_config(cfg: dict):
    from lipreading_video_generation_tpu_torch.core.config import PreprocessConfig

    return PreprocessConfig(lip_crop_size=tuple(cfg["lip_crop_size"]),
                            model_input_size=(cfg["image_size"], cfg["image_size"]),
                            clahe_clip_limit=cfg["clahe_clip_limit"],
                            clahe_grid=tuple(cfg["clahe_grid"]))


def _unwritten_attention(mha_fn):
    """Each block's attention with the first clip's output left at zero, as
    a kernel that skipped a batch item leaves it."""
    def wrong(*args, **kwargs):
        out = mha_fn(*args, **kwargs).clone()
        out[0] = 0
        return out
    return wrong


class Program:
    precision = "bf16"

    def __init__(self, cfg: dict, mix: dict, seed: int, device: str):
        from lipreading_video_generation_tpu_torch.models.vivit import ViViT

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.vcfg, self.pre = vivit_config(cfg), preprocess_config(cfg)
        with torch.device("meta"):
            model = ViViT(self.vcfg)
        self.params = weights.from_seed(model.state_dict(), seed, device)
        self.model = model.to_empty(device=device)
        self.model.load_state_dict(self.params)
        self.model.eval()
        self._input = None
        self.model.register_forward_pre_hook(self._keep_input)
        self._ref_roi: Dict[int, torch.Tensor] = {}
        gen = torch.Generator(device=device).manual_seed(weights.derive(seed, 2))
        n, (h, w) = mix["clips"] * cfg["num_frames"], mix["frame_hw"]
        self.pool = [torch.randint(0, 256, (n, h, w, 3), generator=gen, device=device,
                                   dtype=torch.uint8).cpu().numpy()
                     for _ in range(mix["frame_sets"])]

    def request(self, index: int) -> Request:
        """Request ``index`` (negative: warm-up and traced requests, another stream)."""
        r = weights.rng(self.seed, 3, 0 if index >= 0 else 1, abs(index))
        clips, j = self.mix["clips"], self.mix["box_jitter"]
        n = clips * self.cfg["num_frames"]
        boxes = (np.tile(np.asarray(self.mix["box"], np.float32), (n, 1))
                 + r.uniform(-j, j, (n, 4)).astype(np.float32))
        return Request(index, self.pool[index % len(self.pool)], boxes, clips, n)

    def _keep_input(self, module, args) -> None:
        self._input = args[0]

    def serve(self, req: Request) -> Served:
        from lipreading_video_generation_tpu_torch.pipelines.train_vivit import predict_frames

        logp = predict_frames(self.model, req.frames, req.boxes, self.pre)
        with torch.inference_mode():
            x, self._input = self._input, None
            roi = x.mul(255.0).round_().to(torch.uint8).reshape(-1, *x.shape[2:4])
        return Served(logp, roi)

    @staticmethod
    def faults() -> dict:
        """What a run can get wrong: one frame's ROI (of the first clip),
        planted where the entry makes it, and an attention output inside
        every block."""
        return {"roi_frame_inverted": ("lipreading_video_generation_tpu_torch.pipelines.train_vivit",
                                       "mouth_roi_pipeline", faults.altered_frames),
                "attention_item_unwritten": ("lipreading_video_generation_tpu_torch.models.layers",
                                             "mha", _unwritten_attention)}

    # ---- the benchmark's own counts, from the shapes --------------------------------

    def tokens(self) -> int:
        tt, th, tw = self.cfg["tubelet_size"]
        s = self.cfg["image_size"]
        return (self.cfg["num_frames"] // tt) * (s // th) * (s // tw)

    def attention_calls(self, req: Request) -> List[Tuple[int, int, int, int, str]]:
        """(batch, heads, tokens, head dim, "fwd") of every block's attention
        of a request: K2's launches."""
        h = self.cfg["num_heads"]
        return [(req.clips, h, self.tokens(), self.cfg["hidden_size"] // h, "fwd")] \
            * self.cfg["num_layers"]

    def clahe_calls(self, req: Request) -> List[Tuple[int, int, int]]:
        """(images, height, width) of every K1 launch of a request: one, over
        every frame's luma crop."""
        h, w = self.cfg["lip_crop_size"]
        return [(req.n_frames, h, w)]

    def model_flops(self, req: Request) -> float:
        """2·M·N·K of every product of a request: the ViViT (tubelet
        embedding, qkv, attention 4·b·h·s²·d, projection, MLP, head) and the
        ROI's resampling and luma, which the entry computes as per-frame
        matrix products (the cubic crop-resize from the frame, the luma's
        weighted sum, the antialiased resize to the model's input; 0.6% of
        the total at the cell's size)."""
        c = self.cfg
        e, m, s = c["hidden_size"], c["mlp_dim"], self.tokens()
        k = int(np.prod(c["tubelet_size"])) * c["num_channels"]
        rows = req.clips * s
        layer = 2.0 * rows * e * 3 * e + 4.0 * rows * s * e + 2.0 * rows * e * e \
            + 2.0 * 2 * rows * e * m
        vivit = 2.0 * rows * k * e + c["num_layers"] * layer + 2.0 * req.clips * e * c["num_classes"]
        (fh, fw), (ch, cw), o = self.mix["frame_hw"], c["lip_crop_size"], c["image_size"]
        roi = (2.0 * ch * fh * fw * 3 + 2.0 * ch * cw * fw * 3 + 2.0 * ch * cw * 3
               + 2.0 * o * ch * cw + 2.0 * o * o * cw)
        return vivit + req.n_frames * roi

    def int8_products(self, req: Request) -> list:
        return []

    # ---- the comparison ---------------------------------------------------------------

    def release(self) -> None:
        """Free the program's model before the reference runs."""
        self.model = None
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def reference_output(self, req: Request, mode: str) -> torch.Tensor:
        model = ref.ViViT(self.params, self.cfg, Numerics(mode))
        dev = self.device
        with torch.no_grad():
            logp, self._ref_roi[req.index] = ref.request(
                model, torch.from_numpy(req.frames).to(dev), torch.from_numpy(req.boxes).to(dev),
                self.mix["reference_block"], tuple(self.cfg["lip_crop_size"]),
                self.cfg["clahe_clip_limit"], tuple(self.cfg["clahe_grid"]))
        return logp

    def compare(self, req: Request, out, ref_out: torch.Tensor) -> Dict[str, float]:
        """``out``: the program's ``Served``, or the control's log-probs,
        whose ROI is the reference's own (float32 in every mode)."""
        want = ref_out.float()
        logp = out.logp if isinstance(out, Served) else out
        got = torch.from_numpy(np.asarray(logp, np.float32)).to(want.device)
        gap = (got - want).abs() / want.std(dim=-1, keepdim=True)
        far = 0.0
        if isinstance(out, Served):
            roi = out.roi.to(want.device, torch.int16)
            far = float(((roi - self._ref_roi[req.index].to(torch.int16)).abs() > 1)
                        .float().mean())
        return {"max_gap": float(gap.max()), "mean_gap": float(gap.mean()), "roi_far_share": far}
