"""wav2lip_gen_96: the lip-sync generator served by ``generate_frames``.

The program's entry is ``pipelines.inference.generate_frames`` with the
generator's state dict, host uint8 frames, face boxes and mel windows, in
float32 or (the mix's ``int8``) with every convolution through dynamic
int8 (``ops/quant`` and the K6 kernel). A request is ``mix["frames"]``
frames of ``mix["frame_hw"]``: the frames come from a few distinct sets
made on the device from the seed (a request's frames are host memory, as a
decoder would hand them over), the boxes (``mix["box"]`` ± ``box_jitter``
pixels) and the standard-normal mel windows from the seed and the
request's index. The reference (``reference/wav2lip.py``) recomputes each
kept request from the same inputs and weights; the numbers compared are
the largest gap of an output pixel, in uint8 levels, the mean gap over the
region the face boxes cover, and the largest gap outside each frame's own
box (the pixels paste-back leaves and the copies carry back).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

import faults
import weights
from reference import wav2lip as ref
from reference.nn import Numerics


@dataclasses.dataclass
class Request:
    index: int
    frames: np.ndarray        # (N, H, W, 3) uint8
    boxes: np.ndarray         # (N, 4) float32 y1y2x1x2
    mels: np.ndarray          # (N, 80, 16) float32
    n_frames: int


class Program:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: str):
        from lipreading_video_generation_tpu_torch.core.config import GanConfig, PreprocessConfig
        from lipreading_video_generation_tpu_torch.models.generator import TalkingFaceGenerator

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.width = cfg["width"]
        self.precision = "int8" if mix["int8"] else "float32"
        with torch.device("meta"):
            shapes = TalkingFaceGenerator(width=self.width).state_dict()
        self.params = weights.from_seed(shapes, seed, device)
        gen = torch.Generator(device=device).manual_seed(weights.derive(seed, 2))
        n, (h, w) = mix["frames"], mix["frame_hw"]
        self.pool = [torch.randint(0, 256, (n, h, w, 3), generator=gen, device=device,
                                   dtype=torch.uint8).cpu().numpy()
                     for _ in range(mix["frame_sets"])]
        self.gan = GanConfig(img_size=cfg["img_size"], serve_int8=bool(mix["int8"]))
        self.pre = PreprocessConfig(gen_batch_size=cfg["gen_batch_size"])

    def request(self, index: int) -> Request:
        """Request ``index`` (negative: warm-up and traced requests, another stream)."""
        r = weights.rng(self.seed, 3, 0 if index >= 0 else 1, abs(index))
        n, j = self.mix["frames"], self.mix["box_jitter"]
        boxes = (np.tile(np.asarray(self.mix["box"], np.float32), (n, 1))
                 + r.uniform(-j, j, (n, 4)).astype(np.float32))
        mels = r.standard_normal((n, self.cfg["mel_bins"], self.cfg["mel_steps"])).astype(np.float32)
        return Request(index, self.pool[index % len(self.pool)], boxes, mels, n)

    def serve(self, req: Request) -> np.ndarray:
        from lipreading_video_generation_tpu_torch.pipelines.inference import generate_frames

        return generate_frames(self.params, req.frames, req.boxes, req.mels, self.gan, self.pre,
                               self.width, device=self.device)

    @staticmethod
    def faults() -> dict:
        """What a run can get wrong, planted where a batch's frames are made:
        a frame, or one pixel that paste-back leaves as it came in."""
        site = "lipreading_video_generation_tpu_torch.pipelines.inference"
        return {"frame_inverted": (site, "lipsync_batch", faults.altered_frames),
                "corner_pixel": (site, "lipsync_batch",
                                 lambda fn: faults.altered_frames(fn, corner=True))}

    # ---- the benchmark's own counts, from the shapes --------------------------------

    def _batches(self, req: Request) -> List[int]:
        b = self.cfg["gen_batch_size"]
        return [min(b, req.n_frames - i) for i in range(0, req.n_frames, b)]

    def products(self, req: Request) -> List[Tuple[int, int, int]]:
        """(M, N, K) of every convolution's product in a request, K at the
        logical depth kh·kw·Cin."""
        shapes = ref.conv_shapes(self.width, self.cfg["img_size"],
                                 (self.cfg["mel_bins"], self.cfg["mel_steps"]))
        return [(b * oh * ow, cout, kh * kw * cin)
                for b in self._batches(req) for oh, ow, cin, cout, kh, kw in shapes]

    def model_flops(self, req: Request) -> float:
        return float(sum(2 * m * n * k for m, n, k in self.products(req)))

    def int8_products(self, req: Request) -> List[Tuple[int, int, int]]:
        return self.products(req) if self.mix["int8"] else []

    def attention_calls(self, req: Request) -> list:
        return []

    # ---- the comparison ---------------------------------------------------------------

    def reference_output(self, req: Request, mode: str) -> torch.Tensor:
        gen = ref.Generator(self.params, Numerics(mode), self.width)
        dev = self.device
        with torch.no_grad():
            return ref.request(gen, torch.from_numpy(req.frames).to(dev),
                               torch.from_numpy(req.boxes).to(dev),
                               torch.from_numpy(req.mels).to(dev),
                               self.cfg["gen_batch_size"], self.cfg["img_size"])

    def compare(self, req: Request, out: np.ndarray, ref_out: torch.Tensor) -> Dict[str, float]:
        a = torch.from_numpy(np.asarray(out)).to(ref_out.device).to(torch.int16)
        gap = (a - ref_out.to(torch.int16)).abs()
        y1, x1 = int(np.floor(req.boxes[:, 0].min())), int(np.floor(req.boxes[:, 2].min()))
        y2, x2 = int(np.ceil(req.boxes[:, 1].max())), int(np.ceil(req.boxes[:, 3].max()))
        region = gap[:, max(y1, 0):y2 + 1, max(x1, 0):x2 + 1]
        # each frame's pixels outside its own box, which paste-back leaves as
        # they came in and the copies carry: equal on both sides, to the level
        H, W = gap.shape[1], gap.shape[2]
        b = torch.from_numpy(req.boxes).to(gap.device)[:, :, None, None]
        rows = torch.arange(H, dtype=torch.float32, device=gap.device)[:, None]
        cols = torch.arange(W, dtype=torch.float32, device=gap.device)[None, :]
        inside = (rows >= b[:, 0]) & (rows < b[:, 1]) & (cols >= b[:, 2]) & (cols < b[:, 3])
        outside = gap.amax(-1).masked_fill(inside, 0)
        return {"max_gap": float(gap.max()), "mean_gap": float(region.float().mean()),
                "outside_gap": float(outside.max())}
