"""unet_audio_128: the audio- and image-conditioned diffusion U-Net served
by ``sample_video``.

The program's entry is ``pipelines.sample_diffusion.sample_video`` on the
port's ``UNetAudio`` (weights from the seed, loaded once at set-up): one
uint8 condition frame and ``mix["frames"]`` audio windows of
``audio_samples`` samples → ``mix["ddim_steps"]`` DDIM steps with
``mix["eta"]`` → uint8 frames, copied to the host. x_T comes from a
``torch.Generator`` on the device, seeded per request. The reference
(``reference/unet_audio.py``) draws the same x_T and samples the clip from
the same inputs and weights in float32; the numbers compared are the
largest gap of an output pixel in uint8 levels and the mean gap.
``Trainer`` serves the training cell: ``pipelines.train_diffusion.train_step``
against ``reference/train_diffusion.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

import faults
import weights
from reference import unet_audio as ref
from reference.nn import Numerics

_DIFFUSION_KEYS = ("im_size", "im_channels", "base_channels", "channel_mult", "num_res_blocks",
                   "attention_resolutions", "num_heads", "time_embed_dim", "audio_embed_dim",
                   "audio_proj_dim", "im_cond_channels", "audio_samples", "num_timesteps",
                   "beta_start", "beta_end", "scheduler", "dropout", "audio_encoder")


@dataclasses.dataclass
class Request:
    index: int
    frame: np.ndarray         # (h, w, 3) uint8 condition frame
    audio: np.ndarray         # (T, samples) float32
    noise_seed: int
    n_frames: int


def diffusion_config(cfg: dict):
    from lipreading_video_generation_tpu_torch.core.config import DiffusionConfig

    kw = {k: tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k] for k in _DIFFUSION_KEYS}
    return DiffusionConfig(dtype=cfg["precision"], **kw)


def model_from_seed(dcfg, seed: int, device: str):
    """(the benchmark's weights from the seed, the port's ``UNetAudio`` holding a copy)."""
    from lipreading_video_generation_tpu_torch.models.unet_audio import UNetAudio

    with torch.device("meta"):
        model = UNetAudio(dcfg)
    params = weights.from_seed(model.state_dict(), seed, device)
    model = model.to_empty(device=device)
    model.load_state_dict(params)
    return params, model


class Program:
    precision = "bf16"

    def __init__(self, cfg: dict, mix: dict, seed: int, device: str):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.dcfg = diffusion_config(cfg)
        self.params, self.model = model_from_seed(self.dcfg, seed, device)
        self.model.eval()

    def request(self, index: int) -> Request:
        r = weights.rng(self.seed, 4, 0 if index >= 0 else 1, abs(index))
        h, w = self.mix["frame_hw"]
        frame = r.integers(0, 256, (h, w, 3), dtype=np.uint8)
        n = self.mix["frames"]
        audio = r.standard_normal((n, self.cfg["audio_samples"])).astype(np.float32)
        return Request(index, frame, audio, int(r.integers(0, 2**62)), n)

    def _generator(self, req: Request) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(req.noise_seed)

    def serve(self, req: Request) -> np.ndarray:
        from lipreading_video_generation_tpu_torch.pipelines.sample_diffusion import sample_video

        out = sample_video(self.model, req.frame, req.audio, self.dcfg,
                           num_inference_steps=self.mix["ddim_steps"], eta=self.mix["eta"],
                           generator=self._generator(req))
        return out.cpu().numpy()

    @staticmethod
    def faults() -> dict:
        """What a run can get wrong, planted where the clip is sampled."""
        site = "lipreading_video_generation_tpu_torch.pipelines.sample_diffusion"
        return {"frame_inverted": (site, "sample", lambda fn: faults.altered_frames(fn, item=0))}

    # ---- the benchmark's own counts, from the shapes --------------------------------

    def attention_calls(self, req: Request) -> List[Tuple[int, int, int, int, str]]:
        """(batch, heads, tokens, head dim, "fwd") of every U-Net attention
        of a request: the flash kernel's calls (past 128 tokens)."""
        calls = []
        for c, res in unet_attention(self.cfg):
            s = res * res
            if s > 128:
                calls.append((req.n_frames, self.cfg["num_heads"], s, c // self.cfg["num_heads"],
                              "fwd"))
        return calls * self.mix["ddim_steps"]

    def model_flops(self, req: Request) -> float:
        return (self.mix["ddim_steps"] * unet_flops(self.cfg, req.n_frames)
                + condition_flops(self.cfg, req.n_frames))

    def int8_products(self, req: Request) -> list:
        return []

    # ---- the comparison ---------------------------------------------------------------

    def release(self) -> None:
        """Free the program's model before the reference runs."""
        self.model = None
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def reference_output(self, req: Request, mode: str) -> torch.Tensor:
        dev = self.device
        s, c = self.cfg["im_size"], self.cfg["im_channels"]
        x_t = torch.randn((req.n_frames, c, s, s), generator=self._generator(req), device=dev)
        model = ref.UNetAudio(self.params, self.cfg, Numerics(mode))
        with torch.no_grad():
            return ref.ddim_request(model, torch.from_numpy(req.frame).to(dev),
                                    torch.from_numpy(req.audio).to(dev), x_t,
                                    self.mix["ddim_steps"], self.mix["reference_block"])

    def compare(self, req: Request, out: np.ndarray, ref_out: torch.Tensor) -> Dict[str, float]:
        a = torch.from_numpy(np.asarray(out)).to(ref_out.device).to(torch.int16)
        gap = (a - ref_out.to(torch.int16)).abs()
        return {"max_gap": float(gap.max()), "mean_gap": float(gap.float().mean())}


# ---- FLOP counts: 2·M·N·K of every product, walked from the plan ---------------------

def unet_attention(cfg: dict) -> List[Tuple[int, int]]:
    """(channels, resolution) of each attention block of the U-Net."""
    res, out = cfg["im_size"], []
    for step in ref.plan(cfg["base_channels"], cfg["channel_mult"], cfg["num_res_blocks"],
                         cfg["attention_resolutions"]):
        if step[0] == "attn":
            out.append((step[1], res))
        elif step[0] == "down":
            res //= 2
        elif step[0] == "up":
            res *= 2
    return out


def unet_flops(cfg: dict, b: int) -> float:
    """One ε-prediction of ``b`` frames: time MLP, stem, ResBlocks,
    attention (qkv, QKᵀ, PV, projection), down/up convolutions, output."""
    base, temb, res = cfg["base_channels"], cfg["time_embed_dim"], cfg["im_size"]
    c_in = cfg["im_channels"] + cfg["audio_proj_dim"] + cfg["im_cond_channels"]

    def conv(r, cin, cout, k):
        return 2.0 * b * r * r * cout * cin * k * k

    f = 2.0 * b * (base * temb + temb * temb) + conv(res, c_in, base, 3)
    for step in ref.plan(base, cfg["channel_mult"], cfg["num_res_blocks"],
                         cfg["attention_resolutions"]):
        if step[0] == "res":
            _, cin, cout = step
            f += conv(res, cin, cout, 3) + conv(res, cout, cout, 3) + 2.0 * b * temb * 2 * cout
            if cin != cout:
                f += conv(res, cin, cout, 1)
        elif step[0] == "attn":
            c, s = step[1], res * res
            f += 2.0 * b * s * c * 4 * c + 4.0 * b * s * s * c
        elif step[0] == "down":
            f += conv(res // 2, step[1], step[1], 3)
            res //= 2
        elif step[0] == "up":
            res *= 2
            f += conv(res, step[1], step[1], 3)
    return f + conv(res, base, cfg["im_channels"], 3)


def condition_flops(cfg: dict, b: int) -> float:
    """The condition map once a request: mel projection, the audio
    encoder's convolutions and transformer blocks, its projection, the
    condition frame's 1x1 convolution."""
    e, mels = cfg["audio_embed_dim"], 80
    frames = 1 + cfg["audio_samples"] // 200
    t = (frames - 1) // 2 + 1
    f = 2.0 * b * mels * 401 * frames
    f += 2.0 * b * t * (e // 2) * mels * 5 + 2.0 * b * t * e * (e // 2) * 3
    per_block = 2.0 * b * t * e * 3 * e + 2.0 * b * t * e * e + 2.0 * 2 * b * t * e * 4 * e
    per_block += 4.0 * b * t * t * e
    f += cfg["audio_layers"] * per_block + 2.0 * b * e * cfg["audio_proj_dim"]
    s = cfg["im_size"]
    return f + 2.0 * b * s * s * cfg["im_channels"] * cfg["im_cond_channels"]


# ---- training: the ε-MSE step ----------------------------------------------------------

@dataclasses.dataclass
class Step:
    n_frames: int


class Trainer:
    """``pipelines.train_diffusion.train_step`` on one train state (model,
    EMA, Adam, its generator) built once from the seed. Batches of
    ``mix["batch"]`` uint8 target and condition frames of ``frame_hw`` and
    raw audio come from a pool of ``mix["pool"]`` host batches made from the
    seed at set-up, step i taking batch i mod pool. ``first_steps`` (set-up)
    runs the state's first ``mix["checked_steps"]`` steps through the same
    call and feed as the window and records what the reference is compared
    with: each step's loss, each leaf's first gradient (Adam's first moment
    after step 1 over 1 − β1) and each leaf's change after the last."""
    precision = "bf16"

    def __init__(self, cfg: dict, mix: dict, seed: int, device: str):
        from lipreading_video_generation_tpu_torch.pipelines.train_diffusion import new_state

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.dcfg = dataclasses.replace(diffusion_config(cfg), learning_rate=mix["lr"])
        self.params, model = model_from_seed(self.dcfg, seed, device)
        self.gen_seed = weights.derive(seed, 6)
        self.state = new_state(model, self.dcfg, self.gen_seed, device, mix["ema_rate"])
        r = weights.rng(seed, 7)
        b, (h, w) = mix["batch"], mix["frame_hw"]
        self.pool = [{"target_frame": r.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
                      "cond_frame": r.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
                      "audio": r.standard_normal((b, cfg["audio_samples"])).astype(np.float32)}
                     for _ in range(mix["pool"])]
        self.recorded = None

    def request(self, index: int) -> Step:
        return Step(self.mix["batch"])

    def step(self, index: int) -> float:
        """One training step on batch ``index`` mod pool; its loss, read on the host."""
        from lipreading_video_generation_tpu_torch.pipelines.train_diffusion import train_step

        return float(train_step(self.state, self.pool[index % len(self.pool)], self.dcfg)["loss"])

    def first_steps(self) -> None:
        model, opt = self.state.model, self.state.optimizer
        losses, grad = [], {}
        for i in range(self.mix["checked_steps"]):
            losses.append(self.step(i))
            if i == 0:
                beta1 = opt.param_groups[0]["betas"][0]
                grad = {k: opt.state[p]["exp_avg"] / (1.0 - beta1) if p in opt.state
                        else torch.zeros_like(p) for k, p in model.named_parameters()}
        with torch.no_grad():
            change = {k: p - self.params[k] for k, p in model.named_parameters()}
        self.recorded = {"loss": losses, "grad": grad, "change": change}

    @staticmethod
    def faults() -> dict:
        """What a training step can get wrong: a state left unchanged, half
        the batch left out with the mean taken over the rest."""
        site = "lipreading_video_generation_tpu_torch.pipelines.train_diffusion"
        return {"state_unchanged": (site, "apply_update", faults.state_unchanged),
                "half_batch": (site, "noise_mse", faults.half_batch)}

    # ---- the benchmark's own counts -------------------------------------------------

    def model_flops(self, req: Step) -> float:
        """Forward and backward (twice the forward) of the U-Net and the condition."""
        return 3.0 * (unet_flops(self.cfg, req.n_frames) + condition_flops(self.cfg, req.n_frames))

    def attention_calls(self, req: Step) -> list:
        calls = []
        for c, res in unet_attention(self.cfg):
            s, h = res * res, self.cfg["num_heads"]
            if s > 128:
                calls += [(req.n_frames, h, s, c // h, "fwd"), (req.n_frames, h, s, c // h, "bwd")]
        return calls

    def int8_products(self, req: Step) -> list:
        return []

    # ---- the comparison -------------------------------------------------------------

    def release(self) -> None:
        self.state = None
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def reference_record(self, mode: str, fault=None) -> dict:
        from reference import train_diffusion as ref_train

        return ref_train.train(self.params, self.cfg, self.pool[:self.mix["checked_steps"]],
                               self.gen_seed, self.mix["lr"], Numerics(mode), self.device,
                               self.mix["reference_chunk"], fault)

    @staticmethod
    def compare_records(got: dict, ref: dict) -> Dict[str, float]:
        """The first step's loss against the reference's (relative); by the
        worst leaf, the gap between the program's and the reference's norm
        of the first gradient (``grad_gap``) and of the change after the
        checked steps (``change_gap``), and the norm of the first gradient's
        difference (``grad_dir``: a half batch turns the gradient more than
        it changes its norm), each over the reference's norm of that leaf or
        of the median leaf, whichever is larger. Parameters whose reference
        gradient is nought to rounding (under a thousandth of the median
        leaf's root-mean-square gradient, as a key's bias under softmax)
        move under Adam by round-off alone: they are left out of the change,
        and a leaf with none left out of all three."""
        rms = {k: float(g.norm()) / g.numel() ** 0.5 for k, g in ref["grad"].items()}
        floor = 1e-3 * float(np.median(list(rms.values())))
        moved = {k: g.abs() >= floor for k, g in ref["grad"].items()}
        keys = [k for k in ref["grad"] if bool(moved[k].any())]

        def gap(norms_got, norms_ref):
            med = float(np.median([norms_ref[k] for k in keys]))
            return max(abs(norms_got[k] - norms_ref[k]) / max(norms_ref[k], med) for k in keys)

        norm = lambda d, k, m=None: float((d[k] if m is None else d[k][m[k]]).float().norm())
        med = float(np.median([norm(ref["grad"], k) for k in keys]))
        turn = max(float((got["grad"][k].float() - ref["grad"][k].float()).norm())
                   / max(norm(ref["grad"], k), med) for k in keys)
        return {"loss1_gap": abs(got["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0]),
                "grad_gap": gap({k: norm(got["grad"], k) for k in keys},
                                {k: norm(ref["grad"], k) for k in keys}),
                "grad_dir": turn,
                "change_gap": gap({k: norm(got["change"], k, moved) for k in keys},
                                  {k: norm(ref["change"], k, moved) for k in keys})}

    def check(self, mode: str) -> Dict[str, float]:
        """The recorded first steps against the reference's, in ``mode``."""
        return self.compare_records(self.recorded, self.reference_record(mode))

    def readings(self, reference: str, control: str, faults=()) -> Dict[str, Dict[str, float]]:
        """The program's numbers, the control's and each planted fault's
        (in the reference put in the program's place), for ``control.py``."""
        self.release()
        ref = self.reference_record(reference)
        ctrl = self.reference_record(control)
        out = {"program": self.compare_records(self.recorded, ref),
               "control": self.compare_records(ctrl, ref),
               "losses": {"program": self.recorded["loss"], "reference": ref["loss"],
                          "control": ctrl["loss"]}}
        for fault in faults:
            rec = self.reference_record(reference, fault)
            out[fault] = self.compare_records(rec, ref)
            out["losses"][fault] = rec["loss"]
        return out
