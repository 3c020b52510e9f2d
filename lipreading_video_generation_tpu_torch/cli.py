"""The port's command line: the JAX package's ``cli.py`` subcommands that the
port can serve, on the same typed config tree and ``--set section.key=value``
overrides (``core.config.parse_overrides``).

Usage:
  python -m lipreading_video_generation_tpu_torch.cli train-vivit --steps 1000
  python -m lipreading_video_generation_tpu_torch.cli build-frame-index \\
      --data-root data/mvlrs_v1/main --out frames.pkl
  python -m lipreading_video_generation_tpu_torch.cli pack-diffusion-records \\
      --frame-index frames.pkl --out recs/ --num-records 10000
  python -m lipreading_video_generation_tpu_torch.cli train-diffusion --records-root recs/ \\
      --steps 1000 --checkpoint-dir ckpt/
  python -m lipreading_video_generation_tpu_torch.cli sample-diffusion --checkpoint ckpt/ \\
      --frames 25 --ddim-steps 50 --out clip
  python -m lipreading_video_generation_tpu_torch.cli train-superres --synthetic
  python -m lipreading_video_generation_tpu_torch.cli train-noisy-classifier \\
      --synthetic --out clf.pt
  python -m lipreading_video_generation_tpu_torch.cli train-landmark --out lm/
  python -m lipreading_video_generation_tpu_torch.cli lipread-e2e \\
      --data-root data/mvlrs_v1/main --landmark-checkpoint lm/
  python -m lipreading_video_generation_tpu_torch.cli preprocess-gan \\
      --data-root data/mvlrs_v1/main --out data/preprocessed
  python -m lipreading_video_generation_tpu_torch.cli train-syncnet --synthetic \\
      --steps 1000 --out sync.pt
  python -m lipreading_video_generation_tpu_torch.cli pack-gan-records \\
      --preprocessed-root data/preprocessed --out gan_recs/
  python -m lipreading_video_generation_tpu_torch.cli train-gan --records-root gan_recs/ \\
      --syncnet-checkpoint sync.pt --checkpoint-dir gan/
  python -m lipreading_video_generation_tpu_torch.cli eval-gan --checkpoint gan/ \\
      --syncnet-checkpoint sync.pt --synthetic
  python -m lipreading_video_generation_tpu_torch.cli infer-lipsync \\
      --face face.mp4 --audio speech.wav --out result.mp4 --checkpoint gan/ --int8
  python -m lipreading_video_generation_tpu_torch.cli port-wav2vec2 \\
      --pth wav2vec2-base-960h.bin --out w2v/
  python -m lipreading_video_generation_tpu_torch.cli train-diffusion --synthetic \\
      --wav2vec2-checkpoint w2v/ --checkpoint-dir ckpt/
  python -m lipreading_video_generation_tpu_torch.cli port-avhubert --pth base_vox.pt --out av/
  python -m lipreading_video_generation_tpu_torch.cli train-lip-expert --synthetic \\
      --steps 1000 --out expert.pt
  python -m lipreading_video_generation_tpu_torch.cli train-gan --synthetic \\
      --set gan.lip_weight=0.1 --lip-expert-checkpoint expert.pt   # or --avhubert-checkpoint av/
  python -m lipreading_video_generation_tpu_torch.cli port-densenet --pth densenet121.pth \\
      --out densenet.pt
  python -m lipreading_video_generation_tpu_torch.cli train-feature-transformer \\
      --data-root data/mvlrs_v1/main --densenet-checkpoint densenet.pt

Every command runs on the card (``core.device``); ``main(argv,
device="cpu")`` runs it on the CPU, as the tests do. Under torchrun
(``python -m torch.distributed.run --nproc-per-node N -m
lipreading_video_generation_tpu_torch.cli <command>``) each process joins the
process group (``parallel.distributed.initialize``, its own card) and the
trainers and ``sample-diffusion --frames`` / ``infer-lipsync`` run
data-parallel over the mesh, as the JAX CLI's do over its devices; the
primary rank writes the outputs. ``--set mesh.*`` lays out the mesh
(``build_mesh``; a layout the process count does not fit is a usage error). Packed records stream
through the native prefetch loader (``data/records``). A frame index and
``--cond-video`` are decoded with OpenCV, imported on call. The ``port-*``
commands take exactly one of ``--pth`` (a published checkpoint) or
``--selftest`` (one written in its layout here).
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np

# commands of the JAX CLI the port does not serve yet
_WAITING = ()
_S3FD_HELP = ("torch.save'd S3FD state dict in s3fd.pth's layout (s3fd.pth itself or port-s3fd "
              "--out); without it the face detector is drawn from a seed (its boxes are noise)")
_SELFTEST_HELP = ("write a checkpoint in the published layout here (torch.save, seeded values), "
                  "run the whole port path on it, then the model on the artifact; prints a "
                  "JSON summary")

_DISPATCH_HELP = ("batches taken from the feed at once, cut at checkpoints and evals, and "
                  "run as that many ordinary steps (the port has no multi-step device "
                  "program; the results are those of 1)")


def _base_parser(sub, name, help_):
    p = sub.add_parser(name, help=help_)
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   help="config override section.key=value")
    p.add_argument("--seed", type=int, default=0)
    return p


def build_config(args):
    from .core.config import Config, parse_overrides, replace

    cfg = Config()
    cfg = replace(cfg, seed=args.seed)
    return parse_overrides(cfg, args.overrides)


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="lvg-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = _base_parser(sub, "train-vivit", "train the ViViT lipreader")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic word clips (no dataset needed)")

    p = _base_parser(sub, "build-frame-index", "videos → diffusion FrameItem index")
    p.add_argument("--data-root", required=True,
                   help="LRS2-layout tree of <id>.mp4 (+ <id>.txt); frame counts from OpenCV")
    p.add_argument("--out", required=True, help="index pickle")
    p.add_argument("--step", type=int, default=6)

    p = _base_parser(sub, "pack-diffusion-records",
                     "pre-sample diffusion frame pairs into fixed-shape records for the "
                     "native prefetch loader")
    p.add_argument("--frame-index", default=None,
                   help="build-frame-index output (videos decoded with OpenCV)")
    p.add_argument("--out", required=True)
    p.add_argument("--num-records", type=int, default=1000)
    p.add_argument("--synthetic", action="store_true")

    p = _base_parser(sub, "train-diffusion", "train the conditional DDPM")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--frame-index", default=None,
                   help="build-frame-index output (videos decoded with OpenCV)")
    p.add_argument("--records-root", default=None,
                   help="packed-record dir (pack-diffusion-records --out): stream batches "
                        "through the native C++ prefetch loader")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--steps-per-dispatch", type=int, default=4, help=_DISPATCH_HELP)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--wav2vec2-checkpoint", default=None,
                   help="port-wav2vec2 --out artifact: the audio encoder starts from these "
                        "weights and trains jointly; sets diffusion.audio_encoder=wav2vec2 and "
                        "the w2v_* sizes from the artifact's config")

    p = _base_parser(sub, "sample-diffusion", "reverse-diffusion sampling")
    p.add_argument("--checkpoint", default=None,
                   help="train-diffusion checkpoint dir (latest step) or a file of "
                        "{'params': ...}; without it the model is drawn from --seed")
    p.add_argument("--no-ema", action="store_true",
                   help="sample with the raw params instead of the EMA")
    p.add_argument("--cond-video", default=None,
                   help="video to take the condition frame and audio from (OpenCV)")
    p.add_argument("--cond-audio", default=None,
                   help="wav for conditioning (defaults to the video's audio)")
    p.add_argument("--frames", type=int, default=1,
                   help=">1: a clip, all frames denoised as one batch over sliding "
                        "per-frame audio windows; written as <out>.<j:04d>.png, or as "
                        "video for a .mp4/.avi --out (OpenCV)")
    p.add_argument("--fps", type=float, default=25.0,
                   help="output fps when no --cond-video supplies one")
    p.add_argument("--ddim-steps", type=int, default=None,
                   help="few-step sampling over a strided timestep subsequence; default "
                        "the full num_timesteps DDPM chain")
    p.add_argument("--sampler", choices=("ddim", "dpmpp"), default="ddim",
                   help="few-step update rule (with --ddim-steps): ddim or DPM-Solver++(2M)")
    p.add_argument("--eta", type=float, default=0.0,
                   help="DDIM stochasticity: 0 deterministic, 1 DDPM-matched variance")
    p.add_argument("--classifier-checkpoint", default=None,
                   help="train-noisy-classifier artifact: classifier guidance")
    p.add_argument("--class-label", type=int, default=0)
    p.add_argument("--guidance-scale", type=float, default=2.0)
    p.add_argument("--sr-checkpoint", default=None,
                   help="train-superres checkpoint: two-stage cascade (diffusion.im_size "
                        "must equal superres.low_size)")
    p.add_argument("--sr-steps", type=int, default=None,
                   help="DDIM steps of the SR stage (default superres.sr_inference_steps)")
    p.add_argument("--out", required=True,
                   help="image path (.png written without OpenCV), or the clip's prefix")

    p = _base_parser(sub, "train-superres",
                     "train the SuperResModel diffusion SR stage (low_size → im_size cascade)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--frame-index", default=None,
                   help="build-frame-index output for real frames (OpenCV); omit for synthetic")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--steps-per-dispatch", type=int, default=4, help=_DISPATCH_HELP)
    p.add_argument("--synthetic", action="store_true")

    p = _base_parser(sub, "train-noisy-classifier",
                     "train the EncoderUNetModel classifier on q-sampled noisy images "
                     "for classifier-guided sampling")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--synthetic", action="store_true",
                   help="class-k-lights-quadrant-k synthetic task")
    p.add_argument("--out", required=True,
                   help="artifact path (a torch.save file of the classifier's state_dict)")

    p = _base_parser(sub, "train-landmark",
                     "train the lip-landmark regressor (MediaPipe-parity mouth crops)")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--out", default=None, help="save trained landmark params here")

    p = _base_parser(sub, "lipread-e2e", "LRS2 → word clips → ViViT train → sentence eval")
    p.add_argument("--data-root", required=True,
                   help="LRS2-layout tree of <id>.mp4 + <id>.txt (decoded with OpenCV)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--max-clips", type=int, default=None)
    p.add_argument("--landmark-checkpoint", default=None,
                   help="trained lip-landmark params (train-landmark --out); "
                        "defaults to the geometric mouth-box estimate")
    p.add_argument("--s3fd-checkpoint", default=None, help=_S3FD_HELP)

    p = _base_parser(sub, "preprocess-gan", "videos → face crops + wav (offline)")
    p.add_argument("--data-root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--filelist", default=None)
    p.add_argument("--host-id", type=int, default=0)
    p.add_argument("--num-hosts", type=int, default=1)
    p.add_argument("--s3fd-checkpoint", default=None, help=_S3FD_HELP)

    p = _base_parser(sub, "pack-gan-records",
                     "pre-sample GAN training windows into fixed-shape records for the "
                     "native prefetch loader")
    p.add_argument("--preprocessed-root", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--num-records", type=int, default=1000)
    p.add_argument("--synthetic", action="store_true")

    p = _base_parser(sub, "train-gan", "train the lip-sync GAN")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--preprocessed-root", default=None,
                   help="preprocess-gan output root (clip directories of {i}.jpg + audio.wav)")
    p.add_argument("--records-root", default=None,
                   help="packed-record dir (pack-gan-records --out): stream batches through "
                        "the native C++ prefetch loader")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--syncnet-checkpoint", default=None,
                   help="pretrained frozen sync expert (train-syncnet --out)")
    p.add_argument("--lip-expert-checkpoint", default=None,
                   help="train-lip-expert --out: the frozen seq2seq lip expert of the "
                        "gan.lip_weight > 0 loss (transcript batches)")
    p.add_argument("--avhubert-checkpoint", default=None,
                   help="port-avhubert --out: AV-HuBERT's video encoder as the frozen "
                        "feature-matching lip expert; excludes --lip-expert-checkpoint")
    p.add_argument("--steps-per-dispatch", type=int, default=8, help=_DISPATCH_HELP)
    p.add_argument("--synthetic", action="store_true")

    p = _base_parser(sub, "eval-gan",
                     "PSNR/SSIM/L1/sync metrics of a trained generator over a dataset")
    p.add_argument("--checkpoint", required=True,
                   help="train-gan checkpoint dir or a save_once file of {'gen': ...}")
    p.add_argument("--syncnet-checkpoint", default=None)
    p.add_argument("--preprocessed-root", default=None)
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--synthetic", action="store_true")

    p = _base_parser(sub, "train-syncnet", "pretrain the SyncNet expert")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--preprocessed-root", default=None,
                   help="preprocess-gan output root; --eval-auc-every holds out 2 clips "
                        "for the discrimination report")
    p.add_argument("--objective", choices=("infonce_hard", "infonce", "bce"),
                   default="infonce_hard")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--eval-auc-every", type=int, default=0,
                   help="report the aligned-vs-shifted AUC on held-out clips every N steps")
    p.add_argument("--out", default=None,
                   help="save the trained expert here (train-gan/eval-gan "
                        "--syncnet-checkpoint)")

    p = _base_parser(sub, "train-lip-expert",
                     "pretrain the text-conditioned lipreading expert (character seq2seq)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--synthetic", action="store_true",
                   help="word-coded synthetic clips (the mouth's motion codes the word)")
    p.add_argument("--preprocessed-root", default=None,
                   help="preprocess-gan output root whose clips carry text.txt transcripts")
    p.add_argument("--out", default=None,
                   help="save the expert here (train-gan --lip-expert-checkpoint)")

    for name, what, out in (("port-s3fd", "the S3FD face detector's s3fd.pth",
                             "the artifact (--s3fd-checkpoint)"),
                            ("port-densenet", "a torchvision densenet121 state dict (the "
                             "imagenet frame embedder)", "the artifact (--densenet-checkpoint)"),
                            ("port-avhubert", "a fairseq AV-HuBERT checkpoint's video encoder "
                             "(the frozen lip expert)",
                             "the artifact directory (--avhubert-checkpoint)"),
                            ("port-wav2vec2", "an HF wav2vec2 state dict (Wav2Vec2Model or "
                             "Wav2Vec2ForCTC, e.g. facebook/wav2vec2-base-960h)",
                             "the artifact directory (--wav2vec2-checkpoint)")):
        p = _base_parser(sub, name, f"port {what} to the port's artifact")
        p.add_argument("--pth", default=None, help="the checkpoint to port")
        p.add_argument("--selftest", action="store_true", help=_SELFTEST_HELP)
        p.add_argument("--out", required=True, help=out)
        if name in ("port-avhubert", "port-wav2vec2"):
            p.add_argument("--num-heads", type=int, default=None,
                           help="attention heads (not in the shapes; default embed_dim // 64)")
            p.add_argument("--pos-conv-groups", type=int, default=None,
                           help="positional-conv groups (default: AV-HuBERT 16, wav2vec2 read "
                                "off the weight's shape)")
    for name in _WAITING:
        _base_parser(sub, name, "not served by the port yet")

    p = _base_parser(sub, "train-feature-transformer",
                     "DenseNet121 frame features → small transformer classifier (the "
                     "reference's Keras path)")
    p.add_argument("--data-root", default=None,
                   help="LRS2-style tree (videos decoded with OpenCV); omit (or --synthetic) "
                        "for synthetic word clips")
    p.add_argument("--max-clips", type=int, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--densenet-checkpoint", default=None,
                   help="port-densenet --out file or a torchvision densenet121 .pth; without "
                        "it the frame embedder is drawn from --seed")
    p.add_argument("--s3fd-checkpoint", default=None, help=_S3FD_HELP)
    p.add_argument("--landmark-checkpoint", default=None,
                   help="trained lip-landmark params (train-landmark --out)")

    p = _base_parser(sub, "infer-lipsync", "lip-sync a video to an audio track")
    p.add_argument("--face", required=True)
    p.add_argument("--audio", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="train-gan checkpoint dir (latest step) or save_once file; without "
                        "it the generator is drawn from --seed")
    p.add_argument("--static", action="store_true")
    p.add_argument("--pads", type=int, nargs=4, default=[0, 10, 0, 0],
                   metavar=("PADY1", "PADY2", "PADX1", "PADX2"))
    p.add_argument("--resize-factor", type=int, default=1)
    p.add_argument("--crop", type=int, nargs=4, default=[0, -1, 0, -1],
                   metavar=("Y1", "Y2", "X1", "X2"))
    p.add_argument("--rotate", action="store_true")
    p.add_argument("--nosmooth", action="store_true")
    p.add_argument("--s3fd-checkpoint", default=None, help=_S3FD_HELP)
    p.add_argument("--int8", action="store_true",
                   help="every generator conv through the int8 matmul kernel, dynamic scales")
    p.add_argument("--int8-static", action="store_true",
                   help="int8 with activation scales calibrated at the start of the request")
    return parser


def _s3fd(checkpoint: Optional[str]):
    """The face detector: ``checkpoint``'s weights, or drawn from seed 0
    (with a warning: its detections are noise)."""
    from .models.ports import s3fd_params_or_init
    from .models.s3fd import S3FD

    model = S3FD()
    model.load_state_dict(s3fd_params_or_init(checkpoint))
    return model


def _gan_clips(args, parser, with_text: bool = False):
    """(training clips, held-out clips or None) of a GAN command: the
    synthetic sets without --preprocessed-root (audio-visually correlated
    clips for train-syncnet, 18 + 2 held out; word-coded clips for
    train-lip-expert; transcripts drawn with them ``with_text``), else every
    clip directory under it (train-syncnet with --eval-auc-every holds the
    last 2 out)."""
    from .data import datasets

    if args.synthetic or not args.preprocessed_root:
        if args.cmd == "train-syncnet":
            clips = datasets.synthetic_av_clips(n_clips=20, frames=50, with_text=with_text)
            return clips[:-2], clips[-2:]
        if args.cmd == "train-lip-expert":
            return datasets.synthetic_word_av_clips(n_clips=24, frames=40), None
        return datasets.synthetic_gan_clips(n_clips=8, frames=30, with_text=with_text), None
    import os

    clips = [datasets.load_gan_clip(root) for root, _, files in os.walk(args.preprocessed_root)
             if "audio.wav" in files]
    if not clips:
        parser.error(f"no clip directory (audio.wav) under {args.preprocessed_root!r}")
    if args.cmd == "train-syncnet" and args.eval_auc_every:
        if len(clips) >= 4:
            return clips[:-2], clips[-2:]
        print("warning: --eval-auc-every needs >= 4 clips to hold 2 out; AUC report disabled")
    return clips, None


class _SyntheticPairSampler:
    """Diffusion pairs of uniform-noise frames at the train size and
    Gaussian audio, drawn from ``np.random.default_rng(seed)`` in the JAX
    CLI's order (so packed records equal its bytes)."""

    def __init__(self, d, seed: int):
        self.d, self.rng = d, np.random.default_rng(seed)

    def sample_batch(self, n: int):
        d, rng = self.d, self.rng
        return {
            "cond_frame": rng.integers(0, 256, (n, d.im_size, d.im_size, 3), dtype=np.uint8),
            "target_frame": rng.integers(0, 256, (n, d.im_size, d.im_size, 3), dtype=np.uint8),
            "audio": rng.standard_normal((n, d.audio_samples)).astype(np.float32),
        }


def _say(msg: str) -> None:
    """Print on the primary rank only."""
    from .parallel.distributed import is_primary

    if is_primary():
        print(msg)


def _sample_diffusion(args, cfg, parser, device, mesh) -> int:
    """``sample-diffusion``: one frame (``--out`` an image) or a clip of
    ``--frames`` frames (``<out>.<j:04d>.png``, or a video for .mp4/.avi;
    its frames data-parallel over ``mesh``, as in the JAX CLI),
    conditioned on ``--cond-video`` or on inputs drawn from ``--seed`` as
    the JAX CLI draws them; the noise comes from ``torch.Generator(seed)``
    on ``device``, the SR stage's from seed + 1. The primary rank writes."""
    from .parallel.distributed import is_primary

    import torch

    from .core.prng import seeded
    from .data import video as video_io
    from .models.unet_audio import UNetAudio
    from .pipelines import sample_diffusion, train_diffusion

    d = cfg.diffusion
    if args.sr_checkpoint and d.im_size != cfg.superres.low_size:
        parser.error(f"cascade mismatch: diffusion.im_size {d.im_size} != superres.low_size "
                     f"{cfg.superres.low_size} (set --set diffusion.im_size="
                     f"{cfg.superres.low_size} or superres.low_size)")
    model = seeded(lambda: UNetAudio(d), cfg.seed)
    if args.checkpoint:
        model.load_state_dict(train_diffusion.load_sampling_params(
            args.checkpoint, use_ema=not args.no_ema))
    model = model.to(device).eval()
    guidance_kw = {}
    if args.classifier_checkpoint:
        from .pipelines import train_classifier

        guidance_kw = dict(
            classifier_cfg=cfg.classifier,
            classifier_params=train_classifier.load_classifier_params(
                args.classifier_checkpoint),
            class_label=args.class_label, guidance_scale=args.guidance_scale)
    sample_kw = dict(num_inference_steps=args.ddim_steps, eta=args.eta, sampler=args.sampler,
                     generator=torch.Generator(device).manual_seed(cfg.seed), **guidance_kw)

    def sr(x01: torch.Tensor) -> torch.Tensor:
        """The cascade's second stage on [0, 1] frames; the identity without
        --sr-checkpoint."""
        if not args.sr_checkpoint:
            return x01
        from .pipelines import train_superres

        sr_model = seeded(lambda: train_superres.make_sr_model(cfg.superres), cfg.seed)
        sr_model.load_state_dict(train_superres.load_sr_params(args.sr_checkpoint,
                                                               use_ema=not args.no_ema))
        return sample_diffusion.sample_superres(
            sr_model.to(device).eval(), x01, cfg.superres, num_inference_steps=args.sr_steps,
            generator=torch.Generator(device).manual_seed(cfg.seed + 1))

    rng = np.random.default_rng(cfg.seed)
    if args.frames > 1:
        fps = args.fps
        if args.cond_video:
            from .data.datasets import condition_windows_from_video

            cond, windows, fps = condition_windows_from_video(args.cond_video, d, args.frames,
                                                              audio_path=args.cond_audio)
        else:
            cond = rng.integers(0, 256, (d.im_size, d.im_size, 3), dtype=np.uint8)
            windows = rng.standard_normal((args.frames, d.audio_samples)).astype(np.float32)
        clip = sample_diffusion.sample_video(model, cond, windows, d, mesh_spec=mesh, **sample_kw)
        if args.sr_checkpoint:
            clip = (sr(clip.float() / 255.0) * 255).to(torch.uint8)
        clip = clip.cpu().numpy()
        if not is_primary():
            return 0
        if args.out.endswith((".mp4", ".avi")):
            video_io.write_video(args.out, clip, fps=fps)
        else:
            for j, frame in enumerate(clip):
                video_io.write_png(f"{args.out}.{j:04d}.png", frame)
        print(f"wrote {args.frames}-frame clip → {args.out}")
        return 0
    if args.cond_video:
        from .data.datasets import condition_from_video

        cond, audio = condition_from_video(args.cond_video, d, audio_path=args.cond_audio)
        cond, audio = cond[None], audio[None]
    else:
        cond = rng.integers(0, 256, (1, d.im_size, d.im_size, 3), dtype=np.uint8)
        audio = rng.standard_normal((1, d.audio_samples)).astype(np.float32)
    x0, snaps = sample_diffusion.sample(model, cond, audio, d, **sample_kw)
    img = (sr(x0)[0] * 255).to(torch.uint8).cpu().numpy()
    if not is_primary():
        return 0
    video_io.write_image(args.out, img)
    print(f"wrote {args.out} (+{snaps.shape[0]} snapshots available)")
    return 0


def _port(args, device) -> int:
    """``port-s3fd`` / ``port-densenet`` / ``port-avhubert`` / ``port-wav2vec2``: ``--pth``
    through the port path, or ``--selftest`` (JSON summary)."""
    import json

    from .models import ports, selftest

    name = args.cmd[len("port-"):]
    if args.selftest:
        run = getattr(selftest, f"selftest_{name}")
        print(json.dumps({"selftest": args.cmd, **run(args.out, device=device)}))
        return 0
    if name == "s3fd":
        ports.port_s3fd(args.pth, args.out)
        print(f"ported s3fd.pth → {args.out}")
        return 0
    if name == "densenet":
        ports.port_densenet(args.pth, args.out)
        print(f"ported densenet121 → {args.out}")
        return 0
    _, pcfg, skipped = getattr(ports, f"port_{name}")(
        args.pth, args.out, num_heads=args.num_heads, pos_conv_groups=args.pos_conv_groups)
    what = "AV-HuBERT video" if name == "avhubert" else "wav2vec2"
    print(f"ported {what} encoder → {args.out} (embed {pcfg['embed_dim']}, "
          f"{pcfg['num_layers']} layers, {len(skipped)} keys skipped)")
    return 0


def _train_lip_expert(args, cfg, batch_fn, writer, device) -> int:
    """``train-lip-expert``: Adam steps of the seq2seq expert on transcript
    batches; ``--out`` saves ``{"lip_expert": state_dict}``."""
    from .core.metrics import to_host
    from .pipelines import train_lip_expert

    state = train_lip_expert.create_state(cfg.seed, syncnet_T=cfg.gan.syncnet_T, device=device)
    for step in range(args.steps):
        writer.write(step, to_host(train_lip_expert.train_step(state, batch_fn())))
    if args.out:
        from .core.checkpoint import save_once

        save_once(args.out, {"lip_expert": {k: v.cpu() for k, v in
                                            state.model.state_dict().items()}})
        print(f"saved expert → {args.out}")
    return 0


def _train_feature_transformer(args, cfg, parser, device) -> int:
    """``train-feature-transformer``: word clips (synthetic, or from an LRS2
    tree through ``build_word_clip_dataset``) fixed to
    ``max_seq_length`` frames → DenseNet121 features → ``train``; prints the
    validation accuracy and loss."""
    from .core.config import replace
    from .core.device import resolve_device
    from .core.metrics import ConsoleWriter, Metrics
    from .data.datasets import WordClipSampler, synthetic_word_clips
    from .models.ports import densenet_variables_or_init
    from .pipelines import feature_extraction

    device = resolve_device(device)     # before any data is read or made
    ft = cfg.feature_transformer
    if args.synthetic or not args.data_root:
        clips, labels = synthetic_word_clips(n=args.max_clips or 256, t=ft.max_seq_length,
                                             num_classes=ft.num_classes)
        labels = np.asarray(labels, np.int32)
    else:
        from .data.manifest import build_manifest
        from .pipelines.lipreading_e2e import build_word_clip_dataset

        records, _ = build_manifest(args.data_root, require_transcript=True)
        landmark = None
        if args.landmark_checkpoint:
            from .pipelines.train_landmark import load_params

            landmark = load_params(args.landmark_checkpoint, device=device)
        ds = build_word_clip_dataset(cfg, records, s3fd_params=_s3fd(args.s3fd_checkpoint),
                                     max_clips=args.max_clips, landmark_params=landmark,
                                     device=device)
        if not ds.clips:
            parser.error(f"no word clips extracted from {args.data_root!r}")
        clips, labels = ds.clips, ds.labels
        ft = replace(ft, num_classes=max(2, len(ds.vocab)))
    fixer = WordClipSampler(clips, labels, ft.max_seq_length)
    stacked = np.stack([fixer._fix(c) for c in clips])     # (N, T, H, W, 1)
    variables = densenet_variables_or_init(args.densenet_checkpoint, cfg.seed)
    feats = feature_extraction.embed_frames(
        variables, stacked, batch_frames=min(512, len(stacked) * stacked.shape[1]),
        device=device)
    n_train = len(clips) - max(1, int(ft.val_split * len(clips)))
    _, val = feature_extraction.train(ft, feats, labels, seed=cfg.seed,
                                      batch_size=min(64, max(1, n_train)),
                                      metrics_writer=Metrics(ConsoleWriter(every=10)),
                                      device=device)
    print(f"val accuracy={val['accuracy']:.4f} loss={val['loss']:.4f}")
    return 0


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """Run one subcommand; ``device`` is where it runs (``None``: the card,
    the rank's own under torchrun, which this call joins to the process
    group and leaves at the end)."""
    import torch.distributed as dist

    from .parallel import distributed

    started = not dist.is_initialized()
    distributed.initialize(device=device)
    if dist.is_initialized():
        _say(f"[distributed] backend {dist.get_backend()}, world size {dist.get_world_size()}, "
             f"device {distributed.rank_device() or device}")
    try:
        return _main(argv, device)
    finally:
        if started:
            distributed.shutdown()


def _main(argv: Optional[List[str]], device) -> int:
    parser = _parser()
    args, unknown = parser.parse_known_args(argv)
    if args.cmd in _WAITING:
        parser.error(f"{args.cmd} is not served by the port yet")
    if unknown:
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    if args.cmd.startswith("port-") and bool(args.selftest) == bool(args.pth):
        parser.error(f"{args.cmd}: give exactly one of --pth or --selftest")
    if getattr(args, "lip_expert_checkpoint", None) and getattr(args, "avhubert_checkpoint", None):
        parser.error("--lip-expert-checkpoint and --avhubert-checkpoint are mutually exclusive")
    try:
        cfg = build_config(args)
        from .parallel.mesh import build_mesh

        mesh = build_mesh(cfg.mesh)
    except (ValueError, NotImplementedError) as e:
        parser.error(str(e))

    if args.cmd == "train-vivit":
        from .core.metrics import ConsoleWriter, Metrics
        from .data.datasets import WordClipSampler, synthetic_word_clips
        from .pipelines import train_vivit

        clips, labels = synthetic_word_clips(n=512, num_classes=cfg.vivit.num_classes)
        sampler = WordClipSampler(clips, labels, max_frames=cfg.vivit.num_frames)
        state, best = train_vivit.train(
            cfg,
            lambda: sampler.batches(cfg.vivit.batch_size),
            lambda: sampler.batches(cfg.vivit.batch_size, shuffle=False),
            num_epochs=max(1, args.steps // max(1, len(clips) // cfg.vivit.batch_size)),
            mesh_spec=mesh, metrics_writer=Metrics(ConsoleWriter(every=10)),
            device=device,
        )
        _say(f"best: {best}")
        return 0

    if args.cmd.startswith("port-"):
        return _port(args, device)

    if args.cmd in ("preprocess-gan", "train-gan", "train-syncnet", "eval-gan",
                    "infer-lipsync", "build-frame-index", "pack-gan-records",
                    "pack-diffusion-records", "sample-diffusion", "train-lip-expert"):
        from .core.device import resolve_device

        device = resolve_device(device)     # before any data is read or made

    if args.cmd == "build-frame-index":
        from .data.datasets import build_frame_index, save_frame_index
        from .data.manifest import build_manifest

        records, _ = build_manifest(args.data_root)
        items = build_frame_index([r.video_path for r in records], step=args.step)
        save_frame_index(items, args.out)
        print(f"{len(items)} frame pairs → {args.out}")
        return 0

    if args.cmd in ("train-diffusion", "pack-diffusion-records"):
        from .core.metrics import ConsoleWriter, Metrics
        from .pipelines import train_diffusion

        d = cfg.diffusion
        if getattr(args, "wav2vec2_checkpoint", None):
            from .core.config import replace
            from .models.ports import diffusion_cfg_with_wav2vec2, load_wav2vec2_params

            try:
                w2v_cfg = load_wav2vec2_params(args.wav2vec2_checkpoint)[1]
            except FileNotFoundError as e:
                parser.error(f"--wav2vec2-checkpoint: no port-wav2vec2 artifact ({e})")
            d = diffusion_cfg_with_wav2vec2(d, w2v_cfg)
            cfg = replace(cfg, diffusion=d)
        records = None
        if args.cmd == "train-diffusion" and args.records_root is not None:
            from .data.records import iter_record_batches

            records = iter_record_batches(args.records_root, d.batch_size)
        elif args.synthetic or not args.frame_index:
            sampler = _SyntheticPairSampler(d, cfg.seed)
        else:
            from .data.datasets import DiffusionPairSampler, load_frame_index

            sampler = DiffusionPairSampler(load_frame_index(args.frame_index), d.audio_samples,
                                           d.buffer_frames)
        if args.cmd == "pack-diffusion-records":
            from .data.records import write_diffusion_records

            spec = write_diffusion_records(sampler, args.out, args.num_records, d.im_size)
            print(f"{args.num_records} records ({spec.record_bytes} B each) → {args.out}")
            return 0
        batch_fn = ((lambda: next(records)) if records is not None
                    else (lambda: sampler.sample_batch(d.batch_size)))
        try:
            train_diffusion.train(
                d, batch_fn, num_steps=args.steps, seed=cfg.seed,
                checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
                metrics_writer=Metrics(ConsoleWriter(every=10)),
                steps_per_dispatch=args.steps_per_dispatch,
                eval_batch_fn=batch_fn,          # held-out pull from the feed
                eval_every=args.checkpoint_every, device=device,
                wav2vec2_checkpoint=args.wav2vec2_checkpoint,
            )
        finally:
            if records is not None:
                records.close()                  # stops the native loader's threads
        return 0

    if args.cmd == "sample-diffusion":
        return _sample_diffusion(args, cfg, parser, device, mesh)

    if args.cmd == "train-superres":
        from .core.metrics import ConsoleWriter, Metrics
        from .pipelines import train_superres

        s = cfg.superres
        if args.synthetic or not args.frame_index:
            rng = np.random.default_rng(cfg.seed)
            batch_fn = lambda: {"target_frame": rng.integers(  # noqa: E731
                0, 256, (s.batch_size, s.im_size, s.im_size, 3), dtype=np.uint8)}
        else:
            from .data.datasets import DiffusionPairSampler, load_frame_index

            pairs = DiffusionPairSampler(load_frame_index(args.frame_index),
                                         cfg.diffusion.audio_samples,
                                         cfg.diffusion.buffer_frames)
            batch_fn = lambda: {  # noqa: E731
                "target_frame": pairs.sample_batch(s.batch_size)["target_frame"]}
        train_superres.train(
            s, batch_fn, num_steps=args.steps, seed=cfg.seed, checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            metrics_writer=Metrics(ConsoleWriter(every=10)),
            steps_per_dispatch=args.steps_per_dispatch, device=device,
        )
        return 0

    if args.cmd == "train-noisy-classifier":
        from .pipelines import train_classifier

        if not args.synthetic:
            parser.error("train-noisy-classifier currently supports "
                         "--synthetic (labeled image datasets are external)")
        rng = np.random.default_rng(cfg.seed)
        state = train_classifier.train(
            cfg.classifier, cfg.diffusion,
            lambda: train_classifier.synthetic_batch(rng, cfg.classifier, cfg.diffusion),
            num_steps=args.steps, seed=cfg.seed, device=device)
        train_classifier.save_classifier(args.out, state)
        print(f"trained noisy classifier → {args.out} "
              f"({cfg.classifier.num_classes} classes)")
        return 0

    if args.cmd == "train-landmark":
        from .pipelines import train_landmark

        train_landmark.train(num_steps=args.steps, batch_size=args.batch_size, seed=cfg.seed,
                             checkpoint_dir=args.out, device=device)
        if args.out:
            print(f"saved landmark params → {args.out}")
        return 0

    if args.cmd == "train-feature-transformer":
        return _train_feature_transformer(args, cfg, parser, device)

    if args.cmd == "lipread-e2e":
        from .pipelines import lipreading_e2e

        _, stats = lipreading_e2e.run(
            cfg, args.data_root, num_epochs=args.epochs, max_clips=args.max_clips,
            landmark_checkpoint=args.landmark_checkpoint,
            s3fd_checkpoint=args.s3fd_checkpoint, device=device)
        print(f"word accuracy={stats.get('accuracy'):.4f} "
              f"sentence accuracy={stats.get('sentence_accuracy'):.4f}")
        return 0

    if args.cmd == "preprocess-gan":
        from .data.manifest import build_manifest, read_filelist
        from .pipelines.offline_preprocess import preprocess_dataset

        filelist = read_filelist(args.filelist) if args.filelist else None
        records, skipped = build_manifest(args.data_root, filelist)
        print(f"{len(records)} clips ({skipped} skipped)")
        s3fd = _s3fd(args.s3fd_checkpoint).to(device).eval()
        ok, failed = preprocess_dataset(s3fd, records, args.out, cfg.preprocess,
                                        args.host_id, args.num_hosts)
        print(f"ok={ok} failed={failed}")
        return 0

    if args.cmd in ("train-gan", "train-syncnet", "eval-gan", "pack-gan-records",
                    "train-lip-expert"):
        from .core.metrics import ConsoleWriter, Metrics
        from .data.datasets import GanWindowSampler
        from .pipelines import train_gan, train_syncnet

        want_text = args.cmd == "train-lip-expert" or cfg.gan.lip_weight > 0
        records = None
        if getattr(args, "records_root", None) is not None:
            from .data.records import iter_gan_record_batches

            records = iter_gan_record_batches(args.records_root, cfg.gan.batch_size)

            def batch_fn():
                return next(records)
        else:
            clips, held_out = _gan_clips(args, parser, want_text)
            have_text = any(c.text for c in clips)
            if args.cmd == "train-lip-expert" and not have_text:
                parser.error("train-lip-expert needs transcripts, but no clip under the "
                             "dataset root has a text sidecar (text.txt); use --synthetic")
            sampler = GanWindowSampler(clips, cfg.gan.syncnet_T, seed=cfg.seed,
                                       with_text=want_text and have_text)

            def batch_fn():
                return sampler.sample_batch(cfg.gan.batch_size)

        if args.cmd == "pack-gan-records":
            from .data.records import write_gan_records

            spec = write_gan_records(sampler, args.out, args.num_records)
            print(f"{args.num_records} records ({spec.record_bytes} B each) → {args.out}")
            return 0
        writer = Metrics(ConsoleWriter(every=10))
        if args.cmd == "train-lip-expert":
            return _train_lip_expert(args, cfg, batch_fn, writer, device)
        syncnet_params = (train_syncnet.load_params(args.syncnet_checkpoint)
                          if getattr(args, "syncnet_checkpoint", None) else None)
        if args.cmd == "train-gan":
            expert = {}
            if args.lip_expert_checkpoint:
                from .pipelines import train_lip_expert

                expert["lip_expert_params"] = train_lip_expert.load_params(
                    args.lip_expert_checkpoint)
            elif args.avhubert_checkpoint:
                from .models.ports import load_avhubert_expert

                expert["lip_expert_model"], _ = load_avhubert_expert(args.avhubert_checkpoint)
            try:
                train_gan.train(cfg.gan, batch_fn, eval_batch_fn=batch_fn, num_steps=args.steps,
                                seed=cfg.seed, checkpoint_dir=args.checkpoint_dir,
                                audio_cfg=cfg.audio, metrics_writer=writer,
                                syncnet_params=syncnet_params,
                                steps_per_dispatch=args.steps_per_dispatch, device=device,
                                **expert)
            finally:
                if records is not None:
                    records.close()              # stops the native loader's threads
            return 0
        if args.cmd == "eval-gan":
            from .core.metrics import RunningMean, to_host

            state = train_gan.create_state(cfg.gan, cfg.seed, syncnet_params, device)
            state.gen.load_state_dict(train_gan.load_generator_params(args.checkpoint))
            mean = RunningMean()
            for _ in range(args.batches):
                mean.update(to_host(train_gan.gan_eval_step(state, batch_fn(), cfg.gan,
                                                            cfg.audio)))
            for k, v in sorted(mean.means().items()):
                print(f"{k}: {v:.4f}")
            if not args.syncnet_checkpoint:
                print("note: eval/sync_loss used an untrained SyncNet "
                      "(pass --syncnet-checkpoint)")
            return 0
        state = train_syncnet.train(cfg.gan, batch_fn, num_steps=args.steps, seed=cfg.seed,
                                    lr=args.lr, objective=args.objective,
                                    metrics_writer=writer, eval_clips=held_out,
                                    eval_every=args.eval_auc_every, audio_cfg=cfg.audio,
                                    device=device)
        if held_out is not None:
            from .pipelines.expert_proof import alignment_scores, auc

            pos, neg = alignment_scores(state.model, cfg.gan, held_out, seed=cfg.seed,
                                        audio_cfg=cfg.audio)
            print(f"held-out discrimination AUC={auc(pos, neg):.3f} "
                  "(aligned vs ±6-frame shifted mels)")
        if args.out:
            from .core.checkpoint import save_once

            save_once(args.out, {"syncnet": {k: v.cpu() for k, v in
                                             state.model.state_dict().items()}})
            print(f"saved sync expert → {args.out}")
        return 0

    if args.cmd == "infer-lipsync":
        import dataclasses

        from .core.prng import seeded
        from .models.generator import TalkingFaceGenerator
        from .pipelines import train_gan
        from .pipelines.inference import lipsync_video

        if args.checkpoint:
            gen_params = train_gan.load_generator_params(args.checkpoint)
        else:
            gen_params = seeded(lambda: TalkingFaceGenerator(width=cfg.gan.model_width),
                                cfg.seed).state_dict()
        gan_cfg = cfg.gan
        if args.int8 or args.int8_static:
            gan_cfg = dataclasses.replace(cfg.gan, serve_int8=True,
                                          serve_int8_static=args.int8_static)
        res = lipsync_video(gen_params, _s3fd(args.s3fd_checkpoint), args.face, args.audio,
                            args.out, gan_cfg, cfg.audio, cfg.preprocess,
                            static_frame=args.static, model_width=cfg.gan.model_width,
                            pads=tuple(args.pads), resize_factor=args.resize_factor,
                            crop=tuple(args.crop), rotate=args.rotate, nosmooth=args.nosmooth,
                            mesh_spec=mesh, device=device)
        _say(f"wrote {args.out} ({len(res.frames)} frames, muxed={res.muxed})")
        return 0


if __name__ == "__main__":
    sys.exit(main())
