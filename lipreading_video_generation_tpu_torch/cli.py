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

Every command runs on the card (``core.device``); ``main(argv,
device="cpu")`` runs it on the CPU, as the tests do. Packed records stream
through the native prefetch loader (``data/records``). A frame index and
``--cond-video`` are decoded with OpenCV, imported on call. The lip-expert
GAN loss and the pretrained wav2vec2 encoder are refused with the ROADMAP
item they wait for.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np

# arguments of the JAX CLI whose data or weights the port cannot read yet
_WAITING = {
    "wav2vec2_checkpoint": "--wav2vec2-checkpoint needs the pretrained wav2vec2 port "
                           "(ROADMAP §1 item 7, pretrained-model family)",
    "lip_expert_checkpoint": "--lip-expert-checkpoint needs the lip expert "
                             "(ROADMAP §1 item 7, pretrained-model family)",
    "avhubert_checkpoint": "--avhubert-checkpoint needs the AV-HuBERT port "
                           "(ROADMAP §1 item 7, pretrained-model family)",
}
_S3FD_HELP = ("torch.save'd S3FD state dict in s3fd.pth's layout; without it the face "
              "detector is drawn from a seed (its boxes are noise)")

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
    p.add_argument("--wav2vec2-checkpoint", default=None)

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
    p.add_argument("--lip-expert-checkpoint", default=None)
    p.add_argument("--avhubert-checkpoint", default=None)
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
    import torch

    from .core.prng import seeded
    from .models.s3fd import S3FD

    model = seeded(S3FD, 0)
    if checkpoint:
        model.load_state_dict(torch.load(checkpoint, map_location="cpu", weights_only=True))
    else:
        print("warning: no --s3fd-checkpoint; the face detector is random and its boxes are "
              "noise", file=sys.stderr)
    return model


def _gan_clips(args, parser):
    """(training clips, held-out clips or None) of a GAN command: the
    synthetic sets without --preprocessed-root (audio-visually correlated
    clips for train-syncnet, 18 + 2 held out), else every clip directory
    under it (train-syncnet with --eval-auc-every holds the last 2 out)."""
    from .data import datasets

    if args.synthetic or not args.preprocessed_root:
        if args.cmd == "train-syncnet":
            clips = datasets.synthetic_av_clips(n_clips=20, frames=50)
            return clips[:-2], clips[-2:]
        return datasets.synthetic_gan_clips(n_clips=8, frames=30), None
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


def _sample_diffusion(args, cfg, parser, device) -> int:
    """``sample-diffusion``: one frame (``--out`` an image) or a clip of
    ``--frames`` frames (``<out>.<j:04d>.png``, or a video for .mp4/.avi),
    conditioned on ``--cond-video`` or on inputs drawn from ``--seed`` as
    the JAX CLI draws them; the noise comes from ``torch.Generator(seed)``
    on ``device``, the SR stage's from seed + 1."""
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
        clip = sample_diffusion.sample_video(model, cond, windows, d, **sample_kw)
        if args.sr_checkpoint:
            clip = (sr(clip.float() / 255.0) * 255).to(torch.uint8)
        clip = clip.cpu().numpy()
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
    video_io.write_image(args.out, img)
    print(f"wrote {args.out} (+{snaps.shape[0]} snapshots available)")
    return 0


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """Run one subcommand; ``device`` is where it runs (``None``: the card)."""
    parser = _parser()
    args = parser.parse_args(argv)
    for name, why in _WAITING.items():
        if getattr(args, name, None) is not None:
            parser.error(why)
    try:
        cfg = build_config(args)
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
            metrics_writer=Metrics(ConsoleWriter(every=10)),
            device=device,
        )
        print(f"best: {best}")
        return 0

    if args.cmd in ("preprocess-gan", "train-gan", "train-syncnet", "eval-gan",
                    "infer-lipsync", "build-frame-index", "pack-gan-records",
                    "pack-diffusion-records", "sample-diffusion"):
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
            )
        finally:
            if records is not None:
                records.close()                  # stops the native loader's threads
        return 0

    if args.cmd == "sample-diffusion":
        return _sample_diffusion(args, cfg, parser, device)

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

    if args.cmd in ("train-gan", "train-syncnet", "eval-gan", "pack-gan-records"):
        from .core.metrics import ConsoleWriter, Metrics
        from .data.datasets import GanWindowSampler
        from .pipelines import train_gan, train_syncnet

        if cfg.gan.lip_weight > 0:
            parser.error("gan.lip_weight > 0 needs the lip expert "
                         "(ROADMAP §1 item 7, pretrained-model family)")
        records = None
        if getattr(args, "records_root", None) is not None:
            from .data.records import iter_gan_record_batches

            records = iter_gan_record_batches(args.records_root, cfg.gan.batch_size)

            def batch_fn():
                return next(records)
        else:
            clips, held_out = _gan_clips(args, parser)
            sampler = GanWindowSampler(clips, cfg.gan.syncnet_T, seed=cfg.seed)

            def batch_fn():
                return sampler.sample_batch(cfg.gan.batch_size)

        if args.cmd == "pack-gan-records":
            from .data.records import write_gan_records

            spec = write_gan_records(sampler, args.out, args.num_records)
            print(f"{args.num_records} records ({spec.record_bytes} B each) → {args.out}")
            return 0
        writer = Metrics(ConsoleWriter(every=10))
        syncnet_params = (train_syncnet.load_params(args.syncnet_checkpoint)
                          if getattr(args, "syncnet_checkpoint", None) else None)
        if args.cmd == "train-gan":
            try:
                train_gan.train(cfg.gan, batch_fn, eval_batch_fn=batch_fn, num_steps=args.steps,
                                seed=cfg.seed, checkpoint_dir=args.checkpoint_dir,
                                audio_cfg=cfg.audio, metrics_writer=writer,
                                syncnet_params=syncnet_params,
                                steps_per_dispatch=args.steps_per_dispatch, device=device)
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
                            device=device)
        print(f"wrote {args.out} ({len(res.frames)} frames, muxed={res.muxed})")
        return 0


if __name__ == "__main__":
    sys.exit(main())
