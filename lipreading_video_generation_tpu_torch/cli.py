"""The port's command line: the JAX package's ``cli.py`` subcommands that the
port can serve, on the same typed config tree and ``--set section.key=value``
overrides (``core.config.parse_overrides``).

Usage:
  python -m lipreading_video_generation_tpu_torch.cli train-vivit --steps 1000
  python -m lipreading_video_generation_tpu_torch.cli train-diffusion --synthetic \\
      --steps 1000 --checkpoint-dir ckpt/
  python -m lipreading_video_generation_tpu_torch.cli train-superres --synthetic
  python -m lipreading_video_generation_tpu_torch.cli train-noisy-classifier \\
      --synthetic --out clf.pt
  python -m lipreading_video_generation_tpu_torch.cli train-landmark --out lm/
  python -m lipreading_video_generation_tpu_torch.cli lipread-e2e \\
      --data-root data/mvlrs_v1/main --landmark-checkpoint lm/

Every command runs on the card (``core.device``); ``main(argv,
device="cpu")`` runs it on the CPU, as the tests do. Data other than the
synthetic sets (a frame index, packed records) and the pretrained wav2vec2
encoder are refused with the ROADMAP item they wait for.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np

# arguments of the JAX CLI whose data or weights the port cannot read yet
_WAITING = {
    "frame_index": "--frame-index needs the diffusion frame index of data/datasets "
                   "(ROADMAP §1 item 6, data plumbing)",
    "records_root": "--records-root needs the packed-record loader data/records "
                    "(ROADMAP §1 item 6, data plumbing)",
    "wav2vec2_checkpoint": "--wav2vec2-checkpoint needs the pretrained wav2vec2 port "
                           "(ROADMAP §1 item 7, pretrained-model family)",
}


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

    p = _base_parser(sub, "train-diffusion", "train the conditional DDPM")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--frame-index", default=None)
    p.add_argument("--records-root", default=None)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--wav2vec2-checkpoint", default=None)

    p = _base_parser(sub, "train-superres",
                     "train the SuperResModel diffusion SR stage (low_size → im_size cascade)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--frame-index", default=None)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=500)
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
    p.add_argument("--s3fd-checkpoint", default=None,
                   help="torch.save'd S3FD state dict in s3fd.pth's layout; without "
                        "it the face detector is drawn from a seed")
    return parser


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

    if args.cmd == "train-diffusion":
        from .core.metrics import ConsoleWriter, Metrics
        from .pipelines import train_diffusion

        d = cfg.diffusion
        rng = np.random.default_rng(cfg.seed)

        def batch_fn():
            return {
                "cond_frame": rng.integers(0, 256, (d.batch_size, d.im_size, d.im_size, 3),
                                           dtype=np.uint8),
                "target_frame": rng.integers(0, 256, (d.batch_size, d.im_size, d.im_size, 3),
                                             dtype=np.uint8),
                "audio": rng.standard_normal((d.batch_size, d.audio_samples)).astype(np.float32),
            }

        train_diffusion.train(
            d, batch_fn, num_steps=args.steps, seed=cfg.seed,
            checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
            metrics_writer=Metrics(ConsoleWriter(every=10)),
            eval_batch_fn=batch_fn,          # held-out pull from the feed
            eval_every=args.checkpoint_every, device=device,
        )
        return 0

    if args.cmd == "train-superres":
        from .core.metrics import ConsoleWriter, Metrics
        from .pipelines import train_superres

        s = cfg.superres
        rng = np.random.default_rng(cfg.seed)
        train_superres.train(
            s, lambda: {"target_frame": rng.integers(
                0, 256, (s.batch_size, s.im_size, s.im_size, 3), dtype=np.uint8)},
            num_steps=args.steps, seed=cfg.seed, checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            metrics_writer=Metrics(ConsoleWriter(every=10)), device=device,
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


if __name__ == "__main__":
    sys.exit(main())
