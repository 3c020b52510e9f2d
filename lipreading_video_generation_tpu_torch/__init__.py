"""PyTorch/CUDA port of ``lipreading_video_generation_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package mirrors its
module paths and function names so each counterpart is easy to find:

- ``pipelines.preprocess`` — fused mouth-ROI preprocessing (crop → 48×48
  cubic → gray → CLAHE → 32×32), batched over all frames.
- ``models.vivit`` / ``pipelines.train_vivit`` — ViViT word classifier:
  forward, training (AdamW, staircase schedule, dropout, eval, best-accuracy
  snapshot; ``data.datasets``, ``data.loader``, ``core.metrics``),
  ``predict_step`` and ``predict_step_int8``.
- ``pipelines.lipreading_e2e`` — the lipreading chain end to end: LRS2
  records (``data.manifest``, ``data.video``) → S3FD face tracks
  (``models.s3fd``, ``ops.bbox``, ``pipelines.inference.detect_face_tracks``,
  ``models.face_api``) → mouth boxes (geometric, or ``models.lip_landmark``
  trained by ``pipelines.train_landmark``) → ROI → word clips → ViViT →
  sentence eval scored by the causal word LM (``pipelines.sentence_eval``,
  ``models.word_lm``; ``pipelines.phonetics``); ``core.checkpoint``.
- ``cli`` — the command line (``train-vivit``, ``train-diffusion``,
  ``train-superres``, ``train-noisy-classifier``, ``train-landmark``,
  ``lipread-e2e``) on ``core.config``'s ``Config`` tree and ``--set``
  overrides.
- ``pipelines.sample_diffusion``, ``train_diffusion``, ``train_superres``,
  ``train_classifier`` — audio+image-conditioned diffusion: sampling,
  training, the super-resolution cascade, classifier guidance
  (``models.unet``, ``unet_audio``, ``audio_encoder``, ``schedulers``).
- ``pipelines.inference`` — lip-sync serving from decoded frames
  (``generate_frames``) with ``models.generator`` and int8 serving
  (``ops.quant``).
- ``models.convert``       — Flax params → this package's ``state_dict``s.
- ``ops.image`` / ``ops.audio`` / ``ops.attention`` / ``ops.matmul_cuda`` —
  plain torch ops plus the dispatch to the hand-written CUDA kernels in
  ``csrc/`` (CLAHE, small MHA, flash attention forward and backward, the
  int8/bf16 matmul), built with nvcc on first use by ``ops._build``.
- ``bench.microbench_int8`` — the matmul kernel against the library's calls.

Public functions keep the JAX layouts: NTHWC clips, ``(T, H, W, 3)`` uint8
frames, y1y2x1x2 boxes and ``(B, S, E)`` attention inputs. A CUDA tensor
goes through the kernels or raises; the plain torch versions run only for
CPU tensors (and in the tests that hold the kernels against them). Entry
points that take a ``device`` run on the card unless told otherwise
(``core.device``).

This package imports ``torch`` and never ``jax``, ``flax`` or the JAX package.
"""

__version__ = "0.1.0"
