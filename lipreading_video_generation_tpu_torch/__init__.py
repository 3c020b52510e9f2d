"""PyTorch/CUDA port of ``lipreading_video_generation_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package mirrors its
module paths and function names so each counterpart is easy to find:

- ``pipelines.preprocess`` — fused mouth-ROI preprocessing (crop → 48×48
  cubic → gray → CLAHE → 32×32), batched over all frames.
- ``models.vivit``         — ViViT word-classifier forward (inference).
- ``models.convert``       — Flax ViViT params → this package's ``state_dict``.
- ``ops.image`` / ``ops.attention`` — plain torch ops plus the dispatch to
  the hand-written CUDA kernels in ``csrc/`` (``ops.clahe_cuda`` and
  ``ops.attention.small_mha``), built with nvcc on first use by ``ops._build``.

Public functions keep the JAX layouts: NTHWC clips, ``(T, H, W, 3)`` uint8
frames, y1y2x1x2 boxes and ``(B, S, E)`` attention inputs. A CUDA tensor
goes through the kernels or raises; the plain torch versions run only for
CPU tensors (and in the tests that hold the kernels against them).

This package imports ``torch`` and never ``jax``, ``flax`` or the JAX package.
"""

__version__ = "0.1.0"
