"""The typed configuration tree of the port.

Copies of ``lipreading_video_generation_tpu/core/config.py``'s dataclasses
(``AudioConfig``, ``MeshConfig``, ``GanConfig``, ``DiffusionConfig``,
``ClassifierConfig``, ``SuperResConfig``, ``ViViTConfig``,
``FeatureTransformerConfig``, ``SentenceEvalConfig``, ``PreprocessConfig``
and the root ``Config``) with the same field names and defaults, and of its
``replace`` and ``parse_overrides``, so ``--set section.key=value`` means
the same on both sides: the JAX package's ``core/__init__`` imports jax and
orbax, so the port cannot import the originals.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Sequence, Tuple


@dataclass(frozen=True)
class AudioConfig:
    """Log-mel frontend parameters (reference: gan-model/preprocessing/params.py:24-64)."""

    sample_rate: int = 16000
    n_fft: int = 800
    hop_size: int = 200
    win_size: int = 800
    num_mels: int = 80
    fmin: float = 55.0
    fmax: float = 7600.0
    preemphasis: float = 0.97
    preemphasize: bool = True
    min_level_db: float = -100.0
    ref_level_db: float = 20.0
    max_abs_value: float = 4.0
    symmetric_mels: bool = True
    signal_normalization: bool = True
    rescale: bool = True
    rescaling_max: float = 0.9

    @property
    def mel_step_per_frame(self) -> float:
        """Mel frames per video frame at 25 fps: 80 mel steps / sec ÷ 25 fps."""
        return (self.sample_rate / self.hop_size) / 25.0


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout: the ``data`` and ``model`` axes of
    ``parallel.mesh.build_mesh``, over the processes of a
    ``torch.distributed`` group (one a GPU)."""

    data_axis: str = "data"
    model_axis: str = "model"
    # -1 means "all remaining devices"
    data_parallel: int = -1
    model_parallel: int = 1
    model_shard_threshold: int = 2**22
    zero1: bool = False
    zero1_min_size: int = 2**16


@dataclass(frozen=True)
class ViViTConfig:
    """ViViT word-level lipreader (reference: lipreading/main.py:33-36,59-60,
    huggingface_vivit_model.py:18-46)."""

    image_size: int = 32
    num_frames: int = 5
    num_channels: int = 1
    tubelet_size: Tuple[int, int, int] = (1, 8, 8)  # (t, h, w) tubelet embedding
    hidden_size: int = 256
    num_layers: int = 12
    num_heads: int = 8
    mlp_dim: int = 1024
    dropout: float = 0.0
    num_classes: int = 64
    # training (huggingface_vivit_model.py:36-47)
    batch_size: int = 16
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    lr_step_epochs: int = 2
    lr_step_gamma: float = 0.2
    num_epochs: int = 10
    dtype: str = "bfloat16"
    # sequence parallelism: attention through the ring over this mesh axis
    # (ops/ring_attention.py) when it is live; pipeline parallelism: the
    # encoder blocks in stages over the model axis (parallel/pipeline.py),
    # pp_num_micro microbatches (0: the stage count)
    sequence_parallel: bool = False
    sequence_axis: str = "model"
    pipeline_parallel: bool = False
    pp_num_micro: int = 0


@dataclass(frozen=True)
class PreprocessConfig:
    """Mouth-ROI / face-crop preprocessing
    (reference: lipreading/preprocess.py, gan-model/preprocessing/preprocess.py)."""

    lip_crop_size: Tuple[int, int] = (48, 48)   # lipreading path (get_data.py:45)
    model_input_size: Tuple[int, int] = (32, 32)  # ViViT input (main.py:35-36)
    face_det_batch_size: int = 16
    gen_batch_size: int = 128
    box_smooth_T: int = 5       # inference.py:61-68
    clahe_clip_limit: float = 0.2
    clahe_grid: Tuple[int, int] = (8, 8)
    face_det_score_threshold: float = 0.5
    nms_threshold: float = 0.3


@dataclass(frozen=True)
class GanConfig:
    """Wav2Lip-style lip-sync GAN (reference: gan-model/preprocessing/params.py:67-85,
    gan-model/train_lipreading.py:31-44)."""

    img_size: int = 96
    fps: float = 25.0
    syncnet_T: int = 5          # frames per window (dataset.py:32)
    syncnet_mel_step_size: int = 16  # mel steps per window (dataset.py:33)
    batch_size: int = 16
    learning_rate: float = 1e-4
    disc_learning_rate: float = 1e-4
    adam_b1: float = 0.5        # train_lipreading.py:330-333
    adam_b2: float = 0.999
    syncnet_wt: float = 0.0     # gated to 0.03 once eval sync loss < .75
    syncnet_wt_after_gate: float = 0.03
    syncnet_gate_threshold: float = 0.75
    disc_wt: float = 0.07
    lip_weight: float = 0.0     # AV-HuBERT-style lipreading expert loss weight
    checkpoint_interval: int = 3000
    eval_interval: int = 9000
    num_epochs: int = 10**6     # train until stopped, like the reference
    dtype: str = "bfloat16"
    model_width: float = 1.0    # channel multiplier (1.0 = reference plan)
    # Serving-only int8 (ops/quant.py): every 2-D conv and Linear of the
    # generator runs quantise -> im2col -> the int8 matmul kernel K6 ->
    # dequantise, with dynamic per-tensor activation scales. Training is
    # untouched. What it costs and buys on an H100 is in PERF.md.
    serve_int8: bool = False
    # Activation scales fixed by one calibration pass at the start of a
    # request (no per-layer max reduction afterwards); needs serve_int8.
    serve_int8_static: bool = False


@dataclass(frozen=True)
class DiffusionConfig:
    """Image+audio-conditioned DDPM (reference: video-generation/diffusion/
    train.py:48-97, test.py:33-49); defaults as in the JAX package: 128×128
    frames, the as-trained U-Net channel plan, the sampling schedule of
    test.py (T=500, linear 5e-5 → 0.015), the native audio encoder, bf16."""

    im_size: int = 128
    im_channels: int = 3
    num_timesteps: int = 500
    beta_start: float = 5e-5
    beta_end: float = 0.015
    scheduler: str = "linear"   # linear | linear_v2 | cosine
    base_channels: int = 64
    channel_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (1, 2, 4)  # downsample factors with attention
    num_heads: int = 1
    dropout: float = 0.1
    time_embed_dim: int = 256
    audio_embed_dim: int = 768
    audio_proj_dim: int = 128
    im_cond_channels: int = 64
    audio_samples: int = 4000
    buffer_frames: int = 5
    # "native" = AudioFeatureEncoder (log-mel + conv + transformer);
    # "wav2vec2" = models/wav2vec2 at the w2v_* sizes (port-wav2vec2 weights).
    audio_encoder: str = "native"
    w2v_num_layers: int = 12
    w2v_ffn_dim: int = 3072
    w2v_num_heads: int = 12
    w2v_conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    w2v_conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    w2v_conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    w2v_pos_conv_kernel: int = 128
    w2v_pos_conv_groups: int = 16
    batch_size: int = 8
    learning_rate: float = 1e-4
    num_epochs: int = 10
    dtype: str = "bfloat16"
    # ResBlock rematerialisation (torch.utils.checkpoint); sequence-parallel
    # attention through the ring over ``sequence_axis`` when it is live
    remat: bool = False
    sequence_parallel: bool = False
    sequence_axis: str = "model"

    def __post_init__(self):
        if self.audio_encoder not in ("native", "wav2vec2"):
            raise ValueError(f"unknown audio_encoder {self.audio_encoder!r} (native | wav2vec2)")


@dataclass(frozen=True)
class ClassifierConfig:
    """Noisy-image classifier for classifier-guided sampling (an
    ``EncoderUNetModel``), trained on q-sampled x_t at uniform t; the
    noise schedule comes from the ``DiffusionConfig``."""

    num_classes: int = 4
    base_channels: int = 32
    channel_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 1
    attention_resolutions: Tuple[int, ...] = (4,)
    num_heads: int = 2
    time_embed_dim: int = 128
    dropout: float = 0.0
    # training
    batch_size: int = 32
    learning_rate: float = 3e-4
    dtype: str = "bfloat16"


@dataclass(frozen=True)
class SuperResConfig:
    """Diffusion super-resolution stage (a ``SuperResModel``): a
    U-Net denoises a high-res frame conditioned on its bilinearly upsampled
    low-res version; serving is the two-stage cascade (base model at
    ``low_size``, this stage lifts to ``im_size``)."""

    im_size: int = 128           # high-res output
    low_size: int = 64           # base-stage / conditioning resolution
    im_channels: int = 3
    num_timesteps: int = 500
    beta_start: float = 5e-5
    beta_end: float = 0.015
    scheduler: str = "linear"
    base_channels: int = 48
    channel_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4,)
    num_heads: int = 1
    time_embed_dim: int = 192
    dropout: float = 0.0
    # training
    batch_size: int = 8
    learning_rate: float = 1e-4
    dtype: str = "bfloat16"
    sr_inference_steps: int = 50  # few-step DDIM default for the SR stage


@dataclass(frozen=True)
class FeatureTransformerConfig:
    """Keras-transformer-over-DenseNet-features variant
    (reference: lipreading/keras_vivit_model.py:17-125, feature_extraction.py:16-19)."""

    max_seq_length: int = 5
    num_features: int = 1024
    dense_dim: int = 4
    num_heads: int = 2
    num_layers: int = 2
    dropout: float = 0.3
    head_dropout: float = 0.5
    num_classes: int = 64
    num_epochs: int = 20
    val_split: float = 0.15
    learning_rate: float = 1e-3


@dataclass(frozen=True)
class SentenceEvalConfig:
    """Beam-search sentence eval (reference: lipreading/sentence_eval.py:5-56)."""

    beam_width: int = 20
    keep_top: int = 5
    word_top_k: int = 5


@dataclass(frozen=True)
class Config:
    """Root config: one object per training/inference job."""

    audio: AudioConfig = field(default_factory=AudioConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    gan: GanConfig = field(default_factory=GanConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    classifier: ClassifierConfig = field(default_factory=ClassifierConfig)
    superres: SuperResConfig = field(default_factory=SuperResConfig)
    vivit: ViViTConfig = field(default_factory=ViViTConfig)
    feature_transformer: FeatureTransformerConfig = field(default_factory=FeatureTransformerConfig)
    sentence_eval: SentenceEvalConfig = field(default_factory=SentenceEvalConfig)
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    seed: int = 0
    checkpoint_dir: str = "checkpoints"
    data_root: str = "data/mvlrs_v1/main"
    preprocessed_root: str = "data/preprocessed"


def replace(cfg, **kwargs):
    """Functional update of a frozen config dataclass."""
    return dataclasses.replace(cfg, **kwargs)


def _coerce(value: str, target: Any) -> Any:
    if isinstance(target, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(target, int):
        return int(value)
    if isinstance(target, float):
        return float(value)
    if isinstance(target, tuple):
        parts = [p for p in value.strip("()[] ").split(",") if p.strip()]
        elem = target[0] if target else 0
        return tuple(_coerce(p.strip(), elem) for p in parts)
    return value


def parse_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    """Apply ``section.key=value`` CLI overrides to a frozen Config tree,
    e.g. ``parse_overrides(cfg, ["gan.batch_size=32", "seed=1"])``;
    ``ValueError`` on a malformed item or an unknown key."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must be key=value, got {item!r}")
        path, value = item.split("=", 1)
        keys = path.split(".")
        # walk down, collecting objects so we can rebuild immutably
        try:
            objs = [cfg]
            for k in keys[:-1]:
                objs.append(getattr(objs[-1], k))
            leaf_owner = objs[-1]
            current = getattr(leaf_owner, keys[-1])
        except AttributeError:
            raise ValueError(f"unknown config key {path!r}") from None
        new_leaf = _coerce(value, current)
        rebuilt = dataclasses.replace(leaf_owner, **{keys[-1]: new_leaf})
        for obj, k in zip(reversed(objs[:-1]), reversed(keys[:-1])):
            rebuilt = dataclasses.replace(obj, **{k: rebuilt})
        cfg = rebuilt
    return cfg
