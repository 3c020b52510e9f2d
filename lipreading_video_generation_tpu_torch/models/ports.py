"""Pretrained-weight ports: torch checkpoints → the port's artifacts.

Port of ``lipreading_video_generation_tpu/models/ports.py``: read a
checkpoint on the host, convert it with the model modules' converters,
check the result against the module's own ``state_dict`` (same names, same
shapes: ``_validate_against_init``), save it.

- S3FD: the port's ``models.s3fd.S3FD`` has ``s3fd.pth``'s layout, so
  ``port_s3fd`` only validates the file and saves its float32 state dict
  (what ``--s3fd-checkpoint`` reads, like ``s3fd.pth`` itself).
- DenseNet121: the port's ``models.densenet.DenseNet121`` has torchvision's
  ``densenet121`` layout, so ``port_densenet`` drops what the JAX converter
  drops (``classifier.*``, ``num_batches_tracked``), validates the rest and
  saves it as a float32 state dict (what ``--densenet-checkpoint`` reads,
  like a torchvision ``.pth`` itself).
- AV-HuBERT (fairseq ``.pt``) and wav2vec2 (HF ``.pth``/``.bin``): an
  artifact is a directory holding ``<name>.pt`` (a ``core.checkpoint``
  file of ``{"<name>": state_dict}``) and ``<name>.config.json``, the
  architecture the converter read off the checkpoint.

Templates are built on the ``meta`` device (shapes, no memory), as the JAX
package uses ``jax.eval_shape``. Loaders return modules on the CPU with the
weights assigned (no random init first); callers move them.
"""
from __future__ import annotations

import json
import os
import sys
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn


def _load_torch_state_dict(pth_path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint as a flat dict of CPU tensors: a bare state dict
    or a ``{"state_dict": ...}`` wrapper, DataParallel's ``module.`` prefixes
    stripped."""
    obj = torch.load(pth_path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj and all(
            not torch.is_tensor(v) for k, v in obj.items() if k != "state_dict"):
        obj = obj["state_dict"]
    return {(k[len("module."):] if k.startswith("module.") else k): torch.as_tensor(v)
            for k, v in obj.items()}


def _validate_against_init(converted: Mapping[str, Any], template: Mapping[str, Any]) -> None:
    """``converted`` has exactly ``template``'s names and shapes; else
    ``ValueError`` naming the first few differences."""
    conv = {k: tuple(v.shape) for k, v in converted.items()}
    tmpl = {k: tuple(v.shape) for k, v in template.items()}
    missing, extra = sorted(set(tmpl) - set(conv)), sorted(set(conv) - set(tmpl))
    if missing or extra:
        raise ValueError(f"port mismatch: missing={missing[:5]} extra={extra[:5]} "
                         f"({len(missing)} missing / {len(extra)} extra total)")
    bad = [k for k in tmpl if tmpl[k] != conv[k]]
    if bad:
        raise ValueError(f"port shape mismatch on {bad[:5]} "
                         f"(e.g. {bad[0]}: want {tmpl[bad[0]]}, got {conv[bad[0]]})")


def _template(build: Callable[[], nn.Module]) -> Dict[str, torch.Tensor]:
    """``build()``'s ``state_dict`` on the meta device: names and shapes."""
    with torch.device("meta"):
        return build().state_dict()


def _materialise(build: Callable[[], nn.Module], state_dict: Mapping[str, torch.Tensor]
                 ) -> nn.Module:
    """``build()`` with ``state_dict`` assigned, without a random init."""
    with torch.device("meta"):
        model = build()
    model.load_state_dict({k: v.to(torch.float32) for k, v in state_dict.items()}, assign=True)
    return model


def _save_artifact(out_path: str, name: str, state_dict: Dict[str, torch.Tensor],
                   cfg: Dict[str, Any]) -> None:
    from ..core.checkpoint import save_once

    from ..parallel.distributed import write_once

    out = os.path.abspath(out_path)
    save_once(os.path.join(out, f"{name}.pt"), {name: state_dict})

    def write(tmp: str) -> None:
        with open(tmp, "w") as f:
            json.dump({k: list(v) if isinstance(v, tuple) else v for k, v in cfg.items()}, f)

    write_once(os.path.join(out, f"{name}.config.json"), write)


def _load_artifact(path: str, name: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    from ..core.checkpoint import load_once

    path = os.path.abspath(path)
    with open(os.path.join(path, f"{name}.config.json")) as f:
        cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in json.load(f).items()}
    return load_once(os.path.join(path, f"{name}.pt"))[name], cfg


# --------------------------------------------------------------------------
# S3FD
# --------------------------------------------------------------------------

def _s3fd_template() -> Dict[str, torch.Tensor]:
    from .s3fd import S3FD

    return _template(S3FD)


def port_s3fd(pth_path: str, out_path: str) -> Dict[str, torch.Tensor]:
    """``s3fd.pth`` → its validated float32 state dict saved at
    ``out_path`` (a file ``--s3fd-checkpoint`` reads); returns it."""
    from ..core.checkpoint import save_once

    sd = {k: v.to(torch.float32) for k, v in _load_torch_state_dict(pth_path).items()}
    _validate_against_init(sd, _s3fd_template())
    save_once(out_path, sd)
    return sd


def load_s3fd_params(checkpoint_path: str) -> Dict[str, torch.Tensor]:
    """A ``port-s3fd --out`` file (or ``s3fd.pth`` itself), validated."""
    sd = _load_torch_state_dict(checkpoint_path)
    _validate_against_init(sd, _s3fd_template())
    return sd


def s3fd_params_or_init(checkpoint_path: Optional[str], seed: int = 0) -> Dict[str, torch.Tensor]:
    """Ported weights when a checkpoint is given, else a seeded init with a
    warning (a random detector's boxes are noise)."""
    if checkpoint_path:
        return load_s3fd_params(checkpoint_path)
    from ..core.prng import seeded
    from .s3fd import S3FD

    print("warning: no --s3fd-checkpoint — face detector is RANDOM-INIT; detections will be "
          "garbage (run port-s3fd on s3fd.pth first)", file=sys.stderr)
    return seeded(S3FD, seed).state_dict()


# --------------------------------------------------------------------------
# DenseNet121
# --------------------------------------------------------------------------

def _densenet_template() -> Dict[str, torch.Tensor]:
    from .densenet import DenseNet121

    return _template(DenseNet121)


def load_densenet_variables(checkpoint_path: str) -> Dict[str, torch.Tensor]:
    """A ``port-densenet --out`` file or a torchvision ``densenet121``
    ``.pth`` itself → the validated float32 state dict of
    ``models.densenet.DenseNet121``."""
    from .densenet import convert_torch_state_dict

    sd = convert_torch_state_dict(_load_torch_state_dict(checkpoint_path))
    _validate_against_init(sd, _densenet_template())
    return sd


def port_densenet(pth_path: str, out_path: str) -> Dict[str, torch.Tensor]:
    """torchvision ``densenet121`` state dict → its validated float32 state
    dict saved at ``out_path`` (a file ``--densenet-checkpoint`` reads);
    returns it."""
    from ..core.checkpoint import save_once

    sd = load_densenet_variables(pth_path)
    save_once(out_path, sd)
    return sd


def densenet_variables_or_init(checkpoint_path: Optional[str], seed: int = 0
                               ) -> Dict[str, torch.Tensor]:
    """Ported imagenet weights when a checkpoint is given, else a seeded
    init with a warning: random features are still a fixed projection the
    transformer can learn against, but the reference always uses imagenet
    features."""
    if checkpoint_path:
        return load_densenet_variables(checkpoint_path)
    from ..core.prng import seeded
    from .densenet import DenseNet121

    print("warning: no --densenet-checkpoint — frame embedder is RANDOM-INIT (run "
          "port-densenet on torchvision densenet121 weights for imagenet-quality features)",
          file=sys.stderr)
    return seeded(DenseNet121, seed).state_dict()


# --------------------------------------------------------------------------
# AV-HuBERT video encoder (the frozen lipreading expert)
# --------------------------------------------------------------------------

def _load_fairseq_model_state(pth_path: str) -> Dict[str, torch.Tensor]:
    """A fairseq checkpoint's model tensors: the ``{"model": ...}`` (or
    ``{"state_dict": ...}``) wrapper unwrapped, the ``module.``,
    ``encoder.w2v_model.`` (fine-tuned seq2seq) and ``w2v_model.`` prefixes
    stripped, non-tensor entries dropped.

    A safe ``weights_only`` load is tried first; real fairseq checkpoints
    pickle their config objects (omegaconf ``DictConfig``, argparse
    ``Namespace``) beside the tensors, which it refuses, so those are read
    with ``weights_only=False`` — only for checkpoints one trusts."""
    try:
        obj = torch.load(pth_path, map_location="cpu", weights_only=True)
    except Exception:
        obj = torch.load(pth_path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    elif isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    out: Dict[str, torch.Tensor] = {}
    for k, v in obj.items():
        if not torch.is_tensor(v):
            continue
        changed = True
        while changed:
            changed = False
            for pre in ("module.", "encoder.w2v_model.", "w2v_model."):
                if k.startswith(pre):
                    k, changed = k[len(pre):], True
        out[k] = v.detach().cpu()
    return out


def _avhubert_build(cfg: Dict[str, Any]) -> Callable[[], nn.Module]:
    from .avhubert import AVHubertVideoEncoder

    return lambda: AVHubertVideoEncoder(**cfg)


def port_avhubert(pth_path: str, out_path: str, num_heads: Optional[int] = None,
                  pos_conv_groups: Optional[int] = None):
    """A fairseq AV-HuBERT checkpoint → the artifact directory ``out_path``
    (``avhubert.pt`` + ``avhubert.config.json``). Returns (state_dict,
    config, skipped keys). Heads and conv groups are not in the shapes:
    defaults embed_dim // 64 and 16, or as given."""
    from .avhubert import convert_avhubert_state_dict

    sd, cfg, skipped = convert_avhubert_state_dict(_load_fairseq_model_state(pth_path))
    if num_heads:
        cfg["num_heads"] = int(num_heads)
    if pos_conv_groups:
        cfg["pos_conv_groups"] = int(pos_conv_groups)
    _validate_against_init(sd, _template(_avhubert_build(cfg)))
    _save_artifact(out_path, "avhubert", sd, cfg)
    return sd, cfg, skipped


def load_avhubert_expert(checkpoint_path: str) -> Tuple[nn.Module, Dict[str, torch.Tensor]]:
    """A ``port-avhubert --out`` artifact → (the encoder on the CPU with its
    weights, its state dict): the GAN's frozen feature-matching expert."""
    sd, cfg = _load_artifact(checkpoint_path, "avhubert")
    return _materialise(_avhubert_build(cfg), sd), sd


# --------------------------------------------------------------------------
# wav2vec2 (the diffusion's pretrained audio conditioning)
# --------------------------------------------------------------------------

def _wav2vec2_build(cfg: Dict[str, Any]) -> Callable[[], nn.Module]:
    from .wav2vec2 import Wav2Vec2Encoder

    return lambda: Wav2Vec2Encoder(**cfg)


def port_wav2vec2(pth_path: str, out_path: str, num_heads: Optional[int] = None,
                  pos_conv_groups: Optional[int] = None):
    """An HF wav2vec2 state dict (``Wav2Vec2Model`` or the ``Wav2Vec2ForCTC``
    wrapper ``facebook/wav2vec2-base-960h`` ships as) → the artifact
    directory ``out_path`` (``wav2vec2.pt`` + ``wav2vec2.config.json``).
    Returns (state_dict, config, skipped keys)."""
    from .wav2vec2 import convert_wav2vec2_state_dict

    sd, cfg, skipped = convert_wav2vec2_state_dict(
        _load_torch_state_dict(pth_path), num_heads=num_heads, pos_conv_groups=pos_conv_groups)
    _validate_against_init(sd, _template(_wav2vec2_build(cfg)))
    _save_artifact(out_path, "wav2vec2", sd, cfg)
    return sd, cfg, skipped


def load_wav2vec2_params(checkpoint_path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """A ``port-wav2vec2 --out`` artifact → (state dict, config)."""
    sd, cfg = _load_artifact(checkpoint_path, "wav2vec2")
    _validate_against_init(sd, _template(_wav2vec2_build(cfg)))
    return sd, cfg


def diffusion_cfg_with_wav2vec2(diff_cfg: Any, w2v_cfg: Mapping[str, Any]) -> Any:
    """``diff_cfg`` with ``audio_encoder="wav2vec2"`` and the ``w2v_*``
    sizes (and ``audio_embed_dim``) of a ported encoder."""
    import dataclasses

    return dataclasses.replace(
        diff_cfg, audio_encoder="wav2vec2", audio_embed_dim=w2v_cfg["embed_dim"],
        w2v_num_layers=w2v_cfg["num_layers"], w2v_num_heads=w2v_cfg["num_heads"],
        w2v_ffn_dim=w2v_cfg["ffn_dim"], w2v_conv_dim=tuple(w2v_cfg["conv_dim"]),
        w2v_conv_kernel=tuple(w2v_cfg["conv_kernel"]),
        w2v_conv_stride=tuple(w2v_cfg["conv_stride"]),
        w2v_pos_conv_kernel=w2v_cfg["pos_conv_kernel"],
        w2v_pos_conv_groups=w2v_cfg["pos_conv_groups"])


def graft_wav2vec2_into_diffusion(diff_params: Mapping[str, torch.Tensor],
                                  w2v_params: Mapping[str, torch.Tensor]
                                  ) -> Dict[str, torch.Tensor]:
    """A ``UNetAudio`` state dict with its ``audio_encoder.*`` entries
    replaced by ported wav2vec2 weights (validated against them: the
    config must be ``diffusion_cfg_with_wav2vec2``'s)."""
    pre = "audio_encoder."
    encoder = {k[len(pre):]: v for k, v in diff_params.items() if k.startswith(pre)}
    if not encoder:
        raise ValueError("diffusion params carry no audio_encoder subtree")
    _validate_against_init(w2v_params, encoder)
    out = {k: v for k, v in diff_params.items() if not k.startswith(pre)}
    out.update({pre + k: v.to(torch.float32) for k, v in w2v_params.items()})
    return out
