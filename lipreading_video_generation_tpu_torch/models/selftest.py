"""Port selftests: write a checkpoint in the published layout, run the whole
port path on it, then run the model on the ported artifact.

Port of ``lipreading_video_generation_tpu/models/selftest.py``. The
published binaries (``s3fd.pth``, torchvision's ``densenet121``, the fairseq
AV-HuBERT ``.pt``, ``facebook/wav2vec2-base-960h``) are not in the
repository and are not fetched, so each selftest writes a
real file with ``torch.save`` — the exact key layout, seeded values — drives
the same ``port_*`` function the CLI runs on a user's file, loads the
artifact back and runs the model on it, on ``device`` (None: the card).

``make_wav2vec2_selftest_pth`` writes a ``Wav2Vec2ForCTC``-layout state
dict from the port's own key list (``wav2vec2.hf_key_map``) and a seeded
``torch.Generator``, with either serialisation of the weight-normed
positional conv, so it needs no ``transformers``; the comparison with HF's
own class is in the CPU tests.
"""
from __future__ import annotations

import hashlib
import os
from typing import Any, Dict

import numpy as np
import torch

from ..core.checkpoint import atomic_save
from ..core.device import resolve_device

SMALL_WAV2VEC2 = dict(embed_dim=64, num_layers=2, num_heads=4, ffn_dim=128,
                      conv_dim=(24, 24, 24), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
                      pos_conv_kernel=16, pos_conv_groups=4)
BASE_WAV2VEC2 = dict(embed_dim=768, num_layers=12, num_heads=12, ffn_dim=3072,
                     conv_dim=(512,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
                     conv_stride=(5, 2, 2, 2, 2, 2, 2), pos_conv_kernel=128, pos_conv_groups=16)
BASE_AVHUBERT = dict(embed=768, layers=12, base=64, ffn=3072, pos_kernel=128)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _src_path(out_path: str, suffix: str) -> str:
    pth = os.path.abspath(out_path.rstrip("/")) + suffix
    os.makedirs(os.path.dirname(pth), exist_ok=True)
    return pth


# ---------------------------------------------------------------------------
# S3FD
# ---------------------------------------------------------------------------

def make_s3fd_selftest_pth(pth_path: str, seed: int = 0) -> str:
    """An ``s3fd.pth``-layout state dict with detector-like seeded weights:
    fan-in-scaled backbone, L2Norm scales near 10/8/5, confidence heads
    biased to the background with enough spread that some positions fire
    above 0.5, small box heads."""
    from . import ports

    rng = np.random.default_rng(seed)
    conf_w = {"conv3_3_norm_mbox_conf": 3.5, "conv4_3_norm_mbox_conf": 3.5,
              "conv5_3_norm_mbox_conf": 2.1, "fc7_mbox_conf": 0.015,
              "conv6_2_mbox_conf": 0.015, "conv7_2_mbox_conf": 0.015}
    l2_scale = {"conv3_3_norm": 10.0, "conv4_3_norm": 8.0, "conv5_3_norm": 5.0}
    sd: Dict[str, torch.Tensor] = {}
    for key, tmpl in ports._s3fd_template().items():
        mod, leaf = key.rsplit(".", 1)
        shape = tuple(tmpl.shape)
        if leaf == "weight" and len(shape) == 4:             # drawn HWIO, stored OIHW
            co, ci, kh, kw = shape
            std = (2.0 / (kh * kw * ci)) ** 0.5
            if "mbox_conf" in mod:
                std *= conf_w[mod]
            elif "mbox_loc" in mod:
                std *= 0.02
            w = rng.standard_normal((kh, kw, ci, co)) * std
            sd[key] = torch.from_numpy(w.astype(np.float32).transpose(3, 2, 0, 1).copy())
        elif leaf == "weight":                                 # L2Norm scale
            sd[key] = torch.from_numpy(
                (l2_scale[mod] + 0.01 * rng.standard_normal(shape)).astype(np.float32))
        elif "mbox_conf" in mod:
            b = np.full(shape, 1.2, np.float32)
            b[-1] = -1.2
            sd[key] = torch.from_numpy(b + 0.1 * rng.standard_normal(shape).astype(np.float32))
        else:
            scale = 0.05 if "mbox_loc" in mod else 0.01
            sd[key] = torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))
    atomic_save(pth_path, sd)
    return pth_path


def selftest_s3fd(out_path: str, seed: int = 0, device=None) -> Dict[str, Any]:
    """.pth → ``port_s3fd`` → load → detections on a 128×128 image."""
    from . import ports
    from . import s3fd as sf

    device = resolve_device(device)
    pth = make_s3fd_selftest_pth(_src_path(out_path, ".selftest_src.pth"), seed)
    ports.port_s3fd(pth, out_path)
    model = sf.S3FD()
    model.load_state_dict(ports.load_s3fd_params(out_path))
    img = np.random.default_rng(seed + 1).uniform(0, 255, (1, 128, 128, 3)).astype(np.float32)
    boxes, _, valid = sf.detect_faces(model.to(device).eval(), torch.from_numpy(img),
                                      max_faces=32)
    n = int(valid[0].sum())
    if n < 1:
        raise RuntimeError("port selftest FAILED: ported detector produced no detections "
                           "(the seeded recipe is known to fire >0.5 at 128²)")
    kept = boxes[0][valid[0]].cpu().numpy()
    return {"pth": pth, "pth_sha256": _sha256(pth), "artifact": out_path, "n_detections": n,
            "first_box": [round(float(v), 2) for v in kept[0]]}


# ---------------------------------------------------------------------------
# DenseNet121
# ---------------------------------------------------------------------------

def make_densenet_selftest_pth(pth_path: str, seed: int = 0) -> str:
    """A torchvision-``densenet121``-layout state dict with seeded weights:
    fan-in-scaled conv kernels, BatchNorm scales near 1, small biases and
    means, variances in [0.5, 1.5). The draws are the JAX package's, in its
    order (every kernel drawn HWIO and stored OIHW, the scales and biases
    module by module, then the means and variances), so the two write the
    same tensors for a seed."""
    from . import ports

    rng = np.random.default_rng(seed)
    tmpl = ports._densenet_template()
    sd: Dict[str, torch.Tensor] = {}
    for key, t in tmpl.items():                       # Flax's params tree
        leaf, shape = key.rsplit(".", 1)[1], tuple(t.shape)
        if leaf == "weight" and len(shape) == 4:
            co, ci, kh, kw = shape
            w = rng.standard_normal((kh, kw, ci, co)) * (2.0 / (kh * kw * ci)) ** 0.5
            sd[key] = torch.from_numpy(w.astype(np.float32).transpose(3, 2, 0, 1).copy())
        elif leaf == "weight":
            sd[key] = torch.from_numpy((1.0 + 0.05 * rng.standard_normal(shape)).astype(np.float32))
        elif leaf == "bias":
            sd[key] = torch.from_numpy((0.05 * rng.standard_normal(shape)).astype(np.float32))
    for key, t in tmpl.items():                       # then its batch_stats tree
        leaf, shape = key.rsplit(".", 1)[1], tuple(t.shape)
        if leaf == "running_mean":
            sd[key] = torch.from_numpy((0.1 * rng.standard_normal(shape)).astype(np.float32))
        elif leaf == "running_var":
            sd[key] = torch.from_numpy((0.5 + rng.uniform(0, 1, shape)).astype(np.float32))
    atomic_save(pth_path, sd)
    return pth_path


def selftest_densenet(out_path: str, seed: int = 0, device=None) -> Dict[str, Any]:
    """.pth → ``port_densenet`` → load → pooled 1024-d features of two
    64×64 images on ``device`` (None: the card)."""
    from . import ports
    from .densenet import DenseNet121

    device = resolve_device(device)
    pth = make_densenet_selftest_pth(_src_path(out_path, ".selftest_src.pth"), seed)
    ports.port_densenet(pth, out_path)
    model = ports._materialise(DenseNet121, ports.load_densenet_variables(out_path))
    img = np.random.default_rng(seed + 1).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        feats = model.to(device).eval()(torch.from_numpy(img).to(device)).cpu().numpy()
    if not np.all(np.isfinite(feats)) or float(np.abs(feats).sum()) == 0.0:
        raise RuntimeError("port selftest FAILED: non-finite or all-zero features")
    return {"pth": pth, "pth_sha256": _sha256(pth), "artifact": out_path,
            "feature_shape": list(feats.shape),
            "feature_l2": round(float(np.linalg.norm(feats)), 4)}


# ---------------------------------------------------------------------------
# AV-HuBERT video encoder
# ---------------------------------------------------------------------------

def make_avhubert_selftest_pth(pth_path: str, seed: int = 0, embed: int = 64, layers: int = 2,
                               base: int = 8, ffn: int = 128, pos_kernel: int = 16) -> str:
    """A fairseq-AV-HuBERT-layout checkpoint (``{"model": sd}``: resnet.py's
    ResEncoder and wav2vec2's TransformerEncoder key scheme, live BatchNorm
    statistics, 16 positional-conv groups) at the given sizes, with two
    keys a real checkpoint carries and the converter skips."""
    rng = np.random.default_rng(seed)

    def t(shape, scale=None):
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        s = scale if scale is not None else (2.0 / max(fan_in, 1)) ** 0.5
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(np.float32))

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = t((c,), 0.0) + 1.0
        sd[f"{prefix}.bias"] = t((c,), 0.05)
        sd[f"{prefix}.running_mean"] = t((c,), 0.1)
        sd[f"{prefix}.running_var"] = torch.from_numpy(
            (0.5 + rng.uniform(0, 1, (c,))).astype(np.float32))
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(1000)

    sd: Dict[str, torch.Tensor] = {}
    vp = "feature_extractor_video.resnet"
    sd[f"{vp}.frontend3D.0.weight"] = t((base, 1, 5, 7, 7))
    bn(f"{vp}.frontend3D.1", base)
    sd[f"{vp}.frontend3D.2.weight"] = t((base,), 0.0) + 0.25
    c_prev = base
    for li in range(1, 5):
        c = base * 2 ** (li - 1)
        for bi in range(2):
            tp = f"{vp}.trunk.layer{li}.{bi}"
            cin = c_prev if bi == 0 else c
            sd[f"{tp}.conv1.weight"] = t((c, cin, 3, 3))
            bn(f"{tp}.bn1", c)
            sd[f"{tp}.relu1.weight"] = t((c,), 0.0) + 0.25
            sd[f"{tp}.conv2.weight"] = t((c, c, 3, 3))
            bn(f"{tp}.bn2", c)
            sd[f"{tp}.relu2.weight"] = t((c,), 0.0) + 0.25
            if bi == 0 and li > 1:
                sd[f"{tp}.downsample.0.weight"] = t((c, cin, 1, 1))
                bn(f"{tp}.downsample.1", c)
        c_prev = c
    sd["feature_extractor_video.proj.weight"] = t((embed, 8 * base))
    sd["feature_extractor_video.proj.bias"] = t((embed,), 0.01)
    sd["layer_norm.weight"] = t((2 * embed,), 0.0) + 1.0
    sd["layer_norm.bias"] = t((2 * embed,), 0.01)
    sd["post_extract_proj.weight"] = t((embed, 2 * embed))
    sd["post_extract_proj.bias"] = t((embed,), 0.01)
    groups = 16
    sd["encoder.pos_conv.0.weight_v"] = t((embed, embed // groups, pos_kernel))
    sd["encoder.pos_conv.0.weight_g"] = t((1, 1, pos_kernel), 0.0) + 1.0
    sd["encoder.pos_conv.0.bias"] = t((embed,), 0.01)
    sd["encoder.layer_norm.weight"] = t((embed,), 0.0) + 1.0
    sd["encoder.layer_norm.bias"] = t((embed,), 0.01)
    for i in range(layers):
        lp = f"encoder.layers.{i}"
        for p in ("q", "k", "v", "out"):
            sd[f"{lp}.self_attn.{p}_proj.weight"] = t((embed, embed))
            sd[f"{lp}.self_attn.{p}_proj.bias"] = t((embed,), 0.01)
        sd[f"{lp}.self_attn_layer_norm.weight"] = t((embed,), 0.0) + 1.0
        sd[f"{lp}.self_attn_layer_norm.bias"] = t((embed,), 0.01)
        sd[f"{lp}.fc1.weight"] = t((ffn, embed))
        sd[f"{lp}.fc1.bias"] = t((ffn,), 0.01)
        sd[f"{lp}.fc2.weight"] = t((embed, ffn))
        sd[f"{lp}.fc2.bias"] = t((embed,), 0.01)
        sd[f"{lp}.final_layer_norm.weight"] = t((embed,), 0.0) + 1.0
        sd[f"{lp}.final_layer_norm.bias"] = t((embed,), 0.01)
    sd["final_proj.weight"] = t((embed, embed))
    sd["mask_emb"] = t((embed,), 0.02)
    atomic_save(pth_path, {"model": sd})
    return pth_path


def selftest_avhubert(out_path: str, seed: int = 0, device=None) -> Dict[str, Any]:
    """fairseq .pt → ``port_avhubert`` → load → encoder features on video."""
    from . import ports

    device = resolve_device(device)
    pth = make_avhubert_selftest_pth(_src_path(out_path, ".selftest_src.pt"), seed)
    _, cfg, skipped = ports.port_avhubert(pth, out_path)
    model, _ = ports.load_avhubert_expert(out_path)
    video = np.random.default_rng(seed + 1).standard_normal((1, 3, 88, 88, 1)).astype(np.float32)
    with torch.no_grad():
        feats = model.to(device).eval()(torch.from_numpy(video).to(device)).cpu().numpy()
    if not np.all(np.isfinite(feats)):
        raise RuntimeError("port selftest FAILED: non-finite encoder features")
    return {"pth": pth, "pth_sha256": _sha256(pth), "artifact": out_path, "config": cfg,
            "skipped_keys": len(skipped), "feature_shape": list(feats.shape),
            "feature_l2": round(float(np.linalg.norm(feats)), 4)}


# ---------------------------------------------------------------------------
# wav2vec2
# ---------------------------------------------------------------------------

def make_wav2vec2_selftest_pth(pth_path: str, seed: int = 0, weight_norm: str = "weight_g",
                               **sizes) -> str:
    """A ``Wav2Vec2ForCTC``-layout state dict (``wav2vec2.``-prefixed
    encoder keys, ``masked_spec_embed``, a 32-token ``lm_head``) at
    ``sizes`` (default ``SMALL_WAV2VEC2``), drawn from a seeded
    ``torch.Generator`` (fan-in-scaled weights, norms near (1, 0));
    ``weight_norm`` picks the positional conv's serialisation:
    ``"weight_g"`` (``weight_g``/``weight_v``) or ``"parametrizations"``
    (``parametrizations.weight.original0/1``)."""
    from .ports import _template, _wav2vec2_build
    from .wav2vec2 import _POS, WEIGHT_NORM_LAYOUTS, hf_key_map

    cfg = dict(SMALL_WAV2VEC2, **sizes)
    shapes = {k: tuple(v.shape) for k, v in _template(_wav2vec2_build(cfg)).items()}
    gen = torch.Generator().manual_seed(seed)

    def draw(shape, key):
        if key.endswith(("ln.weight", "ln.bias", "gn.weight", "gn.bias")):
            base = torch.ones if key.endswith("weight") else torch.zeros
            return base(shape) + 0.05 * torch.randn(shape, generator=gen)
        if len(shape) == 1:
            return 0.02 * torch.randn(shape, generator=gen)
        fan_in = int(np.prod(shape[1:]))
        return torch.randn(shape, generator=gen) * (1.0 / fan_in) ** 0.5

    sd = {f"wav2vec2.{hf}": draw(shapes[port], port)
          for hf, port in hf_key_map(len(cfg["conv_dim"]), cfg["num_layers"])}
    g_name, v_name = WEIGHT_NORM_LAYOUTS[weight_norm]
    e, k = cfg["embed_dim"], cfg["pos_conv_kernel"]
    sd[f"wav2vec2.{_POS}.{v_name}"] = draw((e, e // cfg["pos_conv_groups"], k), "pos_v")
    sd[f"wav2vec2.{_POS}.{g_name}"] = 1.0 + 0.1 * torch.rand((1, 1, k), generator=gen)
    sd["wav2vec2.masked_spec_embed"] = torch.rand((e,), generator=gen)
    sd["lm_head.weight"] = draw((32, e), "lm_head")
    sd["lm_head.bias"] = torch.zeros(32)
    atomic_save(pth_path, sd)
    return pth_path


def selftest_wav2vec2(out_path: str, seed: int = 0, device=None) -> Dict[str, Any]:
    """HF-layout .pth → ``port_wav2vec2`` → load → the ported encoder's
    weights against the file's (the positional conv recomposed in float64)
    → grafted into a small ``UNetAudio`` → ``encode_condition`` and one
    denoise step."""
    from ..core.config import DiffusionConfig
    from ..core.prng import seeded
    from . import ports
    from .unet_audio import UNetAudio
    from .wav2vec2 import _t, _weight_norm

    device = resolve_device(device)
    pth = make_wav2vec2_selftest_pth(_src_path(out_path, ".selftest_src.pth"), seed)
    ports.port_wav2vec2(pth, out_path, num_heads=SMALL_WAV2VEC2["num_heads"])
    w2v, w2v_cfg = ports.load_wav2vec2_params(out_path)
    src = torch.load(pth, map_location="cpu", weights_only=True)
    pos = "wav2vec2.encoder.pos_conv_embed.conv"
    want = _weight_norm(src[f"{pos}.weight_g"].numpy(), src[f"{pos}.weight_v"].numpy())
    err = float((w2v["pos_conv.weight"] - want).abs().max())
    if err != 0.0 or not torch.equal(w2v["proj.weight"], _t(
            src["wav2vec2.feature_projection.projection.weight"].numpy())):
        raise RuntimeError("port selftest FAILED: ported weights differ from the file's")
    cfg = ports.diffusion_cfg_with_wav2vec2(
        DiffusionConfig(im_size=16, base_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                        attention_resolutions=(2,), num_heads=2, time_embed_dim=64,
                        audio_proj_dim=16, im_cond_channels=8, audio_samples=1600,
                        num_timesteps=10, dtype="float32"), w2v_cfg)
    unet = seeded(lambda: UNetAudio(cfg), seed)
    unet.load_state_dict(ports.graft_wav2vec2_into_diffusion(unet.state_dict(), w2v))
    unet = unet.to(device).eval()
    wave = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (1, cfg.audio_samples)).astype(np.float32)).to(device)
    with torch.no_grad():
        cond = unet.encode_condition(wave, torch.zeros(1, 3, 16, 16, device=device))
        eps = unet.denoise(torch.zeros(1, 3, 16, 16, device=device), cond,
                           torch.zeros(1, dtype=torch.long, device=device))
    if not (torch.isfinite(cond).all() and torch.isfinite(eps).all()):
        raise RuntimeError("port selftest FAILED: non-finite conditioning or denoise output")
    return {"pth": pth, "pth_sha256": _sha256(pth), "artifact": out_path,
            "config": {k: list(v) if isinstance(v, tuple) else v for k, v in w2v_cfg.items()},
            "cond_map_shape": list(cond.shape), "eps_shape": list(eps.shape)}
