"""Weights bridge: Flax params → the port's ``state_dict``s.

``vivit_state_dict_from_flax`` for the ViViT (``vivit_pp_state_dict_from_flax``
from the JAX package's pipeline layout, and ``flax_vivit_params_from_state_dict``
back to either Flax layout); ``unet_audio_state_dict_from_flax``
(with ``unet_state_dict_from_flax`` and ``audio_encoder_state_dict_from_flax``)
for the diffusion model; ``superres_state_dict_from_flax`` and
``encoder_unet_state_dict_from_flax`` for the super-resolution U-Net and the
guidance classifier; ``generator_state_dict_from_flax`` for the talking-face
generator (with ``generator_flax_module_names``, which maps the Flax module
paths that key JAX's static int8 scales to the port's module names);
``discriminator_state_dict_from_flax`` and ``syncnet_state_dict_from_flax``
for the GAN's discriminator and sync expert;
``s3fd_state_dict_from_flax``, ``lip_landmark_state_dict_from_flax`` and
``word_lm_state_dict_from_flax`` for the lipreading chain's face detector,
lip-landmark regressor and word LM; ``wav2vec2_state_dict_from_flax``,
``avhubert_state_dict_from_flax`` and ``lip_expert_state_dict_from_flax``
for the pretrained encoders and the seq2seq lip expert (the first two keep
the Flax module names, so a name that does not fit shows as a missing or
unexpected key in ``load_state_dict``); ``densenet_state_dict_from_flax``
(params and ``batch_stats``, into torchvision's ``densenet121`` layout) and
``feature_transformer_state_dict_from_flax`` for the DenseNet feature path. The
params stay float32 in the port (its layers cast
to the compute dtype inside ``forward``), so a round trip is exact. A Flax
gradient tree has the params' structure and goes through the same
functions.

The Flax tree (``lipreading_video_generation_tpu/models/vivit.py``)::

    TubeletEmbed_0/proj/{kernel, bias}     pos_embedding (1, N, E)
    block_i/{LayerNorm_0, qkv, proj, LayerNorm_1, MLP_0/{Dense_0, Dense_1}}
    LayerNorm_0                             head

Rules: a Dense ``kernel (in, out)`` becomes a Linear ``weight (out, in)``;
a 3-D conv ``kernel`` DHWIO becomes OIDHW, a 2-D one HWIO becomes OIHW and a
1-D one (W, I, O) becomes (O, I, W); a LayerNorm or GroupNorm ``scale`` becomes ``weight``;
the fused qkv stays fused, so the q/k/v split order of ``jnp.split(qkv, 3)``
carries over. Every function raises ``KeyError`` on a missing or unexpected
entry. Takes numpy
arrays (or anything ``np.asarray`` reads), so it needs neither jax nor flax.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping

import numpy as np
import torch

from . import discriminator as _disc
from . import syncnet as _sync
from .generator import AUDIO_PLAN, DECODER_PLAN, FACE_PLAN
from .unet import encoder_plan, plan


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(sd: Dict[str, torch.Tensor], name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _tensor(p["kernel"]).T.contiguous()
    sd[f"{name}.bias"] = _tensor(p["bias"])


_CONV_ORDER = {5: (4, 3, 0, 1, 2), 4: (3, 2, 0, 1), 3: (2, 1, 0)}


def _conv(sd: Dict[str, torch.Tensor], name: str, p: Mapping) -> None:
    """3-D (DHWIO → OIDHW), 2-D (HWIO → OIHW) or 1-D ((W, I, O) → (O, I, W))
    conv, with or without a bias."""
    kernel = _tensor(p["kernel"])
    sd[f"{name}.weight"] = kernel.permute(_CONV_ORDER[kernel.ndim]).contiguous()
    if "bias" in p:
        sd[f"{name}.bias"] = _tensor(p["bias"])


def _exact(params: Mapping, keys: Iterable[str], where: str) -> Mapping:
    """``params`` if its keys are exactly ``keys``; ``KeyError`` otherwise."""
    want, have = set(keys), set(params)
    if want != have:
        raise KeyError(f"{where}: missing Flax params {sorted(want - have)}, "
                       f"unexpected {sorted(have - want)}")
    return params


def _norm(sd: Dict[str, torch.Tensor], name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _tensor(p["scale"])
    sd[f"{name}.bias"] = _tensor(p["bias"])


def block_state_dict_from_flax(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flax ``TransformerBlock`` params → ``models.layers.TransformerBlock``
    entries, each key prefixed with ``prefix``."""
    sd: Dict[str, torch.Tensor] = {}
    _norm(sd, f"{prefix}norm1", params["LayerNorm_0"])
    _dense(sd, f"{prefix}qkv", params["qkv"])
    _dense(sd, f"{prefix}proj", params["proj"])
    _norm(sd, f"{prefix}norm2", params["LayerNorm_1"])
    _dense(sd, f"{prefix}mlp.fc1", params["MLP_0"]["Dense_0"])
    _dense(sd, f"{prefix}mlp.fc2", params["MLP_0"]["Dense_1"])
    return sd


def vivit_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ViViT ``params`` (nested dict of arrays) → float32 ``state_dict``
    for ``models.vivit.ViViT``. Raises ``KeyError`` on a missing or
    unexpected entry."""
    sd: Dict[str, torch.Tensor] = {}
    used = set()

    def take(key):
        used.add(key)
        return params[key]

    _dense(sd, "tubelet.proj", take("TubeletEmbed_0")["proj"])
    sd["pos_embedding"] = _tensor(take("pos_embedding"))
    i = 0
    while f"block_{i}" in params:
        sd.update(block_state_dict_from_flax(take(f"block_{i}"), f"blocks.{i}."))
        i += 1
    _norm(sd, "norm", take("LayerNorm_0"))
    _dense(sd, "head", take("head"))
    extra = set(params) - used
    if extra:
        raise KeyError(f"vivit_state_dict_from_flax: unexpected Flax params {sorted(extra)}")
    return sd


def _map_tree(fn, tree):
    return ({k: _map_tree(fn, v) for k, v in tree.items()} if isinstance(tree, Mapping)
            else fn(tree))


def vivit_pp_state_dict_from_flax(params: Mapping, num_layers: int) -> Dict[str, torch.Tensor]:
    """The JAX package's pipeline layout of ViViT params (``pp_params``: the
    ``block_i`` subtrees stacked into one ``blocks`` tree) → the port's
    canonical ``ViViT`` ``state_dict`` (``models.vivit.pp_params`` stacks
    it for the port's pipeline)."""
    canonical = {k: v for k, v in params.items() if k != "blocks"}
    for i in range(num_layers):
        canonical[f"block_{i}"] = _map_tree(lambda a, i=i: np.asarray(a)[i], params["blocks"])
    return vivit_state_dict_from_flax(canonical)


def _flax_dense(sd: Mapping, name: str) -> Dict[str, np.ndarray]:
    return {"kernel": sd[f"{name}.weight"].detach().cpu().numpy().T.copy(),
            "bias": sd[f"{name}.bias"].detach().cpu().numpy()}


def _flax_norm(sd: Mapping, name: str) -> Dict[str, np.ndarray]:
    return {"scale": sd[f"{name}.weight"].detach().cpu().numpy(),
            "bias": sd[f"{name}.bias"].detach().cpu().numpy()}


def flax_vivit_params_from_state_dict(sd: Mapping[str, torch.Tensor],
                                      pipeline: bool = False) -> Dict:
    """Inverse of ``vivit_state_dict_from_flax``: a canonical ``ViViT``
    ``state_dict`` → the Flax params tree (numpy), or with ``pipeline`` the
    JAX package's ``pp_params`` layout (one ``blocks`` tree stacked over the
    layers), so a checkpoint of either package's trainer loads in the
    other's model."""
    n = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    blocks = [{"LayerNorm_0": _flax_norm(sd, f"blocks.{i}.norm1"),
               "qkv": _flax_dense(sd, f"blocks.{i}.qkv"),
               "proj": _flax_dense(sd, f"blocks.{i}.proj"),
               "LayerNorm_1": _flax_norm(sd, f"blocks.{i}.norm2"),
               "MLP_0": {"Dense_0": _flax_dense(sd, f"blocks.{i}.mlp.fc1"),
                         "Dense_1": _flax_dense(sd, f"blocks.{i}.mlp.fc2")}}
              for i in range(n)]
    params = {"TubeletEmbed_0": {"proj": _flax_dense(sd, "tubelet.proj")},
              "pos_embedding": sd["pos_embedding"].detach().cpu().numpy(),
              "LayerNorm_0": _flax_norm(sd, "norm"), "head": _flax_dense(sd, "head")}
    if pipeline:
        def stack(*leaves):
            return np.stack(leaves) if not isinstance(leaves[0], Mapping) else {
                k: stack(*(leaf[k] for leaf in leaves)) for k in leaves[0]}
        params["blocks"] = stack(*blocks)
    else:
        params.update({f"block_{i}": b for i, b in enumerate(blocks)})
    return params


def audio_encoder_state_dict_from_flax(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flax ``AudioFeatureEncoder`` params → ``models.audio_encoder.AudioFeatureEncoder``
    entries, each key prefixed with ``prefix``."""
    n_blocks = sum(1 for k in params if k.startswith("block_"))
    _exact(params, ["Conv_0", "Conv_1", "LayerNorm_0", "LayerNorm_1", "pos_embedding"]
           + [f"block_{i}" for i in range(n_blocks)], "audio_encoder")
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, f"{prefix}conv1", params["Conv_0"])
    _conv(sd, f"{prefix}conv2", params["Conv_1"])
    _norm(sd, f"{prefix}norm_in", params["LayerNorm_0"])
    sd[f"{prefix}pos_embedding"] = _tensor(params["pos_embedding"])
    for i in range(n_blocks):
        sd.update(block_state_dict_from_flax(params[f"block_{i}"], f"{prefix}blocks.{i}."))
    _norm(sd, f"{prefix}norm_out", params["LayerNorm_1"])
    return sd


def res_block_state_dict_from_flax(params: Mapping, skip: bool,
                                   prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flax ``ResBlock`` params → ``models.unet.ResBlock`` entries; ``skip``
    when the block changes the channel count (its 1×1 ``Conv_2``)."""
    _exact(params, ["GroupNorm_0", "Conv_0", "Dense_0", "GroupNorm_1", "Conv_1"]
           + (["Conv_2"] if skip else []), "ResBlock")
    sd: Dict[str, torch.Tensor] = {}
    _norm(sd, f"{prefix}norm1", params["GroupNorm_0"])
    _conv(sd, f"{prefix}conv1", params["Conv_0"])
    _dense(sd, f"{prefix}emb", params["Dense_0"])
    _norm(sd, f"{prefix}norm2", params["GroupNorm_1"])
    _conv(sd, f"{prefix}conv2", params["Conv_1"])
    if skip:
        _conv(sd, f"{prefix}skip", params["Conv_2"])
    return sd


def attention_block_state_dict_from_flax(params: Mapping,
                                         prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flax ``AttentionBlock`` params → ``models.unet.AttentionBlock`` entries."""
    _exact(params, ["GroupNorm_0", "qkv", "proj"], "AttentionBlock")
    sd: Dict[str, torch.Tensor] = {}
    _norm(sd, f"{prefix}norm", params["GroupNorm_0"])
    _dense(sd, f"{prefix}qkv", params["qkv"])
    _dense(sd, f"{prefix}proj", params["proj"])
    return sd


def _flax_names(steps, remat: bool = False):
    """(Flax submodule name, step) for each module-creating step, in
    creation order: Flax names each by its class and index (``ResBlock_3``,
    ``AttentionBlock_0`` …; ``CheckpointResBlock_3`` under ``nn.remat``),
    the port keeps them in one ``layers`` list."""
    kinds = {"res": "CheckpointResBlock" if remat else "ResBlock", "attn": "AttentionBlock",
             "down": "Downsample", "up": "Upsample"}
    names, count = [], {k: 0 for k in kinds}
    for step in steps:
        if step[0] in kinds:
            names.append((f"{kinds[step[0]]}_{count[step[0]]}", step))
            count[step[0]] += 1
    return names


def _layers_state_dict(params: Mapping, names, prefix: str) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for i, (name, step) in enumerate(names):
        at = f"{prefix}layers.{i}."
        if step[0] == "res":
            sd.update(res_block_state_dict_from_flax(params[name], step[1] != step[2], at))
        elif step[0] == "attn":
            sd.update(attention_block_state_dict_from_flax(params[name], at))
        else:
            _conv(sd, f"{at}conv", _exact(params[name], ["Conv_0"], f"unet/{name}")["Conv_0"])
    return sd


def unet_state_dict_from_flax(params: Mapping, base_channels: int, channel_mult,
                              num_res_blocks: int, attention_resolutions,
                              prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flax ``UNetModel`` params → ``models.unet.UNetModel`` entries. Walks
    ``UNetModel.__call__``'s order (``models.unet.plan``); takes the params
    of a ``remat=True`` model (rematerialised ResBlocks) as well."""
    names = _flax_names(plan(base_channels, channel_mult, num_res_blocks,
                             attention_resolutions),
                        remat="CheckpointResBlock_0" in params)
    _exact(params, ["Dense_0", "Dense_1", "Conv_0", "GroupNorm_0", "Conv_1"]
           + [n for n, _ in names], "unet")
    sd: Dict[str, torch.Tensor] = {}
    _dense(sd, f"{prefix}time1", params["Dense_0"])
    _dense(sd, f"{prefix}time2", params["Dense_1"])
    _conv(sd, f"{prefix}stem", params["Conv_0"])
    sd.update(_layers_state_dict(params, names, prefix))
    _norm(sd, f"{prefix}out_norm", params["GroupNorm_0"])
    _conv(sd, f"{prefix}out_conv", params["Conv_1"])
    return sd


def encoder_unet_state_dict_from_flax(params: Mapping, ccfg) -> Dict[str, torch.Tensor]:
    """Flax ``EncoderUNetModel`` params of a ``ClassifierConfig`` → float32
    ``state_dict`` for ``models.unet.EncoderUNetModel`` (the final Dense is
    ``Dense_2``)."""
    names = _flax_names(encoder_plan(ccfg.base_channels, ccfg.channel_mult,
                                     ccfg.num_res_blocks, ccfg.attention_resolutions))
    _exact(params, ["Dense_0", "Dense_1", "Conv_0", "GroupNorm_0", "Dense_2"]
           + [n for n, _ in names], "EncoderUNetModel")
    sd: Dict[str, torch.Tensor] = {}
    _dense(sd, "time1", params["Dense_0"])
    _dense(sd, "time2", params["Dense_1"])
    _conv(sd, "stem", params["Conv_0"])
    sd.update(_layers_state_dict(params, names, ""))
    _norm(sd, "out_norm", params["GroupNorm_0"])
    _dense(sd, "head", params["Dense_2"])
    return sd


def superres_state_dict_from_flax(params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """Flax ``SuperResModel`` params of a ``SuperResConfig`` (one ``unet``
    subtree) → float32 ``state_dict`` for ``models.unet.SuperResModel``."""
    _exact(params, ["unet"], "SuperResModel")
    return unet_state_dict_from_flax(params["unet"], cfg.base_channels, cfg.channel_mult,
                                     cfg.num_res_blocks, cfg.attention_resolutions, "unet.")


def unet_audio_state_dict_from_flax(params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """Flax ``UNetAudio(cfg)`` params (native or wav2vec2 audio encoder) →
    float32 ``state_dict`` for ``models.unet_audio.UNetAudio(cfg)``."""
    _exact(params, ["audio_encoder", "audio_proj", "im_cond_conv", "unet"], "UNetAudio")
    if cfg.audio_encoder == "wav2vec2":
        sd = wav2vec2_state_dict_from_flax(params["audio_encoder"], "audio_encoder.")
    else:
        sd = audio_encoder_state_dict_from_flax(params["audio_encoder"], "audio_encoder.")
    _dense(sd, "audio_proj", params["audio_proj"])
    _conv(sd, "im_cond_conv", params["im_cond_conv"])
    sd.update(unet_state_dict_from_flax(
        params["unet"], cfg.base_channels, cfg.channel_mult, cfg.num_res_blocks,
        cfg.attention_resolutions, "unet."))
    return sd


_GENERATOR_PARTS = (("AudioEncoder_0", "audio", AUDIO_PLAN), ("FaceEncoder_0", "face", FACE_PLAN),
                    ("FaceDecoder_0", "decoder", DECODER_PLAN))
_GENERATOR_KINDS = {"conv": "ConvBlock", "res": "ResConvBlock", "up": "UpsampleConv"}


def _generator_blocks(plan):
    """(Flax block path, port block name) for each block-creating step of a
    generator plan, in call order: Flax names each block by its class and
    index (``ConvBlock_1``, ``ResConvBlock_4`` …), the port keeps them in one
    ``layers`` list; a ResConvBlock or UpsampleConv wraps one ``ConvBlock_0``
    (the port's ``block``)."""
    count = {k: 0 for k in _GENERATOR_KINDS}
    blocks = []
    for step in plan:
        kind = step[0]
        if kind not in _GENERATOR_KINDS:
            continue
        flax = f"{_GENERATOR_KINDS[kind]}_{count[kind]}"
        count[kind] += 1
        at = f"layers.{len(blocks)}"
        blocks.append((flax, at) if kind == "conv" else (f"{flax}/ConvBlock_0", f"{at}.block"))
    return blocks


def generator_flax_module_names() -> Dict[str, str]:
    """Flax module path of each of the generator's 51 convs
    (``AudioEncoder_0/ConvBlock_0/Conv_0`` …, the keys of JAX's
    ``calibrate_activation_scales``) → the port's ``named_modules()`` name
    (``audio.layers.0.conv`` …)."""
    names = {}
    for flax_part, part, plan in _GENERATOR_PARTS:
        for flax, at in _generator_blocks(plan):
            names[f"{flax_part}/{flax}/Conv_0"] = f"{part}.{at}.conv"
    names["FaceDecoder_0/Conv_0"] = "decoder.out_conv"
    return names


def generator_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``TalkingFaceGenerator`` params (group norm, any width) →
    float32 ``state_dict`` for ``models.generator.TalkingFaceGenerator``."""
    _exact(params, [p[0] for p in _GENERATOR_PARTS], "TalkingFaceGenerator")
    sd: Dict[str, torch.Tensor] = {}
    for flax_part, part, plan in _GENERATOR_PARTS:
        tree = params[flax_part]
        blocks = _generator_blocks(plan)
        _exact(tree, {b[0].split("/")[0] for b in blocks}
               | ({"Conv_0"} if part == "decoder" else set()), flax_part)
        for flax, at in blocks:
            block = tree
            for key in flax.split("/"):
                block = block[key]
            _exact(block, ["Conv_0", "GroupNorm_0"], f"{flax_part}/{flax}")
            _conv(sd, f"{part}.{at}.conv", block["Conv_0"])
            _norm(sd, f"{part}.{at}.norm", block["GroupNorm_0"])
    _conv(sd, "decoder.out_conv", params["FaceDecoder_0"]["Conv_0"])
    return sd


def discriminator_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``Discriminator`` params (``ConvBlock_0…12``, each an unnormed
    ``Conv_0``, then ``Conv_0``) → float32 ``state_dict`` for
    ``models.discriminator.Discriminator``."""
    blocks = [f"ConvBlock_{i}" for i in range(len(_disc.PLAN))]
    _exact(params, blocks + ["Conv_0"], "Discriminator")
    sd: Dict[str, torch.Tensor] = {}
    for i, name in enumerate(blocks):
        _conv(sd, f"blocks.{i}.conv", _exact(params[name], ["Conv_0"], name)["Conv_0"])
    _conv(sd, "out_conv", params["Conv_0"])
    return sd


def syncnet_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``SyncNet`` params (``face_blocks_0…16``, ``audio_blocks_0…13``,
    each ``Conv_0`` + ``GroupNorm_0``) → float32 ``state_dict`` for
    ``models.syncnet.SyncNet``."""
    towers = (("face_blocks", len(_sync.FACE_PLAN)), ("audio_blocks", len(_sync.AUDIO_PLAN)))
    _exact(params, [f"{t}_{i}" for t, n in towers for i in range(n)], "SyncNet")
    sd: Dict[str, torch.Tensor] = {}
    for tower, n in towers:
        for i in range(n):
            block = _exact(params[f"{tower}_{i}"], ["Conv_0", "GroupNorm_0"], f"{tower}_{i}")
            _conv(sd, f"{tower}.{i}.conv", block["Conv_0"])
            _norm(sd, f"{tower}.{i}.norm", block["GroupNorm_0"])
    return sd


def s3fd_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``S3FD`` params → float32 ``state_dict`` for ``models.s3fd.S3FD``,
    which is ``s3fd.pth``'s layout: the inverse of the JAX package's
    ``convert_torch_state_dict`` (conv kernels HWIO → OIHW, the L2Norm
    ``weight``s as they are)."""
    from .s3fd import S3FD

    want = {k.rsplit(".", 1)[0] for k in S3FD().state_dict()}
    _exact(params, want, "S3FD")
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        if "kernel" in p:
            _conv(sd, name, _exact(p, ["kernel", "bias"], f"S3FD/{name}"))
        else:
            sd[f"{name}.weight"] = _tensor(_exact(p, ["weight"], f"S3FD/{name}")["weight"])
    return sd


def lip_landmark_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``LipLandmarkNet`` params → float32 ``state_dict`` for
    ``models.lip_landmark.LipLandmarkNet`` (same module names)."""
    convs = [f"conv{i}" for i in range(4)] + ["up2", "up1", "heat"]
    norms = [f"norm{i}" for i in range(4)] + ["upnorm2", "upnorm1"]
    _exact(params, convs + norms, "LipLandmarkNet")
    sd: Dict[str, torch.Tensor] = {}
    for name in convs:
        _conv(sd, name, params[name])
    for name in norms:
        _norm(sd, name, params[name])
    return sd


def word_lm_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``WordLM`` params → float32 ``state_dict`` for
    ``models.word_lm.WordLM`` (same module names; the embedding is also the
    tied output head)."""
    n = sum(1 for k in params if k.startswith("qkv_"))
    per_layer = ("ln1", "qkv", "proj", "ln2", "fc1", "fc2")
    _exact(params, ["embedding", "pos_embedding", "ln_f"]
           + [f"{p}_{i}" for i in range(n) for p in per_layer], "WordLM")
    sd = {"embedding": _tensor(params["embedding"]),
          "pos_embedding": _tensor(params["pos_embedding"])}
    for i in range(n):
        for p in per_layer:
            (_norm if p.startswith("ln") else _dense)(sd, f"{p}_{i}", params[f"{p}_{i}"])
    _norm(sd, "ln_f", params["ln_f"])
    return sd


def _flax_named_state_dict(params: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """A Flax tree whose module names the port's module keeps (AV-HuBERT,
    wav2vec2): Dense and conv kernels transposed, a LayerNorm's or
    GroupNorm's ``scale`` → ``weight``; a folded BatchNorm (``*bn*``: the
    ``_Affine`` modules) keeps ``scale``; PReLU ``alpha`` as it is."""
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        at = f"{prefix}{name}"
        if not isinstance(p, Mapping):
            raise KeyError(f"unexpected Flax leaf {at!r}")
        if "kernel" in p:
            (_dense if np.ndim(p["kernel"]) == 2 else _conv)(sd, at, p)
        elif "scale" in p and "bn" in name:
            sd[f"{at}.scale"], sd[f"{at}.bias"] = _tensor(p["scale"]), _tensor(p["bias"])
        elif "scale" in p:
            _norm(sd, at, p)
        elif "alpha" in p:
            sd[f"{at}.alpha"] = _tensor(p["alpha"])
        else:
            sd.update(_flax_named_state_dict(p, f"{at}."))
    return sd


def wav2vec2_state_dict_from_flax(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flax ``Wav2Vec2Encoder`` params → ``models.wav2vec2.Wav2Vec2Encoder``
    entries, each key prefixed with ``prefix``."""
    return _flax_named_state_dict(params, prefix)


def avhubert_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``AVHubertVideoEncoder`` params → float32 ``state_dict`` for
    ``models.avhubert.AVHubertVideoEncoder``."""
    return _flax_named_state_dict(params, "")


def _conformer_state_dict_from_flax(p: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """Flax ``ConformerBlock`` (auto-named in call order: the outer Dense of
    each FFN is built first) → ``models.lip_expert.ConformerBlock``."""
    _exact(p, [f"Dense_{i}" for i in range(4)] + [f"LayerNorm_{i}" for i in range(4)]
           + [f"Conv_{i}" for i in range(3)] + ["attn"], "ConformerBlock")
    sd = block_state_dict_from_flax(p["attn"], f"{prefix}attn.")
    for flax, port in (("LayerNorm_0", "ff1_norm"), ("LayerNorm_1", "conv_norm"),
                       ("LayerNorm_2", "ff2_norm"), ("LayerNorm_3", "out_norm")):
        _norm(sd, prefix + port, p[flax])
    for flax, port in (("Dense_0", "ff1_out"), ("Dense_1", "ff1_in"), ("Dense_2", "ff2_out"),
                       ("Dense_3", "ff2_in")):
        _dense(sd, prefix + port, p[flax])
    for flax, port in (("Conv_0", "conv_pw1"), ("Conv_1", "conv_dw"), ("Conv_2", "conv_pw2")):
        _conv(sd, prefix + port, p[flax])
    return sd


def lip_expert_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``LipExpertSeq2Seq`` params → float32 ``state_dict`` for
    ``models.lip_expert.LipExpertSeq2Seq``."""
    n_dec = sum(1 for k in params if k.startswith("dec_") and k != "dec_pos")
    _exact(params, ["encoder", "tok_embed", "dec_pos", "out_norm", "head"]
           + [f"dec_{i}" for i in range(n_dec)], "LipExpertSeq2Seq")
    enc = params["encoder"]
    n_conf = sum(1 for k in enc if k.startswith("conf_"))
    _exact(enc, ["Conv_0", "Conv_1", "Conv_2", "Dense_0", "pos_embedding"]
           + [f"conf_{i}" for i in range(n_conf)], "ConformerLipEncoder")
    sd: Dict[str, torch.Tensor] = {}
    for i in range(3):
        _conv(sd, f"encoder.stem{i + 1}", enc[f"Conv_{i}"])
    _dense(sd, "encoder.proj", enc["Dense_0"])
    sd["encoder.pos_embedding"] = _tensor(enc["pos_embedding"])
    for i in range(n_conf):
        sd.update(_conformer_state_dict_from_flax(enc[f"conf_{i}"], f"encoder.blocks.{i}."))
    sd["tok_embed.weight"] = _tensor(params["tok_embed"]["embedding"])
    sd["dec_pos"] = _tensor(params["dec_pos"])
    for i in range(n_dec):
        p, at = params[f"dec_{i}"], f"blocks.{i}."
        _exact(p, ["LayerNorm_0", "LayerNorm_1", "LayerNorm_2", "Dense_0", "Dense_1", "self_qkv",
                   "self_proj", "cross_q", "cross_kv", "cross_proj"], f"dec_{i}")
        for flax, port in (("LayerNorm_0", "norm1"), ("LayerNorm_1", "norm2"),
                           ("LayerNorm_2", "norm3")):
            _norm(sd, at + port, p[flax])
        for flax, port in (("Dense_1", "fc1"), ("Dense_0", "fc2"), ("self_qkv", "self_qkv"),
                           ("self_proj", "self_proj"), ("cross_q", "cross_q"),
                           ("cross_kv", "cross_kv"), ("cross_proj", "cross_proj")):
            _dense(sd, at + port, p[flax])
    _norm(sd, "out_norm", params["out_norm"])
    _dense(sd, "head", params["head"])
    return sd


def densenet_state_dict_from_flax(params: Mapping, batch_stats: Mapping
                                  ) -> Dict[str, torch.Tensor]:
    """Flax ``DenseNet121`` params and ``batch_stats`` → float32
    ``state_dict`` for ``models.densenet.DenseNet121``, which is
    torchvision's layout: the inverse of the JAX package's
    ``convert_torch_state_dict`` (``block{i}_layer{j}`` →
    ``features.denseblock{i+1}.denselayer{j+1}``, ``transition{i}`` →
    ``features.transition{i+1}``, ``norm_final`` → ``features.norm5``;
    kernels HWIO → OIHW, a BatchNorm's ``scale``/``mean``/``var`` →
    ``weight``/``running_mean``/``running_var``)."""
    _exact(batch_stats, [k for k in params if k != "conv0"], "DenseNet121 batch_stats")

    def module(name: str) -> str:
        if name.startswith("block"):
            bi, li = name[len("block"):].split("_layer")
            return f"features.denseblock{int(bi) + 1}.denselayer{int(li) + 1}"
        if name.startswith("transition"):
            return f"features.transition{int(name[len('transition'):]) + 1}"
        if name == "norm_final":
            return "features.norm5"
        if name in ("conv0", "norm0"):
            return f"features.{name}"
        raise KeyError(f"DenseNet121: unexpected Flax module {name!r}")

    sd: Dict[str, torch.Tensor] = {}

    def put(at: str, p: Mapping, stats: Mapping) -> None:
        if "kernel" in p:
            _conv(sd, at, _exact(p, ["kernel"], at))
            return
        _norm(sd, at, _exact(p, ["scale", "bias"], at))
        stats = _exact(stats, ["mean", "var"], at)
        sd[f"{at}.running_mean"] = _tensor(stats["mean"])
        sd[f"{at}.running_var"] = _tensor(stats["var"])

    for name, p in params.items():
        at = module(name)
        if name in ("conv0", "norm0", "norm_final"):
            put(at, p, batch_stats.get(name, {}))
        else:
            for sub, q in p.items():
                put(f"{at}.{sub}", q, batch_stats[name].get(sub, {}))
    return sd


def feature_transformer_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``FeatureTransformer`` params → float32 ``state_dict`` for
    ``models.vivit.FeatureTransformer``."""
    n = sum(1 for k in params if k.startswith("block_"))
    _exact(params, ["pos_embedding", "head"] + [f"block_{i}" for i in range(n)],
           "FeatureTransformer")
    sd = {"pos_embedding": _tensor(params["pos_embedding"])}
    for i in range(n):
        sd.update(block_state_dict_from_flax(params[f"block_{i}"], f"blocks.{i}."))
    _dense(sd, "head", params["head"])
    return sd
