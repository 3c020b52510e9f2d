"""Weights bridge: Flax ViViT params → the port's ``ViViT`` ``state_dict``.

The Flax tree (``lipreading_video_generation_tpu/models/vivit.py``)::

    TubeletEmbed_0/proj/{kernel, bias}     pos_embedding (1, N, E)
    block_i/{LayerNorm_0, qkv, proj, LayerNorm_1, MLP_0/{Dense_0, Dense_1}}
    LayerNorm_0                             head

Rules: a Dense ``kernel (in, out)`` becomes a Linear ``weight (out, in)``;
a LayerNorm ``scale`` becomes ``weight``; the fused qkv stays fused, so the
q/k/v split order of ``jnp.split(qkv, 3)`` carries over. Takes numpy
arrays (or anything ``np.asarray`` reads), so it needs neither jax nor flax.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(sd: Dict[str, torch.Tensor], name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _tensor(p["kernel"]).T.contiguous()
    sd[f"{name}.bias"] = _tensor(p["bias"])


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
    for ``models.vivit.ViViT`` (``load_state_dict`` casts to the module
    dtypes). Raises ``KeyError`` on a missing or unexpected entry."""
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
