"""The PyTorch port's ViViT forward against the Flax model, on weights
bridged by ``models.convert`` (small config: 2 layers, hidden 64, 4 heads,
MLP 128, 8 classes)."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lipreading_video_generation_tpu.core import config as jcfg
from lipreading_video_generation_tpu.models.layers import TransformerBlock as JBlock
from lipreading_video_generation_tpu.models.vivit import ViViT as JViViT
from lipreading_video_generation_tpu_torch.core import config as tcfg
from lipreading_video_generation_tpu_torch.models.convert import (
    block_state_dict_from_flax,
    vivit_state_dict_from_flax,
)
from lipreading_video_generation_tpu_torch.models.layers import TransformerBlock as TBlock
from lipreading_video_generation_tpu_torch.models.vivit import ViViT as TViViT

SMALL = dict(num_layers=2, hidden_size=64, num_heads=4, mlp_dim=128, num_classes=8)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


def _perturbed(params, seed):
    """Flax init leaves LayerNorm at (1, 0) and biases at 0, where a swapped
    mapping would not show: add seeded numpy noise to every leaf."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_transformer_block_matches_flax(dtype, tol):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 80, 64)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    blk = JBlock(num_heads=4, mlp_dim=128, dtype=jdt)
    params = _perturbed(blk.init(jax.random.key(0), jnp.asarray(x, jdt))["params"], 1)
    want = np.asarray(blk.apply({"params": params}, jnp.asarray(x, jdt)), np.float32)
    tblk = TBlock(64, 4, 128, getattr(torch, dtype))
    tblk.load_state_dict(block_state_dict_from_flax(params))
    with torch.inference_mode():
        got = tblk(torch.from_numpy(x).to(getattr(torch, dtype))).float().numpy()
    # bf16: Dense/GELU round at other points in the two frameworks
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_vivit_matches_flax(dtype, tol):
    """Logits of ~1.5: bf16 rounding through two blocks stays within 3e-2."""
    rng = np.random.default_rng(2)
    clips = rng.uniform(0, 1, (3, 5, 32, 32, 1)).astype(np.float32)
    jmodel = JViViT(jcfg.ViViTConfig(dtype=dtype, **SMALL))
    params = _perturbed(jmodel.init(jax.random.key(0), jnp.asarray(clips))["params"], 3)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(clips)))
    model = TViViT(tcfg.ViViTConfig(dtype=dtype, **SMALL)).eval()
    model.load_state_dict(vivit_state_dict_from_flax(params))
    with torch.inference_mode():
        got = model(torch.from_numpy(clips))
    assert got.dtype == torch.float32 and got.shape == (3, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_bridge_rejects_unknown_params():
    params = JViViT(jcfg.ViViTConfig(dtype="float32", **SMALL)).init(
        jax.random.key(0), jnp.zeros((1, 5, 32, 32, 1)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    assert set(vivit_state_dict_from_flax(params)) == set(
        TViViT(tcfg.ViViTConfig(**SMALL)).state_dict())
    with pytest.raises(KeyError, match="unexpected"):
        vivit_state_dict_from_flax({**params, "extra": {}})


def test_configs_mirror_jax():
    for name in ("ViViTConfig", "PreprocessConfig"):
        assert dataclasses.asdict(getattr(tcfg, name)()) == dataclasses.asdict(
            getattr(jcfg, name)())
    for flag in ("sequence_parallel", "pipeline_parallel"):
        assert dataclasses.asdict(tcfg.ViViTConfig(**{flag: True})) == dataclasses.asdict(
            jcfg.ViViTConfig(**{flag: True}))
    # JAX's own ValueError: pipeline and sequence parallelism both claim the model axis
    from lipreading_video_generation_tpu.models.vivit import apply_pipelined as japply
    from lipreading_video_generation_tpu_torch.models.vivit import apply_pipelined as tapply
    from lipreading_video_generation_tpu_torch.parallel.mesh import build_mesh

    both = dict(SMALL, sequence_parallel=True, pipeline_parallel=True)
    with pytest.raises(ValueError, match="model axis"):
        japply(jcfg.ViViTConfig(**both), {}, jnp.zeros((1, 5, 32, 32, 1)), None)
    with pytest.raises(ValueError, match="model axis"):
        tapply(tcfg.ViViTConfig(**both), {}, torch.zeros(1, 5, 32, 32, 1), build_mesh())
