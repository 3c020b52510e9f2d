"""The port's ring attention (sequence parallelism) against the JAX package's.

The port's two ranks form a gloo group on the CPU (``torch_parallel_tasks.LocalGroup``,
spawned once for the module, through a ``FileStore`` under the test's
temporary directory) running ``torch_parallel_tasks`` (no JAX imports);
JAX runs ``ring_attention`` and the sequence-parallel models on two devices
of its 8-device CPU mesh, from the same numpy inputs and bridged weights.

Bounds (float32): the ring's output and its q/k/v gradients within 1e-5 of
JAX's ring (plain einsums on both sides, the same online-softmax order);
the sequence-parallel ViViT's logits and the U-Net's ε within 1e-5 of
JAX's sequence-parallel forward, the ViViT's parameter gradients within
1e-5 of the largest of each tensor's gradient of JAX's local forward (the
ring is exact).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lipreading_video_generation_tpu.core import config as jcfg
from lipreading_video_generation_tpu.models.unet_audio import UNetAudio as JUNetAudio
from lipreading_video_generation_tpu.models.vivit import ViViT as JViViT
from lipreading_video_generation_tpu.ops.ring_attention import ring_attention as jring
from lipreading_video_generation_tpu.parallel import mesh as jmesh
from lipreading_video_generation_tpu_torch.core import config as tcfg
from lipreading_video_generation_tpu_torch.models import convert
from lipreading_video_generation_tpu_torch.models.vivit import ViViT
from lipreading_video_generation_tpu_torch.ops.attention import attention_reference
from lipreading_video_generation_tpu_torch.ops.ring_attention import (live_ring_mesh,
                                                                       ring_attention)
from lipreading_video_generation_tpu_torch.parallel import mesh as tmesh

import torch_parallel_tasks as tasks
from torch_parallel_tasks import LocalGroup

TOL = 1e-5


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    with LocalGroup(2, str(tmp_path_factory.mktemp("gloo") / "store")) as g:
        yield g


def _jspec(**kw):
    return jmesh.build_mesh(jcfg.MeshConfig(**kw), devices=jax.devices()[:2])


def _qkv(seed, b=2, h=2, s=64, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("causal", [False, True], ids=["plain", "causal"])
@pytest.mark.parametrize("axis", ["data", "model"])
def test_ring_matches_jax(group, causal, axis):
    """Forward and the q/k/v gradients of a cotangent, over 2 ranks of
    either axis, against JAX's ring over the same axis of 2 devices."""
    q, k, v, do = _qkv(0)
    mesh_kw = {} if axis == "data" else {"model_parallel": 2}
    spec = _jspec(**mesh_kw)

    def f(q, k, v):
        return jring(q, k, v, spec.mesh, axis_name=axis, causal=causal)

    want, want_grads = jax.jit(lambda q, k, v, do: (lambda o, vjp: (o, vjp(do)))(
        *jax.vjp(f, q, k, v)))(*map(jnp.asarray, (q, k, v, do)))
    out = group.run(tasks.ring, q, k, v, do, causal, mesh_kw, axis)
    for o in out:
        np.testing.assert_allclose(o["out"], np.asarray(want), rtol=TOL, atol=TOL)
        for g, w in zip(o["grads"], want_grads):
            np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL)


def test_ring_one_block_and_errors():
    """Without a group the ring is one block: the dense reference; a live
    ring needs a sequence its ranks divide (JAX's ``ValueError``); without a
    mesh no ring is live."""
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(1, s=100))
    spec = tmesh.build_mesh()
    for causal in (False, True):
        np.testing.assert_allclose(ring_attention(q, k, v, spec, causal=causal).numpy(),
                                   attention_reference(q, k, v, causal=causal).numpy(),
                                   rtol=TOL, atol=TOL)
    assert live_ring_mesh("model") is None and live_ring_mesh(None) is None
    with tmesh.use_mesh(spec):
        assert live_ring_mesh("model") is None


def test_ring_rejects_indivisible_sequences(group):
    q, k, v, do = _qkv(2, s=63)
    with pytest.raises(RuntimeError, match="not divisible by axis model=2"):
        group.run(tasks.ring, q, k, v, do, False, {"model_parallel": 2}, "model")


VIVIT = dict(num_classes=8, hidden_size=32, num_layers=2, num_heads=4, mlp_dim=64,
             num_frames=5, dtype="float32")


def _vivit_params(seed=0):
    shapes = jax.eval_shape(JViViT(jcfg.ViViTConfig(**VIVIT)).init, jax.random.key(0),
                            jnp.zeros((1, 5, 32, 32, 1)))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) / np.sqrt(max(1, np.prod(a.shape[:-1]))))
        .astype(np.float32), shapes)


def test_vivit_sequence_parallel_matches_jax(group):
    """ViViT with ``sequence_parallel`` over a model axis of 2 (80 tokens, 40
    a rank): logits against JAX's sequence-parallel forward on a model=2
    mesh, the gradient of their sum against JAX's local one; off the mesh
    the same config runs local attention."""
    params = _vivit_params()
    sp = dataclasses.replace(jcfg.ViViTConfig(**VIVIT), sequence_parallel=True)
    clips = np.random.default_rng(3).random((2, 5, 32, 32, 1)).astype(np.float32)
    spec = _jspec(model_parallel=2)
    with spec.mesh:
        want = jax.jit(lambda p, c: JViViT(sp).apply({"params": p}, c))(params,
                                                                          jnp.asarray(clips))
    grads = jax.jit(jax.grad(lambda p: JViViT(jcfg.ViViTConfig(**VIVIT)).apply(
        {"params": p}, jnp.asarray(clips)).sum()))(params)
    sd = {k: v.numpy() for k, v in convert.vivit_state_dict_from_flax(params).items()}
    out = group.run(tasks.vivit_sp, dict(VIVIT, sequence_parallel=True), sd, clips,
                    {"model_parallel": 2})
    want_g = convert.vivit_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    for o in out:
        np.testing.assert_allclose(o["logits"], np.asarray(want), rtol=TOL, atol=TOL)
        for name, w in want_g.items():
            w = w.numpy()
            np.testing.assert_allclose(o["grads"][name], w, rtol=0,
                                       atol=TOL * max(np.abs(w).max(), 1e-6), err_msg=name)
    model = ViViT(tcfg.ViViTConfig(**VIVIT, sequence_parallel=True)).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.no_grad():
        off = model(torch.from_numpy(clips)).numpy()
    np.testing.assert_allclose(off, np.asarray(want), rtol=TOL, atol=TOL)


UNET = dict(im_size=8, base_channels=16, channel_mult=(1, 2), num_res_blocks=1,
            attention_resolutions=(1, 2), num_heads=2, time_embed_dim=16,
            audio_embed_dim=16, audio_proj_dim=4, im_cond_channels=4,
            audio_samples=800, num_timesteps=10, dtype="float32", dropout=0.0)


def test_unet_sequence_parallel_matches_jax(group):
    """UNetAudio with ``sequence_parallel`` over a model axis of 2: its
    attention at ds 1 (64 tokens) and ds 2 (16) through the ring; ε against
    JAX's sequence-parallel forward on a model=2 mesh."""
    cfg = jcfg.DiffusionConfig(**UNET)
    rng = np.random.default_rng(4)
    xt, cond = (rng.standard_normal((2, 8, 8, 3)).astype(np.float32) for _ in range(2))
    audio = rng.standard_normal((2, 800)).astype(np.float32)
    t = np.asarray([3, 7], np.int32)
    shapes = jax.eval_shape(JUNetAudio(cfg).init, jax.random.key(0), xt, cond, audio, t)
    params = jax.tree_util.tree_map(
        lambda a: (0.5 * rng.standard_normal(a.shape) / np.sqrt(max(1, np.prod(a.shape[:-1]))))
        .astype(np.float32), shapes["params"])
    spec = _jspec(model_parallel=2)
    model = JUNetAudio(dataclasses.replace(cfg, sequence_parallel=True))
    with spec.mesh:
        want = jax.jit(lambda p, *a: model.apply({"params": p}, *a))(
            params, *map(jnp.asarray, (xt, cond, audio, t)))
    sd = {k: v.numpy() for k, v in convert.unet_audio_state_dict_from_flax(
        params, tcfg.DiffusionConfig(**UNET)).items()}
    out = group.run(tasks.unet_sp, dict(UNET, sequence_parallel=True), sd, xt, cond, audio,
                    t.astype(np.int64), {"model_parallel": 2})
    for o in out:
        np.testing.assert_allclose(o, np.asarray(want), rtol=TOL, atol=TOL)


def test_ring_over_a_sharded_data_axis_is_refused(group):
    """A ring over ``data`` while the data ranks hold different rows of the
    batch would mix them: ``ValueError``."""
    sd = {k: v.numpy() for k, v in convert.vivit_state_dict_from_flax(_vivit_params(1)).items()}
    with pytest.raises(RuntimeError, match="is the data axis"):
        group.run(tasks.vivit_sp_over_data, VIVIT, sd)
