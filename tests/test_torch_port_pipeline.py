"""The port's GPipe pipeline over the model axis against the JAX package's.

Four ranks of a gloo group on the CPU (``torch_parallel_tasks.LocalGroup``, spawned once for
the module, through a ``FileStore`` under the test's temporary directory),
as many as JAX's own pipeline test gives its stages, run
``torch_parallel_tasks`` (no JAX imports); JAX runs on four devices of its
8-device CPU mesh, from the same numpy inputs and bridged weights
(``models.convert``, which also bridges JAX's stacked ``pp_params`` layout).

Bounds (float32): pipelined logits within 1e-5 of JAX's ``apply_pipelined``
(the same layers in the same order, microbatches only reordered); one
pipeline train step's loss within 1e-5 relative and every parameter's
gradient within 1e-5 of its tensor's largest of JAX's canonical (non-pp)
gradient, leaf by leaf: the blocks on their stage, the embedding, final
LayerNorm and head (replicated) on every rank; the updated params within
2·lr, more than 1e-6 off in at most 1% of them (Adam's first step is about
lr·sign(g) whatever |g| is).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lipreading_video_generation_tpu.core import config as jcfg
from lipreading_video_generation_tpu.models.vivit import ViViT as JViViT
from lipreading_video_generation_tpu.models.vivit import apply_pipelined as japply
from lipreading_video_generation_tpu.models.vivit import pp_params as jpp_params
from lipreading_video_generation_tpu.parallel import mesh as jmesh
from lipreading_video_generation_tpu.pipelines import losses as jlosses
from lipreading_video_generation_tpu.pipelines import train_vivit as jtv
from lipreading_video_generation_tpu_torch.core import config as tcfg
from lipreading_video_generation_tpu_torch.models import convert
from lipreading_video_generation_tpu_torch.models.vivit import (ViViT, pp_params,
                                                                pp_params_to_canonical)
from lipreading_video_generation_tpu_torch.parallel import pipeline as pipe
from lipreading_video_generation_tpu_torch.pipelines import train_vivit as ttv

import torch_parallel_tasks as tasks
from torch_parallel_tasks import LocalGroup

CFG = dict(num_classes=8, hidden_size=32, num_layers=4, num_heads=2, mlp_dim=64,
           dtype="float32")
B = 8


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    with LocalGroup(4, str(tmp_path_factory.mktemp("gloo") / "store")) as g:
        yield g


@pytest.fixture(scope="module")
def flax_params():
    shapes = jax.eval_shape(JViViT(jcfg.ViViTConfig(**CFG)).init, jax.random.key(0),
                            jnp.zeros((1, 5, 32, 32, 1)))["params"]
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) / np.sqrt(max(1, np.prod(a.shape[:-1]))))
        .astype(np.float32), shapes)


def _np_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"clips": rng.integers(0, 256, (B, 5, 32, 32, 1), dtype=np.uint8),
            "labels": rng.integers(0, 8, (B,), dtype=np.int32)}


def _jspec(mp):
    return jmesh.build_mesh(jcfg.MeshConfig(model_parallel=mp), devices=jax.devices()[:4])


def test_layouts_and_bridges(flax_params):
    """``stack_blocks`` / ``unstack_blocks`` round trip; the port's stacked
    layout of the bridged params equals the bridge of JAX's ``pp_params``;
    ``flax_vivit_params_from_state_dict`` gives JAX's trees back in both
    layouts; ``pp_state_sharding`` splits only the blocks."""
    jcfg_ = jcfg.ViViTConfig(**CFG)
    sd = convert.vivit_state_dict_from_flax(flax_params)
    stacked = pp_params(sd, tcfg.ViViTConfig(**CFG))
    assert stacked["blocks.qkv.weight"].shape == (4, 96, 32)
    back = pp_params_to_canonical(stacked, tcfg.ViViTConfig(**CFG))
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    from_jax = convert.vivit_pp_state_dict_from_flax(jpp_params(dict(flax_params), jcfg_), 4)
    assert all(torch.equal(from_jax[k], sd[k]) for k in sd)
    for pipeline, want in ((False, flax_params), (True, jpp_params(dict(flax_params), jcfg_))):
        got = convert.flax_vivit_params_from_state_dict(sd, pipeline=pipeline)
        jax.tree_util.tree_map(np.testing.assert_array_equal, got,
                               jax.tree_util.tree_map(np.asarray, want))

    class _Four:
        model_axis, model_size, mesh = "model", 4, object()

    layout = pipe.pp_state_sharding(_Four(), stacked)
    assert layout["blocks.qkv.weight"] == ("model",) and layout["head.weight"] == ()


@pytest.mark.parametrize("mp,n_micro", [(4, None), (2, 2), (4, 1), (1, None)])
def test_pipelined_forward_matches_jax(group, flax_params, mp, n_micro):
    """dp×pp meshes of 4 ranks: pipelined logits against JAX's
    ``apply_pipelined`` on 4 devices."""
    clips = np.random.default_rng(1).random((B, 5, 32, 32, 1)).astype(np.float32)
    spec = _jspec(mp)
    want = jax.jit(lambda p, c: japply(jcfg.ViViTConfig(**CFG), p, c, spec, n_micro=n_micro))(
        jpp_params(dict(flax_params), jcfg.ViViTConfig(**CFG)), jnp.asarray(clips))
    stacked = _np_sd(pp_params(convert.vivit_state_dict_from_flax(flax_params),
                               tcfg.ViViTConfig(**CFG)))
    out = group.run(tasks.pp_forward, CFG, stacked, clips, n_micro, {"model_parallel": mp})
    for o in out:
        np.testing.assert_allclose(o, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_step(flax_params):
    """JAX's canonical step: loss, gradient and the AdamW update."""
    import optax

    cfg = jcfg.ViViTConfig(**CFG)
    batch = _batch(2)

    def loss_fn(p):
        logits = JViViT(cfg).apply({"params": p}, jtv.preprocess_clips(batch["clips"]))
        return jlosses.softmax_xent(logits, batch["labels"])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(flax_params)
    tx = jtv.make_optimizer(cfg)
    updates, _ = tx.update(grads, tx.init(flax_params), flax_params)
    new = optax.apply_updates(flax_params, updates)
    to_sd = lambda t: _np_sd(convert.vivit_state_dict_from_flax(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, t)))
    return {"batch": batch, "loss": float(loss), "grads": to_sd(grads), "params": to_sd(new)}


@pytest.mark.parametrize("mp,n_micro", [(4, None), (2, 2), (4, 4)])
def test_pp_train_step_matches_jax(group, flax_params, jax_step, mp, n_micro):
    """One pipeline train step (4 stages, or 2 stages × 2 data ranks): loss,
    every gradient leaf by leaf and the updated params against JAX's
    canonical step; each stage holds its layers only; every rank ends with
    the same canonical params."""
    sd = _np_sd(convert.vivit_state_dict_from_flax(flax_params))
    out = group.run(tasks.pp_step, CFG, sd, jax_step["batch"], n_micro, {"model_parallel": mp})
    per = 4 // mp
    for r, o in enumerate(out):
        np.testing.assert_allclose(o["loss"], jax_step["loss"], rtol=1e-5)
        stage = r % mp
        assert o["stage"] == list(range(stage * per, (stage + 1) * per))
        assert o["stage_leaf"] == (per, 96, 32)
        for name, g in o["grads"].items():
            w = jax_step["grads"][name]
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * max(np.abs(w).max(), 1e-6),
                                       err_msg=name)
        assert len(o["grads"]) == 7 + 12 * per    # the replicated leaves and its layers'
        d = np.concatenate([np.abs(o["params"][k] - jax_step["params"][k]).ravel()
                            for k in jax_step["params"]])
        assert d.max() <= 2e-4 * (1 + 1e-3) and (d > 1e-6).mean() <= 1e-2
        for k in o["params"]:
            assert np.array_equal(o["params"][k], out[0]["params"][k]), k


def test_pipeline_errors():
    """JAX's ``ValueError``s: stages that do not split the layers, pipeline
    and sequence parallelism together, dropout under the pipeline, a batch
    the microbatches do not divide."""
    class _Eight:
        model_axis, model_size, model_rank, mesh = "model", 8, 0, object()

    with pytest.raises(ValueError, match="stages"):
        pipe.stage_layers(4, _Eight())
    with pytest.raises(ValueError, match="model axis"):
        ttv.create_state_pp(tcfg.ViViTConfig(**CFG, sequence_parallel=True), device="cpu")
    with pytest.raises(ValueError, match="dropout"):
        ttv.create_state_pp(tcfg.ViViTConfig(**dict(CFG, dropout=0.1)), device="cpu")
    with pytest.raises(ValueError, match="dropout"):
        jtv.create_state_pp(jcfg.ViViTConfig(**dict(CFG, dropout=0.1)), jax.random.key(0))

    class _Two:
        model_axis, model_size, model_rank, mesh = "model", 2, 0, object()

    with pytest.raises(ValueError, match="not divisible by n_micro 4"):
        pipe.pipeline_blocks(lambda h: h, torch.zeros(6, 3), _Two(), n_micro=4)


def test_pp_state_on_one_process_is_the_model(flax_params):
    """On the 1×1 mesh the pipelined ViViT is one stage of every layer: the
    canonical logits."""
    cfg = tcfg.ViViTConfig(**CFG)
    sd = convert.vivit_state_dict_from_flax(flax_params)
    clips = torch.from_numpy(np.random.default_rng(3).random((3, 5, 32, 32, 1))
                             .astype(np.float32))
    model = ViViT(cfg).eval()
    model.load_state_dict(sd)
    from lipreading_video_generation_tpu_torch.models.vivit import apply_pipelined

    with torch.no_grad():
        np.testing.assert_allclose(apply_pipelined(cfg, pp_params(sd, cfg), clips, None).numpy(),
                                   model(clips).numpy(), rtol=1e-6, atol=1e-6)


def test_pp_train_loop_returns_the_canonical_model(group):
    """``train_vivit.train`` with ``pipeline_parallel`` on 2 stages × 2 data
    ranks: every rank ends with the same canonical ``ViViT`` (``block_i``
    keys) after its steps, with a finite eval."""
    batches = [_batch(s) for s in (4, 5)]
    out = group.run(tasks.pp_train_loop, dict(CFG, pipeline_parallel=True, batch_size=B),
                    batches, {"model_parallel": 2})
    keys = sorted(ViViT(tcfg.ViViTConfig(**CFG)).state_dict())
    for o in out:
        assert o["step"] == 2 and o["keys"] == keys and np.isfinite(o["best"]["loss"])
        for k in keys:
            assert np.array_equal(o["params"][k], out[0]["params"][k]), k
