"""The lip-sync GAN's train step with tensor parallelism against the JAX
package's: the generator's, the discriminator's and the frozen SyncNet's
leaves cut where JAX's ``param_partition_spec`` cuts them, on a gloo group
of two ranks on the CPU against JAX's tp2 mesh on 2 of its CPU devices.
Bounds and helpers as in ``test_torch_port_tensor_parallel.py``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from lipreading_video_generation_tpu.core.config import GanConfig as JGanCfg
from lipreading_video_generation_tpu.parallel import mesh as jmesh
from lipreading_video_generation_tpu_torch.models import convert

import torch_parallel_tasks as tasks
from test_torch_port_tensor_parallel import _adam_rule, _gan_shapes, _jax_layout, _jspec
from torch_parallel_tasks import LocalGroup


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    with LocalGroup(2, str(tmp_path_factory.mktemp("gloo2") / "store")) as g:
        yield g


@pytest.fixture(scope="module")
def gan_tp():
    """JAX's GAN step on its tp2 mesh (threshold 2048, state placed by
    ``shard_state``) from seeded weights at width 0.25, batch 2, float32,
    on a batch prepared by JAX's eager ``prepare_batch``."""
    from lipreading_video_generation_tpu.core.config import AudioConfig as JAudioCfg
    from lipreading_video_generation_tpu.pipelines import train_gan as jtg
    from lipreading_video_generation_tpu_torch.data import datasets as tdata

    kw = dict(model_width=0.25, batch_size=2, dtype="float32")
    cfg = JGanCfg(**kw)
    shapes = _gan_shapes(0.25)

    def tree(name, seed):
        rng = np.random.default_rng(seed)

        def fill(path, leaf):
            key = jax.tree_util.keystr(path)
            if key.endswith("['kernel']"):
                v = rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
            elif key.endswith("['scale']"):
                v = 1.0 + 0.05 * rng.standard_normal(leaf.shape)
            else:
                v = 0.05 * rng.standard_normal(leaf.shape)
            return v.astype(np.float32)
        return jax.tree_util.tree_map_with_path(fill, shapes[name]["params"])

    params = {"gen": tree("gen", 0), "disc": tree("disc", 1), "sync": tree("sync", 2)}
    clips = tdata.synthetic_av_clips(n_clips=3, frames=30, img=64, seed=0)
    raw = tdata.GanWindowSampler(clips, cfg.syncnet_T, seed=0).sample_batch(2)
    prep = {k: np.array(v) for k, v in jtg.prepare_batch(
        {k: jnp.asarray(v) for k, v in raw.items()}, cfg, JAudioCfg()).items()}
    gen_tx = optax.adam(cfg.learning_rate, b1=cfg.adam_b1, b2=cfg.adam_b2)
    disc_tx = optax.adam(cfg.disc_learning_rate, b1=cfg.adam_b1, b2=cfg.adam_b2)
    state = jtg.GanTrainState(
        step=jnp.zeros((), jnp.int32), gen_params=params["gen"], disc_params=params["disc"],
        gen_opt=gen_tx.init(params["gen"]), disc_opt=disc_tx.init(params["disc"]),
        syncnet_params=params["sync"], syncnet_wt=jnp.asarray(0.03, jnp.float32),
        gen_tx=gen_tx, disc_tx=disc_tx)
    spec = _jspec(model_parallel=2, model_shard_threshold=2048)
    real_prep = jtg.prepare_batch
    jtg.prepare_batch = lambda b, cfg, audio_cfg: b
    try:
        with spec.mesh:
            state = jmesh.shard_state(spec, state)
            state, m = jtg.gan_train_step(state, jmesh.shard_batch(spec, prep),
                                          jax.random.key(0), cfg)
    finally:
        jtg.prepare_batch = real_prep
    layout = {name: _jax_layout(shapes[name]["params"], spec, bridge) for name, bridge in (
        ("gen", convert.generator_state_dict_from_flax),
        ("disc", convert.discriminator_state_dict_from_flax),
        ("sync", convert.syncnet_state_dict_from_flax))}
    return {"kw": kw, "params": params, "prep": prep, "layout": layout,
            "metrics": {k: float(v) for k, v in m.items()},
            "gen": {k: v.numpy() for k, v in convert.generator_state_dict_from_flax(
                jax.tree_util.tree_map(np.asarray, state.gen_params)).items()},
            "disc": {k: v.numpy() for k, v in convert.discriminator_state_dict_from_flax(
                jax.tree_util.tree_map(np.asarray, state.disc_params)).items()}}


def test_tp2_gan_step_matches_jax_mesh(tp2, gan_tp):
    """One G+D step on tp2 with the sync gate open: the generator's,
    discriminator's and frozen SyncNet's leaves cut where JAX's rule cuts
    them, every loss term within 1e-5 relative of JAX's tp2 mesh step, both
    networks' params by the Adam rule, and both ranks' params and gradients
    (of the replicated leaves and the gathered slices) equal bit for bit."""
    kw = dict(gan_tp["kw"], syncnet_wt=0.03)
    out = tp2.run(tasks.gan_dp, kw, gan_tp["params"], gan_tp["prep"],
                  {"model_parallel": 2, "model_shard_threshold": 2048})
    assert out[0]["tp"] == out[1]["tp"] == gan_tp["layout"]
    assert all(len(v) > 3 for v in gan_tp["layout"].values())
    for name, want in gan_tp["metrics"].items():
        if name in out[0]["metrics"][0]:
            np.testing.assert_allclose(float(out[0]["metrics"][0][name]), want, rtol=1e-5,
                                       atol=1e-7, err_msg=name)
    for net in ("gen", "disc"):
        _adam_rule(out[0][net], gan_tp[net], 1e-4)
        for k in out[0][net]:
            assert np.array_equal(out[0][net][k], out[1][net][k]), (net, k)
        for k, g in out[0]["grads"][net].items():
            assert np.array_equal(g, out[1]["grads"][net][k]), (net, k)
