"""The port's mesh, data parallelism and ZeRO-1 against the JAX package's.

The port runs one process per device: two ranks of a gloo group on the CPU
(``torch_parallel_tasks.LocalGroup``, spawned once for the module, joined through
a ``FileStore`` under the test's temporary directory), running the
functions of ``torch_parallel_tasks`` (which import no JAX). JAX runs here
on two devices of its 8-device CPU mesh (``tests/conftest.py``), from the
same numpy inputs and bridged weights.

Bounds: the data-parallel diffusion and GAN steps in float32 hold the loss
within 1e-5 relative of JAX's mesh step; the diffusion step's averaged
gradient (the whole vector) within 1e-4 relative L2 of JAX's (other
summation orders in every conv and GEMM: the port on one process lies
5.2e-5 from JAX at these params) and within 1e-6 of the port's own on one
process (the mean over the ranks' halves: 2e-7); after an Adam step the
params are within 2·lr, off by more than 1e-6 in at most 1% of them
(Adam's first step is about lr·sign(g), so a gradient within float32 noise
of 0 may step either way). The ranks end
with the same params bit for bit, and ZeRO-1 gives plain data
parallelism's bits. Serving on two ranks gives one rank's uint8 frames
within one level (other batch sizes in the convs) and its log-probs within
1e-5.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from lipreading_video_generation_tpu.core.config import DiffusionConfig as JDiffCfg
from lipreading_video_generation_tpu.core.config import GanConfig as JGanCfg
from lipreading_video_generation_tpu.core.config import MeshConfig as JMeshCfg
from lipreading_video_generation_tpu.models.unet_audio import UNetAudio as JUNetAudio
from lipreading_video_generation_tpu.parallel import mesh as jmesh
from lipreading_video_generation_tpu.pipelines import losses as jlosses
from lipreading_video_generation_tpu.pipelines import train_diffusion as jtd
from lipreading_video_generation_tpu_torch.core import prng as tprng
from lipreading_video_generation_tpu_torch.core.config import MeshConfig
from lipreading_video_generation_tpu_torch.models import convert
from lipreading_video_generation_tpu_torch.parallel import mesh as tmesh

import torch_parallel_tasks as tasks
from torch_parallel_tasks import LocalGroup

DIFF = dict(im_size=8, base_channels=16, channel_mult=(1, 2), num_res_blocks=1,
            attention_resolutions=(2,), num_heads=2, time_embed_dim=16,
            audio_embed_dim=16, audio_proj_dim=4, im_cond_channels=4,
            audio_samples=800, num_timesteps=50, dropout=0.0, dtype="float32")
B = 4


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    with LocalGroup(2, str(tmp_path_factory.mktemp("gloo") / "store")) as g:
        yield g


def _jspec(**kw):
    return jmesh.build_mesh(JMeshCfg(**kw), devices=jax.devices()[:2])


def test_build_mesh_shapes_and_errors(group):
    info = group.run(tasks.mesh_info, {})
    assert [i["shape"] for i in info] == [{"data": 2, "model": 1}] * 2
    assert [i["data_rank"] for i in info] == [0, 1]
    assert [i["primary"] for i in info] == [True, False]
    assert [i["slice"] for i in info] == [(0, 4), (4, 4)]
    info = group.run(tasks.mesh_info, {"model_parallel": 2})
    assert [i["shape"] for i in info] == [{"data": 1, "model": 2}] * 2
    assert [i["model_rank"] for i in info] == [0, 1]
    assert dict(_jspec(model_parallel=2).mesh.shape) == info[0]["shape"]
    for kw in (dict(model_parallel=3), dict(data_parallel=3), dict(data_parallel=2,
                                                                   model_parallel=2)):
        with pytest.raises(ValueError) as want:
            _jspec(**kw)
        assert group.run(tasks.mesh_error, kw) == [str(want.value)] * 2


def test_shard_batch_and_indivisible_batches(group):
    """Each rank's rows are the addressable shard JAX puts on its device; a
    batch whose rows the data axis does not divide stays whole, as JAX
    replicates it; the step axis of a stacked batch is kept."""
    batch = {"x": np.arange(8).reshape(4, 2), "y": np.arange(3)}
    stacked = {"x": np.arange(24).reshape(3, 4, 2), "y": np.arange(21).reshape(3, 7)}
    got = group.run(tasks.shard_rows, batch, stacked)
    jb = jmesh.shard_batch(_jspec(), batch)
    for r in range(2):
        np.testing.assert_array_equal(got[r]["batch"]["x"],
                                      np.asarray(jb["x"].addressable_shards[r].data))
        np.testing.assert_array_equal(got[r]["batch"]["y"], batch["y"])
        np.testing.assert_array_equal(got[r]["stacked"]["x"], stacked["x"][:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(got[r]["stacked"]["y"], stacked["y"])
        assert got[r]["rows"] == (4, 2 * r, 2)
        np.testing.assert_array_equal(got[r]["global"], [0, 1, 10, 11])
    assert jb["y"].sharding.spec == jax.sharding.PartitionSpec()


def test_collectives_and_their_gradients(group):
    """``psum``'s VJP is a psum; ``ppermute``'s backward sends the gradient
    back; ``copy_to`` / ``reduce_from`` and ``scatter_to`` / ``gather_from``
    hand a replicated consumer's gradient back once (rank r's input is
    scaled by r + 1)."""
    out = group.run(tasks.collectives)
    for r, o in enumerate(out):
        s = r + 1
        np.testing.assert_allclose(o["psum_grad"], [s * 3.0] * 3)         # r·Σ_ranks w
        other = 2 - r                                       # the rank we sent to, scaled
        np.testing.assert_allclose(o["ppermute_grad"], s * other * np.array([1, 10, 100.0]))
        np.testing.assert_allclose(o["copy_to_grad"], [3.0] * 3)          # Σ_ranks r
        np.testing.assert_allclose(o["reduce_from"], [3.0, 6.0, 9.0])
        np.testing.assert_allclose(o["reduce_from_grad"], s * 2 * np.array([3.0, 6.0, 9.0]))
        np.testing.assert_allclose(o["scatter_gather"], [0.0, 1.0, 4.0, 9.0])
        np.testing.assert_allclose(o["scatter_gather_grad"], [0.0, 4.0, 12.0, 24.0])
        assert float(o["pmean"]) == 1.5


# ---------------------------------------------------------------------------
# data-parallel training against JAX's mesh


def _draws(seed, n=2):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, DIFF["num_timesteps"], B),
             rng.standard_normal((B, 8, 8, 3)).astype(np.float32)) for _ in range(n)]


def _diff_batch(seed):
    rng = np.random.default_rng(seed)
    return {"target_frame": rng.integers(0, 256, (B, 8, 8, 3), dtype=np.uint8),
            "cond_frame": rng.integers(0, 256, (B, 8, 8, 3), dtype=np.uint8),
            "audio": rng.standard_normal((B, 800)).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_dp():
    """JAX's loss and gradient of the ε-MSE on its 2-device mesh (the batch
    sharded over ``data``) at params drawn from seeded numpy for the tree
    Flax's init builds (``jax.eval_shape``: nothing runs eagerly), and
    optax's Adam step of it."""
    cfg = JDiffCfg(**DIFF)
    rng = np.random.default_rng(1)
    shapes = jax.eval_shape(JUNetAudio(cfg).init, jax.random.key(0), jnp.zeros((1, 8, 8, 3)),
                            jnp.zeros((1, 8, 8, 3)), jnp.zeros((1, 800)),
                            jnp.zeros((1,), jnp.int32))["params"]
    params = jax.tree_util.tree_map(   # every leaf drawn: no zero-initialised layer
        lambda a: (0.2 * rng.standard_normal(a.shape) / np.sqrt(max(1, np.prod(a.shape[:-1]))))
        .astype(np.float32), shapes)
    batch, (t, noise) = _diff_batch(2), _draws(3)[0]
    spec = _jspec()
    sched = jtd.make_scheduler(cfg.scheduler, cfg.num_timesteps, cfg.beta_start, cfg.beta_end)

    def loss_fn(p, b, t, noise):
        prep = jtd.prepare_batch(b, cfg)
        noisy = sched.add_noise(prep["target"], noise, t)
        pred = JUNetAudio(cfg).apply({"params": p}, noisy, prep["cond"], prep["audio"], t)
        return jlosses.noise_mse(pred, noise)

    with spec.mesh:
        sharded = jmesh.shard_batch(spec, {**batch, "t": t, "noise": noise})
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            params, {k: sharded[k] for k in batch}, sharded["t"], sharded["noise"])
    tx = optax.adam(cfg.learning_rate)
    updates, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, updates)
    np_tree = lambda tree: jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)  # noqa
    bridge = lambda tree: {k: v.numpy() for k, v in  # noqa: E731
                           convert.unet_audio_state_dict_from_flax(np_tree(tree), cfg).items()}
    return {"params0": bridge(params), "batch": batch, "draws": [(t, noise)],
            "loss": float(loss), "grads": bridge(grads), "params1": bridge(new)}


def _adam_rule(got: dict, want: dict, lr: float, share: float = 1e-2):
    d = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert d.max() <= 2 * lr * (1 + 1e-3) and (d > 1e-6).mean() <= share, (
        d.max(), (d > 1e-6).mean())


def test_dp_diffusion_step_matches_jax_mesh(group, jax_dp):
    """One data-parallel diffusion step, 2 rows a rank: the averaged loss
    and gradients against JAX's on its 2-device mesh, the params after Adam
    against optax's step of JAX's gradient, the same on both ranks."""
    out = group.run(tasks.diffusion_dp, DIFF, jax_dp["params0"], [jax_dp["batch"]],
                    jax_dp["draws"], {})
    np.testing.assert_allclose([o["losses"][0] for o in out], jax_dp["loss"], rtol=1e-5)
    # the whole gradient: against JAX, the two frameworks' float32 (the port
    # on one process lies as far from JAX); against the port on one process,
    # only the mean over the ranks' halves
    names = list(jax_dp["grads"])
    flat = lambda g: np.concatenate([np.asarray(g[n]).ravel() for n in names])  # noqa: E731
    want, got = flat(jax_dp["grads"]), flat(out[0]["grads"])
    one = flat(tasks.diffusion_dp(DIFF, jax_dp["params0"], [jax_dp["batch"]], jax_dp["draws"],
                                  {})["grads"])
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)
    assert np.linalg.norm(got - one) <= 1e-6 * np.linalg.norm(want)
    _adam_rule(out[0]["params"], jax_dp["params1"], DIFF.get("learning_rate", 1e-4))
    for k in out[0]["params"]:
        assert np.array_equal(out[0]["params"][k], out[1]["params"][k]), k
        assert np.array_equal(out[0]["ema"][k], out[1]["ema"][k]), k


def test_zero1_layout_and_bits_equal_plain_dp(group, jax_dp, tmp_path):
    """Two steps with ZeRO-1 (``zero1_min_size=0``): each rank's Adam
    moments have the shape ``zero1_partition_spec`` gives (JAX's function
    on the same shapes), the params equal plain data parallelism's bit for
    bit, and the checkpoint holds the whole moments."""
    batches, draws = [jax_dp["batch"], _diff_batch(5)], _draws(6)
    plain = group.run(tasks.diffusion_dp, DIFF, jax_dp["params0"], batches, draws, {})
    z1 = group.run(tasks.diffusion_dp, DIFF, jax_dp["params0"], batches, draws,
                   {"zero1": True, "zero1_min_size": 0}, str(tmp_path))
    for r in range(2):
        for k in plain[r]["params"]:
            assert np.array_equal(plain[r]["params"][k], z1[r]["params"][k]), k
        assert plain[r]["losses"] == z1[r]["losses"]
    jspec = _jspec(zero1=True, zero1_min_size=0)
    sharded = 0
    for name, (shape, d) in z1[0]["moments"].items():
        full = jax_dp["params0"][name].shape
        want = tuple(jmesh.zero1_partition_spec(np.zeros(full, np.float32), jspec))
        if "data" in want:
            sharded += 1
            assert d == want.index("data")
            assert shape == tuple(n // 2 if i == d else n for i, n in enumerate(full)), name
        else:
            assert shape == full and d is None, name
    assert sharded > 10
    assert all(s == jax_dp["params0"][n].shape
               for s, n in zip(z1[0]["checkpoint"].values(), z1[0]["moments"]))


class _TwoDataRanks(tmesh.MeshSpec):
    """A spec that says it has two data ranks (the layout rules read sizes only)."""

    @property
    def data_size(self):
        return 2


def test_zero1_partition_spec_matches_jax():
    """The layout rule itself on JAX's cases: the data axis on the largest
    divisible dim, small leaves and scalars replicated."""
    for shape, min_size in (((128, 64), 0), ((3, 64), 0), ((3, 5), 0), ((), 0), ((96,), 0),
                            ((4, 4), 2**16), ((2, 6, 4), 0)):
        leaf = np.zeros(shape, np.float32)
        want = jmesh.zero1_partition_spec(leaf, _jspec(zero1=True, zero1_min_size=min_size))
        spec = _TwoDataRanks(None, zero1=True, zero1_min_size=min_size)
        assert tmesh.zero1_partition_spec(leaf, spec) == tuple(want), shape


@pytest.fixture(scope="module")
def gan_setup():
    """JAX's GAN step on its 2-device mesh from seeded weights at width 0.25,
    batch 2, float32, on a batch prepared by JAX's eager ``prepare_batch``."""
    from lipreading_video_generation_tpu.core.config import AudioConfig as JAudioCfg
    from lipreading_video_generation_tpu.models.discriminator import Discriminator as JDisc
    from lipreading_video_generation_tpu.models.generator import TalkingFaceGenerator as JGen
    from lipreading_video_generation_tpu.models.syncnet import SyncNet as JSync
    from lipreading_video_generation_tpu.pipelines import train_gan as jtg
    from lipreading_video_generation_tpu_torch.data import datasets as tdata

    kw = dict(model_width=0.25, batch_size=2, dtype="float32")
    cfg = JGanCfg(**kw)
    t = cfg.syncnet_T

    def tree(module, seed, *inputs):
        rng = np.random.default_rng(seed)
        shapes = jax.eval_shape(module.init, jax.random.key(0), *inputs)["params"]

        def fill(path, leaf):
            name = jax.tree_util.keystr(path)
            if name.endswith("['kernel']"):
                v = rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
            elif name.endswith("['scale']"):
                v = 1.0 + 0.05 * rng.standard_normal(leaf.shape)
            else:
                v = 0.05 * rng.standard_normal(leaf.shape)
            return v.astype(np.float32)
        return jax.tree_util.tree_map_with_path(fill, shapes)

    params = {"gen": tree(JGen(width=0.25), 0, jnp.zeros((1, t, 80, 16, 1)),
                          jnp.zeros((1, t, 96, 96, 6))),
              "disc": tree(JDisc(width=0.25), 1, jnp.zeros((1, t, 96, 96, 3))),
              "sync": tree(JSync(width=0.25), 2, jnp.zeros((1, 80, 16, 1)),
                           jnp.zeros((1, 48, 96, 3 * t)))}
    clips = tdata.synthetic_av_clips(n_clips=3, frames=30, img=64, seed=0)
    raw = tdata.GanWindowSampler(clips, t, seed=0).sample_batch(2)
    prep = {k: np.array(v) for k, v in jtg.prepare_batch(
        {k: jnp.asarray(v) for k, v in raw.items()}, cfg, JAudioCfg()).items()}
    gen_tx = optax.adam(cfg.learning_rate, b1=cfg.adam_b1, b2=cfg.adam_b2)
    disc_tx = optax.adam(cfg.disc_learning_rate, b1=cfg.adam_b1, b2=cfg.adam_b2)
    state = jtg.GanTrainState(
        step=jnp.zeros((), jnp.int32), gen_params=params["gen"], disc_params=params["disc"],
        gen_opt=gen_tx.init(params["gen"]), disc_opt=disc_tx.init(params["disc"]),
        syncnet_params=params["sync"], syncnet_wt=jnp.asarray(0.03, jnp.float32),
        gen_tx=gen_tx, disc_tx=disc_tx)
    spec = _jspec()
    real_prep = jtg.prepare_batch
    jtg.prepare_batch = lambda b, cfg, audio_cfg: b
    try:
        with spec.mesh:
            state, m = jtg.gan_train_step(state, jmesh.shard_batch(spec, prep),
                                          jax.random.key(0), cfg)
    finally:
        jtg.prepare_batch = real_prep
    return {"kw": kw, "params": params, "prep": prep,
            "metrics": {k: float(v) for k, v in m.items()},
            "gen": {k: v.numpy() for k, v in convert.generator_state_dict_from_flax(
                jax.tree_util.tree_map(np.asarray, state.gen_params)).items()},
            "disc": {k: v.numpy() for k, v in convert.discriminator_state_dict_from_flax(
                jax.tree_util.tree_map(np.asarray, state.disc_params)).items()}}


def test_dp_gan_step_matches_jax_mesh(group, gan_setup):
    """One G+D step with the sync gate open, a row a rank: every loss term
    within 1e-5 relative of JAX's mesh step, both networks' params by the
    Adam rule, the same on both ranks."""
    kw = dict(gan_setup["kw"], syncnet_wt=0.03)
    out = group.run(tasks.gan_dp, kw, gan_setup["params"], gan_setup["prep"], {})
    for name, want in gan_setup["metrics"].items():
        if name in out[0]["metrics"][0]:
            np.testing.assert_allclose(float(out[0]["metrics"][0][name]), want, rtol=1e-5,
                                       atol=1e-7, err_msg=name)
    for net in ("gen", "disc"):
        _adam_rule(out[0][net], gan_setup[net], 1e-4)
        for k in out[0][net]:
            assert np.array_equal(out[0][net][k], out[1][net][k]), (net, k)


def test_tensor_parallel_leaf_raises_citing_the_roadmap(group):
    """A model axis on which a parameter would be tensor-parallel (the MLP's
    1024×256 kernel at a threshold of 2^18) is refused; below it the model
    axis replicates compute."""
    out = group.run(tasks.tensor_parallel_refusal, 2**18)
    assert all("ROADMAP §1 item 9" in o["error"] for o in out)
    assert "blocks.0.mlp.fc1.weight" in out[0]["leaves"]
    assert [o["error"] for o in group.run(tasks.tensor_parallel_refusal, 2**22)] == [None] * 2


def test_train_loop_writes_once_and_ranks_agree(group, tmp_path):
    """``train_diffusion.train`` on the group: both ranks end at the same
    params bit for bit; the primary rank wrote the one checkpoint."""
    batches = [_diff_batch(s) for s in (7, 8)]
    out = group.run(tasks.diffusion_train_loop, DIFF, batches, str(tmp_path / "ck"), {})
    assert [o["step"] for o in out] == [2, 2]
    assert out[0]["files"] == out[1]["files"] == ["step_000000002.pt"]
    for k in out[0]["params"]:
        assert np.array_equal(out[0]["params"][k], out[1]["params"][k]), k


@pytest.mark.parametrize("zero1", [False, True])
def test_resume_equals_an_uninterrupted_run(group, tmp_path, zero1):
    """``train_diffusion.train`` on the group, stopped after 2 of 4 steps
    and resumed from its checkpoint (the Adam moments restored into the
    plain optimizer, then sliced for ZeRO-1), ends at the uninterrupted
    run's params bit for bit."""
    batches = [_diff_batch(s) for s in (7, 8, 9, 10)]
    mesh_kw = {"zero1": zero1, "zero1_min_size": 0}
    whole = group.run(tasks.diffusion_train_loop, DIFF, batches, str(tmp_path / "whole"),
                      mesh_kw, 4, 2)
    ck = str(tmp_path / "cut")
    first = group.run(tasks.diffusion_train_loop, DIFF, batches[:2], ck, mesh_kw, 2, 2)
    assert [o["step"] for o in first] == [2, 2]
    out = group.run(tasks.diffusion_train_loop, DIFF, batches[2:], ck, mesh_kw, 4, 2)
    assert [o["step"] for o in out] == [4, 4]
    assert out[0]["files"] == ["step_000000002.pt", "step_000000004.pt"]
    for r in range(2):
        for k, want in whole[0]["params"].items():
            assert np.array_equal(out[r]["params"][k], want), (r, k)


# ---------------------------------------------------------------------------
# data-parallel serving: two ranks against one


def _seeded_sd(build, seed=0):
    return {k: v.numpy() for k, v in tprng.seeded(build, seed).state_dict().items()}


def test_sample_video_two_ranks_equal_one(group):
    """A 5-frame clip over 2 ranks (padded to 6): every step's noise drawn
    for the whole clip, so the frames equal one rank's within a level."""
    from lipreading_video_generation_tpu_torch.core.config import DiffusionConfig
    from lipreading_video_generation_tpu_torch.models.unet_audio import UNetAudio

    params = _seeded_sd(lambda: UNetAudio(DiffusionConfig(**DIFF)))
    rng = np.random.default_rng(9)
    cond = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    audio = rng.standard_normal((5, 800)).astype(np.float32)
    want = tasks.sample_video_dp(DIFF, params, cond, audio, 4, 3, None).numpy()
    got = group.run(tasks.sample_video_dp, DIFF, params, cond, audio, 4, 3, {})
    assert got[0].shape == want.shape == (5, 8, 8, 3)
    assert np.array_equal(got[0], got[1])
    assert np.abs(got[0].astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("gan_kw", [{}, {"serve_int8": True},
                                    {"serve_int8": True, "serve_int8_static": True}],
                         ids=["float", "int8", "int8_static"])
def test_generate_frames_two_ranks_equal_one(group, gan_kw):
    """7 frames in batches of 4 over 2 ranks (each batch padded to a data
    multiple), float and both int8 modes: one rank's frames within a level."""
    from lipreading_video_generation_tpu_torch.models.generator import TalkingFaceGenerator

    params = _seeded_sd(lambda: TalkingFaceGenerator(width=0.125))
    rng = np.random.default_rng(10)
    frames = rng.integers(0, 256, (7, 40, 48, 3), dtype=np.uint8)
    boxes = np.tile(np.asarray([4.0, 36.0, 6.0, 42.0], np.float32), (7, 1))
    mels = rng.standard_normal((7, 80, 16)).astype(np.float32)
    args = (params, frames, boxes, mels, 0.125, gan_kw, 4)
    want = tasks.generate_frames_dp(*args, None)
    got = group.run(tasks.generate_frames_dp, *args, {})
    assert got[0].shape == want.shape == frames.shape
    assert np.array_equal(got[0], got[1])
    assert np.abs(got[0].astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_predict_sharded_two_ranks_equal_one(group, int8):
    """13 clips over 2 ranks (padded to 14): one rank's log-probs."""
    from lipreading_video_generation_tpu_torch.core.config import ViViTConfig
    from lipreading_video_generation_tpu_torch.models.vivit import ViViT

    kw = dict(num_classes=8, hidden_size=32, num_layers=2, num_heads=2, mlp_dim=64,
              dtype="float32")
    params = _seeded_sd(lambda: ViViT(ViViTConfig(**kw)))
    clips = np.random.default_rng(11).integers(0, 256, (13, 5, 32, 32, 1), dtype=np.uint8)
    want = tasks.predict_sharded_dp(kw, params, clips, int8, None).numpy()
    got = group.run(tasks.predict_sharded_dp, kw, params, clips, int8, {})
    assert got[0].shape == want.shape == (13, 8)
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], want, atol=1e-5)


def test_one_process_mesh_is_the_identity():
    """Without a process group the mesh is 1×1 and every helper is a no-op."""
    spec = tmesh.build_mesh(MeshConfig())
    assert tmesh.is_degenerate(spec) and spec.shape == {"data": 1, "model": 1}
    x = torch.arange(6.0)
    assert tmesh.ppermute(x, spec, "model") is x and tmesh.psum(x, spec, "data") is x
    assert tmesh.shard_batch(spec, {"x": x})["x"] is x
    with pytest.raises(ValueError, match="does not divide device count 1"):
        tmesh.build_mesh(MeshConfig(model_parallel=2))
