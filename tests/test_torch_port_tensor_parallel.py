"""Tensor parallelism over the model axis against the JAX package's.

The JAX package shards every ≥2-D leaf of at least ``model_shard_threshold``
elements whose output dim the model axis divides (``param_partition_spec``)
and lets GSPMD partition the compute; the port cuts the same leaves to a
slice per model rank (``parallel.mesh.shard_params``) and runs its
``Linear``/conv layers column-parallel. The port runs on gloo groups of two
(tp2) and four (dp2×tp2) ranks on the CPU (``torch_parallel_tasks``), JAX
on 2 or 4 of its 8 CPU devices, from the same numpy inputs and bridged
weights.

Bounds, with the reasons:
- Layouts: the port's sharded leaves and their dims are exactly those of
  JAX's rule on the bridged leaves (JAX's own test sizes and thresholds).
- A float32 tp2 diffusion step: the loss within 1e-5 relative of JAX's
  mesh step, the whole gradient within 1e-4 relative L2 of JAX's (other
  summation orders in every conv and GEMM) and within 1e-6 of the port's
  on one process (a sharded layer's input gradient is the sum of two
  ranks' partial products), the params after Adam by ``_adam_rule`` (within
  2·lr, off by more than 1e-6 in at most 1%), the EMA within 1e-7 of one
  process's (0.0001 of an Adam step's difference).
- The GAN step (``test_torch_port_tensor_parallel_gan.py``): every loss
  term within 1e-5 relative of JAX's, both networks' params by
  ``_adam_rule``.
- The ranks agree bit for bit on every leaf and every gradient; ZeRO-1 on
  dp2×tp2 gives plain dp2×tp2's bits; int8 products are exact integers with
  per-output-channel scales, so int8 outputs under TP equal those without.
- Serving: log-probs within 1e-4 of one process (JAX's own bound for its
  dp×tp2 ``predict_sharded``); frames within one level in float.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from lipreading_video_generation_tpu.core.config import DiffusionConfig as JDiffCfg
from lipreading_video_generation_tpu.core.config import MeshConfig as JMeshCfg
from lipreading_video_generation_tpu.core.config import ViViTConfig as JViViTCfg
from lipreading_video_generation_tpu.models.discriminator import Discriminator as JDisc
from lipreading_video_generation_tpu.models.generator import TalkingFaceGenerator as JGen
from lipreading_video_generation_tpu.models.syncnet import SyncNet as JSync
from lipreading_video_generation_tpu.models.unet_audio import UNetAudio as JUNetAudio
from lipreading_video_generation_tpu.models.vivit import ViViT as JViViT
from lipreading_video_generation_tpu.parallel import mesh as jmesh
from lipreading_video_generation_tpu.pipelines import losses as jlosses
from lipreading_video_generation_tpu.pipelines import train_diffusion as jtd
from lipreading_video_generation_tpu_torch.core import config as tcfg
from lipreading_video_generation_tpu_torch.core import prng as tprng
from lipreading_video_generation_tpu_torch.models import convert
from lipreading_video_generation_tpu_torch.models.discriminator import Discriminator
from lipreading_video_generation_tpu_torch.models.generator import TalkingFaceGenerator
from lipreading_video_generation_tpu_torch.models.syncnet import SyncNet
from lipreading_video_generation_tpu_torch.models.unet_audio import UNetAudio
from lipreading_video_generation_tpu_torch.models.vivit import ViViT
from lipreading_video_generation_tpu_torch.parallel import mesh as tmesh
from lipreading_video_generation_tpu_torch.pipelines import train_diffusion as ttd

import torch_parallel_tasks as tasks
from torch_parallel_tasks import LocalGroup

DIFF = dict(im_size=8, base_channels=16, channel_mult=(1, 2), num_res_blocks=1,
            attention_resolutions=(2,), num_heads=2, time_embed_dim=16,
            audio_embed_dim=16, audio_proj_dim=4, im_cond_channels=4,
            audio_samples=800, num_timesteps=50, dropout=0.0, dtype="float32")
TP_DIFF = {"model_parallel": 2, "model_shard_threshold": 512}
VIVIT = dict(num_classes=8, hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128,
             dtype="float32")
B = 4


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    with LocalGroup(2, str(tmp_path_factory.mktemp("gloo2") / "store")) as g:
        yield g


@pytest.fixture(scope="module")
def dp2tp2(tmp_path_factory):
    with LocalGroup(4, str(tmp_path_factory.mktemp("gloo4") / "store")) as g:
        yield g


def _jspec(n=2, **kw):
    return jmesh.build_mesh(JMeshCfg(**kw), devices=jax.devices()[:n])


class _Ranks(tmesh.MeshSpec):
    """A spec that says how many data and model ranks it has (the layout
    rules read sizes only)."""

    def __init__(self, data=1, model=2, **kw):
        super().__init__(None, **kw)
        object.__setattr__(self, "_sizes", (data, model))

    @property
    def data_size(self):
        return self._sizes[0]

    @property
    def model_size(self):
        return self._sizes[1]


def _adam_rule(got: dict, want: dict, lr: float, share: float = 1e-2):
    d = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert d.max() <= 2 * lr * (1 + 1e-3) and (d > 1e-6).mean() <= share, (
        d.max(), (d > 1e-6).mean())


# ---------------------------------------------------------------------------
# layouts


def _jax_layout(shapes, spec, bridge):
    """The torch keys and dims JAX's ``param_partition_spec`` shards, read
    through the weight bridge: each sharded Flax leaf is filled with its
    index along the last dim (+1), every other leaf with zeros, so the
    bridged tensor is non-zero exactly where JAX shards and varies along
    the torch dim that JAX's last dim became."""
    def mark(leaf):
        if "model" not in tuple(jmesh.param_partition_spec(leaf, spec)):
            return np.zeros(leaf.shape, np.float32)
        n = leaf.shape[-1]
        return np.broadcast_to(np.arange(1, n + 1, dtype=np.float32), leaf.shape).copy()

    out = {}
    for key, t in bridge(jax.tree_util.tree_map(mark, shapes)).items():
        t = t.numpy()
        if not t.any():
            continue
        dims = [d for d in range(t.ndim) if t.shape[d] > 1 and np.array_equal(
            t, np.broadcast_to(np.arange(1, t.shape[d] + 1, dtype=np.float32).reshape(
                [-1 if i == d else 1 for i in range(t.ndim)]), t.shape))]
        assert len(dims) == 1, key
        out[key] = dims[0]
    return out


def _gan_shapes(width):
    t = 5
    return {"gen": jax.eval_shape(JGen(width=width).init, jax.random.key(0),
                                  jnp.zeros((1, t, 80, 16, 1)), jnp.zeros((1, t, 96, 96, 6))),
            "disc": jax.eval_shape(JDisc(width=width).init, jax.random.key(0),
                                   jnp.zeros((1, t, 96, 96, 3))),
            "sync": jax.eval_shape(JSync(width=width).init, jax.random.key(0),
                                   jnp.zeros((1, 80, 16, 1)), jnp.zeros((1, 48, 96, 3 * t)))}


_LAYOUT_CASES = {
    # JAX's test_gan_train_loop_tp2 (width 0.125, threshold 2048)
    "generator": (lambda: _gan_shapes(0.125)["gen"], 2048,
                  convert.generator_state_dict_from_flax,
                  lambda: TalkingFaceGenerator(width=0.125)),
    "discriminator": (lambda: _gan_shapes(0.125)["disc"], 2048,
                      convert.discriminator_state_dict_from_flax,
                      lambda: Discriminator(width=0.125)),
    "syncnet": (lambda: _gan_shapes(0.125)["sync"], 2048, convert.syncnet_state_dict_from_flax,
                lambda: SyncNet(width=0.125)),
    # JAX's test_diffusion_train_loop_tp2 (threshold 512)
    "unet": (lambda: jax.eval_shape(
        JUNetAudio(JDiffCfg(**dict(DIFF, im_size=16, base_channels=8, num_timesteps=10))).init,
        jax.random.key(0), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1, 16, 16, 3)),
        jnp.zeros((1, 800)), jnp.zeros((1,), jnp.int32)), 512,
        lambda p: convert.unet_audio_state_dict_from_flax(
            p, JDiffCfg(**dict(DIFF, im_size=16, base_channels=8))),
        lambda: UNetAudio(tcfg.DiffusionConfig(**dict(DIFF, im_size=16, base_channels=8)))),
    # JAX's test_predict_sharded_matches_single_device (threshold 4096)
    "vivit": (lambda: jax.eval_shape(JViViT(JViViTCfg(**VIVIT)).init, jax.random.key(0),
                                     jnp.zeros((1, 5, 32, 32, 1))), 4096,
              convert.vivit_state_dict_from_flax, lambda: ViViT(tcfg.ViViTConfig(**VIVIT))),
}


@pytest.mark.parametrize("case", list(_LAYOUT_CASES))
def test_sharded_leaves_and_dims_equal_jax(case):
    """The port's rule on its torch-layout leaves picks the leaves JAX's
    rule picks on the Flax leaves, on the same dims, frozen SyncNet
    included."""
    shapes, threshold, bridge, build = _LAYOUT_CASES[case]
    want = _jax_layout(shapes()["params"], _jspec(model_parallel=2,
                                                  model_shard_threshold=threshold), bridge)
    with torch.device("meta"):
        model = build()
    if case == "syncnet":
        model.requires_grad_(False)
    got = tmesh.tensor_parallel_leaves(_Ranks(model_shard_threshold=threshold), model)
    assert got == want and len(want) >= 3


def test_generator_at_width_one_shards_its_two_decoder_convs():
    """At the default threshold (2^22) a two-rank model axis shards exactly
    the generator's two 512×1024×3×3 decoder convs, in both packages."""
    with torch.device("meta"):
        gen = TalkingFaceGenerator(width=1.0)
    got = tmesh.tensor_parallel_leaves(_Ranks(), gen)
    assert got == {"decoder.layers.1.block.conv.weight": 0,
                   "decoder.layers.3.block.conv.weight": 0}
    assert tuple(gen.decoder.layers[1].block.conv.weight.shape) == (512, 1024, 3, 3)
    jshapes = _gan_shapes(1.0)["gen"]["params"]
    spec = _jspec(model_parallel=2)
    picked = [k for k, leaf in jax.tree_util.tree_leaves_with_path(jshapes)
              if "model" in tuple(jmesh.param_partition_spec(leaf, spec))]
    assert len(picked) == 2


def test_zero1_respects_tensor_parallel_claims_as_jax_does():
    """JAX's test_zero1_respects_tensor_parallel_claims on dp2×tp2, each
    Flax leaf against its torch layout (a Dense kernel (in, out) is a
    Linear weight (out, in)): the model axis on the output dim, the data
    axis on another dim, or none."""
    jspec = _jspec(4, model_parallel=2, zero1=True, model_shard_threshold=4096,
                   zero1_min_size=0)
    spec = _Ranks(2, 2, zero1=True, model_shard_threshold=4096, zero1_min_size=0)
    for shape in ((128, 64), (3, 4096), (3, 64), (64, 4096)):
        want = tuple(jmesh.zero1_partition_spec(np.zeros(shape, np.float32), jspec))
        got = tmesh.zero1_partition_spec(torch.empty(shape[::-1], device="meta"), spec,
                                         out_dim=0)
        assert got[::-1] == want + (None,) * (len(shape) - len(want)), shape
    assert tmesh.zero1_partition_spec(np.zeros((128, 64)), spec, out_dim=-1) == (
        "data", "model")


def test_column_parallel_layers_match_one_process(tp2):
    """Every layer kind the rule cuts, at a threshold that cuts all their
    weights: a Linear, a grouped Conv1d (its weight gathered at the use), a
    Conv2d with a bias and one without: the output, the input's gradient
    and every parameter's whole gradient against one process's."""
    x = np.random.default_rng(5).standard_normal((3, 12)).astype(np.float32)
    want = tasks.tp_layers(x, None)
    got = tp2.run(tasks.tp_layers, x, {"model_parallel": 2, "model_shard_threshold": 16})
    assert got[0]["tp"] == {"fc.weight": 0, "grouped.weight": 0, "conv.weight": 0,
                            "plain.weight": 0}
    for r in range(2):
        np.testing.assert_allclose(got[r]["out"], want["out"].numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[r]["x_grad"], want["x_grad"].numpy(), rtol=1e-6,
                                   atol=1e-6)
        for k, g in want["grads"].items():
            np.testing.assert_allclose(got[r]["grads"][k], g.numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=k)


def test_bf16_column_parallel_gradients_round_as_one_process(tp2):
    """The same stack computed in bf16: a sharded layer's input gradient
    is the sum of the model ranks' partial products, taken in float32 and
    rounded to bf16 once, where one process rounds it, so the output and
    every gradient equal one process's (at most 1% of the values may fall
    on the other side of a rounding; summing partials already rounded to
    bf16 moved 31-69% of each gradient's values)."""
    x = np.random.default_rng(5).standard_normal((256, 12)).astype(np.float32)
    want = tasks.tp_layers(x, None, torch.bfloat16)
    got = tp2.run(tasks.tp_layers, x, {"model_parallel": 2, "model_shard_threshold": 16},
                  torch.bfloat16)
    for r in range(2):
        assert np.array_equal(got[r]["out"], want["out"].numpy())
        pairs = [("x", got[r]["x_grad"], want["x_grad"])] + [
            (k, got[r]["grads"][k], g) for k, g in want["grads"].items()]
        for k, a, b in pairs:
            assert (np.asarray(a) != b.numpy()).mean() <= 1e-2, k


# ---------------------------------------------------------------------------
# a diffusion step


def _draws(seed, n=1):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, DIFF["num_timesteps"], B),
             rng.standard_normal((B, 8, 8, 3)).astype(np.float32)) for _ in range(n)]


def _diff_batch(seed):
    rng = np.random.default_rng(seed)
    return {"target_frame": rng.integers(0, 256, (B, 8, 8, 3), dtype=np.uint8),
            "cond_frame": rng.integers(0, 256, (B, 8, 8, 3), dtype=np.uint8),
            "audio": rng.standard_normal((B, 800)).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_tp():
    """JAX's loss and gradient of the ε-MSE on its tp2 mesh (params placed
    by ``shard_params`` at threshold 512), optax's Adam step of it, from
    params drawn with seeded numpy for the tree Flax's init builds; and the
    port's step on one process from the same params."""
    cfg = JDiffCfg(**DIFF)
    rng = np.random.default_rng(1)
    shapes = jax.eval_shape(JUNetAudio(cfg).init, jax.random.key(0), jnp.zeros((1, 8, 8, 3)),
                            jnp.zeros((1, 8, 8, 3)), jnp.zeros((1, 800)),
                            jnp.zeros((1,), jnp.int32))["params"]
    params = jax.tree_util.tree_map(
        lambda a: (0.2 * rng.standard_normal(a.shape) / np.sqrt(max(1, np.prod(a.shape[:-1]))))
        .astype(np.float32), shapes)
    batch, (t, noise) = _diff_batch(2), _draws(3)[0]
    spec = _jspec(**TP_DIFF)
    sched = jtd.make_scheduler(cfg.scheduler, cfg.num_timesteps, cfg.beta_start, cfg.beta_end)

    def loss_fn(p, b, t, noise):
        prep = jtd.prepare_batch(b, cfg)
        noisy = sched.add_noise(prep["target"], noise, t)
        pred = JUNetAudio(cfg).apply({"params": p}, noisy, prep["cond"], prep["audio"], t)
        return jlosses.noise_mse(pred, noise)

    with spec.mesh:
        placed = jmesh.shard_params(spec, params)
        sharded = jmesh.shard_batch(spec, {**batch, "t": t, "noise": noise})
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            placed, {k: sharded[k] for k in batch}, sharded["t"], sharded["noise"])
    assert any("model" in tuple(leaf.sharding.spec) for leaf in jax.tree_util.tree_leaves(placed))
    tx = optax.adam(cfg.learning_rate)
    updates, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, updates)
    np_tree = lambda tree: jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)  # noqa
    bridge = lambda tree: {k: v.numpy() for k, v in  # noqa: E731
                           convert.unet_audio_state_dict_from_flax(np_tree(tree), cfg).items()}
    out = {"params0": bridge(params), "batch": batch, "draws": [(t, noise)],
           "loss": float(loss), "grads": bridge(grads), "params1": bridge(new),
           "layout": _jax_layout(shapes, spec, lambda p: convert.unet_audio_state_dict_from_flax(
               p, cfg))}
    out["one"] = tasks.diffusion_dp(DIFF, out["params0"], [batch], out["draws"], None)
    return out


def _flat(g, names):
    return np.concatenate([np.asarray(g[n]).ravel() for n in names])


def test_tp2_diffusion_step_matches_jax_mesh(tp2, jax_tp):
    """One float32 step on tp2: the loss and the whole gradient against
    JAX's tp2 mesh step and the port's one-process step; the params after
    Adam against optax's step of JAX's gradient; the EMA against one
    process's; every leaf and gradient the same on both ranks, the slices
    cut where JAX's rule cuts them."""
    out = tp2.run(tasks.diffusion_dp, DIFF, jax_tp["params0"], [jax_tp["batch"]],
                  jax_tp["draws"], TP_DIFF)
    assert out[0]["tp"] == out[1]["tp"] == jax_tp["layout"] and len(jax_tp["layout"]) > 10
    np.testing.assert_allclose([o["losses"][0] for o in out], jax_tp["loss"], rtol=1e-5)
    names = list(jax_tp["grads"])
    want, got = _flat(jax_tp["grads"], names), _flat(out[0]["grads"], names)
    one = _flat(jax_tp["one"]["grads"], names)
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)
    assert np.linalg.norm(got - one) <= 1e-6 * np.linalg.norm(want)
    _adam_rule(out[0]["params"], jax_tp["params1"], DIFF.get("learning_rate", 1e-4))
    assert out[0]["bytes_one"] == jax_tp["one"]["bytes"] > out[0]["bytes"]
    for k in jax_tp["one"]["ema"]:
        np.testing.assert_allclose(out[0]["ema"][k], jax_tp["one"]["ema"][k], rtol=0, atol=1e-7,
                                   err_msg=k)
    for k in out[0]["params"]:
        assert np.array_equal(out[0]["params"][k], out[1]["params"][k]), k
        assert np.array_equal(out[0]["ema"][k], out[1]["ema"][k]), k
        assert np.array_equal(out[0]["grads"][k], out[1]["grads"][k]), k
    for k, d in jax_tp["layout"].items():         # each rank holds its half
        half = out[0]["params"][k].shape[d] // 2
        for r in range(2):
            assert np.array_equal(out[r]["local"][k],
                                  np.take(out[r]["params"][k], range(r * half, (r + 1) * half),
                                          axis=d)), k


def test_zero1_on_dp2_tp2_gives_plain_bits(dp2tp2, jax_tp):
    """Two steps on dp2×tp2 with ZeRO-1 (``zero1_min_size=0``): each
    moment's data-axis dim is the one ``zero1_partition_spec`` gives the
    whole leaf (never the model-axis dim), its shape the slice of both, and
    the params equal plain dp2×tp2's bit for bit."""
    batches, draws = [jax_tp["batch"], _diff_batch(5)], _draws(6, 2)
    mesh = dict(TP_DIFF, zero1_min_size=0)
    plain = dp2tp2.run(tasks.diffusion_dp, DIFF, jax_tp["params0"], batches, draws, mesh)
    z1 = dp2tp2.run(tasks.diffusion_dp, DIFF, jax_tp["params0"], batches, draws,
                    dict(mesh, zero1=True))
    for r in range(4):
        assert plain[r]["losses"] == z1[r]["losses"]
        assert z1[r]["bytes"] < plain[r]["bytes"] < z1[r]["bytes_one"] == plain[r]["bytes_one"]
        for k in plain[r]["params"]:
            assert np.array_equal(plain[r]["params"][k], z1[r]["params"][k]), (r, k)
            assert np.array_equal(plain[r]["local"][k], z1[r]["local"][k]), (r, k)
    spec = _Ranks(2, 2, zero1=True, zero1_min_size=0, model_shard_threshold=512)
    both = 0
    for name, (shape, d) in z1[0]["moments"].items():
        full = jax_tp["params0"][name].shape
        tp = z1[0]["tp"].get(name)
        out_dim = 0 if name.endswith(".weight") and len(full) >= 2 else len(full) - 1
        want = tmesh.zero1_partition_spec(torch.empty(full, device="meta"), spec,
                                          out_dim=out_dim)
        assert (want.index("model") if "model" in want else None) == tp, name
        assert d == (want.index("data") if "data" in want else None), name
        assert shape == tuple(n // (2 if i in (d, tp) else 1) for i, n in enumerate(full)), name
        both += d is not None and tp is not None
    assert both > 5


# ---------------------------------------------------------------------------
# serving and sequence parallelism


def test_predict_sharded_on_dp2_tp2(dp2tp2):
    """16 clips on dp2×tp2 at threshold 4096 (JAX's case): log-probs within
    1e-4 of one process; in int8 the log-probs equal dp2's without TP bit
    for bit; the caller's model is the same before and after, and whole."""
    params = {k: v.numpy() for k, v in tprng.seeded(
        lambda: ViViT(tcfg.ViViTConfig(**VIVIT)), 0).state_dict().items()}
    clips = np.random.default_rng(0).integers(0, 256, (16, 5, 32, 32, 1), dtype=np.uint8)
    mesh = {"model_parallel": 2, "model_shard_threshold": 4096}
    want = tasks.predict_sharded_tp(VIVIT, params, clips, False, None)["out"].numpy()
    got = dp2tp2.run(tasks.predict_sharded_tp, VIVIT, params, clips, False, mesh)
    int8 = dp2tp2.run(tasks.predict_sharded_tp, VIVIT, params, clips, True, mesh)
    int8_dp = dp2tp2.run(tasks.predict_sharded_tp, VIVIT, params, clips, True,
                         {"data_parallel": 2, "model_parallel": 2,
                          "model_shard_threshold": 2**30})
    for r in range(4):
        np.testing.assert_allclose(got[r]["out"], want, atol=1e-4)
        np.testing.assert_array_equal(int8[r]["out"], int8_dp[r]["out"])
        for res in (got[r], int8[r]):
            assert not res["placed"] and len(res["tp"]) > 4
            for k, v in params.items():
                assert np.array_equal(res["after"][k], v), k
    assert int8_dp[0]["tp"] == {}


@pytest.mark.parametrize("gan_kw", [{}, {"serve_int8": True}], ids=["float", "int8"])
def test_generate_frames_tp2(tp2, gan_kw):
    """7 frames in batches of 4 on tp2 at width 0.125, threshold 2048 (the
    generator's larger convs column-parallel): int8 frames equal one
    process's bit for bit, float frames within a level."""
    params = {k: v.numpy() for k, v in tprng.seeded(
        lambda: TalkingFaceGenerator(width=0.125), 0).state_dict().items()}
    rng = np.random.default_rng(10)
    frames = rng.integers(0, 256, (7, 40, 48, 3), dtype=np.uint8)
    boxes = np.tile(np.asarray([4.0, 36.0, 6.0, 42.0], np.float32), (7, 1))
    mels = rng.standard_normal((7, 80, 16)).astype(np.float32)
    args = (params, frames, boxes, mels, 0.125, gan_kw, 4)
    want = tasks.generate_frames_dp(*args, None)
    got = tp2.run(tasks.generate_frames_dp, *args,
                  {"model_parallel": 2, "model_shard_threshold": 2048})
    assert np.array_equal(got[0], got[1])
    if gan_kw:
        np.testing.assert_array_equal(got[0], want)
    else:
        assert np.abs(got[0].astype(int) - want.astype(int)).max() <= 1


def test_sequence_parallel_and_tensor_parallel_share_the_model_axis(tp2):
    """A ViViT with ``sequence_parallel`` (the ring over ``model``) whose
    leaves the same axis shards: logits and the whole gradient of their sum
    against one process."""
    kw = dict(VIVIT, sequence_parallel=True)
    params = {k: v.numpy() for k, v in tprng.seeded(
        lambda: ViViT(tcfg.ViViTConfig(**VIVIT)), 1).state_dict().items()}
    clips = np.random.default_rng(2).standard_normal((2, 5, 32, 32, 1)).astype(np.float32)
    want = tasks.vivit_tp(kw, params, clips, None)
    got = tp2.run(tasks.vivit_tp, kw, params, clips,
                  {"model_parallel": 2, "model_shard_threshold": 4096})
    assert len(got[0]["tp"]) > 4
    for r in range(2):
        np.testing.assert_allclose(got[r]["logits"], want["logits"], atol=1e-5)
        for k, g in want["grads"].items():
            g = np.asarray(g)
            np.testing.assert_allclose(got[r]["grads"][k], g, rtol=1e-4,
                                       atol=1e-5 * np.abs(g).max(), err_msg=k)


def test_pipeline_state_shards_no_leaf_by_the_tp_rule(tp2):
    """A pipelined ViViT (``pipeline_parallel``) at a threshold that would
    cut every kernel: its stage leaves stay whole, as JAX's
    ``pp_state_sharding`` places them."""
    kw = dict(num_classes=4, hidden_size=32, num_layers=2, num_heads=2, mlp_dim=64,
              dtype="float32", pipeline_parallel=True)
    out = tp2.run(tasks.pp_placement, kw, {"model_parallel": 2, "model_shard_threshold": 16})
    for o in out:
        assert not o["placed"] and o["before"] == o["after"] and o["rule"]


# ---------------------------------------------------------------------------
# checkpoints


def test_tp2_checkpoint_is_whole_and_resumes(tp2, tmp_path):
    """``train_diffusion.train`` on tp2: its checkpoint holds every leaf at
    the one-process shape (params, EMA, both Adam moments); resuming it on
    tp2 ends at the uninterrupted run's params bit for bit; restored in one
    process it is the same state bit for bit, and two steps from it track
    the tp2 run."""
    batches = [_diff_batch(s) for s in (7, 8, 9, 10)]
    whole = tp2.run(tasks.diffusion_train_loop, DIFF, batches, str(tmp_path / "whole"),
                    TP_DIFF, 4, 2)
    cut = str(tmp_path / "cut")
    tp2.run(tasks.diffusion_train_loop, DIFF, batches[:2], cut, TP_DIFF, 2, 2)
    ck = ttd.load_checkpoint(f"{cut}/step_000000002.pt")
    one = ttd.create_state(tcfg.DiffusionConfig(**DIFF), device="cpu")
    shapes = {k: tuple(v.shape) for k, v in one.model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in ck["params"].items()} == shapes
    assert {k: tuple(v.shape) for k, v in ck["ema_params"].items()} == shapes
    order = [tuple(p.shape) for p in one.model.parameters()]
    for i, st in ck["opt_state"]["state"].items():
        assert tuple(st["exp_avg"].shape) == tuple(st["exp_avg_sq"].shape) == order[int(i)]
    ttd.restore_state(one, ck)
    back = ttd.checkpoint_tree(one)
    for part in ("params", "ema_params"):
        for k, v in ck[part].items():
            assert torch.equal(back[part][k], v), (part, k)
    for i, st in ck["opt_state"]["state"].items():
        assert torch.equal(back["opt_state"]["state"][i]["exp_avg_sq"], st["exp_avg_sq"])
    resumed = tp2.run(tasks.diffusion_train_loop, DIFF, batches[2:], cut, TP_DIFF, 4, 2)
    assert [o["step"] for o in resumed] == [4, 4]
    for r in range(2):
        for k, want in whole[0]["params"].items():
            assert np.array_equal(resumed[r]["params"][k], want), (r, k)
    single = str(tmp_path / "single")
    import shutil

    shutil.copytree(cut, single)
    alone = tasks.diffusion_train_loop(DIFF, batches[2:], single, {}, 4, 2)
    assert alone["step"] == 4
    for k, want in whole[0]["params"].items():
        np.testing.assert_allclose(alone["params"][k].numpy(), want, rtol=0, atol=1e-5,
                                   err_msg=k)


def test_bridged_flax_tree_loads_whole_into_a_tp_model(tp2):
    """A Flax ViViT tree bridged by ``models/convert.py`` (whole leaves) and
    loaded through ``load_full_state_dict`` into a model already cut for
    tp2 gives JAX's logits (1e-5) and one process's (1e-6)."""
    cfg = JViViTCfg(**VIVIT)
    rng = np.random.default_rng(4)
    shapes = jax.eval_shape(JViViT(cfg).init, jax.random.key(0),
                            jnp.zeros((1, 5, 32, 32, 1)))["params"]
    params = jax.tree_util.tree_map(
        lambda a: (0.5 * rng.standard_normal(a.shape) / np.sqrt(max(1, np.prod(a.shape[:-1]))))
        .astype(np.float32), shapes)
    clips = rng.standard_normal((3, 5, 32, 32, 1)).astype(np.float32)
    want = np.asarray(jax.jit(JViViT(cfg).apply)({"params": params}, clips))
    sd = {k: v.numpy() for k, v in convert.vivit_state_dict_from_flax(params).items()}
    one = tasks.vivit_loaded(VIVIT, sd, clips, None)
    got = tp2.run(tasks.vivit_loaded, VIVIT, sd, clips,
                  {"model_parallel": 2, "model_shard_threshold": 4096})
    for r in range(2):
        assert len(got[r]["tp"]) > 4
        np.testing.assert_allclose(got[r]["logits"], want, atol=1e-5)
        np.testing.assert_allclose(got[r]["logits"], one["logits"].numpy(), atol=1e-6)
        for k, v in sd.items():
            assert np.array_equal(got[r]["whole"][k], v), k
