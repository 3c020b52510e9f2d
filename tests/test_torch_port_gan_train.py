"""The port's lip-sync GAN and SyncNet trainers against the JAX package, at
``GanConfig(model_width=0.25, batch_size=2)`` in float32: ``prepare_batch``,
one G+D step of ``_gan_train_step_impl`` with the sync gate shut and open,
``gan_eval_step``, ``train_syncnet.train_step`` for its three objectives
given JAX's draws, and the AUC report; then the port's own loop: the gate,
checkpoint and resume, ``load_generator_params``.

Width 0.25, not the JAX tests' 0.125: at 0.125 the SyncNet's and the
generator's audio towers end in GroupNorm groups of two channels at 1×1,
where float32 rounding becomes ~5e-4 of the audio embedding in both
frameworks (JAX's lies 6.8e-4 from a float64 evaluation, the port's
1.8e-4), above the bounds below.

The steps' inputs: both sides run on the same prepared batch, JAX's
``prepare_batch`` run op by op (patched into both while the steps run).
``test_prepare_batch_matches_jax`` holds the port's own, whose mels differ
from JAX's by up to the melspectrogram's 2e-4 (two float32 FFTs), which the
SyncNet's audio tower on random weights turns into ~1e-3 of a cosine. And
op by op, because under ``jax.jit`` XLA folds ``80.0 * s / 25.0`` into
``s * 3.19999981``: JAX's jitted steps start the window of every fifth video
frame one mel step early, where its eager ``prepare_batch`` (and its own test
of the window offsets) takes floor(80·s/25), as the port does (ROADMAP §3).

Weights: each network's tree as its Flax module builds it
(``jax.eval_shape`` of its ``init``), filled from seeded numpy (HWIO kernels
~ N(0, 1/fan_in), small biases, GroupNorm near (1, 0)), bridged to the
port. Batches: ``GanWindowSampler`` over ``synthetic_av_clips`` of 64×64
faces, resized to 96 by both sides.

Bounds: losses within 1e-5 relative; ``prepare_batch`` within 1e-5 but for
pixels at a uint8 resize tie (JAX rounds a value a hair above .5 up, the
port to even: one level, ROADMAP §3) and the mels at the melspectrogram's
2e-4. After a step every parameter is within 2·lr of JAX's (PR 9's rule:
Adam's first step is about lr·sign(g) whatever |g| is, so a gradient within
float32 noise of 0 may step either way); more than 1e-6 apart are only the
conv biases whose gradient is 0 in exact arithmetic (before a GroupNorm of
one channel a group: noise on both sides, stepped by ±lr) and at most 1% of
the other params: 0.46% in the generator, all in its blocks at 1×1 to 6×6,
where GroupNorm normalises a few values a group and float32 rounding grows
(≤ 7e-5 in the discriminator and the SyncNet).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from lipreading_video_generation_tpu.core.config import AudioConfig as JAudioCfg
from lipreading_video_generation_tpu.core.config import GanConfig as JGanCfg
from lipreading_video_generation_tpu.data import datasets as jdata
from lipreading_video_generation_tpu.models.discriminator import Discriminator as JDisc
from lipreading_video_generation_tpu.models.generator import TalkingFaceGenerator as JGen
from lipreading_video_generation_tpu.models.syncnet import SyncNet as JSync
from lipreading_video_generation_tpu.models.syncnet import stack_window_lower_half as jstack
from lipreading_video_generation_tpu.ops import audio as jaudio
from lipreading_video_generation_tpu.pipelines import expert_proof as jproof
from lipreading_video_generation_tpu.pipelines import train_gan as jtg
from lipreading_video_generation_tpu.pipelines import train_syncnet as jts
from lipreading_video_generation_tpu_torch.core.config import AudioConfig, GanConfig
from lipreading_video_generation_tpu_torch.core.checkpoint import CheckpointManager, save_once
from lipreading_video_generation_tpu_torch.data import datasets as tdata
from lipreading_video_generation_tpu_torch.models import convert
from lipreading_video_generation_tpu_torch.ops import audio as taudio
from lipreading_video_generation_tpu_torch.pipelines import expert_proof as tproof
from lipreading_video_generation_tpu_torch.pipelines import train_gan as ttg
from lipreading_video_generation_tpu_torch.pipelines import train_syncnet as tts

TINY = dict(model_width=0.25, batch_size=2, dtype="float32")
W = TINY["model_width"]
CFG, JCFG = GanConfig(**TINY), JGanCfg(**TINY)
SHARE = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


def _flax_tree(module, seed, *inputs):
    """``module.init``'s param tree (shapes from ``jax.eval_shape``, nothing
    compiled), filled from seeded numpy."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.key(0), *inputs)["params"]

    def fill(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if name.endswith("['kernel']"):
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name.endswith("['scale']"):
            v = 1.0 + 0.05 * rng.standard_normal(shape)
        else:
            v = 0.05 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def params():
    t = CFG.syncnet_T
    return {
        "gen": _flax_tree(JGen(width=W), 0, jnp.zeros((1, t, 80, 16, 1)),
                          jnp.zeros((1, t, 96, 96, 6))),
        "disc": _flax_tree(JDisc(width=W), 1, jnp.zeros((1, t, 96, 96, 3))),
        "sync": _flax_tree(JSync(width=W), 2, jnp.zeros((1, 80, 16, 1)),
                           jnp.zeros((1, 48, 96, 3 * t))),
    }


@pytest.fixture(scope="module")
def clips():
    return tdata.synthetic_av_clips(n_clips=3, frames=30, img=64, seed=0)


@pytest.fixture(scope="module")
def batch(clips):
    return tdata.GanWindowSampler(clips, CFG.syncnet_T, seed=0).sample_batch(CFG.batch_size)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


_JAX_PREPARE_BATCH = jtg.prepare_batch


def _eager_prep(batch):
    """JAX's ``prepare_batch`` run op by op: floor(80·s/25) windows."""
    return _JAX_PREPARE_BATCH(_jb(batch), JCFG, JAudioCfg())


def _torch_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.fixture
def same_prep(monkeypatch):
    """Both sides on JAX's eager ``prepare_batch``: a JAX step is handed
    ``_eager_prep(batch)`` in place of the batch (its ``prepare_batch`` is
    the identity while it traces); the port's ``prepare_batch`` and
    ``melspectrogram`` return JAX's eager results."""
    for mod in (jtg, jts):
        monkeypatch.setattr(mod, "prepare_batch", lambda b, cfg, audio_cfg: b)
    for mod in (ttg, tts, tproof):
        monkeypatch.setattr(mod, "prepare_batch",
                            lambda b, cfg, audio_cfg, device: _torch_tree(_eager_prep(b)))
    monkeypatch.setattr(taudio, "melspectrogram", lambda wav, cfg=None: torch.from_numpy(
        np.array(jaudio.melspectrogram(jnp.asarray(wav.numpy()), JAudioCfg()))))


# one instance each: a train state's optimizers are static fields of its
# pytree, so new ones would make the jitted step compile again
GEN_TX = optax.adam(JCFG.learning_rate, b1=JCFG.adam_b1, b2=JCFG.adam_b2)
DISC_TX = optax.adam(JCFG.disc_learning_rate, b1=JCFG.adam_b1, b2=JCFG.adam_b2)
SYNC_TX = optax.adam(1e-4)


def _jax_state(params, syncnet_wt):
    gen_tx, disc_tx = GEN_TX, DISC_TX
    return jtg.GanTrainState(
        step=jnp.zeros((), jnp.int32), gen_params=params["gen"], disc_params=params["disc"],
        gen_opt=gen_tx.init(params["gen"]), disc_opt=disc_tx.init(params["disc"]),
        syncnet_params=params["sync"], syncnet_wt=jnp.asarray(syncnet_wt, jnp.float32),
        gen_tx=gen_tx, disc_tx=disc_tx)


def _port_state(params, syncnet_wt):
    state = ttg.create_state(CFG, syncnet_params=convert.syncnet_state_dict_from_flax(
        params["sync"]), device="cpu")
    state.gen.load_state_dict(convert.generator_state_dict_from_flax(params["gen"]))
    state.disc.load_state_dict(convert.discriminator_state_dict_from_flax(params["disc"]))
    state.syncnet_wt = float(np.float32(syncnet_wt))
    return state


def _zero_grad_biases(module) -> set:
    """Conv biases whose gradient is 0 in exact arithmetic: those of the
    ``ConvBlock``s whose GroupNorm has one channel a group (it subtracts
    each channel's own mean)."""
    return {f"{name}.conv.bias" for name, m in module.named_modules()
            if getattr(m, "norm", None) is not None and m.norm.groups == m.norm.weight.numel()}


def _params_match(module, want: dict, lr: float):
    """Adam's rule after one step (module docstring): every parameter within
    2·lr, and off by more than 1e-6 in at most ``SHARE`` of those whose
    gradient is not 0 in exact arithmetic (``_zero_grad_biases``: float32
    noise, stepped by ±lr on both sides). Returns that share."""
    got = module.state_dict()
    assert set(got) == set(want)
    zero = _zero_grad_biases(module)
    d = {k: np.abs(got[k].numpy() - want[k].numpy()) for k in want}
    assert max(v.max() for v in d.values()) <= 2 * lr * (1 + 1e-3)   # and the params' rounding
    rest = np.concatenate([v.ravel() for k, v in d.items() if k not in zero])
    share = float((rest > 1e-6).mean())
    assert share <= SHARE, share
    return share


def test_create_state():
    """Float32 masters at the compute dtype's widths, optax adam's
    hyperparameters for G and D, the SyncNet frozen without an optimizer; at
    ``lip_weight`` > 0 the lip expert (the seq2seq default) frozen in
    float32, in no optimizer; a mesh waits for ROADMAP item 9."""
    state = ttg.create_state(dataclasses.replace(CFG, dtype="bfloat16"), device="cpu")
    for m in (state.gen, state.disc, state.syncnet):
        assert all(p.dtype == torch.float32 for p in m.parameters())
    assert not any(p.requires_grad for p in state.syncnet.parameters())
    for opt, lr in ((state.gen_opt, CFG.learning_rate),
                    (state.disc_opt, CFG.disc_learning_rate)):
        assert opt.defaults["lr"] == lr and opt.defaults["betas"] == (0.5, 0.999)
        assert opt.defaults["eps"] == 1e-8 and opt.defaults["weight_decay"] == 0
    assert state.step == 0 and state.syncnet_wt == 0.0
    assert state.gen.decoder.out_conv.compute_dtype == torch.bfloat16
    assert state.lip_expert is None
    lip = ttg.create_state(dataclasses.replace(CFG, lip_weight=0.5, dtype="bfloat16"),
                           device="cpu")
    assert type(lip.lip_expert).__name__ == "LipExpertSeq2Seq" and not lip.lip_expert.training
    assert all(p.dtype == torch.float32 and not p.requires_grad
               for p in lip.lip_expert.parameters())
    in_opt = {id(p) for opt in (lip.gen_opt, lip.disc_opt) for g in opt.param_groups
              for p in g["params"]}
    assert not any(id(p) in in_opt for p in lip.lip_expert.parameters())
    # the 1×1 mesh of one process gives mesh_spec=None's state
    from lipreading_video_generation_tpu_torch.parallel.mesh import build_mesh

    plain = ttg.train(CFG, lambda: None, device="cpu")
    meshed = ttg.train(CFG, lambda: None, mesh_spec=build_mesh(), device="cpu")
    assert plain.step == meshed.step == 0
    for a, b in zip(plain.gen.state_dict().values(), meshed.gen.state_dict().values()):
        assert torch.equal(a, b)


def test_prepare_batch_matches_jax(batch):
    want = _eager_prep(batch)
    got = ttg.prepare_batch(batch, CFG, AudioConfig(), "cpu")
    assert set(got) == set(want)
    shapes = {"x": (2, 5, 96, 96, 6), "gt": (2, 5, 96, 96, 3), "mel": (2, 80, 16, 1),
              "indiv_mels": (2, 5, 80, 16, 1)}
    for k, shape in shapes.items():
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape == shape and g.dtype == np.float32
        d = np.abs(g - w)
        if k in ("x", "gt"):
            # uint8 resize ties: one level, at a few pixels
            assert d.max() <= 1 / 255 + 1e-6 and (d > 1e-5).mean() < 1e-2, (k, d.max())
        else:
            assert d.max() <= 2e-4, (k, d.max())
    # at a uint8 resize tie (0.1% of these pixels), one level
    # the masked half of x is zero, the reference half is not
    assert got["x"][..., 48:, :, :3].abs().max() == 0 and got["x"][..., 48:, :, 3:].max() > 0


@pytest.fixture(scope="module")
def jax_gan_step():
    return jax.jit(jtg._gan_train_step_impl, static_argnames=("cfg", "audio_cfg"))


@pytest.mark.parametrize("syncnet_wt", [0.0, 0.03])
def test_gan_train_step_matches_jax(params, batch, jax_gan_step, same_prep, syncnet_wt):
    """One G+D step from the same weights: the G loss through the old D and
    the frozen SyncNet, the D loss on the G step's output; with the gate open
    (0.03) the sync gradient reaches G."""
    jstate, jm = jax_gan_step(_jax_state(params, syncnet_wt), _eager_prep(batch),
                              jax.random.key(0), cfg=JCFG)
    state = _port_state(params, syncnet_wt)
    m = ttg.train_step(state, batch, CFG)
    assert state.step == 1 and int(jstate.step) == 1
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert m["syncnet_wt"].item() == float(jm["syncnet_wt"]) == np.float32(syncnet_wt)
    _params_match(state.gen, convert.generator_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jstate.gen_params)), CFG.learning_rate)
    _params_match(state.disc, convert.discriminator_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jstate.disc_params)), CFG.disc_learning_rate)
    # the frozen expert has no gradient and did not move
    want = convert.syncnet_state_dict_from_flax(params["sync"])
    for k, v in state.syncnet.state_dict().items():
        assert torch.equal(v, want[k])
    assert all(p.grad is None for p in state.syncnet.parameters())


def test_gan_eval_and_generate_step_match_jax(params, batch, same_prep):
    jstate = _jax_state(params, 0.0)
    want = jtg.gan_eval_step(jstate, _eager_prep(batch), JCFG)
    state = _port_state(params, 0.0)
    got = ttg.gan_eval_step(state, batch, CFG)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4, err_msg=k)
    g = ttg.generate_step(state, batch, CFG)
    assert g.shape == (2, 5, 96, 96, 3) and 0 <= g.min() and g.max() <= 1


def test_sync_gate_rule():
    state = ttg.create_state(CFG, device="cpu")
    ttg.maybe_open_sync_gate(state, 0.9, CFG)
    assert state.syncnet_wt == 0.0
    ttg.maybe_open_sync_gate(state, 0.5, CFG)
    assert state.syncnet_wt == float(np.float32(0.03))
    state.syncnet_wt = 0.01          # an open gate is not moved again
    ttg.maybe_open_sync_gate(state, 0.1, CFG)
    assert state.syncnet_wt == 0.01


def test_train_gate_checkpoint_resume_and_generator_params(clips, tmp_path):
    """JAX's loop test at the same sizes: an eval every 2 steps opens the
    forced gate; checkpoints every 2 steps; a resumed run continues at the
    saved step with both Adam states and the gate; the generator loads back
    from the directory and from a ``save_once`` file; a finite feed stops the
    loop; samples are dumped at each checkpoint."""
    cfg = dataclasses.replace(CFG, eval_interval=2, checkpoint_interval=2,
                              syncnet_gate_threshold=1e9)
    sampler = tdata.GanWindowSampler(clips, seed=0)
    ckdir, samples = str(tmp_path / "ck"), str(tmp_path / "samples")
    written = []

    class Writer:
        def write(self, step, metrics):
            written.append((step, sorted(metrics)))

    state = ttg.train(cfg, lambda: sampler.sample_batch(2), eval_batch_fn=lambda: sampler
                      .sample_batch(2), num_steps=3, checkpoint_dir=ckdir, metrics_writer=Writer(),
                      sample_dir=samples, device="cpu")
    assert state.step == 3 and state.syncnet_wt == float(np.float32(0.03))
    assert [s for s, _ in written] == [0, 1, 1, 2]
    assert written[2][1] == ["eval/l1", "eval/psnr", "eval/ssim", "eval/sync_loss"]
    assert CheckpointManager(ckdir).steps() == [2]
    assert (tmp_path / "samples" / "step2.jpg").exists()
    state2 = ttg.train(cfg, lambda: sampler.sample_batch(2), num_steps=4, checkpoint_dir=ckdir,
                       device="cpu")
    assert state2.step == 4 and state2.syncnet_wt == float(np.float32(0.03))
    assert CheckpointManager(ckdir).steps() == [2, 4]
    fresh = ttg.restore_state(ttg.create_state(cfg, device="cpu"),
                              CheckpointManager(ckdir).restore())
    assert fresh.step == 4 and fresh.syncnet_wt == state2.syncnet_wt
    for a, b in ((fresh.gen_opt, state2.gen_opt), (fresh.disc_opt, state2.disc_opt)):
        sa, sb = a.state_dict()["state"], b.state_dict()["state"]
        assert len(sa) == len(sb) > 0
        for i in sb:
            for k in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(sa[i][k], sb[i][k])
        assert any(s["exp_avg"].abs().max() > 0 for s in sa.values())
    for k, v in ttg.load_generator_params(ckdir).items():
        assert torch.equal(v, state2.gen.state_dict()[k])
    save_once(str(tmp_path / "gen.pt"), {"gen": state.gen.state_dict()})
    for k, v in ttg.load_generator_params(str(tmp_path / "gen.pt")).items():
        assert torch.equal(v, state.gen.state_dict()[k])
    feed = iter([sampler.sample_batch(2)])
    short = ttg.train(cfg, lambda: next(feed), num_steps=5, device="cpu")
    assert short.step == 1


def _jax_draws(step, b, objective):
    """JAX's ``train_syncnet.train_step`` draws at ``step`` from key 0."""
    key = jax.random.fold_in(jax.random.key(0), step)
    out = {}
    if objective == "bce":
        k1, key = jax.random.split(key)
        out["y"] = np.array(jax.random.uniform(k1, (b,)) > 0.5, np.float32)
    k1, k2 = jax.random.split(key)
    out["mag"] = np.array(jax.random.randint(k1, (b,), 3, 9), np.float32)
    out["sign"] = np.array(jnp.where(jax.random.uniform(k2, (b,)) > 0.5, 1.0, -1.0))
    return out


@pytest.mark.parametrize("objective", ["infonce_hard", "infonce", "bce"])
def test_syncnet_train_step_matches_jax(params, clips, same_prep, monkeypatch,
                                        objective):
    """One step of each objective on a batch of 4, the port given JAX's
    draws: loss within 1e-4 relative, the params by Adam's rule."""
    sampler = tdata.GanWindowSampler(clips, 5, seed=1)
    batch = sampler.sample_batch(4)
    # JAX's negative windows, op by op at its step's own key (see _jax_draws)
    key = jax.random.fold_in(jax.random.key(0), 0)
    if objective == "bce":
        key = jax.random.split(key)[1]
    y = jnp.asarray(_jax_draws(0, 4, objective).get("y", np.zeros(4, np.float32)))
    negatives = jts._shifted_mel_windows(_jb(batch), y, key, JCFG, JAudioCfg())
    monkeypatch.setattr(jts, "_shifted_mel_windows", lambda *a: negatives)
    prep = dict(_eager_prep(batch), wav=jnp.asarray(batch["wav"]))
    jstate = jts.SyncnetTrainState(step=jnp.zeros((), jnp.int32), params=params["sync"],
                                   opt_state=SYNC_TX.init(params["sync"]), tx=SYNC_TX)
    jstate, jm = jts.train_step(jstate, prep, jax.random.key(0), JCFG, objective=objective)
    state = tts.create_state(CFG, device="cpu")
    state.model.load_state_dict(convert.syncnet_state_dict_from_flax(params["sync"]))
    draws = _jax_draws(0, 4, objective)
    m = tts.train_step(state, batch, CFG, objective=objective, draws=draws)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4)
    _params_match(state.model, convert.syncnet_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jstate.params)), 1e-4)
    assert state.step == 1
    # the port's own draws: labels and shift magnitudes in range, signs ±1
    own = tts.draw_negatives(state, 64, bce=True)
    assert set(own["y"].tolist()) == {0.0, 1.0} and set(own["sign"].tolist()) == {-1.0, 1.0}
    assert own["mag"].min() >= 3 and own["mag"].max() <= 8
    with pytest.raises(ValueError, match="unknown syncnet objective"):
        tts.train_step(state, batch, CFG, objective="hinge")


def test_shifted_negatives_match_jax(clips):
    """Given the same mel and draws, the negative windows are JAX's (op by
    op), bit for bit: shifted by sign·mag frames, turned the other way where
    they would leave the mel, aligned where y = 1."""
    batch = tdata.GanWindowSampler(clips, 5, seed=3).sample_batch(8)
    batch["start_frame"] = np.array([0, 1, 2, 25, 24, 12, 5, 10], np.int32)
    mel_full = np.asarray(jaudio.melspectrogram(jnp.asarray(batch["wav"]), JAudioCfg()))
    for seed in range(3):
        key = jax.random.key(seed)
        y = np.asarray(jax.random.uniform(jax.random.key(seed + 10), (8,)) > 0.5, np.float32)
        want = jts._shifted_mel_windows(_jb(batch), jnp.asarray(y), key, JCFG, JAudioCfg())
        k1, k2 = jax.random.split(key)
        mag = np.asarray(jax.random.randint(k1, (8,), 3, 9), np.float32)
        sign = np.asarray(jnp.where(jax.random.uniform(k2, (8,)) > 0.5, 1.0, -1.0))
        got = tts._shifted_mel_windows(torch.from_numpy(mel_full),
                                       torch.from_numpy(batch["start_frame"]).float(),
                                       *map(torch.from_numpy, (y, mag, sign)), CFG, AudioConfig())
        assert got.shape == (8, 80, 16, 1) and np.array_equal(got.numpy(), np.asarray(want))


def test_alignment_scores_and_auc_match_jax(params, clips, same_prep, monkeypatch):
    """The same windows, shift signs and cosines (JAX's ``_sync_sims`` on
    its eager ``prepare_batch``, see the module's docstring) and AUC."""
    apply = jax.jit(JSync(width=W).apply)

    def sims(p, batch, cfg, audio_cfg=JAudioCfg()):
        prep = _eager_prep(batch)
        a, v = apply({"params": p}, prep["mel"], jstack(prep["gt"]))
        return jnp.sum(a * v, axis=-1)

    monkeypatch.setattr(jproof, "_sync_sims", sims)
    model = tts.create_state(CFG, device="cpu").model
    model.load_state_dict(convert.syncnet_state_dict_from_flax(params["sync"]))
    jclips = [jdata.GanClip(c.frames, c.wav) for c in clips]
    for seed in (0, 1):
        pos, neg = tproof.alignment_scores(model, CFG, clips, n_pairs=6, seed=seed)
        jpos, jneg = jproof.alignment_scores(params["sync"], JCFG, jclips, n_pairs=6, seed=seed)
        np.testing.assert_allclose(pos, jpos, rtol=0, atol=1e-5)
        np.testing.assert_allclose(neg, jneg, rtol=0, atol=1e-5)
        assert tproof.auc(pos, neg) == jproof.auc(pos, neg)
    rng = np.random.default_rng(7)
    a, b = rng.integers(0, 4, 9).astype(np.float32), rng.integers(0, 4, 7).astype(np.float32)
    assert tproof.auc(a, b) == jproof.auc(a, b)
    with pytest.raises(ValueError, match="no clip has"):
        tproof._window_batch([tdata.GanClip(clips[0].frames[:10], clips[0].wav)], 5, 2,
                             np.random.default_rng(0), max_shift=6)


def test_syncnet_train_reports_auc_and_exports(clips, tmp_path):
    """``train`` with held-out clips adds the AUC at step 0 and the last;
    held-out clips too short for it are dropped with a warning;
    ``load_params`` reads a ``{"syncnet": ...}`` export."""
    sampler = tdata.GanWindowSampler(clips[:2], 5, seed=0)
    written = []

    class Writer:
        def write(self, step, metrics):
            written.append((step, sorted(metrics)))

    state = tts.train(CFG, lambda: sampler.sample_batch(2), num_steps=3, eval_clips=clips[2:],
                      eval_every=5, metrics_writer=Writer(), device="cpu")
    assert state.step == 3
    assert written == [(0, ["auc", "loss"]), (1, ["loss"]), (2, ["auc", "loss"])]
    with pytest.warns(UserWarning, match="shorter than"):
        tts.train(CFG, lambda: sampler.sample_batch(2), num_steps=1,
                  eval_clips=[tdata.GanClip(clips[2].frames[:12], clips[2].wav)],
                  eval_every=1, device="cpu")
    save_once(str(tmp_path / "s.pt"), {"syncnet": state.model.state_dict()})
    for k, v in tts.load_params(str(tmp_path / "s.pt")).items():
        assert torch.equal(v, state.model.state_dict()[k])
