"""The port's ViViT trainer against the JAX package's, on the same perturbed
params (through ``models.convert``) and the same numpy batches.

Small configuration: 2 layers, hidden 64, 4 heads, MLP 128, 8 classes,
dropout 0 (Flax draws its masks from its own key tree, so dropout is held by
its properties instead). Float32 where the point is the algorithm; each
tolerance states its bound.
"""
import dataclasses
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from lipreading_video_generation_tpu.core import config as jcfg
from lipreading_video_generation_tpu.data import datasets as jdata
from lipreading_video_generation_tpu.data import loader as jloader
from lipreading_video_generation_tpu.pipelines import losses as jlosses
from lipreading_video_generation_tpu.pipelines import train_vivit as jtv
from lipreading_video_generation_tpu_torch.core import config as tcfg
from lipreading_video_generation_tpu_torch.core import metrics as tmetrics
from lipreading_video_generation_tpu_torch.core import prng as tprng
from lipreading_video_generation_tpu_torch.data import datasets as tdata
from lipreading_video_generation_tpu_torch.data import loader as tloader
from lipreading_video_generation_tpu_torch.models.convert import vivit_state_dict_from_flax
from lipreading_video_generation_tpu_torch.models.layers import MLP, dropout, dropout_mask
from lipreading_video_generation_tpu_torch.models.vivit import ViViT
from lipreading_video_generation_tpu_torch.pipelines import losses as tlosses
from lipreading_video_generation_tpu_torch.pipelines import train_vivit as ttv
from lipreading_video_generation_tpu_torch.parallel.mesh import build_mesh

SMALL = dict(num_layers=2, hidden_size=64, num_heads=4, mlp_dim=128, num_classes=8)
B = 8   # a multiple of the 8 virtual CPU devices JAX's train() shards over


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _perturbed(params, seed):
    """Flax init leaves LayerNorm at (1, 0) and biases at 0, where a swapped
    mapping would not show: add seeded numpy noise to every leaf."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32), params)


def _sampler(n=2 * B, seed=0):
    clips, labels = jdata.synthetic_word_clips(n=n, num_classes=8, seed=seed)
    return jdata.WordClipSampler(clips, labels, max_frames=5)


def _batches(n_batches, seed):
    return list(_sampler(n_batches * B, seed).batches(B, shuffle=False))


def _jax_state(cfg, params, steps_per_epoch=100):
    state = jtv.create_state(cfg, jax.random.key(0), steps_per_epoch)
    return state.replace(params=params, opt_state=state.tx.init(params))


def _port_state(cfg, params, steps_per_epoch=100):
    state = ttv.create_state(cfg, device="cpu", steps_per_epoch=steps_per_epoch)
    state.model.load_state_dict(vivit_state_dict_from_flax(params))
    return state


def _flat(params):
    return {n: t.numpy() for n, t in vivit_state_dict_from_flax(params).items()}


def _k_bias(name, shape):
    """Entries with an exact gradient of 0: the key part of each qkv bias (a
    shift of a query row's scores leaves its softmax as it was), where both
    sides compute cancellation noise."""
    mask = np.zeros(shape, bool)
    if name.endswith("qkv.bias"):
        e = shape[0] // 3
        mask[e:2 * e] = True
    return mask


def _updates_match(state, want_params, steps, lr, share=1e-3):
    """Adam's first steps move each weight by about lr·sign(g) whatever |g|
    is, so a gradient component within rounding noise of zero may step the
    other way: params agree to 1e-6 except at most ``share`` of them (and
    the key biases, whose gradient is 0), which stay within 2·lr a step."""
    want = _flat(want_params)
    got = state.model.state_dict()
    diffs, noise = [], []
    for n, w in want.items():
        d = np.abs(got[n].numpy() - w)
        k = _k_bias(n, w.shape)
        diffs.append(d[~k])
        noise.append(d[k])
    diffs, noise = np.concatenate(diffs), np.concatenate(noise)
    assert noise.size == 2 * SMALL["hidden_size"] and noise.max() <= 2 * steps * lr
    assert (diffs > 1e-6).mean() <= share and diffs.max() <= 2 * steps * lr, (
        (diffs > 1e-6).mean(), diffs.max())


@pytest.fixture(scope="module")
def params0():
    cfg = jcfg.ViViTConfig(dtype="float32", **SMALL)
    return _perturbed(jtv.create_state(cfg, jax.random.key(0)).params, 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_softmax_xent_and_accuracy_match_jax(seed):
    """Loss within 1e-6; accuracy equal, ties included (the first maximum)."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((32, 8)).astype(np.float32) * 3
    logits[:8, 2] = logits[:8, 5] = logits[:8].max(-1) + 1   # ties at 2 and 5
    labels = rng.integers(0, 8, 32).astype(np.int32)
    labels[:4] = 2
    labels[4:8] = 5
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    np.testing.assert_allclose(
        tlosses.softmax_xent(tl, torch.from_numpy(labels)).item(),
        float(jlosses.softmax_xent(jl, jnp.asarray(labels))), rtol=1e-6)
    acc = tlosses.accuracy(tl, torch.from_numpy(labels).long())
    assert acc.dtype == torch.float32
    assert acc.item() == float(jlosses.accuracy(jl, jnp.asarray(labels)))


@pytest.mark.parametrize("lr_step_epochs,steps_per_epoch", [(2, 3), (1, 100), (0, 7)])
def test_learning_rate_matches_the_optax_schedule(lr_step_epochs, steps_per_epoch):
    """The rate at steps 0, b−1, b, b+1 of the first two boundaries b, around
    the last of the 50 and far past it, equal (float32) to
    ``optax.piecewise_constant_schedule`` built as the JAX package's
    ``make_optimizer`` builds it (train_vivit.py:35-45)."""
    cfg = tcfg.ViViTConfig(lr_step_epochs=lr_step_epochs)
    sched = ttv.StaircaseSchedule(cfg, steps_per_epoch)
    if lr_step_epochs > 0:
        want = optax.piecewise_constant_schedule(cfg.learning_rate, {
            (e + 1) * cfg.lr_step_epochs * steps_per_epoch: cfg.lr_step_gamma
            for e in range(50)})
    else:
        want = lambda count: cfg.learning_rate   # noqa: E731
    b = lr_step_epochs * steps_per_epoch
    steps = {0, 1, 10**6} | {s for k in (1, 2, 50) for s in (k * b - 1, k * b, k * b + 1)}
    for step in sorted(s for s in steps if s >= 0):
        assert np.float32(sched(step)) == np.float32(want(step)), step
    if lr_step_epochs > 0:
        assert sched(b - 1) == sched(0) and sched(b) < sched(b - 1)
        assert sched(10**6) == sched(50 * b)
        opt, _ = ttv.make_optimizer(cfg, [torch.nn.Parameter(torch.zeros(2))], steps_per_epoch)
        assert opt.defaults["weight_decay"] == cfg.weight_decay
        assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_jax(params0, dtype):
    """One ``train_step`` against JAX's: loss, accuracy, the gradient of every
    parameter (Flax's tree through the same bridge) and the updated params.
    float32: other summation orders only: loss within 1e-5 relative, each
    gradient within 1e-5 of its tensor's largest, params as
    ``_updates_match`` bounds them. bf16: the two frameworks round Dense,
    GELU, attention and the bias sums (640 bf16 terms) at other points: loss
    within 3e-2 relative, accuracy within one clip, the whole gradient within
    3e-2 relative L2 (1.7e-2 measured) and each tensor within 1e-1 (7.2e-2,
    a bias); updates that flip with a gradient's sign below bf16 noise in at
    most 1% of the params (0.8% measured)."""
    jc = jcfg.ViViTConfig(dtype=dtype, **SMALL)
    batch = _batches(1, 3)[0]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = _jax_state(jc, params0)

    def loss_fn(p):
        logits = jstate.apply_fn({"params": p}, jtv.preprocess_clips(jbatch["clips"]))
        return jlosses.softmax_xent(logits, jbatch["labels"])

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params0)
    jstate, jm = jtv.train_step(jstate, jbatch, jax.random.key(0))

    state = _port_state(tcfg.ViViTConfig(dtype=dtype, **SMALL), params0)
    m = ttv.train_step(state, batch)
    f32 = dtype == "float32"
    assert state.step == 1 and set(m) == {"loss", "accuracy"}
    np.testing.assert_allclose(m["loss"].item(), float(jloss), rtol=1e-5 if f32 else 3e-2)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5 if f32 else 3e-2)
    assert abs(m["accuracy"].item() - float(jm["accuracy"])) <= (0 if f32 else 1 / B)
    want = _flat(_np_tree(jgrads))
    got = {n: p.grad.numpy() for n, p in state.model.named_parameters()}
    assert set(got) == set(want)
    for name, w in want.items():
        if f32:
            np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                       err_msg=name)
        else:
            assert np.linalg.norm(got[name] - w) <= 1e-1 * np.linalg.norm(w), name
    if not f32:
        g, w = (np.concatenate([t[n].ravel() for n in want]) for t in (got, want))
        assert np.linalg.norm(g - w) <= 3e-2 * np.linalg.norm(w)
    for p in state.model.parameters():
        assert p.dtype == torch.float32
    for s in state.optimizer.state.values():
        assert s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32
    _updates_match(state, _np_tree(jstate.params), 1, jc.learning_rate, 1e-3 if f32 else 1e-2)


def test_three_steps_across_a_decay_boundary_match_jax(params0):
    """``steps_per_epoch=1``, ``lr_step_epochs=2``: the rate falls by γ = 0.2
    before the third update. Losses within 1e-5 relative; the params after
    three steps as ``_updates_match`` bounds them (a rate left at 1e-4 for
    the third step would move them by ~8e-5 more)."""
    jc = jcfg.ViViTConfig(dtype="float32", **SMALL)
    batches = _batches(3, 4)
    jstate = _jax_state(jc, params0, steps_per_epoch=1)
    jlosses_ = []
    for b in batches:
        jstate, jm = jtv.train_step(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                    jax.random.key(0))
        jlosses_.append(float(jm["loss"]))
    state = _port_state(tcfg.ViViTConfig(dtype="float32", **SMALL), params0, steps_per_epoch=1)
    got = [ttv.train_step(state, b)["loss"].item() for b in batches]
    assert state.optimizer.param_groups[0]["lr"] == np.float32(np.float32(0.2) * np.float32(1e-4))
    np.testing.assert_allclose(got, jlosses_, rtol=1e-5)
    _updates_match(state, _np_tree(jstate.params), 3, jc.learning_rate)


def test_evaluate_matches_jax(params0):
    """``evaluate`` over three batches: the clip-weighted loss within 1e-5,
    accuracy equal; eval runs without dropout and leaves train mode on."""
    jc = jcfg.ViViTConfig(dtype="float32", **dict(SMALL, dropout=0.3))
    batches = _batches(3, 5)
    want = jtv.evaluate(_jax_state(jc, params0),
                        [{k: jnp.asarray(v) for k, v in b.items()} for b in batches])
    state = _port_state(tcfg.ViViTConfig(dtype="float32", **dict(SMALL, dropout=0.3)), params0)
    got = ttv.evaluate(state, batches)
    assert state.model.training
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["accuracy"] == pytest.approx(want["accuracy"], abs=1e-7)
    m = ttv.eval_step(state, batches[0])
    assert m["count"] == B


def test_word_clip_sampler_and_synthetic_clips_equal_jax():
    """``synthetic_word_clips`` and ``WordClipSampler`` batches, shuffled
    over three epochs and in order, with clips shorter and longer than
    ``max_frames`` and with a channel axis: bit-equal to the JAX package's."""
    for kw in (dict(n=40, t=5), dict(n=23, t=3, hw=16, num_classes=4, seed=7),
               dict(n=17, t=9, seed=2)):
        jc, jl = jdata.synthetic_word_clips(**kw)
        tc, tl = tdata.synthetic_word_clips(**kw)
        assert jl == tl and all(np.array_equal(a, b) for a, b in zip(jc, tc))
        channels = [c[..., None] for c in jc[::2]]
        for clips in (jc, channels):
            labels = jl[:len(clips)]
            js = jdata.WordClipSampler(clips, labels, max_frames=5, seed=3)
            ts = tdata.WordClipSampler(clips, labels, max_frames=5, seed=3)
            assert len(ts) == len(js)
            for shuffle in (True, True, True, False):
                want = list(js.batches(4, shuffle=shuffle))
                got = list(ts.batches(4, shuffle=shuffle))
                assert len(got) == len(want) > 0
                for g, w in zip(got, want):
                    assert g["clips"].dtype == w["clips"].dtype == np.uint8
                    assert g["labels"].dtype == w["labels"].dtype
                    assert np.array_equal(g["clips"], w["clips"])
                    assert np.array_equal(g["labels"], w["labels"])
    with pytest.raises(ValueError, match="labels"):
        tdata.WordClipSampler(jc, jl[:-1])


def test_train_two_epochs_matches_jax(params0, monkeypatch):
    """``train`` for 2 epochs of 2 steps (batch 8) against JAX's ``train``
    with ``steps_per_dispatch=1``, both ``create_state``s patched onto the
    same bridged weights: the metrics the writer sees at steps 1..4 (loss
    within 1e-5 relative, accuracy equal), the best stats and the params
    handed back (the best epoch's)."""
    jc = jcfg.Config(vivit=jcfg.ViViTConfig(dtype="float32", batch_size=B, **SMALL))
    tc = tcfg.Config(vivit=tcfg.ViViTConfig(dtype="float32", batch_size=B, **SMALL))
    real_j, real_t = jtv.create_state, ttv.create_state
    monkeypatch.setattr(jtv, "create_state", lambda cfg, key, *a: real_j(cfg, key).replace(
        params=params0, opt_state=real_j(cfg, key).tx.init(params0)))

    def port_state(cfg, seed=0, device=None, steps_per_epoch=100):
        state = real_t(cfg, seed, device, steps_per_epoch)
        state.model.load_state_dict(vivit_state_dict_from_flax(params0))
        return state

    monkeypatch.setattr(ttv, "create_state", port_state)

    class Recorder:
        def __init__(self):
            self.rows = []

        def write(self, step, metrics):
            self.rows.append((step, tmetrics.to_host(metrics) if isinstance(
                next(iter(metrics.values())), torch.Tensor) else
                {k: float(v) for k, v in metrics.items()}))

    runs = {}
    for name, train, cfg in (("jax", jtv.train, jc), ("port", ttv.train, tc)):
        sampler, evals = _sampler(2 * B, seed=8), _batches(2, 9)
        rec = Recorder()
        kw = dict(steps_per_dispatch=1) if name == "jax" else dict(device="cpu")
        state, best = train(cfg, lambda: sampler.batches(B), lambda: iter(evals),
                            num_epochs=2, metrics_writer=rec, **kw)
        runs[name] = (state, best, rec.rows)
    (jstate, jbest, jrows), (state, best, rows) = runs["jax"], runs["port"]
    assert [s for s, _ in rows] == [s for s, _ in jrows] == [1, 2, 3, 4]
    for (_, g), (_, w) in zip(rows, jrows):
        assert set(g) == set(w) == {"loss", "accuracy"}
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        assert g["accuracy"] == w["accuracy"]
    assert set(best) == {"loss", "accuracy"}
    np.testing.assert_allclose(best["loss"], jbest["loss"], rtol=1e-5)
    assert best["accuracy"] == pytest.approx(jbest["accuracy"], abs=1e-7)
    assert state.step == 4
    _updates_match(state, _np_tree(jstate.params), 4, tc.vivit.learning_rate)


def test_train_keeps_a_real_copy_of_the_best_params(params0, monkeypatch):
    """The snapshot of the best epoch is a copy: later steps do not move it,
    and it is what ``train`` hands back."""
    tc = tcfg.Config(vivit=tcfg.ViViTConfig(dtype="float32", batch_size=B, **SMALL))
    accs = iter([0.5, 0.25])
    snap = {}
    real_evaluate = ttv.evaluate

    def evaluate(state, batches):
        real_evaluate(state, batches)
        snap.setdefault("params", {k: v.clone() for k, v in state.model.state_dict().items()})
        return {"loss": 1.0, "accuracy": next(accs)}

    monkeypatch.setattr(ttv, "evaluate", evaluate)
    sampler, evals = _sampler(2 * B, seed=10), _batches(1, 11)
    state, best = ttv.train(tc, lambda: sampler.batches(B), lambda: iter(evals), num_epochs=2,
                            device="cpu")
    assert best == {"loss": 1.0, "accuracy": 0.5} and state.step == 4
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, snap["params"][k]), k


def test_dropout_properties():
    """Keep rate 1 − p; kept values scaled by 1/(1 − p) in the input's dtype;
    nothing drawn in eval mode or at rate 0; equal masks from equal
    generator seeds; a mask due and no generator raises."""
    mask = dropout_mask((200_000,), 0.3, torch.Generator().manual_seed(0), "cpu")
    assert abs(mask.float().mean().item() - 0.7) < 3e-3
    x = torch.randn(4, 80, 64).to(torch.bfloat16)
    y = dropout(x, 0.3, True, torch.Generator().manual_seed(1))
    keep = dropout_mask(x.shape, 0.3, torch.Generator().manual_seed(1), "cpu")
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, torch.where(keep, x / 0.7, 0.0))
    gen = torch.Generator().manual_seed(2)
    state = gen.get_state()
    assert dropout(x, 0.3, False, gen) is x and dropout(x, 0.0, True, gen) is x
    assert torch.equal(gen.get_state(), state)
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.3, True, None)

    mlp = MLP(64, 128, 64, torch.float32, dropout=0.5).train()
    h = {}
    mlp.fc2.register_forward_hook(lambda m, i, o: h.update(x=i[0], y=o))
    out = mlp(x.float(), torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    k1 = dropout_mask((4, 80, 128), 0.5, g, "cpu")
    k2 = dropout_mask((4, 80, 64), 0.5, g, "cpu")
    gelu = torch.nn.functional.gelu(mlp.fc1(x.float()), approximate="tanh")
    assert torch.equal(h["x"], torch.where(k1, gelu / 0.5, 0.0))
    assert torch.equal(out, torch.where(k2, h["y"] / 0.5, 0.0))

    cfg = tcfg.ViViTConfig(dtype="float32", **dict(SMALL, dropout=0.1))
    model = ViViT(cfg)
    clips = torch.rand(2, 5, 32, 32, 1)
    with torch.no_grad():
        model.eval()
        e1, e2 = model(clips), model(clips)
        model.train()
        t1 = model(clips, generator=torch.Generator().manual_seed(4))
        t2 = model(clips, generator=torch.Generator().manual_seed(4))
        t3 = model(clips, generator=torch.Generator().manual_seed(5))
        with pytest.raises(ValueError, match="generator"):
            model(clips)
    assert torch.equal(e1, e2) and torch.equal(t1, t2)
    assert not torch.allclose(t1, e1) and not torch.allclose(t1, t3)
    no_drop = ViViT(tcfg.ViViTConfig(dtype="float32", **SMALL))
    no_drop.load_state_dict(model.state_dict())
    with torch.no_grad():
        assert torch.equal(no_drop.train()(clips), e1)


def test_train_step_dropout_masks_follow_the_step_key(params0):
    """With dropout, two states of one seed take equal steps (masks from the
    generator re-seeded by ``step_key`` each step), and a state re-seeded by
    another root key takes another step; the loss is that of the model in
    train mode with the masks of ``step_key(root, step)``."""
    cfg = tcfg.ViViTConfig(dtype="float32", **dict(SMALL, dropout=0.2))
    batch = _batches(1, 12)[0]
    a, b, c = (_port_state(cfg, params0) for _ in range(3))
    c.root_key = tprng.make_root_key(1)
    clips, labels = ttv._batch_on(batch, "cpu")
    with torch.no_grad():
        want = tlosses.softmax_xent(a.model.train()(clips, generator=torch.Generator().manual_seed(
            tprng.step_key(a.root_key, 0))), labels).item()
    la, lb, lc = (ttv.train_step(s, batch)["loss"].item() for s in (a, b, c))
    assert la == lb == pytest.approx(want, rel=1e-6) and la != lc
    la2, lb2 = (ttv.train_step(s, batch)["loss"].item() for s in (a, b))
    assert la2 == lb2


def test_prng_keys():
    """Keys are 64-bit seeds for ``torch.Generator``: deterministic, distinct
    per step and per name, the names through JAX's ``_stable_hash`` bit for
    bit."""
    from lipreading_video_generation_tpu.core import prng as jprng

    for name in ("dropout", "params", "", "ünïcode"):
        assert tprng._stable_hash(name) == jprng._stable_hash(name)
    root = tprng.make_root_key(0)
    assert root == tprng.make_root_key(0) != tprng.make_root_key(1)
    steps = [tprng.step_key(root, s) for s in range(100)]
    assert len(set(steps)) == 100 and all(0 <= k < 2**64 for k in steps)
    a, b = tprng.split_for(root, "dropout", "noise")
    assert (a, b) == tprng.split_for(root, "dropout", "noise") and a != b
    assert tprng.split_for(root, "noise", "dropout") == (b, a)
    it = tprng.key_iterator(0)
    assert [next(it) for _ in range(3)] == [tprng.fold_in(root, i) for i in range(3)]
    torch.Generator().manual_seed(steps[-1])


def test_metrics_to_host_and_writers(tmp_path, capsys):
    """``to_host`` turns a dict of 0-d tensors and numbers into floats;
    ``Metrics`` fans out to the console and a JSONL file, as in JAX."""
    from lipreading_video_generation_tpu.core import metrics as jmetrics

    m = {"loss": torch.tensor(1.5), "acc": torch.tensor(0.25, dtype=torch.float64),
         "count": 8.0, "n": 3}
    assert tmetrics.to_host(m) == {"loss": 1.5, "acc": 0.25, "count": 8.0, "n": 3.0}
    assert tmetrics.to_host({}) == {}
    path = tmp_path / "m.jsonl"
    w = tmetrics.Metrics(tmetrics.ConsoleWriter(every=2), tmetrics.JsonlWriter(str(path)))
    for step in (1, 2):
        w.write(step, {"loss": torch.tensor(0.5 * step)})
    w.close()
    jw = jmetrics.ConsoleWriter(every=2)
    jw.write(2, {"loss": 1.0})
    err = capsys.readouterr().err.splitlines()
    assert err == ["[step 2] loss=1", "[step 2] loss=1"]
    rows = [l for l in path.read_text().splitlines() if l]
    assert len(rows) == 2 and '"step": 2' in rows[1] and '"loss": 1.0' in rows[1]
    rm, jrm = tmetrics.RunningMean(), jmetrics.RunningMean()
    for v in (1.0, 2.0, 4.0):
        rm.update({"x": v})
        jrm.update({"x": v})
    assert rm.means() == jrm.means()
    rm.reset()
    assert rm.means() == {}


def test_loader_host_side_matches_jax():
    """``host_prefetch`` over ``iterator_feed`` yields the batches in order
    and ends; ``take`` and ``stack_batches`` as in JAX; an error of the
    producer is raised in the consumer instead of leaving it waiting."""
    batches = [{"x": np.full((2, 3), i)} for i in range(20)]
    got = list(tloader.host_prefetch(tloader.iterator_feed(iter(batches)), depth=4))
    assert [int(b["x"][0, 0]) for b in got] == list(range(20))
    assert tloader.take(iter(range(5)), 3) == jloader.take(iter(range(5)), 3) == [0, 1, 2]
    assert tloader.take(iter(range(2)), 3) == [0, 1]
    s, js = tloader.stack_batches(batches[:3]), jloader.stack_batches(batches[:3])
    assert s["x"].shape == (3, 2, 3) and np.array_equal(s["x"], js["x"])

    def broken():
        yield batches[0]
        raise OSError("bad record")

    it = tloader.host_prefetch(tloader.iterator_feed(broken()))
    assert next(it) is batches[0]
    with pytest.raises(OSError, match="bad record"):
        next(it)


def test_predict_sharded_on_one_device(params0):
    """``predict_sharded`` is ``predict_step`` on the model's device for any
    clip count; so it is on the 1×1 mesh of one process, bit for bit."""
    model = ViViT(tcfg.ViViTConfig(dtype="float32", **SMALL)).eval()
    model.load_state_dict(vivit_state_dict_from_flax(params0))
    clips = np.random.default_rng(13).integers(0, 256, (5, 5, 32, 32, 1), dtype=np.uint8)
    want = ttv.predict_step(model, torch.from_numpy(clips))
    assert torch.equal(ttv.predict_sharded(model, clips), want)
    assert ttv.predict_sharded(model, clips, int8=True).shape == (5, 8)
    assert torch.equal(ttv.predict_sharded(model, clips, mesh_spec=build_mesh()), want)


OVERRIDES = [
    ["vivit.num_classes=8", "seed=3"],
    ["diffusion.channel_mult=(1,2)", "diffusion.attention_resolutions=[2]",
     "gan.serve_int8=true", "gan.model_width=0.25"],
    ["classifier.attention_resolutions=()", "preprocess.clahe_grid=(4, 4)",
     "vivit.dtype=float32", "superres.sr_inference_steps=10", "audio.preemphasize=no"],
    ["mesh.data_axis=batch", "feature_transformer.dropout=0.5", "sentence_eval.beam_width=4",
     "checkpoint_dir=/tmp/x", "vivit.tubelet_size=(1,4,4)"],
]


@pytest.mark.parametrize("overrides", OVERRIDES, ids=range(len(OVERRIDES)))
def test_parse_overrides_matches_jax(overrides):
    """The whole config tree, defaults and overrides (tuples, bools, floats,
    nested sections, top-level keys), equal to the JAX package's."""
    want = dataclasses.asdict(jcfg.parse_overrides(jcfg.Config(), overrides))
    got = tcfg.parse_overrides(tcfg.Config(), overrides)
    assert dataclasses.asdict(got) == want
    assert tcfg.replace(got, seed=9).seed == 9


@pytest.mark.parametrize("bad,err", [
    ("vivit.no_such_key=1", "unknown config key"), ("nosection.x=1", "unknown config key"),
    ("vivit.num_classes", "key=value")])
def test_parse_overrides_rejects_what_jax_rejects(bad, err):
    for mod in (jcfg, tcfg):
        with pytest.raises(ValueError, match=err):
            mod.parse_overrides(mod.Config(), [bad])


def test_mesh_and_other_configs_mirror_jax():
    for name in ("MeshConfig", "FeatureTransformerConfig", "SentenceEvalConfig", "Config"):
        assert dataclasses.asdict(getattr(tcfg, name)()) == dataclasses.asdict(
            getattr(jcfg, name)())
    assert tcfg.MeshConfig(data_parallel=1).data_parallel == 1
    from lipreading_video_generation_tpu.parallel.mesh import build_mesh as jbuild

    for kw in (dict(model_parallel=2), dict(data_parallel=4), dict(zero1=True)):
        assert dataclasses.asdict(tcfg.MeshConfig(**kw)) == dataclasses.asdict(
            jcfg.MeshConfig(**kw))
        # one process is one device: JAX's build_mesh over one device says the same
        if kw.get("zero1"):
            assert build_mesh(tcfg.MeshConfig(**kw)).zero1
            continue
        with pytest.raises(ValueError) as want:
            jbuild(jcfg.MeshConfig(**kw), devices=jax.devices()[:1])
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            build_mesh(tcfg.MeshConfig(**kw))
    assert dataclasses.asdict(tcfg.parse_overrides(tcfg.Config(), ["mesh.model_parallel=2"])) \
        == dataclasses.asdict(jcfg.parse_overrides(jcfg.Config(), ["mesh.model_parallel=2"]))
