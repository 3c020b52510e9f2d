"""The port's DenseNet feature path (``pipelines/feature_extraction``,
``models.vivit.FeatureTransformer``) against the JAX package, on the CPU.

``embed_frames`` at the published DenseNet121 widths on 3 clips of 5 frames
(32×32 gray) with padded and all-black frames; the FeatureTransformer at a
small width (64 features, 4 heads) and at the ``FeatureTransformerConfig``
defaults (1024 features, 2 heads: head dim 512); a train step and the whole
epoch loop with both dropouts at 0 (Flax draws its masks from its own key
tree). Params bridged from Flax by ``models.convert``; float32; each
tolerance is stated where it is used.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from lipreading_video_generation_tpu.core.config import FeatureTransformerConfig as JFTConfig
from lipreading_video_generation_tpu.models import densenet as jdn
from lipreading_video_generation_tpu.models.vivit import FeatureTransformer as JFT
from lipreading_video_generation_tpu.pipelines import feature_extraction as jfx
from lipreading_video_generation_tpu.pipelines import losses as jlosses
from lipreading_video_generation_tpu_torch.core.config import FeatureTransformerConfig
from lipreading_video_generation_tpu_torch.models import convert, selftest
from lipreading_video_generation_tpu_torch.models.vivit import FeatureTransformer
from lipreading_video_generation_tpu_torch.pipelines import feature_extraction as tfx

# float32 in both, sums in another order: of the largest |value|
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_embed_frames_matches_jax(tmp_path):
    """Full-width DenseNet121 on seeded weights in torchvision's layout (the
    selftest's): the port's features equal JAX's within 1e-5, frames of
    zero padding and an all-black real frame both get zero features, and a
    chunk size that splits the clips (the port does not pad the last chunk)
    changes nothing."""
    pth = selftest.make_densenet_selftest_pth(str(tmp_path / "dn.pth"), seed=0)
    sd = torch.load(pth)
    params, stats = jdn.convert_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    rng = np.random.default_rng(0)
    clips = rng.integers(1, 256, (3, 5, 32, 32, 1), dtype=np.uint8)
    clips[1, 3:] = 0          # padded frames
    clips[2, 0] = 0           # an all-black frame of a real clip
    want = jfx.embed_frames({"params": params, "batch_stats": stats}, clips, batch_frames=8)
    got = tfx.embed_frames(sd, clips, batch_frames=8, device="cpu")
    assert got.shape == want.shape == (3, 5, 1024) and got.dtype == np.float32
    assert _rel(got, want) <= TOL
    assert np.abs(got[1, 3:]).max() == 0.0 and np.abs(got[2, 0]).max() == 0.0
    assert np.abs(got[0]).max() > 0
    np.testing.assert_allclose(tfx.embed_frames(sd, clips, batch_frames=15, device="cpu"), got,
                               rtol=0, atol=1e-6)


def _jax_params(e, t, heads, layers, classes=4, seed=0):
    """Flax FeatureTransformer params with seeded noise on every leaf."""
    model = JFT(num_classes=classes, dense_dim=4, num_heads=heads, num_layers=layers,
                dropout=0.0, head_dropout=0.0)
    params = jax.jit(model.init)(jax.random.key(seed), jnp.zeros((1, t, e)))["params"]
    rng = np.random.default_rng(seed + 1)
    return model, jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32), params)


def _port(params, e, t, heads, layers, classes=4):
    model = FeatureTransformer(classes, e, t, dense_dim=4, num_heads=heads, num_layers=layers,
                               dropout=0.0, head_dropout=0.0)
    model.load_state_dict(convert.feature_transformer_state_dict_from_flax(params))
    return model


@pytest.mark.parametrize("e,heads", [(64, 4), (1024, 2)], ids=["e64-h4", "defaults-e1024-h2"])
def test_feature_transformer_logits_match_jax(e, heads):
    """Eval-mode logits within 1e-5 of the largest, 2 layers over 5 frames."""
    model, params = _jax_params(e, 5, heads, 2)
    x = np.random.default_rng(3).standard_normal((6, 5, e)).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)({"params": params}, x))
    with torch.no_grad():
        got = _port(params, e, 5, heads, 2).eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (6, 4) and _rel(got, want) <= TOL


def test_max_over_time_shares_the_gradient_of_tied_frames():
    """Frames 0 and 1 equal, with equal position embeddings: every feature's
    max over time is tied between them, and the gradient is shared equally
    (``amax``, as JAX's ``max``), each frame's within 1e-5 of JAX's."""
    model, params = _jax_params(16, 4, 2, 1)
    params = dict(params)
    pos = np.array(params["pos_embedding"])
    pos[:, 1] = pos[:, 0]
    params["pos_embedding"] = pos
    x = np.random.default_rng(4).standard_normal((3, 4, 16)).astype(np.float32)
    x[:, 1] = x[:, 0]
    cot = np.random.default_rng(5).standard_normal((3, 4)).astype(np.float32)
    want = np.asarray(jax.jit(jax.grad(
        lambda f: jnp.sum(model.apply({"params": params}, f) * cot)))(x))
    xt = torch.from_numpy(x).requires_grad_()
    (_port(params, 16, 4, 2, 1)(xt) * torch.from_numpy(cot)).sum().backward()
    got = xt.grad.numpy()
    assert _rel(got, want) <= TOL
    np.testing.assert_allclose(got[:, 0], got[:, 1], rtol=0, atol=1e-7)
    assert np.abs(got[:, 0]).max() > 0


def _ft_cfg(**kw):
    base = dict(num_classes=4, num_features=32, dense_dim=4, num_heads=2, num_layers=2,
                dropout=0.0, head_dropout=0.0, learning_rate=1e-3)
    base.update(kw)
    return FeatureTransformerConfig(**base), JFTConfig(**{k: v for k, v in base.items()
                                                          if k != "num_features"})


def _jax_state(jcfg, params):
    """JAX's ``create_state`` on given params (without its eager init)."""
    model = JFT(num_classes=jcfg.num_classes, dense_dim=jcfg.dense_dim,
                num_heads=jcfg.num_heads, num_layers=jcfg.num_layers, dropout=jcfg.dropout,
                head_dropout=jcfg.head_dropout)
    return jfx.TrainState.create(apply_fn=model.apply,
                                 params=jax.tree_util.tree_map(jnp.asarray, params),
                                 tx=optax.adam(jcfg.learning_rate))


def _with_params(state, params):
    state.model.load_state_dict(convert.feature_transformer_state_dict_from_flax(params))
    state.optimizer = torch.optim.Adam(state.model.parameters(), lr=state.optimizer.defaults["lr"],
                                       betas=(0.9, 0.999), eps=1e-8)
    return state


def test_train_step_matches_jax():
    """One step, dropout 0: the loss within 1e-6 relative, every gradient
    within 1e-5 of its tensor's largest, and the params after Adam's first
    step within 1e-6 wherever the gradient is above 1e-5 (near 0 the
    update's sign may flip); the step count moves to 1."""
    cfg, jcfg = _ft_cfg()
    _, params = _jax_params(32, 5, 2, 2)
    jstate = _jax_state(jcfg, params)
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((8, 5, 32)).astype(np.float32)
    labels = rng.integers(0, 4, 8).astype(np.int32)

    def loss_fn(p):
        return jlosses.softmax_xent(jstate.apply_fn({"params": p}, feats), labels)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(jstate.params)
    want_grads = convert.feature_transformer_state_dict_from_flax(want_grads)
    jnew, jm = jfx.train_step(jstate, jnp.asarray(feats), jnp.asarray(labels), jax.random.key(1))
    want_after = convert.feature_transformer_state_dict_from_flax(jnew.params)

    state = _with_params(tfx.create_state(cfg, device="cpu"), params)
    grads = {}
    for name, p in state.model.named_parameters():
        p.register_hook(lambda g, name=name: grads.__setitem__(name, g.clone()))
    m = tfx.train_step(state, torch.from_numpy(feats), torch.from_numpy(labels))
    assert state.step == 1
    assert abs(m["loss"].item() - float(want_loss)) <= 1e-6 * abs(float(want_loss))
    assert abs(m["loss"].item() - float(jm["loss"])) <= 1e-6 * abs(float(jm["loss"]))
    assert m["accuracy"].item() == pytest.approx(float(jm["accuracy"]))
    for name, g in grads.items():
        assert _rel(g.numpy(), want_grads[name].numpy()) <= TOL, name
        live = want_grads[name].abs() > 1e-5
        after = state.model.state_dict()[name]
        assert (after - want_after[name])[live].abs().max().item() <= 1e-6, name


def test_train_loop_matches_jax(monkeypatch):
    """The whole loop, dropout 0, on the same params: the same permutation,
    validation split and batches (40 clips: 6 held out, 4 steps an epoch of
    8, 3 epochs), metrics at steps 1..12, the validation loss within 1e-4
    relative and the same accuracy, every param within 1e-4, but the key
    third of each qkv bias: its gradient is exactly 0 (a shift of a query's
    scores leaves the softmax as it was), so both sides step on rounding
    noise, by Adam's lr·sign(g), within 2·lr a step."""
    cfg, jcfg = _ft_cfg(num_epochs=3)
    _, params = _jax_params(32, 5, 2, 2)
    monkeypatch.setattr(jfx, "create_state", lambda c, key, num_features: _jax_state(c, params))
    real_port = tfx.create_state
    monkeypatch.setattr(tfx, "create_state", lambda *a, **k: _with_params(real_port(*a, **k),
                                                                            params))
    rng = np.random.default_rng(7)
    labels = rng.integers(0, 4, 40)
    feats = (rng.standard_normal((4, 32))[labels][:, None]
             + 0.5 * rng.standard_normal((40, 5, 32))).astype(np.float32)

    class Steps:
        def __init__(self):
            self.steps = []

        def write(self, step, metrics):
            self.steps.append(int(step))

    jw, tw = Steps(), Steps()
    jstate, want = jfx.train(jcfg, feats, labels, seed=2, batch_size=8, metrics_writer=jw)
    state, got = tfx.train(cfg, feats, labels, seed=2, batch_size=8, metrics_writer=tw,
                           device="cpu")
    assert tw.steps == jw.steps == list(range(1, 13))
    assert abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"])
    assert got["accuracy"] == pytest.approx(want["accuracy"])
    want_sd = convert.feature_transformer_state_dict_from_flax(jstate.params)
    for name, v in state.model.state_dict().items():
        d = (v - want_sd[name]).abs().numpy()
        if name.endswith("qkv.bias"):     # the key third: a gradient of exactly 0
            e = d.shape[0] // 3
            assert d[e:2 * e].max() <= 2 * 12 * cfg.learning_rate, name
            d = np.concatenate([d[:e], d[2 * e:]])
        assert d.max() <= 1e-4, name


def test_train_learns_separable_features():
    """Mirror of the JAX package's convergence smoke test: per-class
    direction patterns in 16-d features, 60 epochs at lr 1e-2: validation
    accuracy clearly above the 25% chance level."""
    cfg = FeatureTransformerConfig(num_classes=4, num_features=16, num_epochs=60, dense_dim=32,
                                   dropout=0.0, head_dropout=0.0, learning_rate=1e-2)
    rng = np.random.default_rng(0)
    n = 128
    labels = rng.integers(0, 4, n)
    patterns = rng.normal(0, 1.0, (4, 16)).astype(np.float32)
    feats = (patterns[labels][:, None, :] + rng.normal(0, 0.2, (n, 5, 16))).astype(np.float32)
    state, val = tfx.train(cfg, feats, labels, batch_size=16, device="cpu")
    assert val["accuracy"] > 0.5
    assert state.step == 60 * ((n - int(0.15 * n)) // 16)


def test_dropout_masks_come_from_the_step_key():
    """With dropout on, a step's masks are drawn from the state's generator
    re-seeded by the step: two states from one seed take equal steps, and
    the train-mode logits differ from the eval-mode ones."""
    cfg = dataclasses.replace(_ft_cfg()[0], dropout=0.3, head_dropout=0.5)
    rng = np.random.default_rng(8)
    feats = torch.from_numpy(rng.standard_normal((8, 5, 32)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 4, 8))
    a, b = (tfx.create_state(cfg, seed=1, device="cpu") for _ in range(2))
    for _ in range(2):
        la, lb = tfx.train_step(a, feats, labels)["loss"], tfx.train_step(b, feats, labels)["loss"]
        assert torch.equal(la, lb)
    with torch.no_grad():
        eval_logits = a.model.eval()(feats)
        a.generator.manual_seed(0)
        train_logits = a.model.train()(feats, generator=a.generator)
    assert not torch.allclose(eval_logits, train_logits)
    m = tfx.eval_step(a, feats, labels)
    assert set(m) == {"loss", "accuracy"} and a.model.training
