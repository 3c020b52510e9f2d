"""The port's DenseNet121 (``models/densenet``), its converters and its port
path against the JAX package, on the CPU.

Small configuration for the module (growth 8, blocks (2, 2, 2, 2), 16
initial features, 32×32 frames), on perturbed Flax params and batch stats
carried across by ``models.convert``; the published widths for the layout,
the converter, the selftest and one forward. Float32 throughout: each
forward within 1e-5 of the largest feature (in train mode 1e-4: see
``TOL_TRAIN``), the running statistics within 1e-6.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lipreading_video_generation_tpu.models import densenet as jdn
from lipreading_video_generation_tpu.models import ports as jports
from lipreading_video_generation_tpu.models import selftest as jselftest
from lipreading_video_generation_tpu_torch.models import convert
from lipreading_video_generation_tpu_torch.models import densenet as tdn
from lipreading_video_generation_tpu_torch.models import ports, selftest

SMALL = dict(growth=8, block_config=(2, 2, 2, 2), init_features=16)
TOL = 1e-5
# Train mode normalises the last block's 1×1 maps with the statistics of a
# batch of 4: the fast variance E[x²]−E[x]² cancels there, and float32
# rounding in another summation order comes out ~|E[x]|²/Var larger.
TOL_TRAIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def small():
    """Flax params and batch stats of the small DenseNet with seeded noise on
    every leaf (init leaves BatchNorm at 1/0 and its stats at 0/1, where a
    swapped mapping would not show); variances kept positive."""
    model = jdn.DenseNet121(**SMALL)
    variables = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(1)

    def noisy(a, positive=False):
        a = np.asarray(a, np.float32)
        if positive:
            return (0.5 + rng.uniform(0, 1, a.shape)).astype(np.float32)
        return a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)

    params = jax.tree_util.tree_map(noisy, variables["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: noisy(a, positive=jax.tree_util.keystr(p).endswith("['var']")),
        variables["batch_stats"])
    sd = convert.densenet_state_dict_from_flax(params, stats)
    port = tdn.DenseNet121(**SMALL)
    port.load_state_dict(sd)
    frames = np.random.default_rng(2).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    x = np.array(jdn.imagenet_preprocess(jnp.asarray(frames)))
    return dict(model=model, params=params, stats=stats, port=port, frames=frames, x=x)


def test_imagenet_preprocess_matches_jax(small):
    got = tdn.imagenet_preprocess(torch.from_numpy(small["frames"])).numpy()
    np.testing.assert_array_equal(got, small["x"])


def test_small_densenet_eval_matches_jax(small):
    """Eval mode (running statistics): the pooled features within 1e-5."""
    want = np.asarray(jax.jit(small["model"].apply)(
        {"params": small["params"], "batch_stats": small["stats"]}, small["x"]))
    with torch.no_grad():
        got = small["port"].eval()(torch.from_numpy(small["x"])).numpy()
    assert got.shape == want.shape == (4, 32)   # 16 + 2·8, halved, … + 2·8
    assert _rel(got, want) <= TOL


def test_small_densenet_train_mode_matches_jax_batch_stats(small):
    """Train mode normalises with the biased batch variance and moves the
    running statistics by 1 − 0.99 towards the batch's (JAX's
    ``mutable=["batch_stats"]``): features within 1e-4, every updated mean
    and variance within 1e-6."""
    want, updated = jax.jit(lambda v, x: small["model"].apply(
        v, x, train=True, mutable=["batch_stats"]))(
        {"params": small["params"], "batch_stats": small["stats"]}, small["x"])
    port = tdn.DenseNet121(**SMALL)
    port.load_state_dict(small["port"].state_dict())
    got = port.train()(torch.from_numpy(small["x"])).detach().numpy()
    assert _rel(got, want) <= TOL_TRAIN
    want_sd = convert.densenet_state_dict_from_flax(small["params"], updated["batch_stats"])
    moved = 0
    for k, v in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), rtol=0, atol=1e-6)
            moved += int(not torch.equal(v, small["port"].state_dict()[k]))
    assert moved == 2 * 21       # norm0, 8 layers × 2, 3 transitions, norm5: all moved


def _torchvision_layout():
    """torchvision's ``densenet121().state_dict()`` names and shapes under
    ``features.`` (without ``num_batches_tracked``), enumerated from the
    published architecture."""
    out = {"features.conv0.weight": (64, 3, 7, 7)}

    def bn(name, c):
        out.update({f"{name}.{leaf}": (c,) for leaf in
                    ("weight", "bias", "running_mean", "running_var")})

    bn("features.norm0", 64)
    ch = 64
    for bi, n in enumerate((6, 12, 24, 16)):
        for li in range(n):
            at = f"features.denseblock{bi + 1}.denselayer{li + 1}"
            cin = ch + li * 32
            bn(f"{at}.norm1", cin)
            out[f"{at}.conv1.weight"] = (128, cin, 1, 1)
            bn(f"{at}.norm2", 128)
            out[f"{at}.conv2.weight"] = (32, 128, 3, 3)
        ch += n * 32
        if bi < 3:
            bn(f"features.transition{bi + 1}.norm", ch)
            out[f"features.transition{bi + 1}.conv.weight"] = (ch // 2, ch, 1, 1)
            ch //= 2
    bn("features.norm5", ch)
    return out


@pytest.fixture(scope="module")
def jax_shapes():
    """JAX's DenseNet121 variables as shapes only (``jax.eval_shape``)."""
    return jax.eval_shape(lambda: jdn.DenseNet121().init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3))))


def test_full_width_layout_is_torchvision_and_jax_template(jax_shapes):
    """The port's DenseNet121 has torchvision's names and shapes, one tensor
    for each leaf of JAX's template (604), and the bridge maps JAX's tree
    onto exactly those."""
    want = _torchvision_layout()
    tmpl = {k: tuple(v.shape) for k, v in ports._densenet_template().items()}
    assert tmpl == want
    leaves = jax.tree_util.tree_leaves(jax_shapes)
    assert len(leaves) == len(want) == 604
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), jax_shapes)
    bridged = convert.densenet_state_dict_from_flax(zeros["params"], zeros["batch_stats"])
    assert {k: tuple(v.shape) for k, v in bridged.items()} == want


def _seeded_torchvision(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(s, generator=g) for k, s in _torchvision_layout().items()}


def test_converter_skips_classifier_and_counters_and_refuses_legacy_keys(tmp_path, jax_shapes):
    """``classifier.*`` and ``num_batches_tracked`` are dropped (as JAX's
    converter drops them); torchvision's legacy names (``norm.1``) are not
    renamed and are refused, by the port and by JAX's validation alike."""
    sd = _seeded_torchvision()
    extra = dict(sd)
    extra["classifier.weight"] = torch.zeros(1000, 1024)
    extra["classifier.bias"] = torch.zeros(1000)
    for k in list(sd):
        if k.endswith("running_var"):
            extra[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    pth = tmp_path / "densenet121.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in extra.items()}}, pth)
    got = ports.port_densenet(str(pth), str(tmp_path / "out.pt"))
    assert got.keys() == sd.keys() and all(torch.equal(got[k], sd[k]) for k in sd)

    legacy = {k.replace("denselayer1.norm1.", "denselayer1.norm.1."): v for k, v in sd.items()}
    torch.save(legacy, tmp_path / "legacy.pth")
    with pytest.raises(ValueError, match="port mismatch"):
        ports.port_densenet(str(tmp_path / "legacy.pth"), str(tmp_path / "legacy.pt"))
    params, stats = jdn.convert_torch_state_dict({k: v.numpy() for k, v in legacy.items()})
    with pytest.raises(ValueError, match="port mismatch"):
        jports._validate_against_init(params, jax_shapes["params"])


def _jax_template_in_creation_order():
    """JAX's ``_densenet_template`` without its eager init (about a minute
    on this CPU): the same tree, in the order Flax creates it (conv0, norm0,
    block0_layer0 …; scale before bias, mean before var), which is the
    order JAX's converter builds from torchvision's keys."""
    params, stats = jdn.convert_torch_state_dict(
        {k: np.zeros(v.shape, np.float32) for k, v in ports._densenet_template().items()})
    return params, stats


def test_selftest_pth_and_features_match_jax(tmp_path, monkeypatch):
    """The selftest file holds the same tensors JAX's selftest writes for
    the seed; ``selftest_densenet`` reports JAX's keys, and the ported
    features of its two 64×64 images equal JAX's DenseNet121 on the same
    file within 1e-5 (the published widths, eval mode)."""
    monkeypatch.setattr(jports, "_densenet_template", _jax_template_in_creation_order)
    jax_pth = jselftest.make_densenet_selftest_pth(str(tmp_path / "jax.pth"), seed=3)
    port_pth = selftest.make_densenet_selftest_pth(str(tmp_path / "port.pth"), seed=3)
    want_sd, got_sd = torch.load(jax_pth), torch.load(port_pth)
    assert want_sd.keys() == got_sd.keys()
    assert all(torch.equal(want_sd[k], got_sd[k]) for k in want_sd)

    r = selftest.selftest_densenet(str(tmp_path / "art.pt"), seed=3, device="cpu")
    assert set(r) == {"pth", "pth_sha256", "artifact", "feature_shape", "feature_l2"}
    assert r["feature_shape"] == [2, 1024] and len(r["pth_sha256"]) == 64
    params, stats = jdn.convert_torch_state_dict({k: v.numpy() for k, v in want_sd.items()})
    img = np.random.default_rng(4).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jdn.DenseNet121().apply)(
        {"params": params, "batch_stats": stats}, img))
    assert abs(r["feature_l2"] - np.linalg.norm(want)) <= 1e-4 * np.linalg.norm(want)
    model = ports._materialise(tdn.DenseNet121, ports.load_densenet_variables(r["artifact"]))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(img)).numpy()
    assert _rel(got, want) <= TOL


def test_artifact_loads_and_random_init_warns(tmp_path, capsys):
    """``load_densenet_variables`` reads a ``port-densenet`` artifact and a
    torchvision ``.pth`` alike; without a checkpoint the embedder is drawn
    from the seed, with JAX's warning."""
    sd = _seeded_torchvision(1)
    torch.save(sd, tmp_path / "tv.pth")
    ports.port_densenet(str(tmp_path / "tv.pth"), str(tmp_path / "art.pt"))
    for path in ("tv.pth", "art.pt"):
        got = ports.load_densenet_variables(str(tmp_path / path))
        assert all(torch.equal(got[k], sd[k]) for k in sd) and got.keys() == sd.keys()
    a = ports.densenet_variables_or_init(None, seed=5)
    b = ports.densenet_variables_or_init(None, seed=5)
    assert "RANDOM-INIT" in capsys.readouterr().err
    assert a.keys() == sd.keys() and all(torch.equal(a[k], b[k]) for k in a)
