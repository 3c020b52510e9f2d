"""The port's AV-HuBERT video encoder (``models/avhubert``), its fairseq
converter and its port path, against the JAX package's module and
converter and against the torch mirror of fairseq's modules that the JAX
package's own port test builds (``tests/test_avhubert_port.py``).

Sizes: the Flax comparison at ResNet base 4, 1 layer, 64 wide, 4 heads,
FFN 128, positional conv 16 taps in 4 groups, on (2, 5, 88, 88, 1) video;
the fairseq mirror at its own sizes (base 8, 2 layers). Float32.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lipreading_video_generation_tpu.models import avhubert as javh
from lipreading_video_generation_tpu_torch.models import avhubert as tavh
from lipreading_video_generation_tpu_torch.models import convert, ports, selftest

from test_avhubert_port import _seeded_state_dict, _TorchAVHubertVideo

CFG = dict(embed_dim=64, num_layers=1, num_heads=4, ffn_dim=128, resnet_base=4,
           pos_conv_kernel=16, pos_conv_groups=4)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


def _video(seed=2, t=5):
    return ((np.random.default_rng(seed).random((2, t, 88, 88, 1)).astype(np.float32) - 0.421)
            / 0.165)


def _flax_tree(shapes, seed):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if name.endswith("['kernel']"):
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name.endswith("['scale']"):
            v = 1.0 + 0.05 * rng.standard_normal(shape)
        elif name.endswith("['alpha']"):
            v = 0.25 + 0.05 * rng.standard_normal(shape)
        else:
            v = 0.05 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_encoder_matches_flax():
    """Folded BatchNorms, channel PReLUs, −inf max-pool padding, the [zeros,
    video] fuse, the grouped positional conv with SamePad and the post-norm
    layers: the same weights through both, within 1e-4."""
    model = javh.AVHubertVideoEncoder(**CFG)
    params = _flax_tree(jax.eval_shape(model.init, jax.random.key(0),
                                       jnp.zeros((1, 5, 88, 88, 1)))["params"], 1)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(_video())))
    port = tavh.AVHubertVideoEncoder(**CFG)
    port.load_state_dict(convert.avhubert_state_dict_from_flax(params))
    with torch.no_grad():
        got = port.encode(torch.from_numpy(_video())).numpy()
    assert got.shape == want.shape == (2, 5, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def fairseq():
    """The fairseq-layout mirror with seeded weights and live BatchNorm
    statistics, and its state dict as numpy."""
    tm = _TorchAVHubertVideo()
    tm.load_state_dict(_seeded_state_dict(tm, 0))
    tm.eval()
    return tm, {k: v.detach().numpy() for k, v in tm.state_dict().items()}


def test_converter_matches_fairseq_mirror_and_jax(fairseq):
    """fairseq state dict → the port's converter → the port's encoder gives
    the mirror's features within the JAX test's bounds (rtol 2e-3, atol
    2e-4: fairseq's LayerNorm eps is 1e-5, the port's 1e-6); the converted
    weights equal the JAX converter's, bridged, bit for bit."""
    tm, sd = fairseq
    got_sd, cfg, skipped = tavh.convert_avhubert_state_dict(sd)
    assert skipped == [] and cfg == dict(embed_dim=64, num_layers=2, num_heads=1, ffn_dim=128,
                                         resnet_base=8, pos_conv_kernel=16, pos_conv_groups=16)
    jparams, jcfg, _ = javh.convert_avhubert_state_dict(sd)
    assert jcfg == cfg
    want_sd = convert.avhubert_state_dict_from_flax(jparams)
    assert set(want_sd) == set(got_sd)
    assert all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd)
    cfg.update(num_heads=4, pos_conv_groups=4)      # the mirror's
    model = tavh.AVHubertVideoEncoder(**cfg)
    model.load_state_dict(got_sd)
    video = _video(3)
    with torch.no_grad():
        want = tm(torch.from_numpy(video)).numpy()
        got = model(torch.from_numpy(video)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def test_converter_rejects_drift_and_skips_non_video_keys(fairseq):
    _, sd = fairseq
    with pytest.raises(ValueError, match="unrecognized"):
        tavh.convert_avhubert_state_dict(
            dict(sd, **{"encoder.layers.0.self_attn.rotary_emb.inv_freq": np.zeros(4)}))
    with pytest.raises(KeyError):
        tavh.convert_avhubert_state_dict({k: v for k, v in sd.items() if "bn2" not in k})
    with pytest.raises(ValueError, match="not an AV-HuBERT"):
        tavh.convert_avhubert_state_dict({k: v for k, v in sd.items()
                                          if not k.startswith("encoder.layers.")})
    extra = {"feature_extractor_audio.proj.weight": np.zeros((64, 104), np.float32),
             "mask_emb": np.zeros((64,), np.float32),
             "decoder.embed_tokens.weight": np.zeros((10, 64), np.float32),
             "final_proj.weight": np.zeros((64, 64), np.float32)}
    _, _, skipped = tavh.convert_avhubert_state_dict(dict(sd, **extra))
    assert set(skipped) == set(extra)


@pytest.mark.parametrize("wrap", ["model", "finetuned"])
def test_port_avhubert_round_trip(tmp_path, fairseq, wrap):
    """``port_avhubert`` on a ``{"model": sd}`` file and on a fine-tuned
    seq2seq file (``encoder.w2v_model.`` prefix, a pickled config object
    beside the tensors: read by the ``weights_only=False`` retry), then
    ``load_avhubert_expert``: the same weights, the head count given."""
    import argparse

    _, sd = fairseq
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    obj = {"model": tensors}
    if wrap == "finetuned":
        obj = {"model": {f"encoder.w2v_model.{k}": v for k, v in tensors.items()},
               "cfg": argparse.Namespace(task="avsr")}
    torch.save(obj, tmp_path / "av.pt")
    got, cfg, _ = ports.port_avhubert(str(tmp_path / "av.pt"), str(tmp_path / "art"),
                                      num_heads=4, pos_conv_groups=4)
    model, back = ports.load_avhubert_expert(str(tmp_path / "art"))
    assert cfg["num_heads"] == 4 and model.enc_layer_0.num_heads == 4
    assert all(torch.equal(back[k], got[k]) for k in got)
    assert all(torch.equal(model.state_dict()[k], got[k]) for k in got)
    with pytest.raises(ValueError, match="port mismatch"):
        ports._validate_against_init({k: v for k, v in got.items()
                                      if not k.endswith("final_ln.bias")},
                                     ports._template(ports._avhubert_build(cfg)))


def test_selftest_at_small_size(tmp_path):
    out = selftest.selftest_avhubert(str(tmp_path / "av"), device="cpu")
    assert out["feature_shape"] == [1, 3, 64] and out["skipped_keys"] == 2
    assert np.isfinite(out["feature_l2"])
