"""The port's FLOP accounting (``utils/flops.py``) against the JAX
package's (``tests/test_flops.py``): torch products by
``torch.utils.flop_counter``'s formulas, the hand-written kernels K1-K6 by
the hooks in their wrappers (on the CPU their plain versions run in their
place, and report the kernels' counts instead of their own products), and
``mfu_report`` / ``device_peak_tflops``. Inputs are numpy arrays from a
seed; JAX's Pallas kernels are traced as ``tests/test_flops.py`` traces
them (interpret mode on the CPU). Each tolerance is stated where it is used.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lipreading_video_generation_tpu.utils import flops as JF
from lipreading_video_generation_tpu_torch.ops import attention as att
from lipreading_video_generation_tpu_torch.ops import image as timage
from lipreading_video_generation_tpu_torch.ops import quant
from lipreading_video_generation_tpu_torch.utils import flops as F

SMALL_VIVIT = dict(num_layers=2, hidden_size=64, num_heads=4, mlp_dim=128, num_classes=8)
TINY_DIFFUSION = dict(im_size=16, base_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                      attention_resolutions=(1, 2), num_heads=2, time_embed_dim=32,
                      audio_embed_dim=32, audio_proj_dim=8, im_cond_channels=4,
                      audio_samples=800, num_timesteps=50, dropout=0.0, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_matmul_count_is_exact():
    a, b = _rand((256, 128), 0), _rand((128, 64), 1)
    want = F.matmul_flops(256, 64, 128)
    assert F.compiled_flops(torch.matmul, torch.from_numpy(a), torch.from_numpy(b)) == want
    # JAX's cost model, within its own test's band (1%)
    got = JF.compiled_flops(jax.jit(lambda x, y: x @ y), jnp.asarray(a), jnp.asarray(b))
    assert got == pytest.approx(want, rel=0.01)


def test_conv_count_is_exact():
    x, k = _rand((2, 16, 16, 8), 2), _rand((3, 3, 8, 32), 3)
    want = F.conv2d_flops(2, 16, 16, 8, 32, 3, 3)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    kt = torch.from_numpy(k).permute(3, 2, 0, 1)
    assert F.compiled_flops(torch.nn.functional.conv2d, xt, kt, None, 1, 1) == want
    # JAX's cost model counts SAME-padded convs over the padded window:
    # its own test's band [0.8, 1.3]
    got = JF.compiled_flops(
        jax.jit(lambda a, w: jax.lax.conv_general_dilated(
            a, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))),
        jnp.asarray(x), jnp.asarray(k))
    assert want * 0.8 <= got <= want * 1.3


def _jax_flash_grad():
    from lipreading_video_generation_tpu.ops.attention import flash_attention

    return jax.jit(lambda q: jax.grad(lambda x: flash_attention(x, x, x).sum())(q).sum())


def _flash_grad(q):
    att.flash_attention(q, q, q).sum().backward()


@pytest.mark.parametrize("d", [64, 48])
def test_flash_forward_backward_match_pallas_flops(d):
    """K3, K4 and K5 through ``_Flash`` on the CPU (their plain versions):
    ``model`` exactly JAX's ``pallas_flops`` model; ``hw`` exactly the
    port's formula (``attention.flash_flops``: float32 takes the CUDA-core
    "tiled" kernels, whose tiles divide 256, at the head dim padded to 64:
    9 products of 2·s²·64 a head, as JAX's padded count); the plain
    versions' own products are not counted beside them."""
    b, h, s = 2, 4, 256
    jm, jh = JF.pallas_flops(_jax_flash_grad(), jnp.zeros((b, h, s, d)))
    q = torch.from_numpy(_rand((b, h, s, d), 4)).requires_grad_()
    detail = F.flops_detail(_flash_grad, q)
    kernels = detail["kernels"]
    assert {k: v["launches"] for k, v in kernels.items()} == {
        "flash_attention": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}
    model = sum(v["model"] for v in kernels.values())
    hw = sum(v["hw"] for v in kernels.values())
    assert model == jm == 2 * 6 * b * h * s * s * d
    want_hw = {name: att.flash_flops(kind, "cuda_core", "tiled", b * h, s, s, d, False)[1]
               for name, kind in (("flash_attention", "fwd"), ("flash_bwd_dkv", "dkv"),
                                  ("flash_bwd_dq", "dq"))}
    assert {k: v["hw"] for k, v in kernels.items()} == want_hw
    assert hw == jh == 2 * 9 * b * h * s * s * 64
    # the sum, its backward and Δ = Σ dO·O are elementwise: nothing else counts
    assert (detail["model"], detail["hw"]) == (model, hw) == F.kernel_flops(_flash_grad, q)


def test_flash_loop_counts_each_call():
    """Five flash calls in a Python loop count five times (the counterpart
    of ``test_pallas_flops_scan_multiplies_by_length``: torch runs each
    trip)."""
    q = torch.from_numpy(_rand((1, 1, 256, 64), 5))

    def five(c):
        for _ in range(5):
            c = att.flash_attention(c, c, c)
        return c

    detail = F.flops_detail(five, q)
    assert detail["kernels"]["flash_attention"]["launches"] == 5
    assert detail["model"] == 5 * 2.0 * 2 * 256 * 256 * 64


def test_flash_causal_hw_counts_the_tiles_walked():
    """Under a causal mask hw counts the tile pairs the kernels walk (key
    tiles past a query tile's last visible key are skipped), model the full
    rectangle, as JAX's rule does."""
    model, hw = att.flash_flops("fwd", "sm90", None, 1, 512, 512, 64, True)
    assert model == 4 * 512 * 512 * 64
    # 128-row x 64-key tiles: query tile i sees key tiles 0 .. 2i + 1
    assert hw == sum(2 * i + 2 for i in range(4)) * 2 * 128 * 64 * 64 * 2


@pytest.mark.parametrize("causal", [False, True])
def test_small_mha_model_matches_pallas_flops(causal):
    """K2's model formula equals JAX's ``pallas_flops`` over its fused
    small-MHA kernel (interpret mode), and the CPU's ``mha`` (the einsum
    path, where the card launches K2) counts the same products."""
    from lipreading_video_generation_tpu.ops.attention import _small_mha

    b, s, e, heads = 2, 80, 64, 4
    x = _rand((3, b, s, e), 6)
    fn = jax.jit(lambda q, k, v: _small_mha(q, k, v, heads, causal, True))
    jm, _ = JF.pallas_flops(fn, *(jnp.asarray(t) for t in x))
    model, hw = att.small_mha_flops("sm90", b, heads, s, e // heads, causal)
    assert model == jm
    assert hw == 4 * b * heads * 80 * 80 * 32          # S pad 16 -> 80, d 16 -> 32
    q, k, v = (torch.from_numpy(t) for t in x)
    assert F.compiled_flops(att.mha, q, k, v, heads, causal) == model


def test_small_mha_backward_recompute_counts_in_hw_only(monkeypatch):
    """K2's backward recomputes the forward through ``_mha_einsum``: those
    products go to hw, not model, so a training step counts 4 + 8 b·h·s²·d
    of model (the einsum path's, as on the CPU) and 4 more in hw. The
    card's launch is stood in for by the einsum under the hook's record."""
    b, s, e, heads = 2, 16, 32, 2
    d = e // heads

    def launch(q, k, v, num_heads, causal):
        F.record("small_mha", *att.small_mha_flops("cuda_core", b, num_heads, s, d, causal))
        with F.plain_version(dict):
            return att._mha_einsum(q, k, v, num_heads, causal)

    monkeypatch.setattr(att, "_small_mha_launch", launch)
    q, k, v = (torch.from_numpy(_rand((b, s, e), 7 + i)).requires_grad_() for i in range(3))
    detail = F.flops_detail(lambda: att._SmallMHA.apply(q, k, v, heads, False).sum().backward())
    unit = b * heads * s * s * d
    assert detail["kernels"]["small_mha"] == {"launches": 1, "model": 4 * unit, "hw": 4 * unit}
    assert (detail["model"], detail["hw"]) == (12 * unit, 16 * unit)
    plain = F.flops_detail(lambda: att._mha_einsum(q, k, v, heads, False).sum().backward())
    assert plain["model"] == detail["model"]


def test_int8_conv_model_at_logical_depth_hw_at_padded():
    """K6's product of an int8 conv: model at the logical depth kh·kw·Cin
    (45; what XLA scores JAX's int8 ``conv_general_dilated`` at), hw at the
    depth the kernel multiplies: the im2col's 48, padded to its 128-byte
    k-step, with M padded to 128 rows and N = 7 to its 8-wide tile."""
    x, k = _rand((2, 12, 12, 5), 8), _rand((3, 3, 5, 7), 9)
    detail = F.flops_detail(quant.int8_conv, torch.from_numpy(x), torch.from_numpy(k), None,
                            (1, 1), "SAME")
    want = F.conv2d_flops(2, 12, 12, 5, 7, 3, 3)
    assert detail["model"] == want
    assert detail["kernels"] == {"int8_matmul": {"launches": 1, "model": want,
                                                 "hw": 2 * 384 * 8 * 128}}
    from lipreading_video_generation_tpu.ops import quant as jquant

    # JAX's count adds the quantisation's elementwise ops: its conv band
    got = JF.compiled_flops(
        jax.jit(lambda a, w: jquant.int8_conv(a, w, None, (1, 1), "SAME")),
        jnp.asarray(x), jnp.asarray(k))
    assert want * 0.8 <= got <= want * 1.3


def test_clahe_counts_zero_beside_jax_declared():
    """The known difference: K1 does integer histograms and a lookup, in
    the kernel and in ``clahe_reference`` alike, and counts 0; the JAX
    kernel declares its one-hot matmuls (about 159 MFLOP a 48x48 image)."""
    from lipreading_video_generation_tpu.ops.clahe_pallas import clahe_pallas

    img = np.random.default_rng(10).integers(0, 256, (2, 48, 48), dtype=np.uint8)
    jm, jh = JF.pallas_flops(jax.jit(lambda t: clahe_pallas(t, interpret=True)),
                             jnp.asarray(img))
    assert jm == jh == 2 * 2 * (2 * 48 * 48 * 64 * 256 + 256 * 256 * 64)
    detail = F.flops_detail(timage.clahe, torch.from_numpy(img))
    assert detail == {"model": 0, "hw": 0,
                      "kernels": {"clahe_cuda": {"launches": 1, "model": 0, "hw": 0}}}


@pytest.mark.parametrize("flops,sec", [(1e12, 0.1), (None, 0.1),
                                       ({"model": 1e12, "hw": 2e12}, 0.1)])
def test_mfu_report_matches_jax(monkeypatch, flops, sec):
    monkeypatch.setenv("LVG_PEAK_TFLOPS", "100")
    assert F.mfu_report(flops, sec) == JF.mfu_report(flops, sec)


@pytest.mark.parametrize("name,peak", [("NVIDIA H100 80GB HBM3", 989.4),
                                       ("NVIDIA H100 SXM5 80GB", 989.4),
                                       ("NVIDIA H100 PCIe", 756.0),
                                       ("NVIDIA A100-SXM4-80GB", None)])
def test_device_peak_tflops_by_name(monkeypatch, name, peak):
    monkeypatch.delenv("LVG_PEAK_TFLOPS", raising=False)
    monkeypatch.setattr(F, "_device_name", lambda device: name)
    assert F.device_peak_tflops() == peak


def test_device_peak_tflops_cpu_and_override(monkeypatch):
    monkeypatch.delenv("LVG_PEAK_TFLOPS", raising=False)
    assert F.device_peak_tflops("cpu") is None
    if not torch.cuda.is_available():
        assert F.device_peak_tflops() is None
    monkeypatch.setenv("LVG_PEAK_TFLOPS", "123.5")
    assert F.device_peak_tflops("cpu") == 123.5


def _vivits(dtype):
    from lipreading_video_generation_tpu.core import config as jcfg
    from lipreading_video_generation_tpu.models.vivit import ViViT as JViViT
    from lipreading_video_generation_tpu_torch.core import config as tcfg
    from lipreading_video_generation_tpu_torch.models.vivit import ViViT as TViViT

    torch.manual_seed(0)
    return (JViViT(jcfg.ViViTConfig(**SMALL_VIVIT, dtype=dtype)),
            TViViT(tcfg.ViViTConfig(**SMALL_VIVIT, dtype=dtype)).eval())


def test_vivit_forward_counts_near_jax():
    """8 clips through the small ViViT in bf16: the port counts products
    only, XLA also counts elementwise ops and the softmax; measured 0.944 of
    JAX's model count, held within [0.93, 1.0]."""
    jm, tm = _vivits("bfloat16")
    x = np.random.default_rng(11).random((8, 5, 32, 32, 1)).astype(np.float32)
    params = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x))["params"])
    want = JF.flops_detail(jax.jit(lambda p, a: jm.apply({"params": p}, a)), params,
                           jax.ShapeDtypeStruct(x.shape, jnp.float32))["model"]
    with torch.inference_mode():
        got = F.compiled_flops(tm, torch.from_numpy(x))
    assert 0.93 <= got / want <= 1.0


def test_vivit_logits_bit_equal_under_count():
    _, tm = _vivits("float32")
    x = torch.from_numpy(np.random.default_rng(12).random((4, 5, 32, 32, 1)).astype(np.float32))
    with torch.inference_mode():
        plain = tm(x)
        with F.FlopCount() as count:
            counted = tm(x)
    assert count.model > 0 and not F.running
    assert torch.equal(plain, counted)


def test_count_ends_when_fn_raises():
    def boom():
        raise ValueError("boom")

    with pytest.raises(ValueError):
        F.flops_detail(boom)
    assert not F.running


def test_unet_train_step_kernel_terms_match_pallas_flops():
    """One float32 step of the tiny 16x16 U-Net trainer (attention at 256
    tokens: K3 forward, K4/K5 backward, three layers): the kernels' model
    terms equal JAX's ``pallas_flops`` exactly; the whole step's model
    count (forward, backward, Adam) within [0.99, 1.01] of JAX's
    ``flops_detail`` (measured 1.0005: XLA's elementwise work on one side,
    torch's convolution-backward formulas on the other)."""
    from lipreading_video_generation_tpu.core.config import DiffusionConfig as JCfg
    from lipreading_video_generation_tpu.pipelines import train_diffusion as jtd
    from lipreading_video_generation_tpu_torch.core.config import DiffusionConfig as TCfg
    from lipreading_video_generation_tpu_torch.pipelines import train_diffusion as ttd

    rng = np.random.default_rng(13)
    batch = {"target_frame": rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8),
             "cond_frame": rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8),
             "audio": rng.standard_normal((2, 800)).astype(np.float32)}
    cfg = JCfg(**TINY_DIFFUSION)
    key = jax.random.key(0)
    state = jax.eval_shape(lambda: jtd.create_state(cfg, key))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm, jh = JF.pallas_flops(jtd.train_step, state, jbatch, key, cfg)
    want = JF.flops_detail(jtd.train_step, state, jbatch, key, cfg)["model"]

    tcfg = TCfg(**TINY_DIFFUSION)
    detail = F.flops_detail(ttd.train_step, ttd.create_state(tcfg, seed=0, device="cpu"),
                            batch, tcfg)
    kernels = detail["kernels"]
    assert {k: v["launches"] for k, v in kernels.items()} == {
        "flash_attention": 3, "flash_bwd_dkv": 3, "flash_bwd_dq": 3}
    assert sum(v["model"] for v in kernels.values()) == jm
    # head dim 16 padded to 64 on both sides
    assert sum(v["hw"] for v in kernels.values()) == jh
    assert 0.99 <= detail["model"] / want <= 1.01
