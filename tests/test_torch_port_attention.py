"""The PyTorch port's attention against the JAX package.

The JAX side runs as tests/test_attention.py runs it: ``_mha_einsum`` and
the fused small-MHA Pallas kernel in interpret mode. The CUDA kernel K2
is held against its plain version in tests/test_torch_port_cuda.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lipreading_video_generation_tpu.ops import attention as jatt
from lipreading_video_generation_tpu_torch.ops import attention as tatt


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


# the shapes of tests/test_attention.py:206-211
_SHAPES = [(3, 81, 256, 8, False), (2, 81, 256, 8, True),
           (2, 33, 64, 4, False), (1, 16, 32, 1, True)]


def _bse(seed, b, s, e):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, e)).astype(np.float32) for _ in range(3)]


def _to_jax(arrs, dtype):
    return [jnp.asarray(a).astype(dtype) for a in arrs]


def _to_torch(arrs, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


@pytest.mark.parametrize("b,s,e,h,causal", _SHAPES)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_mha_matches_jax_einsum(b, s, e, h, causal, dtype, tol):
    """``mha`` on CPU tensors (the plain path) against JAX's ``_mha_einsum``:
    float32 to summation order; bf16 to one bf16 rounding of P and of O."""
    arrs = _bse(0, b, s, e)
    want = np.asarray(jatt._mha_einsum(*_to_jax(arrs, dtype), h, causal), np.float32)
    got = tatt.mha(*_to_torch(arrs, getattr(torch, dtype)), h, causal).float().numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("b,s,e,h,causal", _SHAPES)
def test_small_mha_plain_matches_jax_kernel(b, s, e, h, causal):
    """The port's ``small_mha`` on the CPU against the JAX Pallas kernel in
    interpret mode, at that kernel's own test tolerance (it scales q before
    QKᵀ and sums heads folded into tokens)."""
    arrs = _bse(1, b, s, e)
    assert tatt.small_mha_viable(h, s, s, e) and jatt.small_mha_viable(h, s, s, e)
    want = np.asarray(jatt._small_mha(*_to_jax(arrs, jnp.float32), h, causal, True))
    got = tatt.small_mha(*_to_torch(arrs, torch.float32), h, causal).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


def test_small_mha_gradients_match_jax():
    """The port's backward is autograd through ``_mha_einsum``, as JAX's
    custom VJP is the einsum VJP."""
    arrs = _bse(2, 2, 33, 64)
    cot = np.random.default_rng(3).standard_normal((2, 33, 64)).astype(np.float32)

    def loss(q, k, v):
        return jnp.sum(jatt._small_mha(q, k, v, 4, False, True) * cot)

    want = jax.grad(loss, argnums=(0, 1, 2))(*_to_jax(arrs, jnp.float32))
    ts = [t.requires_grad_() for t in _to_torch(arrs, torch.float32)]
    (tatt.small_mha(*ts, 4) * torch.from_numpy(cot)).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_attention_reference_matches_jax():
    rng = np.random.default_rng(4)
    arrs = [rng.standard_normal((2, 3, 20, 16)).astype(np.float32) for _ in range(3)]
    for causal in (False, True):
        want = np.asarray(jatt.attention_reference(*map(jnp.asarray, arrs), causal))
        got = tatt.attention_reference(*map(torch.from_numpy, arrs), causal).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,s_q,s_k,e", [(8, 81, 81, 256), (8, 81, 120, 256),
                                         (8, 200, 200, 256), (3, 81, 81, 256),
                                         (1, 16, 16, 32), (4, 33, 33, 64), (8, 97, 97, 256)])
def test_small_mha_viable_agrees_with_jax(h, s_q, s_k, e):
    # the port adds the kernel's shared-memory bound, which none of these reach
    assert tatt.small_mha_viable(h, s_q, s_k, e) == jatt.small_mha_viable(h, s_q, s_k, e)


@pytest.mark.parametrize("h,s,e,bound", [
    (8, 80, 256, True), (8, 11, 768, True), (4, 33, 64, True), (4, 128, 256, True),
    (1, 768, 32, True),         # one head of 768 tokens: K, V as float fit the CUDA-core block
    (1, 768, 64, False),        # JAX takes it; K and V as float exceed a block's shared memory
    (8, 97, 256, False)])
def test_small_mha_viable_takes_the_bound_of_the_route(h, s, e, bound):
    """The tensor-core route has no bound beyond ``small_mha_route``'s; the
    CUDA-core one keeps its shared-memory bound."""
    jax_rule = jatt.small_mha_viable(h, s, s, e)
    assert tatt.small_mha_viable(h, s, s, e, route="sm90") == jax_rule
    assert tatt.small_mha_viable(h, s, s, e, route="cuda_core") == (jax_rule and bound)
    assert tatt.small_mha_viable(h, s, s, e) == tatt.small_mha_viable(h, s, s, e, "cuda_core")


_E = 256     # a (B, S, 256) tensor: strides (S·256, 256); a qkv slice: (S·768, 768)


@pytest.mark.parametrize("dtype,s,d,strides,offsets,route", [
    # every K2 shape the paths use, contiguous and as column slices of one qkv
    (torch.bfloat16, 80, 32, [(80 * 256, 256)] * 3, [0, 0, 0], "sm90"),            # ViViT
    (torch.bfloat16, 80, 32, [(80 * 768, 768)] * 3, [0, 512, 1024], "sm90"),       # its qkv
    (torch.bfloat16, 11, 96, [(11 * 2304, 2304)] * 3, [0, 1536, 3072], "sm90"),    # audio encoder
    (torch.bfloat16, 33, 16, [(33 * 64, 64)] * 3, [256, 512, 768], "sm90"),        # the causal case
    (torch.float32, 80, 32, [(80 * 256, 256)] * 3, [0, 0, 0], "cuda_core"),        # no TF32
    (torch.float32, 33, 16, [(33 * 64, 64)] * 3, [0, 0, 0], "cuda_core"),
    (torch.float16, 33, 16, [(33 * 64, 64)] * 3, [0, 0, 0], "cuda_core"),          # and it raises there
    # the bounds of S and d
    (torch.bfloat16, 1, 32, [(256, 256)] * 3, [0, 0, 0], "sm90"),
    (torch.bfloat16, 16, 8, [(16 * 64, 64)] * 3, [0, 0, 0], "sm90"),
    (torch.bfloat16, 17, 128, [(17 * 256, 256)] * 3, [0, 0, 0], "sm90"),
    (torch.bfloat16, 128, 128, [(128 * 256, 256)] * 3, [0, 0, 0], "sm90"),
    (torch.bfloat16, 129, 64, [(129 * 64, 64)] * 3, [0, 0, 0], "cuda_core"),
    (torch.bfloat16, 768, 64, [(768 * 64, 64)] * 3, [0, 0, 0], "cuda_core"),
    (torch.bfloat16, 0, 32, [(0, 256)] * 3, [0, 0, 0], "cuda_core"),
    (torch.bfloat16, 64, 136, [(64 * 272, 272)] * 3, [0, 0, 0], "cuda_core"),
    (torch.bfloat16, 64, 12, [(64 * 48, 48)] * 3, [0, 0, 0], "cuda_core"),         # d % 8
    (torch.bfloat16, 64, 20, [(64 * 80, 80)] * 3, [0, 0, 0], "cuda_core"),
    # unaligned views: a base 8 bytes into its rows, rows 8 bytes apart modulo 16
    (torch.bfloat16, 33, 16, [(33 * 72, 72)] * 3, [8, 8, 8], "cuda_core"),
    (torch.bfloat16, 33, 16, [(33 * 64, 64)] * 3, [0, 0, 2], "cuda_core"),
    (torch.bfloat16, 33, 16, [(33 * 68, 68)] * 3, [0, 0, 0], "cuda_core"),
    (torch.bfloat16, 33, 16, [(33 * 64, 64), (33 * 64, 64), (33 * 64 + 4, 64)], [0, 0, 0],
     "cuda_core"),
])
def test_small_mha_route(dtype, s, d, strides, offsets, route):
    assert tatt.small_mha_route(dtype, s, d, strides, offsets) == route


def test_small_mha_route_of_real_tensors():
    """The rule reads what the wrapper hands it: strides in elements and data
    pointers (their value modulo 16 is what counts)."""
    qkv = torch.zeros(4, 80, 768, dtype=torch.bfloat16)
    parts = qkv.chunk(3, dim=-1)

    def route(ts, s=80, d=32):
        return tatt.small_mha_route(ts[0].dtype, s, d, [t.stride()[:2] for t in ts],
                                    [t.data_ptr() - qkv.data_ptr() for t in ts])

    assert route(parts) == "sm90"
    assert route([t.contiguous() for t in parts][:1] * 3) == "sm90"
    wide = torch.zeros(4, 80, 264, dtype=torch.bfloat16)
    assert tatt.small_mha_route(torch.bfloat16, 80, 32, [wide[..., 4:260].stride()[:2]] * 3,
                                [8, 8, 8]) == "cuda_core"
    assert route([t.float() for t in parts]) == "cuda_core"


def test_small_mha_counts_no_route_on_cpu():
    arrs = _to_torch(_bse(7, 2, 33, 64), torch.bfloat16)
    before = (dict(tatt.small_mha.route_counts), dict(tatt.small_mha.variant_counts),
              tatt.small_mha.launch_count)
    tatt.small_mha(*arrs, 4, True)
    assert (tatt.small_mha.route_counts, tatt.small_mha.variant_counts,
            tatt.small_mha.launch_count) == before
    assert set(tatt.small_mha.route_counts) == {"sm90", "cuda_core"}
    assert set(tatt.small_mha.variant_counts) == {"general", "general_vec4", "rows", "rows_vec4"}


# K2's CUDA-core main-path shapes, at small batch: the word LM (causal, d 16),
# AV-HuBERT (d 64), the seq2seq expert's encoder and causal decoder (d 64),
# the FeatureTransformer (d 512)
_CUDA_CORE_SHAPES = [(3, 31, 64, 4, True), (2, 5, 768, 12, False), (2, 5, 256, 4, False),
                     (2, 48, 256, 4, True), (2, 5, 1024, 2, False)]


@pytest.mark.parametrize("b,s,e,h,causal", _CUDA_CORE_SHAPES)
def test_small_mha_at_the_cuda_core_main_path_shapes(b, s, e, h, causal):
    """``small_mha`` on the CPU (the plain path) at the float32 shapes that the
    CUDA-core kernel takes on the main paths: against the JAX Pallas kernel in
    interpret mode at its test tolerance, and against JAX's ``_mha_einsum``
    to float32 summation order."""
    arrs = _bse(8, b, s, e)
    assert tatt.small_mha_viable(h, s, s, e) and jatt.small_mha_viable(h, s, s, e)
    got = tatt.small_mha(*_to_torch(arrs, torch.float32), h, causal).numpy()
    kernel = np.asarray(jatt._small_mha(*_to_jax(arrs, jnp.float32), h, causal, True))
    np.testing.assert_allclose(got, kernel, rtol=5e-4, atol=5e-4)
    einsum = np.asarray(jatt._mha_einsum(*_to_jax(arrs, jnp.float32), h, causal))
    np.testing.assert_allclose(got, einsum, rtol=1e-5, atol=1e-5)


def _qkv_slices(b, s, e, itemsize=4):
    """Strides (elements) and byte offsets of q, k, v as column slices of one
    (b, s, 3e) projection."""
    return [(s * 3 * e, 3 * e)] * 3, [0, e * itemsize, 2 * e * itemsize]


@pytest.mark.parametrize("dtype,s,d,layout,variant", [
    # the main paths' float32 shapes, as the models pass them: 16-byte loads
    (torch.float32, 31, 16, _qkv_slices(100, 31, 64), "rows_vec4"),            # word LM
    (torch.float32, 5, 64, ([(5 * 768, 768)] * 3, [0, 0, 0]), "rows_vec4"),   # AV-HuBERT
    (torch.float32, 5, 64, _qkv_slices(16, 5, 256), "rows_vec4"),              # expert encoder
    (torch.float32, 48, 64, _qkv_slices(16, 48, 256), "rows_vec4"),            # expert decoder
    (torch.float32, 5, 512, _qkv_slices(64, 5, 1024), "rows_vec4"),            # FeatureTransformer
    (torch.float32, 11, 96, _qkv_slices(4, 11, 768), "rows_vec4"),             # audio encoder
    # the rows kernels' bounds: S 1 to 64, d up to 512 in float4s, 128 in elements
    (torch.float32, 1, 16, ([(64, 64)] * 3, [0, 0, 0]), "rows_vec4"),
    (torch.float32, 64, 512, ([(64 * 1024, 1024)] * 3, [0, 0, 0]), "rows_vec4"),
    (torch.float32, 65, 16, ([(65 * 64, 64)] * 3, [0, 0, 0]), "general_vec4"),
    (torch.float32, 80, 32, _qkv_slices(16, 80, 256), "general_vec4"),         # float32 ViViT
    (torch.float32, 5, 516, ([(5 * 1032, 1032)] * 3, [0, 0, 0]), "general_vec4"),
    (torch.float32, 768, 32, ([(768 * 32, 32)] * 3, [0, 0, 0]), "general_vec4"),
    (torch.float32, 0, 16, ([(0, 64)] * 3, [0, 0, 0]), "general_vec4"),
    # element loads: d not a multiple of 4, strides or bases off 16 bytes, bf16
    (torch.float32, 5, 6, ([(5 * 24, 24)] * 3, [0, 0, 0]), "rows"),
    (torch.float32, 48, 64, ([(48 * 260, 260)] * 3, [4, 4, 4]), "rows"),
    (torch.float32, 48, 64, ([(48 * 256, 256)] * 3, [0, 0, 8]), "rows"),
    (torch.float32, 48, 64, ([(48 * 256, 256), (48 * 256, 256), (48 * 256 + 2, 256)],
                             [0, 0, 0]), "rows"),
    (torch.float32, 48, 64, ([(48 * 258, 258)] * 3, [0, 0, 0]), "rows"),
    (torch.float32, 5, 128, ([(5 * 132, 132)] * 3, [4, 4, 4]), "rows"),
    (torch.float32, 5, 132, ([(5 * 528, 528)] * 3, [4, 4, 4]), "general"),
    (torch.bfloat16, 33, 16, ([(33 * 72, 72)] * 3, [8, 8, 8]), "rows"),        # unaligned bf16
    (torch.bfloat16, 64, 18, ([(64 * 72, 72)] * 3, [0, 0, 0]), "rows"),        # d % 8
    (torch.bfloat16, 160, 64, ([(160 * 64, 64)] * 3, [0, 0, 0]), "general"),   # S past 128
])
def test_small_mha_variant(dtype, s, d, layout, variant):
    """The CUDA-core kernel's variant by dtype, S, d, strides (elements) and
    base offsets (bytes)."""
    strides, offsets = layout
    assert tatt.small_mha_variant(dtype, s, d, strides, offsets) == variant
    assert variant in tatt._SMALL_MHA_VARIANTS


def _first_viable(h, s, e):
    """The CUDA-core kernel's first rule, before its variants: the JAX
    package's, and one head's K and V as float, a query and a score row for
    each of 8 warps, in a block's 227 KB of shared memory."""
    d = e // h
    return (jatt.small_mha_viable(h, s, s, e)
            and (s * (2 * d + 1) + 8 * (d + s)) * 4 <= 227 * 1024)


def test_small_mha_cuda_core_takes_every_shape_it_took():
    """Every (heads, S, d) that the CUDA-core kernel took under its first
    shared-memory formula is still viable on that route."""
    checked = 0
    for h in (1, 2, 3, 4, 8, 12, 16):
        for s in (1, 5, 8, 9, 31, 32, 33, 48, 64, 65, 80, 96, 128, 129, 200, 256, 384, 768):
            for d in (1, 6, 16, 32, 64, 96, 128, 132, 256, 424, 512, 600, 1024, 2048, 3000):
                if _first_viable(h, s, h * d):
                    checked += 1
                    assert tatt.small_mha_viable(h, s, s, h * d, route="cuda_core"), (h, s, d)
    assert checked > 500


def test_mha_dispatch_on_cpu():
    """CPU tensors take the plain paths and launch no kernel: ``_mha_einsum``
    up to 128² scores, ``flash_reference`` past it."""
    arrs = _to_torch(_bse(5, 2, 81, 256), torch.float32)
    before = tatt.small_mha.launch_count, tatt.flash_attention.launch_count
    np.testing.assert_array_equal(tatt.mha(*arrs, 8).numpy(),
                                  tatt._mha_einsum(*arrs, 8, False).numpy())
    big = _to_torch(_bse(6, 1, 200, 64), torch.float32)
    heads = [t.reshape(1, 200, 4, 16).transpose(1, 2) for t in big]
    want = tatt.flash_reference(*heads)[0].transpose(1, 2).reshape(1, 200, 64)
    np.testing.assert_array_equal(tatt.mha(*big, 4).numpy(), want.numpy())
    assert (tatt.small_mha.launch_count, tatt.flash_attention.launch_count) == before
    with pytest.raises(ValueError, match="CUDA"):
        tatt._small_mha_launch(*arrs, 8, False)
    with pytest.raises(ValueError, match="CUDA"):
        tatt._flash_launch(*heads, False, 0.25)


@pytest.mark.parametrize("h,s_q,s_k,e,dtype,device,route", [
    (8, 80, 80, 256, torch.bfloat16, "cuda", "small_mha"),   # ViViT: K2
    (8, 11, 11, 768, torch.bfloat16, "cuda", "small_mha"),   # audio encoder: K2
    (8, 80, 80, 256, torch.float32, "cpu", "einsum"),
    (8, 81, 120, 256, torch.bfloat16, "cuda", "einsum"),     # s_q != s_k: K2 does not take it
    (8, 128, 128, 256, torch.bfloat16, "cuda", "einsum"),    # 8·128 > 768
    (4, 33, 33, 64, torch.float16, "cuda", "einsum"),        # K2 takes bf16 and float32
    (2, 64, 64, 64, torch.float32, "cuda", "small_mha"),
    (1, 16384, 16384, 64, torch.bfloat16, "cuda", "flash"),  # U-Net, ds 1: K3
    (1, 1024, 1024, 256, torch.bfloat16, "cpu", "flash"),
])
def test_mha_route_matches_jax_dispatch(h, s_q, s_k, e, dtype, device, route):
    """The route by shape, dtype and device. On CUDA the shapes K2 does not
    take go to ``_mha_einsum``, the JAX package's default small-shape path
    (they used to raise)."""
    assert tatt.mha_route(h, s_q, s_k, e, dtype, torch.device(device)) == route
    if route != "flash":    # JAX: einsum at these shapes, or the opt-in fused kernel
        assert s_q * s_k <= 128 * 128
    if route == "small_mha":
        assert jatt.small_mha_viable(h, s_q, s_k, e)
