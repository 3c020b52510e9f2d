"""Gradients of the port's flash attention (``_Flash`` with the plain
backward ``flash_backward_reference``, which the CPU runs) against
``jax.grad`` of the JAX package's ``flash_attention`` (its Pallas backward
kernels in interpret mode), mirroring tests/test_attention.py's gradient
tests. The kernels K4/K5 are held against the same plain backward on the
card, in tests/test_torch_port_cuda.py.
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


def _inputs(seed, b, h, s_q, s_k, d):
    rng = np.random.default_rng(seed)
    return ([rng.standard_normal(shape).astype(np.float32)
             for shape in ((b, h, s_q, d), (b, h, s_k, d), (b, h, s_k, d))],
            rng.standard_normal((b, h, s_q, d)).astype(np.float32))


def _jax_grads(arrs, w, causal, dtype=jnp.float32, square=False):
    def loss(q, k, v):
        o = jatt.flash_attention(q, k, v, causal=causal, interpret=True).astype(jnp.float32)
        return jnp.sum(o ** 2) if square else jnp.sum(jnp.asarray(w) * o)

    qkv = [jnp.asarray(a).astype(dtype) for a in arrs]
    return [np.asarray(g.astype(jnp.float32)) for g in jax.grad(loss, argnums=(0, 1, 2))(*qkv)]


def _port_grads(arrs, w, causal, dtype=torch.float32, square=False, attn=None):
    qkv = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrs]
    o = (attn or tatt.flash_attention)(*qkv, causal=causal).float()
    (o.pow(2).sum() if square else (torch.from_numpy(w) * o).sum()).backward()
    return [t.grad.float().numpy() for t in qkv]


# (s_q, s_k, causal): non-causal, causal s_q = s_k, causal s_q < s_k, ragged, cross
_CASES = [(256, 256, False), (192, 192, True), (160, 320, True), (200, 200, False),
          (160, 320, False)]


@pytest.mark.parametrize("s_q,s_k,causal", _CASES)
@pytest.mark.parametrize("dtype,tol", [
    ("float32", 5e-4),    # tests/test_attention.py's forward bound: summation order only
    # float32 inside on both sides; each gradient is rounded to bf16 once,
    # so they may differ by one bf16 ulp (≤ 2^-7 of the value)
    ("bfloat16", 1e-2),
])
def test_flash_gradients_match_jax(s_q, s_k, causal, dtype, tol):
    """A random, non-uniform cotangent (the weighted-cotangent case of
    tests/test_attention.py: it exercises Δ = Σ dO·O)."""
    arrs, w = _inputs(0, 1, 2, s_q, s_k, 32)
    want = _jax_grads(arrs, w, causal, getattr(jnp, dtype))
    before = tatt.flash_bwd_dkv.launch_count, tatt.flash_bwd_dq.launch_count
    got = _port_grads(arrs, w, causal, getattr(torch, dtype))
    assert (tatt.flash_bwd_dkv.launch_count, tatt.flash_bwd_dq.launch_count) == before  # CPU
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_flash_gradients_head_dims_match_jax(d):
    """The head dims K4/K5 are compiled for (16 pads to 64); the loss of
    tests/test_attention.py's first gradient test, Σ O²."""
    arrs, w = _inputs(1, 1, 1, 256, 256, d)
    want = _jax_grads(arrs, w, False, square=True)
    got = _port_grads(arrs, w, False, square=True)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, rtol=5e-4, atol=5e-4)


def test_flash_gradients_fully_masked_rows():
    """Causal, q 200, kv 150: the first 50 rows see no key. There JAX's
    backward takes P = exp(s − lse) = 1 for every key (lse absorbed log s_k
    into finfo.min/2), where autograd through ``attention_reference`` gives
    1/s_k; the port follows the latter. With the cotangent only on the rows
    that see keys, the port matches JAX; with a cotangent on every row it
    matches autograd through ``attention_reference`` and JAX is off by more
    than 1 (the known difference, ROADMAP §3)."""
    arrs, w = _inputs(2, 1, 2, 200, 150, 32)
    seen = w.copy()
    seen[:, :, :50] = 0.0
    for g, r in zip(_port_grads(arrs, seen, True), _jax_grads(arrs, seen, True)):
        np.testing.assert_allclose(g, r, rtol=5e-4, atol=5e-4)
    got = _port_grads(arrs, w, True)
    ref = _port_grads(arrs, w, True, attn=tatt.attention_reference)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)
    jax_full = _jax_grads(arrs, w, True)
    assert max(np.abs(j - r).max() for j, r in zip(jax_full, ref)) > 1.0


def test_flash_backward_reference_chunks_change_nothing(monkeypatch):
    """The plain backward walks long inputs in query chunks and sums dK/dV
    over them: the same gradients as one chunk, up to float32 summation
    order."""
    arrs, w = _inputs(3, 1, 1, 300, 280, 32)
    whole = _port_grads(arrs, w, True)
    monkeypatch.setattr(tatt, "_FLASH_REF_CHUNK", 280 * 7)      # 7 query rows a chunk
    chunked = _port_grads(arrs, w, True)
    for a, b in zip(whole, chunked):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_flash_backward_takes_qkv_slices_and_expanded_cotangents():
    """``mha`` on column slices of one fused qkv, with the stride-0
    cotangent of a plain ``sum()``: the gradient of the fused tensor is the
    einsum path's."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 200, 96))
                         .astype(np.float32)).requires_grad_()
    tatt.mha(*x.chunk(3, dim=-1), 2).sum().backward()
    ref = x.detach().clone().requires_grad_()
    tatt._mha_einsum(*ref.chunk(3, dim=-1), 2, False).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), ref.grad.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("route", ["cuda_core", "sm90"])
def test_flash_backward_smem_fits_a_block(route):
    from lipreading_video_generation_tpu_torch.ops import _build

    for d in (16, 64, 128, 192, 256):
        for kernel in ("dkv", "dq"):
            assert tatt.flash_bwd_smem_bytes(d, kernel, route) <= _build.SMEM_PER_BLOCK
    if route == "cuda_core":
        assert tatt.flash_bwd_block_q(192) == 32 and tatt.flash_bwd_block_q(128) == 64
        # float tiles: Q, dO (32 rows), K, V (64 rows) of 260 floats, P, dS, lse, Δ
        assert tatt.flash_bwd_smem_bytes(256, "dkv") == 217344
    else:
        assert [tatt.flash_bwd_block_q(d, route, "dkv") for d in (64, 128, 192)] == [128, 64, 64]
        assert [tatt.flash_bwd_block_q(d, route, "dq") for d in (64, 128, 192)] == [128, 128, 64]
        # bf16 tiles: half the bytes of the float ones at equal rows, so head
        # dim 256 keeps 64-row tiles in two stages
        assert tatt.flash_bwd_smem_bytes(256, "dkv", route) == 2 * 32768 + 2 * 66560 + 1024
        assert tatt.flash_bwd_smem_bytes(64, "dq", route) == 2 * 16384 + 4 * 16384 + 1024
        for d in (128, 256):
            for kernel in ("dkv", "dq"):
                assert (tatt.flash_bwd_smem_bytes(d, kernel, route)
                        < tatt.flash_bwd_smem_bytes(d, kernel, "cuda_core"))


def _bf16_backward_inputs(seed, s_q, s_k, causal, d=32):
    """bf16 q, k, v, dO and the plain forward's O, lse and Δ on them."""
    arrs, w = _inputs(seed, 1, 2, s_q, s_k, d)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    do = torch.from_numpy(w).to(torch.bfloat16)
    o, lse = tatt.flash_reference(q, k, v, causal)
    return arrs, w, (q, k, v, do, lse, (do.float() * o.float()).sum(-1), causal)


# (s_q, s_k, causal): non-causal, causal s_q < s_k, ragged, rows that see no key
_P_DTYPE_CASES = [(256, 256, False), (160, 320, True), (200, 200, False), (200, 150, True)]


@pytest.mark.parametrize("s_q,s_k,causal", _P_DTYPE_CASES)
def test_flash_backward_reference_bf16_p_stays_close(s_q, s_k, causal):
    """``p_dtype=torch.bfloat16`` rounds P and dS where the tensor-core
    kernels round them. Each rounding is 2^-9 relative and the gradients
    are sums of many such terms plus one bf16 rounding at the store: within
    1e-2 of the largest |gradient| of the float32-P version, and within
    1e-2 of the largest |gradient| of the JAX package's Pallas backward
    (interpret mode) on the same bf16 inputs. In the case with rows that
    see no key JAX is compared on a cotangent that is zero on those rows
    (where the two are known to differ)."""
    blind = causal and s_q > s_k
    arrs, w, args = _bf16_backward_inputs(5, s_q, s_k, causal)
    got = tatt.flash_backward_reference(*args, p_dtype=torch.bfloat16)
    want = tatt.flash_backward_reference(*args)
    for g, r in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape
        assert not torch.equal(g, r)                      # the rounding is really there
        assert (g.float() - r.float()).abs().max() <= 1e-2 * r.float().abs().max()
    if blind:
        w = w.copy()
        w[:, :, :s_q - s_k] = 0.0
        q, k, v, _, lse, _, _ = args
        do = torch.from_numpy(w).to(torch.bfloat16)
        o, _ = tatt.flash_reference(q, k, v, causal)
        got = tatt.flash_backward_reference(q, k, v, do, lse, (do.float() * o.float()).sum(-1),
                                            causal, p_dtype=torch.bfloat16)
    jax_grads = _jax_grads(arrs, np.asarray(torch.from_numpy(w).to(torch.bfloat16).float()),
                           causal, jnp.bfloat16)
    for g, r in zip(got, jax_grads):
        assert np.abs(g.float().numpy() - r).max() <= 1e-2 * np.abs(r).max()


@pytest.mark.parametrize("s_q,s_k,causal", _P_DTYPE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_reference_default_p_is_float32(s_q, s_k, causal, dtype):
    """``p_dtype=None`` is the float32-P backward: the same bits as a call
    without the argument and as rounding P and dS to float32, which they
    already are."""
    _, _, args = _bf16_backward_inputs(6, s_q, s_k, causal)
    args = tuple(a.to(dtype) if torch.is_tensor(a) and a.dtype == torch.bfloat16 else a
                 for a in args)
    base = tatt.flash_backward_reference(*args)
    for other in (tatt.flash_backward_reference(*args, p_dtype=None),
                  tatt.flash_backward_reference(*args, p_dtype=torch.float32)):
        for g, r in zip(other, base):
            assert g.dtype == dtype and torch.equal(g, r)


def _bhsd_from_fused(d, heads=1, s=24, b=2, dtype=torch.bfloat16):
    """q, k, v as the U-Net makes them: (B, H, S, D) views of column slices
    of one fused (B, S, 3·H·D) projection."""
    qkv = torch.zeros(b, s, 3 * heads * d, dtype=dtype)
    return [t.reshape(b, s, heads, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1)]


def _route_of(tensors):
    size = tensors[0].element_size()
    return tatt.flash_bwd_route(tensors[0].dtype, tensors[0].shape[-1],
                                [t.stride()[:3] for t in tensors],
                                [t.storage_offset() * size for t in tensors])


@pytest.mark.parametrize("d", [16, 40, 64, 128, 192, 256])
@pytest.mark.parametrize("heads", [1, 2])
def test_flash_bwd_route_takes_fused_qkv_slices_to_sm90(d, heads):
    """Every head dim the U-Net, SR U-Net and classifier use: slices of a
    fused bf16 qkv start at multiples of 2·d bytes with row stride 3·H·d,
    and the (B, S, H, D) gradients are contiguous: all 16-byte aligned."""
    q, k, v = _bhsd_from_fused(d, heads)
    grads = [torch.empty(2, 24, heads, d, dtype=torch.bfloat16).transpose(1, 2) for _ in range(2)]
    assert _route_of([q, k, v, q] + grads) == "sm90"
    assert _route_of([t.contiguous() for t in (q, k, v, q)]) == "sm90"


@pytest.mark.parametrize("case", ["float32", "float32_fused", "odd_head_dim", "offset_view",
                                  "odd_row_stride", "odd_address", "float16"])
def test_flash_bwd_route_keeps_cuda_cores_for_the_rest(case):
    """float32 (tensor cores would mean TF32) and every bf16 layout a 16-byte
    copy cannot read stay on the CUDA-core kernels."""
    if case == "float32":
        tensors = [torch.zeros(1, 2, 24, 64)] * 4
    elif case == "float32_fused":
        tensors = _bhsd_from_fused(64, dtype=torch.float32)
    elif case == "odd_head_dim":                       # d = 20: rows of 40 bytes
        tensors = [torch.zeros(1, 2, 24, 20, dtype=torch.bfloat16)] * 4
    elif case == "offset_view":                        # columns 4..67 of 72: base off by 8 bytes
        tensors = [torch.zeros(1, 2, 24, 72, dtype=torch.bfloat16)[..., 4:68]] * 4
    elif case == "odd_row_stride":                     # 64 of 68 columns: rows of 136 bytes
        tensors = [torch.zeros(1, 2, 24, 68, dtype=torch.bfloat16)[..., :64]] * 4
    elif case == "odd_address":
        assert tatt.flash_bwd_route(torch.bfloat16, 64, [(3072, 1536, 64)] * 4,
                                    [0, 0, 8, 0]) == "cuda_core"
        assert tatt.flash_bwd_route(torch.bfloat16, 64, [(3072, 1536, 64)] * 4,
                                    [0, 32, 4096, 16]) == "sm90"
        return
    else:
        assert tatt.flash_bwd_route(torch.float16, 64, [(3072, 1536, 64)], [0]) == "cuda_core"
        return
    assert tensors[0].stride(-1) == 1
    assert _route_of(tensors) == "cuda_core"


def _variant_of(tensors):
    size = tensors[0].element_size()
    return tatt.flash_bwd_variant(tensors[0].dtype, tensors[0].shape[-1],
                                  [t.stride()[:3] for t in tensors],
                                  [t.storage_offset() * size for t in tensors])


def _with_grads(q, k, v):
    """q, k, v, dO (q's layout) and the kernels' outputs, (B, H, S, D) views
    of contiguous (B, S, H, D) tensors: every tensor a launch passes."""
    def grad_like(x):
        return torch.empty(x.shape[0], x.shape[2], x.shape[1], x.shape[3],
                           dtype=x.dtype).transpose(1, 2)
    return [q, k, v, q, grad_like(k), grad_like(v), grad_like(q)]


def _variant_case(layout, d):
    """The tensors of one launch for ``test_flash_bwd_variant``."""
    if layout == "fused":                      # the U-Net's column slices of one qkv
        return _with_grads(*_bhsd_from_fused(d, dtype=torch.float32))
    if layout == "bf16":
        return _with_grads(*[torch.zeros(1, 2, 24, d, dtype=torch.bfloat16)] * 3)
    if layout == "off4":                       # columns 1..d of rows of d + 4: 4 bytes in
        return _with_grads(*[torch.zeros(1, 2, 24, d + 4)[..., 1:1 + d]] * 3)
    if layout == "row_stride":                 # d of d + 2 columns: rows of 4 (d + 2) bytes
        return _with_grads(*[torch.zeros(1, 2, 24, d + 2)[..., :d]] * 3)
    return _with_grads(*[torch.zeros(1, 2, 24, d)] * 3)


@pytest.mark.parametrize("layout,d,want", [
    *[("contiguous", d, "tiled") for d in (32, 64, 100, 128, 192, 256)],
    *[("fused", d, "tiled") for d in (64, 128, 256)],
    ("contiguous", 6, "general"),              # d % 4 != 0
    ("contiguous", 320, "general"),            # past 256: the sliced kernels
    ("bf16", 64, "general"),
    ("off4", 64, "general"),
    ("row_stride", 64, "general"),
])
def test_flash_bwd_variant(layout, d, want):
    """The "tiled" kernels of csrc/flash_bwd.cu take float32 with d a
    multiple of 4 up to 256, 16-byte rows and bases: every float32 U-Net
    head dim, contiguous or as slices of its fused qkv; the rest keeps the
    "general" ones."""
    tensors = _variant_case(layout, d)
    assert tensors[0].stride(-1) == 1
    assert _variant_of(tensors) == want
    if want == "tiled":       # the same tensors on the CUDA-core route
        assert _route_of(tensors) == "cuda_core"


def test_flash_bwd_variant_reads_every_offset():
    """One tensor of the seven off 16 bytes (a gradient, say) is enough to
    keep the general kernels."""
    strides = [(3 * 24 * 64, 64, 3 * 64)] * 4 + [(24 * 64, 64, 64)] * 3
    assert tatt.flash_bwd_variant(torch.float32, 64, strides, [0, 256, 512, 0, 0, 0, 0]) == "tiled"
    assert tatt.flash_bwd_variant(torch.float32, 64, strides, [0, 256, 512, 0, 0, 0, 8]) == "general"


def test_flash_bwd_tiled_smem_fits_a_block_and_two_share_an_sm():
    """The tiled kernels' shared memory fits a block at every head dim they
    take, and two blocks (each with the 1 KB the card reserves a block) share
    an SM's 228 KB at head dims 64 and 128; the "general" default still
    describes the general kernels."""
    from lipreading_video_generation_tpu_torch.ops import _build

    for d in (32, 64, 100, 128, 192, 256):
        for kernel in ("dkv", "dq"):
            assert tatt.flash_bwd_smem_bytes(d, kernel, variant="tiled") <= _build.SMEM_PER_BLOCK
    for d in (64, 128):
        for kernel in ("dkv", "dq"):
            assert 2 * (tatt.flash_bwd_smem_bytes(d, kernel, variant="tiled") + 1024) <= 228 * 1024
    # K4: K^T, V^T of 32 keys (rows of 36 floats), two stages of Q and dO (64
    # rows of 68), P and dS; K5: Q and dO of 32 rows, two stages of K and V
    # (64 rows of 68), dS^T (64 rows of 36)
    assert tatt.flash_bwd_smem_bytes(64, "dkv", variant="tiled") == 106496
    assert tatt.flash_bwd_smem_bytes(64, "dq", variant="tiled") == 96256
    assert [tatt.flash_bwd_block_q(d, kernel="dkv", variant="tiled") for d in (64, 128, 256)] == [
        64, 32, 32]
    assert [tatt.flash_bwd_block_q(d, kernel="dq", variant="tiled") for d in (64, 128, 256)] == [
        32, 32, 32]
    for d in (64, 256, 512):
        for kernel in ("dkv", "dq"):
            assert tatt.flash_bwd_smem_bytes(d, kernel) == tatt.flash_bwd_smem_bytes(
                d, kernel, "cuda_core", "general")
    with pytest.raises(ValueError):
        tatt.flash_bwd_smem_bytes(320, "dkv", variant="tiled")


def test_flash_gradients_on_the_cpu_count_no_route_or_variant():
    """CPU tensors run the plain backward: no launch, route or variant of K4
    or K5 is counted."""
    fns = (tatt.flash_bwd_dkv, tatt.flash_bwd_dq)

    def counts():
        return [(fn.launch_count, dict(fn.route_counts), dict(fn.variant_counts)) for fn in fns]

    before = counts()
    arrs, w = _inputs(7, 1, 2, 200, 200, 64)
    for g in _port_grads(arrs, w, True):
        assert np.isfinite(g).all()
    assert counts() == before
    assert all(set(fn.variant_counts) == {"general", "tiled"} for fn in fns)
