"""The port's flash attention (its plain version, which the CPU runs)
against the JAX package's flash kernel in Pallas interpret mode, as
tests/test_attention.py runs it.

O is held against ``flash_attention``; the per-row logsumexp against the
``lse`` that ``_flash_forward`` returns, over the unpadded rows. The
kernel K3 itself is held against the same plain version on the card, in
tests/test_torch_port_cuda.py.
"""
import math

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


def _qkv(seed, b, h, s_q, s_k, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s_q, d)).astype(np.float32),
            rng.standard_normal((b, h, s_k, d)).astype(np.float32),
            rng.standard_normal((b, h, s_k, d)).astype(np.float32))


def _jax_flash(arrs, causal, dtype):
    q, k, v = (jnp.asarray(a).astype(dtype) for a in arrs)
    out = jatt.flash_attention(q, k, v, causal=causal, interpret=True)
    s_q, s_k = q.shape[2], k.shape[2]
    # the block sizes flash_attention picks below 4096 tokens
    _, lse = jatt._flash_forward(q, k, v, causal, 1.0 / math.sqrt(q.shape[-1]), 128, 128, True)
    return np.asarray(out.astype(jnp.float32)), np.asarray(lse)[:, :, :s_q]


# (s_q, s_k, causal): non-causal, causal s_q = s_k, causal s_q < s_k, ragged, cross
_CASES = [(256, 256, False), (192, 192, True), (160, 320, True), (200, 200, False),
          (160, 320, False)]


@pytest.mark.parametrize("s_q,s_k,causal", _CASES)
@pytest.mark.parametrize("dtype,tol", [
    ("float32", 5e-4),    # tests/test_attention.py's bound: summation order only
    ("bfloat16", 1e-2),   # float32 inside on both sides; O may round to the next bf16 (2^-7 at 1)
])
def test_flash_matches_jax(s_q, s_k, causal, dtype, tol):
    arrs = _qkv(0, 2, 2, s_q, s_k, 32)
    want_o, want_lse = _jax_flash(arrs, causal, getattr(jnp, dtype))
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs)
    got_o, got_lse = tatt.flash_attention(q, k, v, causal=causal, return_lse=True)
    assert got_o.dtype == q.dtype and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.float().numpy(), want_o, rtol=tol, atol=tol)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_flash_head_dims_match_jax(d):
    """The head dims K3 is compiled for (16 pads to 64)."""
    arrs = _qkv(1, 1, 2, 256, 256, d)
    want_o, want_lse = _jax_flash(arrs, False, jnp.float32)
    got_o, got_lse = tatt.flash_attention(*map(torch.from_numpy, arrs), return_lse=True)
    np.testing.assert_allclose(got_o.numpy(), want_o, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=1e-5, atol=1e-4)


def test_flash_fully_masked_rows_follow_attention_reference():
    """Causal with s_q > s_k: the first s_q − s_k rows see no key. JAX's
    kernel averages V over its padded key length there (it depends on the
    TPU block size); the port, like ``attention_reference``, over the s_k
    real keys. Those rows are held against ``attention_reference``, the
    others against JAX's kernel."""
    arrs = _qkv(2, 1, 2, 200, 150, 32)
    want_o, want_lse = _jax_flash(arrs, True, jnp.float32)
    ref = np.asarray(jatt.attention_reference(*map(jnp.asarray, arrs), causal=True))
    got_o, got_lse = tatt.flash_attention(*map(torch.from_numpy, arrs), causal=True,
                                          return_lse=True)
    got_o, got_lse = got_o.numpy(), got_lse.numpy()
    np.testing.assert_allclose(got_o, ref, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(got_o[:, :, 50:], want_o[:, :, 50:], rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(got_lse[:, :, 50:], want_lse[:, :, 50:], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got_o[:, :, :50], np.broadcast_to(
        arrs[2].mean(axis=2, keepdims=True), got_o[:, :, :50].shape), rtol=1e-5, atol=1e-5)
    assert np.abs(want_o[:, :, :50] - got_o[:, :, :50]).max() > 1e-2   # the known difference


def test_flash_reference_chunks_change_nothing(monkeypatch):
    arrs = [torch.from_numpy(a) for a in _qkv(3, 1, 1, 300, 280, 32)]
    whole = tatt.flash_reference(*arrs, causal=True)
    monkeypatch.setattr(tatt, "_FLASH_REF_CHUNK", 280 * 7)      # 7 query rows a chunk
    chunked = tatt.flash_reference(*arrs, causal=True)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_flash_small_shapes_are_attention_reference():
    arrs = _qkv(4, 1, 2, 100, 100, 32)
    got = tatt.flash_attention(*map(torch.from_numpy, arrs), causal=True).numpy()
    want = np.asarray(jatt.flash_attention(*map(jnp.asarray, arrs), causal=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="no lse"):
        tatt.flash_attention(*map(torch.from_numpy, arrs), return_lse=True)


def test_mha_routes_to_flash_above_128_squared():
    """``mha`` over (B, S, E) past 128² scores goes to the flash path, as
    JAX's ``mha`` does, and matches it; below, to the einsum."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 200, 64)).astype(np.float32) for _ in range(3))
    before = tatt.flash_attention.launch_count
    for causal in (False, True):
        want = np.asarray(jatt.mha(*map(jnp.asarray, (q, k, v)), 4, causal=causal))
        got = tatt.mha(*map(torch.from_numpy, (q, k, v)), 4, causal=causal).numpy()
        np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)
    assert tatt.flash_attention.launch_count == before      # CPU: no kernel launch
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tatt.mha_route(4, 200, 200, 64, torch.float32, cpu) == "flash"
    assert tatt.mha_route(1, 16384, 16384, 64, torch.bfloat16, cuda) == "flash"
    assert tatt.mha_route(4, 128, 128, 64, torch.float32, cpu) == "einsum"
    assert tatt.mha_route(4, 129, 127, 64, torch.float32, cpu) == "einsum"


@pytest.mark.parametrize("route", ["cuda_core", "sm90"])
def test_flash_smem_fits_a_block(route):
    from lipreading_video_generation_tpu_torch.ops import _build

    for d in (16, 64, 128, 192, 256):
        assert tatt.flash_smem_bytes(d, route) <= _build.SMEM_PER_BLOCK
    if route == "cuda_core":
        assert tatt.flash_smem_bytes(64) == tatt.flash_smem_bytes(64, route) == 69632
        # head dims above 256: the float tiles of 256 hold one slice of d at
        # a time, so that they fit a block
        assert tatt.flash_head_dim_pad(320) == tatt.flash_head_dim_pad(512) == 512
        assert tatt.flash_smem_bytes(320, route) == 223232 <= _build.SMEM_PER_BLOCK
        for kernel, want in (("dkv", 217344), ("dq", 208384)):
            assert tatt.flash_bwd_smem_bytes(512, kernel, route) == want <= _build.SMEM_PER_BLOCK
        assert tatt.flash_bwd_block_q(320) == 32
    else:
        # bf16 tiles: Q of 128 queries (64 at head dim 256), two stages each of
        # K and V of 64 keys (128 at head dim 128); two blocks of head dim 64 fit an SM
        assert tatt.flash_smem_bytes(64, route) == 16384 + 4 * 8192 + 1024
        assert 2 * tatt.flash_smem_bytes(64, route) <= _build.SMEM_PER_BLOCK
        assert tatt.flash_smem_bytes(128, route) == 32768 + 4 * 32768 + 1024
        assert tatt.flash_smem_bytes(256, route) == 32768 + 4 * 32768 + 1024
        with pytest.raises(ValueError, match="tensor-core"):
            tatt.flash_smem_bytes(320, route)
        with pytest.raises(ValueError, match="tensor-core"):
            tatt.flash_bwd_block_q(320, route)
    # the CUDA-core kernels walk d in slices of 256: no head dim raises
    assert tatt.flash_head_dim_pad(513) == 768
    with pytest.raises(ValueError, match="head dim"):
        tatt.flash_head_dim_pad(0)


@pytest.mark.parametrize("d,pad", [(320, 512), (512, 512), (640, 768), (1024, 1024),
                                   (1000, 1024), (2048, 2048)])
def test_flash_head_dims_above_256_take_the_sliced_cuda_core_kernels(d, pad):
    """d > 256: the CUDA-core K3, K4 and K5 with the tiles of head dim 256
    (one slice of d at a time), so their shared memory does not grow with d;
    aligned bf16 still takes the CUDA-core route (the tensor-core kernels
    stop at 256)."""
    from lipreading_video_generation_tpu_torch.ops import _build

    assert tatt.flash_head_dim_pad(d) == pad
    assert tatt.flash_smem_bytes(d) == tatt.flash_smem_bytes(256) == 223232 <= _build.SMEM_PER_BLOCK
    assert tatt.flash_bwd_block_q(d) == tatt.flash_bwd_block_q(256) == 32
    for kernel, want in (("dkv", 217344), ("dq", 208384)):
        assert tatt.flash_bwd_smem_bytes(d, kernel) == want <= _build.SMEM_PER_BLOCK
    assert _forward_route(*_fused_qkv(d)) == "cuda_core"
    with pytest.raises(ValueError, match="tensor-core"):
        tatt.flash_smem_bytes(d, "sm90")


def _bf16(arrs):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]


@pytest.mark.parametrize("s_q,s_k,causal", _CASES)
def test_flash_reference_bf16_p_matches_jax(s_q, s_k, causal):
    """``p_dtype=torch.bfloat16`` rounds P where the tensor-core kernel
    rounds it. One rounding is 2^-9 relative a term and averages out over a
    row, and O is rounded to bf16 once (2^-8 of the value): within 1e-2 of
    the JAX package's kernel (interpret mode) on the same bf16 inputs, as
    the float32-P version is. lse is untouched by the rounding."""
    arrs = _qkv(6, 2, 2, s_q, s_k, 32)
    want_o, want_lse = _jax_flash(arrs, causal, jnp.bfloat16)
    got_o, got_lse = tatt.flash_reference(*_bf16(arrs), causal, p_dtype=torch.bfloat16)
    assert got_o.dtype == torch.bfloat16 and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.float().numpy(), want_o, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("s_q,s_k,causal", _CASES + [(200, 150, True)])
def test_flash_reference_bf16_p_stays_close_to_float32_p(s_q, s_k, causal):
    """Against the float32-P default on the same inputs: O within 1e-2 (and
    really different, so the rounding is there), lse equal bit for bit (the
    row sum is taken from the float32 P)."""
    q, k, v = _bf16(_qkv(7, 1, 2, s_q, s_k, 32))
    want_o, want_lse = tatt.flash_reference(q, k, v, causal)
    got_o, got_lse = tatt.flash_reference(q, k, v, causal, p_dtype=torch.bfloat16)
    assert torch.equal(got_lse, want_lse)
    assert not torch.equal(got_o, want_o)
    torch.testing.assert_close(got_o.float(), want_o.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_q,s_k,causal", [(256, 256, False), (160, 320, True), (200, 150, True)])
def test_flash_reference_default_p_is_float32(s_q, s_k, causal, dtype):
    """``p_dtype=None`` is the float32-P forward it was before the argument
    came: the same bits as rounding P to float32, which it already is, and
    as the formula written out here."""
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(8, 1, 2, s_q, s_k, 32))
    base_o, base_lse = tatt.flash_reference(q, k, v, causal)
    for o, lse in (tatt.flash_reference(q, k, v, causal, p_dtype=None),
                   tatt.flash_reference(q, k, v, causal, p_dtype=torch.float32)):
        assert o.dtype == dtype and torch.equal(o, base_o) and torch.equal(lse, base_lse)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * (1.0 / math.sqrt(32)), k.float())
    if causal:
        hidden = torch.arange(s_k)[None, :] > torch.arange(s_q)[:, None] + (s_k - s_q)
        s = s.masked_fill(hidden, float(torch.finfo(torch.float32).min) / 2)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    assert torch.equal(base_o, (torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / denom).to(dtype))
    assert torch.equal(base_lse, (m + torch.log(denom))[..., 0])


def _forward_route(q, k, v):
    """The route ``_flash_launch`` would take: q, k, v and the (B, S, H, D)
    output it allocates."""
    b, h, s_q, d = q.shape
    out = torch.empty(b, s_q, h, d, dtype=q.dtype).transpose(1, 2)
    tensors = (q, k, v, out)
    size = q.element_size()
    return tatt.flash_route(q.dtype, d, [t.stride()[:3] for t in tensors],
                            [t.storage_offset() * size for t in tensors])


def _fused_qkv(d, heads=1, s=24, b=2, dtype=torch.bfloat16):
    qkv = torch.zeros(b, s, 3 * heads * d, dtype=dtype)
    return [t.reshape(b, s, heads, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1)]


@pytest.mark.parametrize("case,want", [
    ("fused_bf16_d64", "sm90"), ("fused_bf16_d128", "sm90"), ("fused_bf16_d256", "sm90"),
    ("fused_bf16_d192_2heads", "sm90"), ("contiguous_bf16", "sm90"),
    ("float32", "cuda_core"), ("offset_view", "cuda_core"), ("odd_row_stride", "cuda_core"),
    ("head_dim_20", "cuda_core"), ("head_dim_320", "cuda_core"), ("float16", "cuda_core")])
def test_flash_route_of_the_forward(case, want):
    """One rule for K3, K4 and K5 (``flash_bwd_route`` is its older name):
    the U-Net's column slices of one bf16 qkv are aligned and take the
    tensor-core kernel; float32, a view that starts 8 bytes into its rows,
    rows of 136 bytes, head dims that are no multiple of 8 or above 256
    keep the CUDA-core kernel."""
    assert tatt.flash_bwd_route is tatt.flash_route
    if case.startswith("fused"):
        d = int(case.split("_d")[1].split("_")[0])
        tensors = _fused_qkv(d, heads=2 if case.endswith("2heads") else 1)
    elif case == "contiguous_bf16":
        tensors = [torch.zeros(1, 2, 24, 64, dtype=torch.bfloat16)] * 3
    elif case == "float32":
        tensors = _fused_qkv(64, dtype=torch.float32)
    elif case == "offset_view":
        tensors = [torch.zeros(1, 2, 24, 72, dtype=torch.bfloat16)[..., 4:68]] * 3
    elif case == "odd_row_stride":
        tensors = [torch.zeros(1, 2, 24, 68, dtype=torch.bfloat16)[..., :64]] * 3
    elif case == "head_dim_20":
        tensors = [torch.zeros(1, 2, 24, 20, dtype=torch.bfloat16)] * 3
    elif case == "head_dim_320":
        tensors = _fused_qkv(320)
    else:
        tensors = [torch.zeros(1, 2, 24, 64, dtype=torch.float16)] * 3
    assert all(t.stride(-1) == 1 for t in tensors)
    assert _forward_route(*tensors) == want
    assert set(tatt.flash_attention.route_counts) == {"sm90", "cuda_core"}


def test_flash_head_dim_320_matches_jax():
    """Head dims above 256 (the CUDA-core kernels take them up to 512; the
    JAX package pads 320 to 384): the CPU path at d = 320, forward, lse and
    gradients, against the JAX package's kernels in interpret mode."""
    arrs = _qkv(9, 1, 1, 256, 256, 320)
    w = np.random.default_rng(10).standard_normal((1, 1, 256, 320)).astype(np.float32)
    want_o, want_lse = _jax_flash(arrs, False, jnp.float32)
    qkv = [torch.from_numpy(a).requires_grad_() for a in arrs]
    got_o, got_lse = tatt.flash_attention(*qkv, return_lse=True)
    np.testing.assert_allclose(got_o.detach().numpy(), want_o, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=1e-5, atol=1e-4)
    (torch.from_numpy(w) * got_o).sum().backward()

    def loss(q, k, v):
        return jnp.sum(jnp.asarray(w) * jatt.flash_attention(q, k, v, interpret=True))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    for t, r in zip(qkv, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=5e-4, atol=5e-4)


def test_flash_head_dim_640_matches_jax():
    """Head dim 640 (the card walks it in slices of 256; the JAX package
    pads it to 768): forward, lse and gradients of ``_Flash`` on the CPU
    against the JAX package's flash kernels in interpret mode, at 128 x 128
    scores (``flash_attention`` would take ``attention_reference`` there, so
    both sides call their custom VJP directly)."""
    arrs = _qkv(11, 1, 1, 128, 128, 640)
    w = np.random.default_rng(12).standard_normal((1, 1, 128, 640)).astype(np.float32)
    scale = 1.0 / math.sqrt(640)
    want_o, want_lse = jatt._flash_forward(*map(jnp.asarray, arrs), False, scale, 128, 128, True)
    qkv = [torch.from_numpy(a).requires_grad_() for a in arrs]
    got_o, got_lse = tatt._Flash.apply(*qkv, False, scale)
    np.testing.assert_allclose(got_o.detach().numpy(), np.asarray(want_o), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[:, :, :128], rtol=1e-5,
                               atol=1e-4)
    (torch.from_numpy(w) * got_o).sum().backward()

    def loss(q, k, v):
        return jnp.sum(jnp.asarray(w) * jatt._flash(q, k, v, False, scale, 128, 128, True))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    for t, r in zip(qkv, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=5e-4, atol=5e-4)


# --- K3's float32 "tiled" kernel: its variant rule, tiles, key splits ------

def _fwd_variant_case(layout, d):
    """q, k, v and the (B, S, H, D) output ``_flash_launch`` allocates, for
    ``test_flash_fwd_variant``."""
    if layout == "fused":                      # the U-Net's column slices of one qkv
        q, k, v = _fused_qkv(d, dtype=torch.float32)
    elif layout == "off4":                     # columns 1..d of rows of d + 4: 4 bytes in
        q = k = v = torch.zeros(1, 2, 24, d + 4)[..., 1:1 + d]
    elif layout == "bf16":
        q = k = v = torch.zeros(1, 2, 24, d, dtype=torch.bfloat16)
    else:
        q = k = v = torch.zeros(1, 2, 24, d)
    out = torch.empty(q.shape[0], q.shape[2], q.shape[1], d, dtype=q.dtype).transpose(1, 2)
    return q, k, v, out


def _fwd_variant_of(tensors, offsets=None):
    size = tensors[0].element_size()
    return tatt.flash_fwd_variant(tensors[0].dtype, tensors[0].shape[-1],
                                  [t.stride()[:3] for t in tensors],
                                  offsets or [t.storage_offset() * size for t in tensors])


@pytest.mark.parametrize("layout,d,want", [
    *[("contiguous", d, "tiled") for d in (32, 64, 100, 128, 192, 256)],
    *[("fused", d, "tiled") for d in (64, 128, 256)],
    ("off4", 64, "general"),                   # a float32 view 4 bytes into its rows
    ("bf16", 64, "general"),                   # the CUDA-core route's bf16 views
    ("contiguous", 30, "general"),             # d % 4 != 0
    ("contiguous", 320, "general"),            # past 256: the sliced kernel
])
def test_flash_fwd_variant(layout, d, want):
    """The "tiled" kernel of csrc/flash_fwd.cu takes float32 with d a
    multiple of 4 up to 256, 16-byte rows and bases: every float32 U-Net
    head dim, contiguous or as slices of its fused qkv; the rest keeps the
    "general" one. The rule is the backward's."""
    tensors = _fwd_variant_case(layout, d)
    assert all(t.stride(-1) == 1 for t in tensors)
    assert _fwd_variant_of(tensors) == want
    assert tatt.flash_bwd_variant(tensors[0].dtype, d, [t.stride()[:3] for t in tensors],
                                  [t.storage_offset() * t.element_size() for t in tensors]) == want
    if want == "tiled":       # the same tensors on the CUDA-core route
        assert _forward_route(*tensors[:3]) == "cuda_core"


def test_flash_fwd_variant_reads_every_offset():
    """An output off 16 bytes alone (the rest aligned) keeps the general
    kernel: the rule reads all four tensors."""
    tensors = _fwd_variant_case("fused", 64)
    assert _fwd_variant_of(tensors, [0, 256, 512, 0]) == "tiled"
    assert _fwd_variant_of(tensors, [0, 256, 512, 8]) == "general"
    assert _fwd_variant_of(tensors, [0, 256, 516, 0]) == "general"
    assert set(tatt.flash_attention.variant_counts) == set(tatt._FLASH_FWD_VARIANTS) == {
        "general", "tiled"}


@pytest.mark.parametrize("d,want", [(64, 104448), (128, 110080), (256, 102144)])
def test_flash_fwd_tiled_smem_fits_a_block_and_two_share_an_sm(d, want):
    """The tiled kernel's shared memory (Q of 64 rows, 32 at head dim 256, two
    stages of K and V of 64, 32 or 16 keys, Pᵀ; rows padded by 4 floats) fits a block, and two
    blocks (each with the 1 KB the card reserves a block) share an SM's
    228 KB at every head dim it takes; the "general" default still describes
    the general kernel."""
    from lipreading_video_generation_tpu_torch.ops import _build

    got = tatt.flash_smem_bytes(d, "cuda_core", "tiled")
    assert got == want <= _build.SMEM_PER_BLOCK
    assert 2 * (got + 1024) <= 228 * 1024
    assert tatt.flash_smem_bytes(d) == tatt.flash_smem_bytes(d, "cuda_core", "general")
    with pytest.raises(ValueError, match="tiled"):
        tatt.flash_smem_bytes(320, "cuda_core", "tiled")


@pytest.mark.parametrize("bh,s_q,s_k,d,want", [
    (2, 16384, 16384, 64, 1),      # 512 row blocks of 64: the card is full
    (4, 4096, 4096, 128, 1),       # the bf16 U-Net's shape in float32: 256
    (67584, 132, 132, 16, 1),
    (2, 4096, 4096, 64, 2),        # 128 row blocks, 4 short of the card: two runs of 32 tiles
    (2, 1024, 1024, 128, 8),       # 32 row blocks: 8 runs of 4 of the 32 key tiles
    (2, 256, 256, 256, 8),         # 16 row blocks of 32: 8 runs of two 16-key tiles
    (2, 300, 300, 192, 7),         # 20 row blocks, 19 tiles: 6 runs of 3, then one
    (2, 200, 150, 64, 1),          # 3 key tiles: too few for two runs of two
    (1, 40, 4096, 64, 32),         # 1 row block, 64 key tiles
])
def test_flash_fwd_splits(bh, s_q, s_k, d, want):
    """1 where the row blocks fill the card (one an SM of 132); above 1 at
    the float32 U-Net's (2,1,1024,128) and (2,1,256,256); never more than
    the grid of one wave (two blocks an SM) holds, nor than half the key
    tiles; every split holds keys, all but the last as many."""
    n = tatt.flash_fwd_splits(bh, s_q, s_k, d)
    assert n == want
    bq, bk = tatt._flash_fwd_tiled_tiles(d)
    dp = tatt.flash_head_dim_pad(d)
    assert (bq, bk) == ((32 if dp == 256 else 64), {64: 64, 128: 32, 256: 16}[dp])
    assert n == 1 or (n * bh * -(-s_q // bq) <= 264 and 2 * n <= -(-s_k // bk))
    keys = tatt._flash_fwd_split_keys(s_k, d, n)
    assert keys[0][0] == 0 and keys[-1][1] == s_k
    assert all(a < b for a, b in keys) and all(b == a for (_, b), (a, _) in zip(keys, keys[1:]))
    assert len({b - a for a, b in keys[:-1]}) <= 1


def _split_combine(arrs, causal, n_split, dtype=torch.float32):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrs)
    return tatt.flash_combine_reference(
        *tatt.flash_partials_reference(q, k, v, causal, n_split=n_split), dtype)


@pytest.mark.parametrize("n_split", [2, 3])
@pytest.mark.parametrize("s_q,s_k,causal", _CASES)
def test_flash_split_combine_matches_jax(s_q, s_k, causal, n_split):
    """The tiled kernel's algebra: the keys split into runs of whole tiles,
    each run's (m, l, acc) apart, joined by the combine, against the JAX
    package's flash kernel (interpret mode) at ``test_flash_matches_jax``'s
    float32 tolerances."""
    arrs = _qkv(13, 2, 2, s_q, s_k, 32)
    want_o, want_lse = _jax_flash(arrs, causal, jnp.float32)
    got_o, got_lse = _split_combine(arrs, causal, n_split)
    np.testing.assert_allclose(got_o.numpy(), want_o, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n_split", [2, 3])
@pytest.mark.parametrize("s_q,s_k,causal", _CASES + [(200, 150, True)])
def test_flash_split_combine_matches_flash_reference(s_q, s_k, causal, n_split):
    """The same against ``flash_reference`` (the plain version of K3 without
    splits): within 1e-6 (float32 sums in another order, exp2 in log2 units
    for exp)."""
    arrs = _qkv(14, 2, 2, s_q, s_k, 32)
    want_o, want_lse = tatt.flash_reference(*map(torch.from_numpy, arrs), causal)
    got_o, got_lse = _split_combine(arrs, causal, n_split)
    torch.testing.assert_close(got_o, want_o, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got_lse, want_lse, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_split", [2, 3])
def test_flash_split_combine_rows_that_see_no_key(n_split):
    """Causal with s_q > s_k: the first 50 rows see no key and get the mean
    of V over the s_k keys, as ``attention_reference`` gives them, whatever
    the split. Each split's m has absorbed log l there (finfo.min/2), so a
    combine of per-split lse values would weigh the splits alike and sum
    their means of V: the partials keep m and l apart."""
    arrs = _qkv(15, 1, 2, 200, 150, 32)
    ref = np.asarray(jatt.attention_reference(*map(jnp.asarray, arrs), causal=True))
    got_o, _ = _split_combine(arrs, True, n_split)
    np.testing.assert_allclose(got_o.numpy(), ref, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(got_o[:, :, :50].numpy(), np.broadcast_to(
        arrs[2].mean(axis=2, keepdims=True), (1, 2, 50, 32)), rtol=1e-5, atol=1e-5)
    # what a combine over lse = m ln 2 + log l would give those rows
    m, l, acc = tatt.flash_partials_reference(*map(torch.from_numpy, arrs), True,
                                              n_split=n_split)
    lse = m * tatt._LN2 + torch.log(l)
    w = torch.softmax(lse, dim=0)
    by_lse = (acc / l[..., None] * w[..., None]).sum(0)
    assert (by_lse[:, :, :50] - got_o[:, :, :50]).abs().max() > 1e-2


def test_flash_fwd_combine_on_the_cpu_is_the_plain_version():
    """CPU partials take ``flash_combine_reference``: the same bits, and no
    launch counted."""
    q, k, v = map(torch.from_numpy, _qkv(16, 1, 2, 200, 150, 32))
    parts = tatt.flash_partials_reference(q, k, v, True, n_split=3)
    before = tatt.flash_fwd_combine.launch_count, dict(tatt.flash_attention.variant_counts)
    got = tatt.flash_fwd_combine(*parts)
    want = tatt.flash_combine_reference(*parts)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    tatt.flash_attention(q, k, v, causal=True)
    assert (tatt.flash_fwd_combine.launch_count, tatt.flash_attention.variant_counts) == before
