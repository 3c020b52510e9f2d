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


def test_flash_smem_fits_a_block():
    from lipreading_video_generation_tpu_torch.ops import _build

    for d in (16, 64, 128, 256):
        assert tatt.flash_smem_bytes(d) <= _build.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="256"):
        tatt.flash_head_dim_pad(320)
