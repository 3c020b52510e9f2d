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


def test_flash_backward_smem_fits_a_block():
    from lipreading_video_generation_tpu_torch.ops import _build

    for d in (16, 64, 128, 192, 256):
        for kernel in ("dkv", "dq"):
            assert tatt.flash_bwd_smem_bytes(d, kernel) <= _build.SMEM_PER_BLOCK
    assert tatt.flash_bwd_block_q(192) == 32 and tatt.flash_bwd_block_q(128) == 64
