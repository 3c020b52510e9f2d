"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither jax nor the JAX package, so it runs on a machine that has only
torch; there, skip the repository's conftest (which sets up JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""
import numpy as np
import pytest
import torch

from lipreading_video_generation_tpu_torch.ops import attention as att
from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl
from lipreading_video_generation_tpu_torch.ops import image as im

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full float32
    return torch.device("cuda")


def _uniform(shape, lo, hi, seed, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(device, dtype)


@pytest.mark.parametrize("shape,grid", [((1920, 48, 48), (8, 8)), ((3, 50, 46), (8, 8)),
                                        ((2, 64, 64), (4, 4))])
def test_clahe_kernel_matches_plain(cuda, shape, grid):
    x = _uniform(shape, 0, 255, 0, cuda)
    before = cl.clahe_cuda.launch_count
    got = cl.clahe_cuda(x, 0.2, grid)
    torch.cuda.synchronize()
    assert cl.clahe_cuda.launch_count == before + 1
    # exact LUTs on both sides; the float32 blend differs only in rounding
    assert (got - cl.clahe_reference(x, 0.2, grid)).abs().max().item() <= 1e-2


def test_clahe_dispatch_on_card(cuda):
    x = _uniform((2, 48, 48), 0, 255, 1, cuda)
    u8 = im.clahe(x.round().to(torch.uint8))
    assert u8.dtype == torch.uint8 and u8.is_cuda
    with pytest.raises(ValueError, match="float32"):
        cl.clahe_cuda(x.double())
    with pytest.raises(ValueError, match="does not take"):
        im.clahe(x, grid=(16, 16))          # 256 tile histograms exceed shared memory


@pytest.mark.parametrize("b,s,e,h,causal,dtype,tol", [
    (384, 80, 256, 8, False, torch.bfloat16, 2e-2),
    (2, 33, 64, 4, True, torch.bfloat16, 2e-2),
    (3, 81, 256, 8, True, torch.float32, 1e-5),
    (1, 16, 32, 1, True, torch.float32, 1e-5),
])
def test_small_mha_kernel_matches_plain(cuda, b, s, e, h, causal, dtype, tol):
    q, k, v = (_uniform((b, s, e), -2, 2, i, cuda, dtype) for i in range(3))
    before = att.small_mha.launch_count
    got = att.mha(q, k, v, h, causal)
    torch.cuda.synchronize()
    assert att.small_mha.launch_count == before + 1
    want = att._mha_einsum(q, k, v, h, causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_small_mha_kernel_takes_qkv_slices(cuda):
    """The main path passes column slices of one fused qkv tensor."""
    q, k, v = _uniform((4, 80, 768), -2, 2, 3, cuda, torch.bfloat16).chunk(3, dim=-1)
    got = att.small_mha(q, k, v, 8)
    want = att._mha_einsum(q.contiguous(), k.contiguous(), v.contiguous(), 8, False)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


def test_small_mha_kernel_gradients(cuda):
    q, k, v = (_uniform((2, 33, 64), -2, 2, 4 + i, cuda).requires_grad_() for i in range(3))
    cot = _uniform((2, 33, 64), -1, 1, 7, cuda)
    (att.small_mha(q, k, v, 4) * cot).sum().backward()
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    (att._mha_einsum(*ref, 4, False) * cot).sum().backward()
    for t, r in zip((q, k, v), ref):
        torch.testing.assert_close(t.grad, r.grad, rtol=1e-4, atol=1e-4)


def test_mha_raises_where_no_kernel_takes_the_shape(cuda):
    q = _uniform((2, 81, 120), -1, 1, 8, cuda)
    with pytest.raises(ValueError, match="not a multiple"):
        att.mha(q, q, q, 7)                  # e % heads != 0
    with pytest.raises(ValueError, match="bf16 or float32"):
        att.small_mha(q.half(), q.half(), q.half(), 4)
    big = _uniform((1, 1, 300, 320), -1, 1, 9, cuda)
    with pytest.raises(ValueError, match="256"):
        att.flash_attention(big, big, big)   # head dim above K3's 256
    with pytest.raises(ValueError, match="bf16 or float32"):
        att.flash_attention(big[..., :64].half(), big[..., :64].half(), big[..., :64].half())


@pytest.mark.parametrize("b,s_q,s_k,e,h", [(2, 81, 120, 256, 8), (3, 128, 128, 256, 8),
                                           (1, 100, 100, 128, 8)])
def test_mha_small_shapes_k2_does_not_take_use_einsum(cuda, b, s_q, s_k, e, h):
    """s_q != s_k, or H·pad(S) > 768: ``_mha_einsum`` on the card, as the
    JAX package computes them (these raised before)."""
    q = _uniform((b, s_q, e), -2, 2, 10, cuda, torch.bfloat16)
    k, v = (_uniform((b, s_k, e), -2, 2, 11 + i, cuda, torch.bfloat16) for i in range(2))
    assert att.mha_route(h, s_q, s_k, e, q.dtype, q.device) == "einsum"
    before = att.small_mha.launch_count, att.flash_attention.launch_count
    got = att.mha(q, k, v, h)
    assert (att.small_mha.launch_count, att.flash_attention.launch_count) == before
    want = att._mha_einsum(q.cpu(), k.cpu(), v.cpu(), h, False)
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=2e-2, atol=2e-2)


# K3 at the U-Net's shapes (batch 2), at scripts/profile_flash_dpad.py's, and
# small causal, ragged and cross cases
_FLASH = [
    ((2, 1, 16384, 64), 16384, False, torch.bfloat16),
    ((2, 1, 4096, 128), 4096, False, torch.bfloat16),
    ((2, 1, 1024, 256), 1024, False, torch.bfloat16),
    ((1, 1, 16384, 64), 16384, False, torch.bfloat16),
    ((1, 1, 512, 64), 512, False, torch.float32),
    ((2, 3, 192, 32), 192, True, torch.float32),
    ((2, 3, 160, 40), 320, True, torch.float32),
    ((2, 3, 200, 16), 200, False, torch.float32),
    ((1, 2, 160, 128), 320, False, torch.float32),
    ((1, 2, 200, 64), 150, True, torch.float32),     # 50 rows see no key
]


@pytest.mark.parametrize("q_shape,s_k,causal,dtype", _FLASH)
def test_flash_kernel_matches_plain(cuda, q_shape, s_k, causal, dtype):
    """O within one output ulp in bf16 (2^-7 at |O| ≤ 1: 1e-2), 1e-4 in
    float32; lse within 1e-4."""
    b, h, s_q, d = q_shape
    q = _uniform(q_shape, -2, 2, 20, cuda, dtype)
    k, v = (_uniform((b, h, s_k, d), -2, 2, 21 + i, cuda, dtype) for i in range(2))
    before = att.flash_attention.launch_count
    got_o, got_lse = att.flash_attention(q, k, v, causal, return_lse=True)
    torch.cuda.synchronize()
    assert att.flash_attention.launch_count == before + 1
    want_o, want_lse = att.flash_reference(q, k, v, causal)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got_o.float(), want_o.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(got_lse, want_lse, rtol=1e-4, atol=1e-4)


def test_flash_kernel_takes_qkv_slices(cuda):
    """The U-Net passes (B, H, S, D) views of column slices of one qkv."""
    qkv = _uniform((2, 4096, 3 * 128), -2, 2, 30, cuda, torch.bfloat16)
    q, k, v = (t.reshape(2, 4096, 1, 128).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    got = att.mha(*qkv.chunk(3, dim=-1), 1)
    want = att.flash_reference(q, k, v)[0].transpose(1, 2).reshape(2, 4096, 128)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


# K4/K5 at the U-Net's three shapes (batch 2), the super-resolution U-Net's
# (d=192, padded to 256), the classifier's (2 heads, d=64), and float32
# cases: non-causal, causal, causal s_q < s_k, ragged, cross, the head dims
# 16/64/128/256, and fully masked rows (causal, s_q > s_k).
_FLASH_BWD = [
    ((2, 1, 16384, 64), 16384, False, torch.bfloat16),
    ((2, 1, 4096, 128), 4096, False, torch.bfloat16),
    ((2, 1, 1024, 256), 1024, False, torch.bfloat16),
    ((2, 1, 1024, 192), 1024, False, torch.bfloat16),
    ((2, 2, 1024, 64), 1024, False, torch.bfloat16),
    ((2, 2, 256, 32), 256, False, torch.float32),
    ((2, 2, 192, 32), 192, True, torch.float32),
    ((2, 2, 160, 32), 320, True, torch.float32),
    ((2, 2, 200, 32), 200, False, torch.float32),
    ((2, 2, 160, 32), 320, False, torch.float32),
    ((1, 2, 256, 16), 256, False, torch.float32),
    ((1, 2, 256, 128), 256, True, torch.float32),
    ((1, 2, 256, 256), 256, True, torch.float32),
    ((1, 2, 200, 64), 150, True, torch.float32),     # 50 rows see no key
]


def _rel_err(got, want):
    """max |got − want| over max |want|: float32 sums in another order
    (≤ 1e-4), or one rounding of each gradient to bf16 (2^-8 of the value,
    so ≤ 1e-2 of the largest)."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.parametrize("q_shape,s_k,causal,dtype", _FLASH_BWD)
def test_flash_backward_kernels_match_plain(cuda, q_shape, s_k, causal, dtype):
    b, h, s_q, d = q_shape
    q = _uniform(q_shape, -2, 2, 40, cuda, dtype)
    k, v = (_uniform((b, h, s_k, d), -2, 2, 41 + i, cuda, dtype) for i in range(2))
    do = _uniform(q_shape, -1, 1, 43, cuda, dtype)
    o, lse = att.flash_attention(q, k, v, causal, return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    before = att.flash_bwd_dkv.launch_count, att.flash_bwd_dq.launch_count
    dk, dv = att.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    dq = att.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert (att.flash_bwd_dkv.launch_count, att.flash_bwd_dq.launch_count) == (
        before[0] + 1, before[1] + 1)
    want = att.flash_backward_reference(q, k, v, do, lse, delta, causal)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for got, ref, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert _rel_err(got, ref) <= tol, (name, _rel_err(got, ref))


def test_flash_autograd_runs_k4_k5_on_qkv_slices(cuda):
    """The U-Net's call: ``mha`` on column slices of one qkv under autograd
    launches K3, K4 and K5 once each and matches the plain backward."""
    qkv = _uniform((2, 4096, 3 * 128), -2, 2, 50, cuda, torch.bfloat16).requires_grad_()
    cot = _uniform((2, 4096, 128), -1, 1, 51, cuda, torch.bfloat16)
    before = (att.flash_attention.launch_count, att.flash_bwd_dkv.launch_count,
              att.flash_bwd_dq.launch_count)
    (att.mha(*qkv.chunk(3, dim=-1), 1).float() * cot.float()).sum().backward()
    torch.cuda.synchronize()
    after = (att.flash_attention.launch_count, att.flash_bwd_dkv.launch_count,
             att.flash_bwd_dq.launch_count)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)
    q, k, v = (t.detach().reshape(2, 4096, 1, 128).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    o, lse = att.flash_reference(q, k, v)
    do = cot.reshape(2, 4096, 1, 128).transpose(1, 2)
    want = att.flash_backward_reference(q, k, v, do, lse, (do.float() * o.float()).sum(-1))
    want = torch.cat([g.transpose(1, 2).reshape(2, 4096, 128) for g in want], dim=-1)
    assert _rel_err(qkv.grad, want) <= 1e-2


def test_flash_backward_fully_masked_rows_follow_attention_reference(cuda):
    """Causal, q 200, kv 150: the first 50 rows see no key. The whole
    gradient agrees with autograd through ``attention_reference``."""
    q = _uniform((1, 2, 200, 32), -2, 2, 60, cuda).requires_grad_()
    k, v = (_uniform((1, 2, 150, 32), -2, 2, 61 + i, cuda).requires_grad_() for i in range(2))
    cot = _uniform((1, 2, 200, 32), -1, 1, 63, cuda)
    (att.flash_attention(q, k, v, causal=True) * cot).sum().backward()
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    (att.attention_reference(*ref, causal=True) * cot).sum().backward()
    for t, r in zip((q, k, v), ref):
        torch.testing.assert_close(t.grad, r.grad, rtol=1e-4, atol=1e-4)
