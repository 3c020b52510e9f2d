"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither jax nor the JAX package, so it runs on a machine that has only
torch; there, skip the repository's conftest (which sets up JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from lipreading_video_generation_tpu_torch.ops import attention as att
from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl
from lipreading_video_generation_tpu_torch.ops import image as im
from lipreading_video_generation_tpu_torch.ops import matmul_cuda as mm
from lipreading_video_generation_tpu_torch.ops import quant

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


# (shape, grid, nbins, clip, route, most LUT entries that may differ): K1's
# two routes at the shapes it took only since its redesign (16 x 16 tiles,
# 128, 8 and 512 bins, tiles of 121, 4,096 and 920 pixels, frames of
# 360 x 640) and the tiled route's edges (padding past the last tile,
# 20,000 bins in three passes, 17 x 17 tiles), clip 0.2, 2.0, 2.5 and 10.
# Where L is an integer and nbins a power of two every partial sum is exact
# and no entry may differ; elsewhere a level next to a rounding tie may move
# by one, in at most twice as many entries as seeds 0-3 moved on the card,
# plus 2 (PERF.md, §6)
_CLAHE = [((2, 48, 48), (16, 16), 256, 0.2, "packed", 0),
          ((2, 48, 48), (16, 16), 256, 2.0, "packed", 0),
          ((2, 48, 48), (8, 8), 128, 0.2, "packed", 0), ((2, 48, 48), (8, 8), 8, 0.2, "packed", 0),
          ((2, 88, 88), (8, 8), 256, 0.2, "packed", 0),
          ((2, 48, 48), (8, 8), 512, 2.5, "tiled", 0),
          ((2, 128, 128), (2, 2), 256, 2.5, "tiled", 0),
          ((2, 128, 128), (2, 2), 256, 0.2, "tiled", 2),
          ((1, 180, 320), (8, 8), 256, 2.0, "tiled", 2),
          ((2, 64, 64), (4, 4), 256, 2.5, "tiled", 2),
          ((2, 360, 640), (8, 8), 256, 0.2, "tiled", 2),
          ((2, 360, 640), (8, 8), 256, 2.5, "tiled", 2), ((3, 5, 5), (4, 4), 256, 0.2, "tiled", 0),
          ((2, 48, 48), (8, 8), 20000, 0.2, "tiled", 135110),
          ((2, 48, 48), (17, 17), 256, 2.0, "tiled", 0),
          ((2, 48, 48), (8, 8), 100, 0.2, "tiled", 116), ((2, 1, 1), (1, 1), 256, 0.2, "tiled", 0),
          ((2, 48, 48), (8, 8), 8, 2.0, "tiled", 0), ((2, 64, 64), (4, 4), 16, 2.0, "tiled", 0),
          ((2, 48, 48), (8, 8), 256, 10.0, "tiled", 2)]


@pytest.mark.parametrize("shape,grid,nbins,clip,route,max_diff", _CLAHE)
def test_clahe_kernel_routes_match_plain(cuda, shape, grid, nbins, clip, route, max_diff):
    """Each route, equal bits over two launches, and the LUTs against
    ``clahe_luts_reference``: equal where L is an integer and nbins a power
    of two (every partial sum exact), and the output within 1e-2; else
    within one level in no more than ``max_diff`` entries (a tie may round
    the other way after sums in another order), and the output within
    1 + 1e-2."""
    x = _uniform(shape, 0, 255, 2, cuda)
    luts = torch.empty(shape[0], grid[0] * grid[1], nbins, device=cuda)
    before = dict(cl.clahe_cuda.route_counts)
    got = cl.clahe_cuda(x, clip, grid, nbins, luts=luts)
    again = cl.clahe_cuda(x, clip, grid, nbins)
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in cl.clahe_cuda.route_counts.items()
            if n != before[r]} == {route: 2}
    assert torch.equal(got, again)
    th, tw = -(-shape[1] // grid[0]), -(-shape[2] // grid[1])
    limit = float(np.float32(max(1.0, clip * th * tw / nbins)))
    exact = limit.is_integer() and nbins & (nbins - 1) == 0
    assert exact == (max_diff == 0)
    lut_d = (luts - cl.clahe_luts_reference(x, clip, grid, nbins)).abs()
    err = (got - cl.clahe_reference(x, clip, grid, nbins)).abs().max().item()
    assert lut_d.max().item() <= (0 if exact else 1) and err <= (1e-2 if exact else 1 + 1e-2)
    assert (lut_d > 0).sum().item() <= max_diff


def test_clahe_unaligned_images_take_the_tiled_route(cuda):
    """Images that do not start on 16 bytes take the tiled route (the packed
    one moves pixels as float4s) and match the plain version."""
    x = _uniform((2 * 48 * 48 + 1,), 0, 255, 4, cuda)[1:].view(2, 48, 48)
    assert cl.clahe_route(48, 48, (8, 8), 256, 0.2, x.data_ptr()) == "tiled"
    before = cl.clahe_cuda.route_counts["tiled"]
    got = cl.clahe_cuda(x, 0.2, (8, 8))
    assert cl.clahe_cuda.route_counts["tiled"] == before + 1
    assert (got - cl.clahe_reference(x, 0.2, (8, 8))).abs().max().item() <= 1e-2


def test_clahe_dispatch_on_card(cuda):
    """``ops/image.clahe`` computes every shape on the card, those that
    raised before the redesign too (16 x 16 tiles, 128 and 512 bins,
    frames of 360 x 640), within a level of the plain version in uint8."""
    x = _uniform((2, 48, 48), 0, 255, 1, cuda)
    u8 = im.clahe(x.round().to(torch.uint8))
    assert u8.dtype == torch.uint8 and u8.is_cuda
    with pytest.raises(ValueError, match="float32"):
        cl.clahe_cuda(x.double())
    frames = _uniform((2, 360, 640), 0, 255, 3, cuda)
    # L = 1 at 48 x 48 (exact LUTs); L = 2.8125 on the frames (a level may move by one)
    for img, kw, tol in ((x, {"grid": (16, 16)}, 1e-2), (x, {"nbins": 128}, 1e-2),
                         (x, {"nbins": 512}, 1e-2), (frames, {}, 1 + 1e-2)):
        u8 = img.round().to(torch.uint8)
        got, want = im.clahe(u8, **kw), cl.clahe_reference(u8, **kw)
        assert got.dtype == torch.uint8
        assert (got.int() - want.int()).abs().max().item() <= math.ceil(tol)
        torch.testing.assert_close(im.clahe(img, **kw), cl.clahe_reference(img, **kw),
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("b,s,e,h,causal,dtype,tol", [
    (384, 80, 256, 8, False, torch.bfloat16, 2e-2),
    (2, 33, 64, 4, True, torch.bfloat16, 2e-2),
    (3, 81, 256, 8, True, torch.float32, 1e-5),
    (1, 16, 32, 1, True, torch.float32, 1e-5),
])
def test_small_mha_kernel_matches_plain(cuda, b, s, e, h, causal, dtype, tol):
    q, k, v = (_uniform((b, s, e), -2, 2, i, cuda, dtype) for i in range(3))
    before = att.small_mha.launch_count
    route = "sm90" if dtype == torch.bfloat16 else "cuda_core"   # all contiguous here
    routed = att.small_mha.route_counts[route]
    got = att.mha(q, k, v, h, causal)
    torch.cuda.synchronize()
    assert att.small_mha.launch_count == before + 1
    assert att.small_mha.route_counts[route] == routed + 1
    want = att._mha_einsum(q, k, v, h, causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# the tensor-core K2's edges: S = 1, 16, 17 and 128 (its largest), head dims 8,
# 64 and 128, more heads than blocks at once
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,e,h", [(3, 1, 64, 4), (3, 16, 64, 4), (3, 17, 64, 4),
                                     (2, 128, 256, 4), (2, 128, 256, 2), (5, 40, 16, 2),
                                     (4, 11, 768, 8), (3000, 16, 64, 4)])
def test_small_mha_tensor_core_kernel_edges(cuda, b, s, e, h, causal):
    """bf16 on the tensor-core route: within 2e-2 of ``_mha_einsum`` (one
    bf16 rounding of P and of O), finite, and the same bits from a second
    launch."""
    q, k, v = (_uniform((b, s, e), -2, 2, 90 + i, cuda, torch.bfloat16) for i in range(3))
    routed = att.small_mha.route_counts["sm90"]
    got = att.small_mha(q, k, v, h, causal)
    again = att.small_mha(q, k, v, h, causal)
    torch.cuda.synchronize()
    assert att.small_mha.route_counts["sm90"] == routed + 2
    assert torch.isfinite(got.float()).all() and torch.equal(got, again)
    want = att._mha_einsum(q, k, v, h, causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


def test_small_mha_routes_what_the_tensor_core_kernel_does_not_take(cuda):
    """A bf16 view that starts 8 bytes into its rows, a sequence past 128
    tokens and float32 run the CUDA-core kernel, to the same bounds."""
    wide = [_uniform((3, 33, 72), -2, 2, 93 + i, cuda, torch.bfloat16) for i in range(3)]
    long = [_uniform((2, 160, 64), -2, 2, 96 + i, cuda, torch.bfloat16) for i in range(3)]
    for (q, k, v), h in (([t[..., 4:68] for t in wide], 4), (long, 1)):
        before = dict(att.small_mha.route_counts)
        got = att.small_mha(q, k, v, h, True)
        torch.cuda.synchronize()
        assert att.small_mha.route_counts == {"sm90": before["sm90"],
                                              "cuda_core": before["cuda_core"] + 1}
        want = att._mha_einsum(q, k, v, h, True)
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


def test_small_mha_kernel_takes_qkv_slices(cuda):
    """The main path passes column slices of one fused qkv tensor."""
    q, k, v = _uniform((4, 80, 768), -2, 2, 3, cuda, torch.bfloat16).chunk(3, dim=-1)
    routed = att.small_mha.route_counts["sm90"]
    got = att.small_mha(q, k, v, 8)
    assert att.small_mha.route_counts["sm90"] == routed + 1      # the tensor-core kernel
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
    big = _uniform((1, 1, 300, 520), -1, 1, 9, cuda)
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
    # bf16 twins of the small cases: the tensor-core kernels' masks and edges
    ((2, 3, 192, 32), 192, True, torch.bfloat16),
    ((2, 3, 160, 40), 320, True, torch.bfloat16),
    ((2, 3, 200, 16), 200, False, torch.bfloat16),
    ((1, 2, 160, 128), 320, False, torch.bfloat16),
    ((1, 2, 256, 256), 256, True, torch.bfloat16),
    ((1, 2, 200, 64), 150, True, torch.bfloat16),    # 50 rows see no key
]


@pytest.mark.parametrize("q_shape,s_k,causal,dtype", _FLASH)
def test_flash_kernel_matches_plain(cuda, q_shape, s_k, causal, dtype):
    """O within one output ulp in bf16 (2^-7 at |O| ≤ 1: 1e-2), 1e-4 in
    float32; lse within 1e-4. Contiguous bf16 takes the tensor-core kernel,
    which rounds P to bf16 before P·V (2^-9 a term, averaging out over a
    row): it is held to the same bound against the float32-P plain version
    and against the one that rounds P there. No atomics: a second launch
    gives the same bits."""
    b, h, s_q, d = q_shape
    q = _uniform(q_shape, -2, 2, 20, cuda, dtype)
    k, v = (_uniform((b, h, s_k, d), -2, 2, 21 + i, cuda, dtype) for i in range(2))
    before = att.flash_attention.launch_count
    route = "sm90" if dtype == torch.bfloat16 else "cuda_core"   # all contiguous here
    routed = att.flash_attention.route_counts[route]
    got_o, got_lse = att.flash_attention(q, k, v, causal, return_lse=True)
    torch.cuda.synchronize()
    assert att.flash_attention.launch_count == before + 1
    assert att.flash_attention.route_counts[route] == routed + 1
    want_o, want_lse = att.flash_reference(q, k, v, causal)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got_o.float(), want_o.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(got_lse, want_lse, rtol=1e-4, atol=1e-4)
    if route == "sm90":
        want_p, lse_p = att.flash_reference(q, k, v, causal, p_dtype=torch.bfloat16)
        assert torch.equal(lse_p, want_lse)
        torch.testing.assert_close(got_o.float(), want_p.float(), rtol=tol, atol=tol)
    again_o, again_lse = att.flash_attention(q, k, v, causal, return_lse=True)
    assert torch.equal(got_o, again_o) and torch.equal(got_lse, again_lse)


def test_flash_kernel_unaligned_bf16_view_takes_cuda_cores(cuda):
    """A bf16 view that starts 8 bytes into its rows cannot be read by
    16-byte copies: K3 runs its CUDA-core kernel, to the same bound; the
    same values in aligned tensors take the tensor-core kernel."""
    wide = [_uniform((2, 2, 300, 72), -2, 2, 24 + i, cuda, torch.bfloat16) for i in range(3)]
    q, k, v = (t[..., 4:68] for t in wide)
    before = dict(att.flash_attention.route_counts)
    o, lse = att.flash_attention(q, k, v, True, return_lse=True)
    torch.cuda.synchronize()
    assert att.flash_attention.route_counts == {"sm90": before["sm90"],
                                                "cuda_core": before["cuda_core"] + 1}
    want_o, want_lse = att.flash_reference(q, k, v, True)
    torch.testing.assert_close(o.float(), want_o.float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    o_a, lse_a = att.flash_attention(*(t.contiguous() for t in (q, k, v)), True, return_lse=True)
    assert att.flash_attention.route_counts["sm90"] == before["sm90"] + 1
    torch.testing.assert_close(o_a.float(), o.float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(lse_a, lse, rtol=1e-4, atol=1e-4)


def _forward_and_backward_match_plain(q_shape, s_k, causal, dtype, route, device):
    """K3, then K4 and K5 on its lse, each by ``route`` and against its plain
    version: O 1e-2 / 1e-4 (bf16 / float32), lse 1e-4, gradients 1e-2 / 1e-4
    of the largest value."""
    b, h, s_q, d = q_shape
    q = _uniform(q_shape, -2, 2, 80, device, dtype)
    k, v = (_uniform((b, h, s_k, d), -2, 2, 81 + i, device, dtype) for i in range(2))
    do = _uniform(q_shape, -1, 1, 83, device, dtype)
    fns = (att.flash_attention, att.flash_bwd_dkv, att.flash_bwd_dq)
    before = [dict(fn.route_counts) for fn in fns]
    o, lse = att.flash_attention(q, k, v, causal, return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    dk, dv = att.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    dq = att.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    for fn, was in zip(fns, before):
        assert {r: n - was[r] for r, n in fn.route_counts.items() if n != was[r]} == {route: 1}
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    want_o, want_lse = att.flash_reference(q, k, v, causal)
    torch.testing.assert_close(o.float(), want_o.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    want = att.flash_backward_reference(q, k, v, do, lse, delta, causal)
    for got, ref, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert _rel_err(got, ref) <= tol, (name, _rel_err(got, ref))


@pytest.mark.parametrize("d", [320, 512, 640, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_take_head_dims_above_256(cuda, d, dtype):
    """Head dims above 256 run the CUDA-core kernels in both types (1024
    tokens: a U-Net block of 512 channels at ds 4); above 512 they walk d
    in slices of 256 columns."""
    _forward_and_backward_match_plain((1, 1, 1024, d), 1024, False, dtype, "cuda_core", cuda)


@pytest.mark.parametrize("d", [640, 1000, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_sliced_kernels_causal_and_ragged(cuda, d, dtype):
    """The sliced kernels with a causal mask over ragged lengths (300
    queries, 260 keys, 2 heads) and a head dim that is no multiple of 256."""
    _forward_and_backward_match_plain((1, 2, 300, d), 260, True, dtype, "cuda_core", cuda)


@pytest.mark.parametrize("q_shape,causal,dtype,route", [
    ((4097, 17, 132, 16), True, torch.bfloat16, "sm90"),         # 69,649 (batch, head) pairs
    ((2048, 33, 132, 16), False, torch.float32, "cuda_core"),    # 67,584
])
def test_flash_kernels_take_more_than_65535_heads(cuda, q_shape, causal, dtype, route):
    """batch·heads is not bound by the 65,535 of ``blockIdx.y``: the CUDA-core
    kernels fold (batch, head, tile) onto ``blockIdx.x``, the tensor-core
    kernels split (batch, head) over y and z (69,649 is odd, so the last z
    slice holds a block that has no pair and must return)."""
    _forward_and_backward_match_plain(q_shape, q_shape[2], causal, dtype, route, cuda)


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
    # bf16 twins of the small cases: the tensor-core kernels' masks and edges
    ((2, 3, 192, 32), 192, True, torch.bfloat16),
    ((2, 3, 160, 40), 320, True, torch.bfloat16),
    ((2, 3, 200, 16), 200, False, torch.bfloat16),
    ((1, 2, 160, 128), 320, False, torch.bfloat16),
    ((1, 2, 256, 256), 256, True, torch.bfloat16),
    ((1, 2, 200, 64), 150, True, torch.bfloat16),    # 50 rows see no key
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
    route = "sm90" if dtype == torch.bfloat16 else "cuda_core"   # all contiguous here
    routed = att.flash_bwd_dkv.route_counts[route], att.flash_bwd_dq.route_counts[route]
    dk, dv = att.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    dq = att.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert (att.flash_bwd_dkv.launch_count, att.flash_bwd_dq.launch_count) == (
        before[0] + 1, before[1] + 1)
    assert (att.flash_bwd_dkv.route_counts[route], att.flash_bwd_dq.route_counts[route]) == (
        routed[0] + 1, routed[1] + 1)
    want = att.flash_backward_reference(q, k, v, do, lse, delta, causal)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for got, ref, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert _rel_err(got, ref) <= tol, (name, _rel_err(got, ref))
    # no atomics: a second launch gives the same bits
    dk2, dv2 = att.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    dq2 = att.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)


def test_flash_backward_unaligned_bf16_view_takes_cuda_cores(cuda):
    """A bf16 view that starts 8 bytes into its rows cannot be read by
    16-byte copies: it runs the CUDA-core kernels, to the same bound."""
    wide = [_uniform((2, 2, 300, 72), lo, -lo, 44 + i, cuda, torch.bfloat16)
            for i, lo in enumerate((-2, -2, -2, -1))]
    q, k, v, do = (t[..., 4:68] for t in wide)
    o, lse = att.flash_attention(q, k, v, True, return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    before = dict(att.flash_bwd_dkv.route_counts), dict(att.flash_bwd_dq.route_counts)
    dk, dv = att.flash_bwd_dkv(q, k, v, do, lse, delta, True)
    dq = att.flash_bwd_dq(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    for fn, was in zip((att.flash_bwd_dkv, att.flash_bwd_dq), before):
        assert fn.route_counts == {"sm90": was["sm90"], "cuda_core": was["cuda_core"] + 1}
    for got, ref in zip((dq, dk, dv), att.flash_backward_reference(q, k, v, do, lse, delta, True)):
        assert _rel_err(got, ref) <= 1e-2
    # the same values in aligned tensors take the tensor-core kernels
    dk_a, dv_a = att.flash_bwd_dkv(*(t.contiguous() for t in (q, k, v, do)), lse, delta, True)
    assert att.flash_bwd_dkv.route_counts["sm90"] == before[0]["sm90"] + 1
    assert _rel_err(dk_a, dk) <= 1e-2 and _rel_err(dv_a, dv) <= 1e-2


def test_flash_backward_bf16_fully_masked_rows_follow_attention_reference(cuda):
    """The tensor-core kernels' rows that see no key: the bf16 gradients
    agree with autograd through ``attention_reference`` on the float32
    values of the same inputs."""
    q = _uniform((1, 2, 200, 32), -2, 2, 64, cuda, torch.bfloat16).requires_grad_()
    k, v = (_uniform((1, 2, 150, 32), -2, 2, 65 + i, cuda, torch.bfloat16).requires_grad_()
            for i in range(2))
    cot = _uniform((1, 2, 200, 32), -1, 1, 67, cuda)
    before = att.flash_bwd_dkv.route_counts["sm90"]
    (att.flash_attention(q, k, v, causal=True).float() * cot).sum().backward()
    assert att.flash_bwd_dkv.route_counts["sm90"] == before + 1
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    (att.attention_reference(*ref, causal=True) * cot).sum().backward()
    for t, r in zip((q, k, v), ref):
        assert _rel_err(t.grad, r.grad) <= 1e-2


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


def _int8(shape, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(device)


# K6: ragged shapes, one 4096-deep product, the generator's narrowest and
# widest outputs (M cut), the tensor-core kernel's tile edges, and the operand
# layouts the int8 path produces
_MM = [(257, 131, 67), (5, 9, 3), (1, 1, 1), (300, 4608, 512), (4096, 294, 16),
       (4096, 32, 3), (640, 1024, 256), (129, 64, 65), (129, 144, 72), (255, 4608, 8),
       (1, 16, 1), (4096, 16, 32), (4096, 1440, 64), (700, 256, 768)]


def _mm_route(a, b):
    return mm.matmul_route(a.dtype, a.shape[0], b.shape[1], a.shape[1], a.stride(), b.stride(),
                           a.data_ptr(), b.data_ptr())


@pytest.mark.parametrize("m,k,n", _MM)
@pytest.mark.parametrize("layout", ["row_major", "b_transposed", "sliced"])
def test_int8_matmul_kernel_is_exact(cuda, m, k, n, layout):
    a = _int8((m, k), 70, cuda)
    if layout == "row_major":
        b = _int8((k, n), 71, cuda)
    elif layout == "b_transposed":          # a quantised (N, K) weight taken as B
        b = _int8((n, k), 71, cuda).t()
    else:                                   # every other row / column of larger tensors
        a = _int8((2 * m, 2 * k), 70, cuda)[::2, ::2]
        b = _int8((2 * k, 2 * n), 71, cuda)[::2, ::2]
    before = mm.int8_matmul.launch_count
    route = _mm_route(a, b)
    # the tensor-core kernel exactly where A and the transposed weight have rows of 16 bytes
    assert route == ("sm90" if layout == "b_transposed" and k % 16 == 0 else "mma_sync")
    routed = mm.int8_matmul.route_counts[route]
    got = mm.int8_matmul(a, b)
    torch.cuda.synchronize()
    assert mm.int8_matmul.launch_count == before + 1
    assert mm.int8_matmul.route_counts[route] == routed + 1
    want = mm.matmul_reference(a, b)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, want)
    assert torch.equal(got, mm.int8_matmul(a, b))          # one fixed order of summation
    assert torch.equal(want.cpu(), mm.matmul_reference(a.cpu(), b.cpu()))


@pytest.mark.parametrize("m,k,n", _MM)
@pytest.mark.parametrize("layout", ["row_major", "b_transposed"])
def test_bf16_matmul_kernel_matches_plain(cuda, m, k, n, layout):
    """The float32 accumulator against a float32 matmul of the same bf16
    values: only the order of summation differs, 1e-3 of the largest |C|."""
    a = _uniform((m, k), -1, 1, 72, cuda, torch.bfloat16)
    b = (_uniform((k, n), -1, 1, 73, cuda, torch.bfloat16) if layout == "row_major"
         else _uniform((n, k), -1, 1, 73, cuda, torch.bfloat16).t())
    before = mm.bf16_matmul.launch_count
    route = _mm_route(a, b)
    # rows of 16 bytes: K a multiple of 8, and N too where B is row-major
    aligned = k % 8 == 0 and (layout == "b_transposed" or n % 8 == 0)
    assert route == ("sm90" if aligned else "mma_sync")
    routed = mm.bf16_matmul.route_counts[route]
    got = mm.bf16_matmul(a, b)
    torch.cuda.synchronize()
    assert mm.bf16_matmul.launch_count == before + 1
    assert mm.bf16_matmul.route_counts[route] == routed + 1
    want = mm.matmul_reference(a, b)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item()
    assert torch.equal(got, mm.bf16_matmul(a, b))          # no atomics: the same bits again


def test_matmul_unaligned_views_take_mma_sync(cuda):
    """Slices that start one element into wider rows cannot be read by
    16-byte copies: both types run the mma.sync kernel, to the same bounds;
    the same values in aligned tensors run the tensor-core kernel."""
    a8 = _int8((300, 80), 77, cuda)[:, 1:65]
    b8 = _int8((48, 80), 78, cuda)[:, 1:65].t()
    a16 = _uniform((300, 80), -1, 1, 79, cuda, torch.bfloat16)[:, 1:65]
    b16 = _uniform((48, 80), -1, 1, 80, cuda, torch.bfloat16)[:, 1:65].t()
    for fn, a, b in ((mm.int8_matmul, a8, b8), (mm.bf16_matmul, a16, b16)):
        before = dict(fn.route_counts)
        got = fn(a, b)
        aligned = fn(a.contiguous(), b.t().contiguous().t())
        torch.cuda.synchronize()
        assert fn.route_counts == {"sm90": before["sm90"] + 1, "mma_sync": before["mma_sync"] + 1}
        want = mm.matmul_reference(a, b)
        if a.dtype == torch.int8:
            assert torch.equal(got, want) and torch.equal(aligned, want)
        else:
            bound = 1e-3 * want.abs().max().item()
            assert (got - want).abs().max().item() <= bound
            assert (aligned - want).abs().max().item() <= bound


def test_matmul_tensor_core_kernel_takes_more_columns_than_a_grid_axis(cuda):
    """N above 65,535 tiles of 64 columns: the tensor-core kernel folds its
    tiles onto one persistent grid; the mma.sync kernel's grid does not
    reach that far and its route raises."""
    n = 65535 * 64 + 8
    a, w = _int8((2, 16), 81, cuda), _int8((n, 16), 82, cuda)
    routed = mm.int8_matmul.route_counts["sm90"]
    got = mm.int8_matmul(a, w.t())
    torch.cuda.synchronize()
    assert mm.int8_matmul.route_counts["sm90"] == routed + 1
    assert torch.equal(got, mm.matmul_reference(a, w.t()))
    with pytest.raises(ValueError, match="mma.sync route"):
        mm.int8_matmul(a, w.t().contiguous())          # row-major int8 B: the other kernel


def test_matmul_wrappers_raise_on_what_k6_does_not_take(cuda):
    a = _int8((8, 8), 74, cuda)
    with pytest.raises(ValueError, match="int8"):
        mm.int8_matmul(a.float(), a.float())
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        mm.int8_matmul(a, a[:4])
    with pytest.raises(ValueError, match="operands on"):
        mm.int8_matmul(a, a.cpu())
    assert mm.int8_matmul(a[:0], a).shape == (0, 8)
    # each route takes what the rule sends it, and nothing falls from one to the other:
    # the tensor-core entry point refuses a row-major int8 B and an unaligned view
    import ctypes

    from lipreading_video_generation_tpu_torch.ops import _build

    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = _build.kernel("lvg_mm_sm90_int8", [vp] * 3 + [i32] * 3 + [i64] * 3 + [vp])
    wide = _int8((16, 32), 75, cuda)
    out = torch.empty(16, 16, dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    assert fn(wide.data_ptr(), wide.data_ptr(), out.data_ptr(), 16, 16, 16, 32, 32, 1, stream) != 0
    view = wide[:, 1:17]
    assert fn(view.data_ptr(), wide.data_ptr(), out.data_ptr(), 16, 16, 16, 32, 1, 32, stream) != 0
    assert fn(wide.data_ptr(), wide.data_ptr(), out.data_ptr(), 16, 16, 16, 32, 1, 32, stream) == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("stride,pad,bias,static", [((2, 2), 1, True, False),
                                                    ((3, 1), 0, False, False),
                                                    ((1, 1), 3, True, True)])
def test_int8_conv_on_card_equals_cpu(cuda, stride, pad, bias, static):
    """The same float inputs give the same integers on both devices, so the
    outputs agree to float32 rounding of the dequantisation."""
    rng = np.random.default_rng(75)
    x = torch.from_numpy(rng.standard_normal((3, 20, 17, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((7, 7, 6, 10)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(10).astype(np.float32)) if bias else None
    scale = 0.03 if static else None
    args = (stride, ((pad, pad), (pad, pad)))
    before = mm.int8_matmul.launch_count
    got = quant.int8_conv(x.to(cuda), w.to(cuda), None if b is None else b.to(cuda), *args,
                          act_scale=scale)
    assert mm.int8_matmul.launch_count == before + 1
    want = quant.int8_conv(x, w, b, *args, act_scale=scale)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    got_d = quant.int8_dense(x.to(cuda), w[0, 0].to(cuda), None, act_scale=scale)
    torch.testing.assert_close(got_d.cpu(), quant.int8_dense(x, w[0, 0], None, act_scale=scale),
                               rtol=1e-5, atol=1e-5)


def test_int8_path_has_no_fallback(cuda, monkeypatch):
    """With the kernel library made unloadable a CUDA int8 product raises."""
    from lipreading_video_generation_tpu_torch.ops import _build

    def unloadable(name, argtypes):
        raise RuntimeError("kernel library unloadable")

    monkeypatch.setattr(_build, "kernel", unloadable)
    a = _int8((8, 16), 76, cuda)
    with pytest.raises(RuntimeError, match="unloadable"):
        mm.int8_matmul(a, a.t())
    x = torch.ones(1, 4, 4, 16, device=cuda)
    with pytest.raises(RuntimeError, match="unloadable"):
        quant.int8_conv(x, torch.ones(1, 1, 16, 8, device=cuda), None, (1, 1), "VALID")
    with pytest.raises(RuntimeError, match="unloadable"):
        quant.int8_dense(x, torch.ones(16, 8, device=cuda), None)
