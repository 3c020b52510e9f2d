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


# the CUDA-core K2's variants at their edges: (b, s, e, heads, causal, dtype,
# layout, variant); "qkv": column slices of one (b, s, 3e) tensor, "off1": views
# one element into their rows, "off4": bf16 views 8 bytes in
_F32, _BF16 = torch.float32, torch.bfloat16
_K2_CUDA_CORE = [
    (3, 1, 64, 4, False, _F32, "", "rows_vec4"),             # S 1, d 16
    (3, 5, 64, 4, True, _F32, "qkv", "rows_vec4"),
    (3, 8, 256, 4, False, _F32, "qkv", "rows_vec4"),         # S 8 / 9: 8 or 32 scores a lane
    (3, 9, 256, 4, True, _F32, "", "rows_vec4"),
    (3, 32, 64, 4, True, _F32, "qkv", "rows_vec4"),          # S 32 / 33: 32 or 64
    (3, 33, 64, 4, False, _F32, "", "rows_vec4"),
    (3, 48, 256, 4, True, _F32, "qkv", "rows_vec4"),
    (3, 64, 256, 4, False, _F32, "", "rows_vec4"),           # S 64, the rows kernels' last
    (3, 64, 64, 4, True, _F32, "qkv", "rows_vec4"),
    (3, 17, 256, 8, True, _F32, "", "rows_vec4"),            # d 32: 8 lanes a row
    (2, 11, 768, 8, False, _F32, "qkv", "rows_vec4"),        # d 96: 32 lanes, 24 of them busy
    (2, 9, 1024, 4, True, _F32, "", "rows_vec4"),            # d 256: 2 chunks a lane
    (2, 5, 1024, 2, False, _F32, "qkv", "rows_vec4"),        # d 512: 4 chunks a lane
    (2, 33, 1024, 2, True, _F32, "", "rows_vec4"),
    (100, 31, 64, 4, True, _F32, "qkv", "rows_vec4"),        # the word LM at batch 100
    (16, 5, 768, 12, False, _F32, "", "rows_vec4"),          # AV-HuBERT
    (3, 5, 24, 4, True, _F32, "", "rows"),                   # d 6
    (3, 7, 12, 4, False, _F32, "", "rows"),                  # d 3: 4 lanes, one idle
    (3, 33, 256, 4, False, _F32, "off1", "rows"),
    (2, 64, 512, 4, True, _F32, "off1", "rows"),             # d 128 in elements
    (3, 33, 64, 4, True, _BF16, "off4", "rows"),             # unaligned bf16
    (3, 64, 72, 4, False, _BF16, "", "rows"),                # bf16 d 18
    (2, 65, 64, 4, True, _F32, "qkv", "general_vec4"),       # S 65: the general kernels
    (2, 80, 256, 8, False, _F32, "", "general_vec4"),
    (2, 5, 2400, 4, False, _F32, "qkv", "general_vec4"),     # d 600
    (2, 5, 528, 4, True, _F32, "off1", "general"),           # d 132 in elements
    (1, 768, 32, 1, False, _F32, "", "general_vec4"),
    (1, 768, 32, 1, True, _F32, "", "general_vec4"),
    (2, 160, 64, 1, False, _BF16, "", "general"),            # bf16 S 160
    (2, 160, 64, 1, True, _BF16, "", "general"),
]


@pytest.mark.parametrize("b,s,e,h,causal,dtype,layout,variant", _K2_CUDA_CORE)
def test_small_mha_cuda_core_variants_match_plain(cuda, b, s, e, h, causal, dtype, layout,
                                                  variant):
    """The CUDA-core K2, each variant at its edges: within 1e-5 (float32) or
    2e-2 (bf16: one rounding of P and of O) of ``_mha_einsum``, the same bits
    from a second launch, both counted on the "cuda_core" route and the
    variant."""
    if layout == "qkv":
        q, k, v = _uniform((b, s, 3 * e), -2, 2, 40, cuda, dtype).chunk(3, dim=-1)
    elif layout:
        pad = 4 if layout == "off1" else 8
        lo = 1 if layout == "off1" else 4
        q, k, v = (_uniform((b, s, e + pad), -2, 2, 40 + i, cuda, dtype)[..., lo:lo + e]
                   for i in range(3))
    else:
        q, k, v = (_uniform((b, s, e), -2, 2, 40 + i, cuda, dtype) for i in range(3))
    routes, variants = dict(att.small_mha.route_counts), dict(att.small_mha.variant_counts)
    got = att.small_mha(q, k, v, h, causal)
    again = att.small_mha(q, k, v, h, causal)
    torch.cuda.synchronize()
    assert {r: n - routes[r] for r, n in att.small_mha.route_counts.items()
            if n != routes[r]} == {"cuda_core": 2}
    assert {r: n - variants[r] for r, n in att.small_mha.variant_counts.items()
            if n != variants[r]} == {variant: 2}
    assert torch.isfinite(got.float()).all() and torch.equal(got, again)
    tol = 1e-5 if dtype == _F32 else 2e-2
    want = att._mha_einsum(q, k, v, h, causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_small_mha_entry_point_refuses_a_variant_that_does_not_fit(cuda):
    """The C entry point checks what a variant needs: 16-byte loads on a view
    one element into its rows, the rows kernels past 64 tokens, an unknown
    variant, the vec4 variants in bf16: each returns an error, nothing runs."""
    import ctypes

    from lipreading_video_generation_tpu_torch.ops import _build

    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    argtypes = [vp] * 4 + [i32] + [i64] * 6 + [i32] * 3 + [ctypes.c_float, i32, i32, vp]

    def rc(entry, q, variant):
        b, s, e = q.shape
        out = torch.empty(b, s, e, dtype=q.dtype, device=q.device)
        return _build.kernel(entry, argtypes)(
            q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(), b, q.stride(0),
            q.stride(1), q.stride(0), q.stride(1), q.stride(0), q.stride(1), s, 4, e // 4,
            0.25, 0, att._SMALL_MHA_VARIANTS.index(variant) if variant in
            att._SMALL_MHA_VARIANTS else 7, torch.cuda.current_stream().cuda_stream)

    off1 = _uniform((2, 5, 68), -1, 1, 50, cuda)[..., 1:65]
    long = _uniform((2, 65, 64), -1, 1, 51, cuda)
    bf = _uniform((2, 5, 64), -1, 1, 52, cuda, torch.bfloat16)
    assert rc("lvg_small_mha_f32", off1, "rows_vec4") != 0
    assert rc("lvg_small_mha_f32", off1, "general_vec4") != 0
    assert rc("lvg_small_mha_f32", long, "rows_vec4") != 0
    assert rc("lvg_small_mha_f32", long, "unknown") != 0
    assert rc("lvg_small_mha_bf16", bf, "rows_vec4") != 0
    assert rc("lvg_small_mha_f32", off1, "rows") == 0
    torch.cuda.synchronize()


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


def _bwd_variant_counts():
    return [dict(fn.variant_counts) for fn in (att.flash_bwd_dkv, att.flash_bwd_dq)]


def _bwd_variants_taken(before):
    """The variants K4 and K5 launched since ``before`` (both must agree)."""
    took = [{v: n - was[v] for v, n in fn.variant_counts.items() if n != was[v]}
            for fn, was in zip((att.flash_bwd_dkv, att.flash_bwd_dq), before)]
    assert took[0] == took[1], took
    return took[0]


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
    # contiguous float32 with d up to 256: the tiled kernels of csrc/flash_bwd.cu
    variant = "tiled" if route == "cuda_core" else None
    routed = att.flash_bwd_dkv.route_counts[route], att.flash_bwd_dq.route_counts[route]
    by_variant = _bwd_variant_counts()
    dk, dv = att.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    dq = att.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert (att.flash_bwd_dkv.launch_count, att.flash_bwd_dq.launch_count) == (
        before[0] + 1, before[1] + 1)
    assert (att.flash_bwd_dkv.route_counts[route], att.flash_bwd_dq.route_counts[route]) == (
        routed[0] + 1, routed[1] + 1)
    assert _bwd_variants_taken(by_variant) == ({} if variant is None else {variant: 1})
    want = att.flash_backward_reference(q, k, v, do, lse, delta, causal)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for got, ref, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert _rel_err(got, ref) <= tol, (name, _rel_err(got, ref))
    # no atomics: a second launch gives the same bits
    dk2, dv2 = att.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    dq2 = att.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)


def _bwd_inputs(q_shape, s_k, layout, device, seed=90):
    """float32 q, k, v, dO; ``layout`` "qkv": (B, H, S, D) views of column
    slices of one (B, S, 3 H D) tensor, as the U-Net passes them; "off4":
    columns 1..d of rows of d + 4 (a view 4 bytes into its rows)."""
    b, h, s_q, d = q_shape
    if layout == "qkv":
        qkv = _uniform((b, s_q, 3 * h * d), -2, 2, seed, device)
        q, k, v = (t.reshape(b, s_q, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        do = _uniform((b, s_q, h * d), -1, 1, seed + 3, device)
        return q, k, v, do.reshape(b, s_q, h, d).transpose(1, 2)
    pad, start = (4, 1) if layout == "off4" else (0, 0)
    q = _uniform((b, h, s_q, d + pad), -2, 2, seed, device)
    k, v = (_uniform((b, h, s_k, d + pad), -2, 2, seed + 1 + i, device) for i in range(2))
    do = _uniform((b, h, s_q, d + pad), -1, 1, seed + 3, device)
    return tuple(t[..., start:start + d] for t in (q, k, v, do))


# chip_smoke.py [kernels]' float32 K4/K5 cases: the float32 U-Net's three
# shapes at 64x64, contiguous and as slices of its fused qkv; head dims 32,
# 100 and 192 (padded to 64, 128, 256); causal with s_q < s_k, ragged,
# cross, rows that see no key; more than 65,535 (batch, head) pairs; and a
# view 4 bytes into its rows, which must keep the general kernels.
# (q_shape, s_k, causal, layout, variant)
_FLASH_BWD_F32 = [
    ((2, 1, 4096, 64), 4096, False, "", "tiled"),
    ((2, 1, 1024, 128), 1024, False, "", "tiled"),
    ((2, 1, 256, 256), 256, False, "", "tiled"),
    ((2, 1, 4096, 64), 4096, False, "qkv", "tiled"),
    ((2, 1, 1024, 128), 1024, False, "qkv", "tiled"),
    ((2, 1, 256, 256), 256, False, "qkv", "tiled"),
    ((2, 2, 300, 32), 300, True, "", "tiled"),
    ((2, 2, 200, 100), 200, True, "", "tiled"),
    ((2, 2, 300, 192), 300, False, "", "tiled"),
    ((2, 3, 160, 40), 320, True, "", "tiled"),        # causal, s_q < s_k
    ((2, 3, 200, 16), 200, False, "", "tiled"),       # ragged
    ((1, 2, 160, 128), 320, False, "", "tiled"),      # cross
    ((1, 2, 200, 64), 150, True, "", "tiled"),        # 50 rows see no key
    ((2048, 33, 132, 16), 132, False, "", "tiled"),   # 67,584 (batch, head) pairs
    ((2, 2, 300, 64), 300, True, "off4", "general"),
]


@pytest.mark.parametrize("q_shape,s_k,causal,layout,variant", _FLASH_BWD_F32)
def test_flash_backward_tiled_matches_plain(cuda, q_shape, s_k, causal, layout, variant):
    """K4 and K5 in float32 by the variant ``flash_bwd_variant`` names: each
    gradient within 1e-4 of the largest of the plain version's (float32 sums
    in another order), one launch each by the cuda_core route and that
    variant, equal bits on a second launch."""
    q, k, v, do = _bwd_inputs(q_shape, s_k, layout, cuda)
    o, lse = att.flash_attention(q, k, v, causal, return_lse=True)
    delta = (do * o).sum(-1)
    routed = att.flash_bwd_dkv.route_counts["cuda_core"], att.flash_bwd_dq.route_counts["cuda_core"]
    by_variant = _bwd_variant_counts()
    dk, dv = att.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    dq = att.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert (att.flash_bwd_dkv.route_counts["cuda_core"],
            att.flash_bwd_dq.route_counts["cuda_core"]) == (routed[0] + 1, routed[1] + 1)
    assert _bwd_variants_taken(by_variant) == {variant: 1}
    want = att.flash_backward_reference(q, k, v, do, lse, delta, causal)
    for got, ref, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert _rel_err(got, ref) <= 1e-4, (name, _rel_err(got, ref))
    dk2, dv2 = att.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    dq2 = att.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.parametrize("kernel", ["dkv", "dq"])
def test_flash_backward_entry_point_refuses_tiled_on_unaligned_input(cuda, kernel):
    """The C entry points check the tiled kernels' preconditions themselves:
    asked for "tiled" on a view 4 bytes into its rows, they return an error
    (cudaErrorInvalidValue) and launch nothing, and the caller raises; the
    general kernels take the same inputs."""
    from lipreading_video_generation_tpu_torch.bench.flash_bwd_timing import c_entry_launcher

    q, k, v, do = _bwd_inputs((1, 1, 300, 64), 300, "off4", cuda)
    o, lse = att.flash_attention(q, k, v, False, return_lse=True)
    delta = (do * o).sum(-1)
    assert att.flash_bwd_variant(q.dtype, 64, [t.stride()[:3] for t in (q, k, v, do)],
                                 [t.data_ptr() for t in (q, k, v, do)]) == "general"
    with pytest.raises(RuntimeError, match="invalid argument"):
        c_entry_launcher(att, kernel, q, k, v, do, lse, delta, variant="tiled")()
    general = c_entry_launcher(att, kernel, q, k, v, do, lse, delta, variant="general")
    general()
    torch.cuda.synchronize()
    want = att.flash_backward_reference(q, k, v, do, lse, delta, dq=kernel == "dq",
                                        dkv=kernel == "dkv")
    for got, ref in zip(general.outs, [w for w in want if w is not None]):
        assert _rel_err(got, ref) <= 1e-4


# K3's float32 cases, each with the variant of csrc/flash_fwd.cu it must
# take: the float32 U-Net's three shapes at 64x64 and its heaviest at
# 128x128, contiguous and as slices of its fused qkv (the two smaller split
# the key axis); causal with s_q < s_k, ragged, cross, rows that see no key;
# head dims 32, 100 and 192 (padded); more than 65,535 (batch, head) pairs;
# and a view 4 bytes into its rows, which must keep the general kernel.
# (q_shape, s_k, causal, layout, variant)
_FLASH_FWD_F32 = [
    ((2, 1, 4096, 64), 4096, False, "", "tiled"),
    ((2, 1, 1024, 128), 1024, False, "", "tiled"),
    ((2, 1, 256, 256), 256, False, "", "tiled"),
    ((2, 1, 16384, 64), 16384, False, "", "tiled"),
    ((2, 1, 4096, 64), 4096, False, "qkv", "tiled"),
    ((2, 1, 1024, 128), 1024, False, "qkv", "tiled"),
    ((2, 1, 256, 256), 256, False, "qkv", "tiled"),
    ((2, 1, 16384, 64), 16384, False, "qkv", "tiled"),
    ((2, 2, 300, 32), 300, True, "", "tiled"),
    ((2, 2, 200, 100), 200, True, "", "tiled"),
    ((2, 2, 300, 192), 300, False, "", "tiled"),
    ((2, 3, 160, 40), 320, True, "", "tiled"),        # causal, s_q < s_k
    ((2, 3, 200, 16), 200, False, "", "tiled"),       # ragged
    ((1, 2, 160, 128), 320, False, "", "tiled"),      # cross
    ((1, 2, 200, 64), 150, True, "", "tiled"),        # 50 rows see no key
    ((1, 2, 300, 256), 60, True, "", "tiled"),        # 240 rows see no key, d 256
    ((2048, 33, 132, 16), 132, False, "", "tiled"),   # 67,584 (batch, head) pairs
    ((2, 2, 300, 64), 300, True, "off4", "general"),
]


@pytest.mark.parametrize("q_shape,s_k,causal,layout,variant", _FLASH_FWD_F32)
def test_flash_forward_tiled_matches_plain(cuda, q_shape, s_k, causal, layout, variant):
    """K3 in float32 by the variant ``flash_fwd_variant`` names: O and lse
    within 1e-4 of the plain version's (float32 sums in another order), one
    launch by the cuda_core route and that variant (and one of the combine
    kernel where ``flash_fwd_splits`` splits the key axis), equal bits on a
    second launch."""
    q, k, v, _ = _bwd_inputs(q_shape, s_k, layout, cuda, seed=110)
    b, h, s_q, d = q_shape
    splits = att.flash_fwd_splits(b * h, s_q, s_k, d) if variant == "tiled" else 1
    routed = att.flash_attention.route_counts["cuda_core"]
    by_variant = dict(att.flash_attention.variant_counts)
    combined = att.flash_fwd_combine.launch_count
    o, lse = att.flash_attention(q, k, v, causal, return_lse=True)
    torch.cuda.synchronize()
    assert att.flash_attention.route_counts["cuda_core"] == routed + 1
    assert {v_: n - by_variant[v_] for v_, n in att.flash_attention.variant_counts.items()
            if n != by_variant[v_]} == {variant: 1}
    assert att.flash_fwd_combine.launch_count == combined + (splits > 1)
    want_o, want_lse = att.flash_reference(q, k, v, causal)
    torch.testing.assert_close(o, want_o, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    o2, lse2 = att.flash_attention(q, k, v, causal, return_lse=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_flash_forward_entry_point_refuses_tiled_on_unaligned_input(cuda):
    """The C entry point checks the tiled kernel's preconditions itself:
    asked for "tiled" on a view 4 bytes into its rows, it returns an error
    (cudaErrorInvalidValue) and launches nothing, and the caller raises; the
    general kernel takes the same inputs."""
    from lipreading_video_generation_tpu_torch.bench.flash_fwd_timing import c_entry_launcher

    q, k, v, _ = _bwd_inputs((1, 1, 300, 64), 300, "off4", cuda)
    out = torch.empty(1, 300, 1, 64, device=cuda).transpose(1, 2)
    assert att.flash_fwd_variant(q.dtype, 64, [t.stride()[:3] for t in (q, k, v, out)],
                                 [t.data_ptr() for t in (q, k, v, out)]) == "general"
    with pytest.raises(RuntimeError, match="invalid argument"):
        c_entry_launcher(att, q, k, v, variant="tiled")()
    with pytest.raises(RuntimeError, match="invalid argument"):
        c_entry_launcher(att, q, k, v, variant="general", n_split=2)()
    general = c_entry_launcher(att, q, k, v, variant="general")
    general()
    torch.cuda.synchronize()
    want_o, want_lse = att.flash_reference(q, k, v)
    torch.testing.assert_close(general.out, want_o, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(general.lse, want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("q_shape,s_k,causal,n_split", [
    ((2, 1, 1024, 128), 1024, False, 5), ((2, 1, 256, 256), 256, False, 16),
    ((1, 2, 200, 64), 150, True, 3), ((2, 3, 160, 40), 320, True, 2)])
def test_flash_forward_split_partials_and_combine_match_plain(cuda, q_shape, s_k, causal,
                                                              n_split):
    """The tiled kernel's partials at ``n_split`` splits against
    ``flash_partials_reference`` (m where finite, which it is exactly where
    the plain version's is; l and acc of their largest), and the combine
    kernel on those partials, through ``flash_fwd_combine``, against
    ``flash_combine_reference`` on the same partials: within 1e-5 of the
    largest value; equal bits on a second launch."""
    from lipreading_video_generation_tpu_torch.bench.flash_fwd_timing import c_entry_launcher

    q, k, v, _ = _bwd_inputs(q_shape, s_k, "", cuda, seed=120)
    launch = c_entry_launcher(att, q, k, v, causal, n_split=n_split)
    launch()
    torch.cuda.synchronize()
    m, l, acc = launch.parts
    want_m, want_l, want_acc = att.flash_partials_reference(q, k, v, causal, n_split=n_split)
    finite = torch.isfinite(want_m)
    assert torch.equal(finite, torch.isfinite(m))
    for got, want in ((m[finite], want_m[finite]), (l, want_l), (acc, want_acc)):
        assert _rel_err(got, want) <= 1e-5
    before = att.flash_fwd_combine.launch_count
    o, lse = att.flash_fwd_combine(m, l, acc)
    o2, lse2 = att.flash_fwd_combine(m, l, acc)
    torch.cuda.synchronize()
    assert att.flash_fwd_combine.launch_count == before + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    want_o, want_lse = att.flash_combine_reference(m, l, acc)
    torch.testing.assert_close(o, want_o, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(launch.out, o, rtol=0, atol=0)
    torch.testing.assert_close(launch.lse, lse, rtol=0, atol=0)


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
    before = mm.int8_matmul.launch_count, mm.int8_matmul.pack_launch_count
    route = _mm_route(a, b)
    # read as they lie exactly where A and the transposed weight have rows of
    # 16 bytes; else packed first (A where K is odd or strided, B unless it
    # is the transposed weight)
    assert route == ("sm90" if layout == "b_transposed" and k % 16 == 0 else "packed")
    packs = (k % 16 != 0 or layout == "sliced") + (k % 16 != 0 or layout != "b_transposed")
    routed = mm.int8_matmul.route_counts[route]
    got = mm.int8_matmul(a, b)
    torch.cuda.synchronize()
    assert mm.int8_matmul.launch_count == before[0] + 1
    assert mm.int8_matmul.pack_launch_count == before[1] + (packs if route == "packed" else 0)
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
    assert route == ("sm90" if aligned else "packed")
    routed = mm.bf16_matmul.route_counts[route]
    got = mm.bf16_matmul(a, b)
    torch.cuda.synchronize()
    assert mm.bf16_matmul.launch_count == before + 1
    assert mm.bf16_matmul.route_counts[route] == routed + 1
    want = mm.matmul_reference(a, b)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item()
    assert torch.equal(got, mm.bf16_matmul(a, b))          # no atomics: the same bits again


def test_matmul_unaligned_views_take_packed(cuda):
    """Slices that start one element into wider rows cannot be read by a
    tensor map: both types pack A and B to K-major rows first, then run the
    same wgmma kernel, to the same bounds; the same values in aligned
    tensors are read as they lie."""
    a8 = _int8((300, 80), 77, cuda)[:, 1:65]
    b8 = _int8((48, 80), 78, cuda)[:, 1:65].t()
    a16 = _uniform((300, 80), -1, 1, 79, cuda, torch.bfloat16)[:, 1:65]
    b16 = _uniform((48, 80), -1, 1, 80, cuda, torch.bfloat16)[:, 1:65].t()
    for fn, a, b in ((mm.int8_matmul, a8, b8), (mm.bf16_matmul, a16, b16)):
        before, packs = dict(fn.route_counts), fn.pack_launch_count
        got = fn(a, b)
        aligned = fn(a.contiguous(), b.t().contiguous().t())
        torch.cuda.synchronize()
        assert fn.route_counts == {"sm90": before["sm90"] + 1, "packed": before["packed"] + 1}
        assert fn.pack_launch_count == packs + 2
        want = mm.matmul_reference(a, b)
        if a.dtype == torch.int8:
            assert torch.equal(got, want) and torch.equal(aligned, want)
        else:
            bound = 1e-3 * want.abs().max().item()
            assert (got - want).abs().max().item() <= bound
            assert (aligned - want).abs().max().item() <= bound


def test_matmul_tensor_core_kernel_takes_more_columns_than_a_grid_axis(cuda):
    """N above 65,535 tiles of 64 columns: the tensor-core kernel folds its
    tiles onto one persistent grid, on both routes (a row-major int8 B is
    packed to (N, K) rows first: by the gathering path, as N is no multiple
    of 16)."""
    n = 65535 * 64 + 8
    a, w = _int8((2, 16), 81, cuda), _int8((n, 16), 82, cuda)
    routed = dict(mm.int8_matmul.route_counts)
    got = mm.int8_matmul(a, w.t())
    torch.cuda.synchronize()
    assert mm.int8_matmul.route_counts["sm90"] == routed["sm90"] + 1
    assert torch.equal(got, mm.matmul_reference(a, w.t()))
    paths = dict(mm.pack_k_major.path_counts)
    packed = mm.int8_matmul(a, w.t().contiguous())     # row-major int8 B
    torch.cuda.synchronize()
    assert mm.int8_matmul.route_counts["packed"] == routed["packed"] + 1
    assert mm.pack_k_major.path_counts["gather"] == paths["gather"] + 1
    assert torch.equal(packed, got)


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


def _vivit_state_dict(cfg, seed):
    """Seeded init (Flax's rules) with every LayerNorm and bias moved off its
    (1, 0) start, so each parameter has a gradient of its own."""
    from lipreading_video_generation_tpu_torch.models.vivit import ViViT
    from lipreading_video_generation_tpu_torch.core.prng import seeded

    sd = seeded(lambda: ViViT(cfg), seed).state_dict()
    g = torch.Generator().manual_seed(seed + 1)
    return {n: t + 0.05 * torch.randn(t.shape, generator=g) if t.ndim == 1 else t
            for n, t in sd.items()}


def _vivit_step(cfg, sd, batch, device):
    """Loss, logits, gradients and updated params of one ``train_step``."""
    from lipreading_video_generation_tpu_torch.pipelines import train_vivit as tv

    state = tv.create_state(cfg, device=device)
    state.model.load_state_dict(sd)
    seen = {}
    hook = state.model.register_forward_hook(lambda m, i, o: seen.update(logits=o.detach()))
    loss = tv.train_step(state, batch)["loss"].item()
    hook.remove()
    return (loss, seen["logits"].float().cpu(),
            {n: p.grad.float().cpu() for n, p in state.model.named_parameters()},
            {n: p.detach().cpu() for n, p in state.model.named_parameters()})


@pytest.mark.parametrize("dtype,route,tol", [("float32", "cuda_core", 1e-4),
                                             ("bfloat16", "sm90", 2e-2)])
def test_vivit_train_step_on_card_matches_cpu(cuda, dtype, route, tol):
    """One ``train_step`` at the ``ViViTConfig`` defaults, batch 16, card
    against CPU: K2 12 times by ``route``; loss and logits within ``tol``
    (relative, of max|ref|), each gradient within ``tol`` of its tensor's
    largest (the key third of each qkv bias, whose gradient is exactly 0,
    aside), the whole gradient within ``tol`` relative L2; the updated
    params within 2·lr, and off by more than 1e-6 only where the gradient is
    within ``tol`` of its tensor's largest of 0 (Adam's first step is about
    lr·sign(g), so only such a gradient may step the other way)."""
    from lipreading_video_generation_tpu_torch.core.config import ViViTConfig
    from lipreading_video_generation_tpu_torch.data.datasets import (
        WordClipSampler, synthetic_word_clips)

    cfg = ViViTConfig(num_classes=8, dtype=dtype)
    sd = _vivit_state_dict(cfg, 0)
    clips, labels = synthetic_word_clips(n=16, seed=1)
    batch = next(WordClipSampler(clips, labels).batches(16))
    before = dict(att.small_mha.route_counts)
    l_gpu, z_gpu, g_gpu, p_gpu = _vivit_step(cfg, sd, batch, cuda)
    took = {r: n - before[r] for r, n in att.small_mha.route_counts.items()}
    assert took == {r: (12 if r == route else 0) for r in took}
    l_cpu, z_cpu, g_cpu, p_cpu = _vivit_step(cfg, sd, batch, "cpu")
    assert abs(l_gpu - l_cpu) <= tol * abs(l_cpu)
    assert (z_gpu - z_cpu).abs().max() <= tol * z_cpu.abs().max()
    num = den = 0.0
    for n, w in g_cpu.items():
        keep = torch.ones(w.shape, dtype=torch.bool)
        if n.endswith("qkv.bias"):
            keep[w.shape[0] // 3:2 * w.shape[0] // 3] = False
        d = (g_gpu[n] - w)[keep]
        assert d.abs().max() <= tol * w[keep].abs().max(), n
        num += float((d.double() ** 2).sum())
        den += float((w[keep].double() ** 2).sum())
    assert math.sqrt(num / den) <= tol
    for n, w in p_cpu.items():
        d = (p_gpu[n] - w).abs()
        assert d.max() <= 2.02 * cfg.learning_rate, n
        g = g_cpu[n].abs()
        assert not ((d > 1e-6) & (g > tol * g.max())).any(), n


def test_small_mha_gradient_at_vivit_training_shapes_equals_einsum_autograd(cuda):
    """K2 under autograd on strided views of a (16, 80, 768) bf16 qkv, as
    each ViViT block passes them: its backward recomputes through
    ``_mha_einsum``, so the q/k/v gradients equal autograd through
    ``_mha_einsum`` bit for bit."""
    qkv = _uniform((16, 80, 768), -2, 2, 40, cuda, torch.bfloat16)
    g = _uniform((16, 80, 256), -1, 1, 41, cuda, torch.bfloat16)
    a, b = qkv.clone().requires_grad_(), qkv.clone().requires_grad_()
    routed = att.small_mha.route_counts["sm90"]
    out = att.small_mha(*a.chunk(3, dim=-1), 8)
    assert att.small_mha.route_counts["sm90"] == routed + 1
    (got,) = torch.autograd.grad(out, a, g)
    (want,) = torch.autograd.grad(att._mha_einsum(*b.chunk(3, dim=-1), 8, False), b, g)
    assert torch.equal(got, want)


def test_cli_train_vivit_on_card(cuda, capsys):
    """``train-vivit`` through ``cli.main`` on the card (its default): one
    epoch of 32 steps and 32 eval batches, K2 12 times each by the
    tensor-core route, then the ``best:`` line."""
    from lipreading_video_generation_tpu_torch import cli

    before = dict(att.small_mha.route_counts)
    assert cli.main(["train-vivit", "--steps", "32", "--set", "vivit.num_classes=8"]) == 0
    took = {r: n - before[r] for r, n in att.small_mha.route_counts.items()}
    assert took == {"sm90": 12 * 64, "cuda_core": 0}
    out = capsys.readouterr()
    assert [ln for ln in out.out.splitlines() if ln.startswith("best: ")]
    assert "[step 30]" in out.err


def test_lipread_e2e_run_on_card(cuda, tmp_path):
    """``lipreading_e2e.run`` on the card (its default) over 8 records fed
    from memory through ``read_frames``: K1 once a clip by the packed route;
    K2 by the tensor-core route in the bf16 ViViT (a multiple of its 2
    layers) and by the CUDA-core route in the float32 causal word LM, 2
    layers × (400 training steps + one beam level a word)."""
    from lipreading_video_generation_tpu_torch.core.config import Config, parse_overrides
    from lipreading_video_generation_tpu_torch.pipelines import lipreading_e2e as e2e

    rng = np.random.default_rng(0)
    words = ["HELLO", "WORLD", "AGAIN", "THERE", "GOOD", "NIGHT"]
    frames_of, n_words = {}, 0
    for i in range(8):
        d = tmp_path / f"spk{i}"
        d.mkdir()
        (d / "00001.mp4").write_bytes(b"")
        ws = list(rng.choice(words, 3))
        n_words += len(ws)
        (d / "00001.txt").write_text(
            f"Text:  {' '.join(ws)}\n\nConf: 4\n\nWORD START END SCORE\n"
            + "".join(f"{w} {0.2 * j:.2f} {0.2 * j + 0.2:.2f} 1.0\n" for j, w in enumerate(ws)))
        frames_of[str(d / "00001.mp4")] = rng.integers(0, 256, (16, 96, 96, 3), dtype=np.uint8)
    cfg = parse_overrides(Config(), ["vivit.hidden_size=64", "vivit.num_layers=2",
                                     "vivit.num_heads=4", "vivit.mlp_dim=64",
                                     "vivit.batch_size=4"])
    k1, k2 = dict(cl.clahe_cuda.route_counts), dict(att.small_mha.route_counts)
    _, stats = e2e.run(cfg, str(tmp_path), num_epochs=1,
                       read_frames=lambda p: (frames_of[p], 25.0))
    torch.cuda.synchronize()
    assert 0.0 <= stats["accuracy"] <= 1.0 and 0.0 <= stats["sentence_accuracy"] <= 1.0
    assert {r: n - k1[r] for r, n in cl.clahe_cuda.route_counts.items()} == {"packed": 8,
                                                                            "tiled": 0}
    took = {r: n - k2[r] for r, n in att.small_mha.route_counts.items()}
    assert took["cuda_core"] == 2 * (400 + n_words)
    assert took["sm90"] > 0 and took["sm90"] % 2 == 0


def _gan_states(cfg, devices, syncnet_wt):
    """Train states of ``train_gan`` on ``devices`` with the same weights
    (drawn once from seed 0 on the CPU)."""
    from lipreading_video_generation_tpu_torch.pipelines import train_gan as ttg

    ref = ttg.create_state(cfg, device="cpu")
    sds = [m.state_dict() for m in (ref.gen, ref.disc, ref.syncnet)]
    states = []
    for device in devices:
        state = ttg.create_state(cfg, syncnet_params=sds[2], device=device)
        state.gen.load_state_dict(sds[0])
        state.disc.load_state_dict(sds[1])
        state.syncnet_wt = syncnet_wt
        states.append(state)
    return states


def _grad_l2(a, b):
    """Relative L2 of ``a``'s whole gradient against ``b``'s (two modules of
    one kind), the conv biases before a GroupNorm of one channel a group
    (gradient 0 in exact arithmetic, noise on either side) aside."""
    zero = {f"{n}.conv.bias" for n, mod in b.named_modules()
            if getattr(mod, "norm", None) is not None
            and mod.norm.groups == mod.norm.weight.numel()}
    num = den = 0.0
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        if n not in zero:
            num += float(((p.grad.cpu() - q.grad).double() ** 2).sum())
            den += float((q.grad.double() ** 2).sum())
    return math.sqrt(num / den)


def _plant_gan_fault(monkeypatch, fault, state, prep):
    """A fault in ``train_gan``'s step on ``state``: ``l1_weight`` weights
    L1 by 1 − syncnet_wt (disc_wt left out); ``sync`` leaves the sync loss
    out of G's gradient (its value kept); ``order`` makes D's fake batch with
    the updated generator."""
    from lipreading_video_generation_tpu_torch.pipelines import losses
    from lipreading_video_generation_tpu_torch.pipelines import train_gan as ttg

    if fault == "l1_weight":
        real = losses.generator_loss

        def l1_weight(recon, sync, perceptual, lip, syncnet_wt, disc_wt, lip_weight):
            total, terms = real(recon, sync, perceptual, lip, syncnet_wt, disc_wt, lip_weight)
            return total + disc_wt * recon, terms

        monkeypatch.setattr(losses, "generator_loss", l1_weight)
    elif fault == "sync":
        real = ttg._sync_loss
        monkeypatch.setattr(ttg, "_sync_loss", lambda *a: real(*a).detach())
    else:
        calls = []

        def fake_from_new_gen(module, args):
            calls.append(1)
            if len(calls) == 3:
                with torch.no_grad():
                    return (state.gen(prep["indiv_mels"].to(state.device),
                                      prep["x"].to(state.device)),)

        state.disc.register_forward_pre_hook(fake_from_new_gen)


@pytest.mark.parametrize("syncnet_wt,tol_l2,faults", [
    (0.0, {"gen": 1e-2, "disc": 1e-2}, {"l1_weight": "gen", "order": "disc"}),
    (0.03, {"gen": 5e-2, "disc": 1e-2}, {"sync": "gen", "order": "disc"}),
])
def test_gan_train_step_on_card_matches_cpu(cuda, monkeypatch, syncnet_wt, tol_l2, faults):
    """One float32 G+D step at width 0.25, batch 2, the sync gate shut and
    open, card (cuDNN without TF32) against CPU on the same prepared batch
    (the CPU's ``prepare_batch``): every loss within 1e-4 relative, each
    network's whole gradient within ``tol_l2[net]`` relative L2
    (``_grad_l2``). Each limit lies between that sound reading and the
    reading of each fault planted on the card's side (``_plant_gan_fault``),
    which must exceed it. No hand-written kernel runs. Prints the
    readings."""
    from lipreading_video_generation_tpu_torch.core.config import AudioConfig, GanConfig
    from lipreading_video_generation_tpu_torch.data import datasets
    from lipreading_video_generation_tpu_torch.pipelines import train_gan as ttg

    cfg = GanConfig(model_width=0.25, batch_size=2, dtype="float32")
    clips = datasets.synthetic_av_clips(n_clips=3, frames=30, img=96, seed=0)
    batch = datasets.GanWindowSampler(clips, 5, seed=0).sample_batch(2)
    prep = ttg.prepare_batch(batch, cfg, AudioConfig(), "cpu")
    monkeypatch.setattr(ttg, "prepare_batch", lambda b, c, a, device: {
        k: v.to(device) for k, v in prep.items()})
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    card, cpu, *planted = _gan_states(cfg, (cuda, "cpu") + (cuda,) * len(faults), syncnet_wt)
    launches = (cl.clahe_cuda.launch_count, mm.int8_matmul.launch_count,
                att.small_mha.launch_count)
    m_card = ttg.train_step(card, batch, cfg)
    torch.cuda.synchronize()
    assert (cl.clahe_cuda.launch_count, mm.int8_matmul.launch_count,
            att.small_mha.launch_count) == launches
    m_cpu = ttg.train_step(cpu, batch, cfg)
    for k, v in m_cpu.items():
        assert abs(m_card[k].item() - v.item()) <= 1e-4 * abs(v.item()) + 1e-7, k
    sound = {net: _grad_l2(getattr(card, net), getattr(cpu, net)) for net in ("gen", "disc")}
    readings = {}
    for (fault, net), state in zip(faults.items(), planted):
        with monkeypatch.context() as mp:
            _plant_gan_fault(mp, fault, state, prep)
            ttg.train_step(state, batch, cfg)
        readings[fault] = _grad_l2(getattr(state, net), getattr(cpu, net))
    print(f"syncnet_wt {syncnet_wt}: card vs CPU {sound}; planted faults {readings} "
          f"(limit {tol_l2})")
    assert all(v <= tol_l2[net] for net, v in sound.items()), sound
    assert all(readings[f] > tol_l2[net] for f, net in faults.items()), readings


def test_contrast_boost_on_card_runs_k1_tiled(cuda):
    """Whole 360×640 frames: one K1 launch by the tiled route; its L channel
    within K1's bound of the plain version (1 + 1e-2 levels: the clip limit
    is no integer count here)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 256, (2, 360, 640, 3), dtype=np.uint8)).to(cuda)
    before = dict(cl.clahe_cuda.route_counts)
    out = im.contrast_boost(x)
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in cl.clahe_cuda.route_counts.items()} == {
        "packed": 0, "tiled": 1}
    assert out.dtype == torch.uint8 and out.shape == x.shape
    L = im.rgb_to_lab(x)[..., 0]
    assert (im.clahe(L) - cl.clahe_reference(L.cpu()).to(cuda)).abs().max() <= 1.01


def test_lipsync_video_int8_on_card(cuda, tmp_path):
    """``lipsync_video`` on the card (its default) from frames in memory and
    a 1.2 s wav at the generator's default width: 30 frames, one batch, K6
    once per convolution (51) by the tensor-core route in dynamic int8."""
    from lipreading_video_generation_tpu_torch.core.config import GanConfig
    from lipreading_video_generation_tpu_torch.core.prng import seeded
    from lipreading_video_generation_tpu_torch.data import video as tvideo
    from lipreading_video_generation_tpu_torch.models.generator import TalkingFaceGenerator
    from lipreading_video_generation_tpu_torch.models.s3fd import S3FD
    from lipreading_video_generation_tpu_torch.pipelines import inference as tinf

    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (30, 360, 640, 3), dtype=np.uint8)
    tvideo.save_wav(str(tmp_path / "a.wav"), rng.standard_normal(19200).astype(np.float32))
    gen = seeded(TalkingFaceGenerator, 0).state_dict()
    kept = {}
    before = dict(mm.int8_matmul.route_counts)
    res = tinf.lipsync_video(gen, seeded(S3FD, 0), "in-memory", str(tmp_path / "a.wav"),
                             str(tmp_path / "o.mp4"), GanConfig(serve_int8=True),
                             read_frames=lambda p, *conditioning: (frames, 25.0),
                             write_video=lambda p, f, fps: kept.update(frames=f))
    assert res.frames.shape == frames.shape and kept["frames"] is res.frames and not res.muxed
    assert {r: n - before[r] for r, n in mm.int8_matmul.route_counts.items()} == {
        "sm90": 51, "packed": 0}


def test_cli_gan_chain_on_card(cuda, tmp_path, capsys):
    """train-syncnet → train-gan → eval-gan through ``cli.main`` on the card
    (its default) at width 0.25."""
    from lipreading_video_generation_tpu_torch import cli

    tiny = ["--set", "gan.model_width=0.25", "--set", "gan.batch_size=4"]
    sync, ck = str(tmp_path / "s.pt"), str(tmp_path / "gan")
    assert cli.main(["train-syncnet", "--synthetic", "--steps", "4", "--out", sync] + tiny) == 0
    assert cli.main(["train-gan", "--synthetic", "--steps", "4", "--syncnet-checkpoint", sync,
                     "--checkpoint-dir", ck, "--set", "gan.eval_interval=2",
                     "--set", "gan.checkpoint_interval=4"] + tiny) == 0
    assert cli.main(["eval-gan", "--checkpoint", ck, "--synthetic", "--batches", "2",
                     "--syncnet-checkpoint", sync] + tiny) == 0
    out = capsys.readouterr().out
    vals = {ln.split(":")[0]: float(ln.split(":")[1]) for ln in out.splitlines()
            if ln.startswith("eval/")}
    assert len(vals) == 4 and all(math.isfinite(v) for v in vals.values())


# the data feed (ROADMAP §1 item 6): a 64x64 U-Net with attention at ds 1
# and 2, bf16, so K3-K5 take their tensor-core route
_FEED_SET = ["--set", "diffusion.im_size=64", "--set", "diffusion.base_channels=32",
             "--set", "diffusion.batch_size=4", "--set", "diffusion.num_timesteps=50"]


def test_records_stream_by_the_native_route_into_training_on_card(cuda, tmp_path):
    """Diffusion records packed on the host stream through the native
    loader into train steps on the card: K3, K4 and K5 by ``sm90``."""
    from lipreading_video_generation_tpu_torch import cli
    from lipreading_video_generation_tpu_torch.data import records as trec

    recs, ck = str(tmp_path / "recs"), str(tmp_path / "ck")
    assert cli.main(["pack-diffusion-records", "--synthetic", "--out", recs, "--num-records",
                     "8"] + _FEED_SET) == 0
    native = trec.iter_record_batches.route_counts["native"]
    before = {k: dict(f.route_counts) for k, f in (("k3", att.flash_attention),
                                                    ("k4", att.flash_bwd_dkv),
                                                    ("k5", att.flash_bwd_dq))}
    assert cli.main(["train-diffusion", "--records-root", recs, "--steps", "3",
                     "--steps-per-dispatch", "2", "--checkpoint-dir", ck,
                     "--checkpoint-every", "3"] + _FEED_SET) == 0
    assert trec.iter_record_batches.route_counts["native"] == native + 1
    for k, f in (("k3", att.flash_attention), ("k4", att.flash_bwd_dkv),
                 ("k5", att.flash_bwd_dq)):
        assert f.route_counts["sm90"] > before[k]["sm90"]
        assert f.route_counts["cuda_core"] == before[k]["cuda_core"]


def test_cli_sample_diffusion_on_card_matches_direct_sample(cuda, tmp_path):
    """``sample-diffusion --frames 3`` on the card (its default): the PNGs,
    read back with chip_smoke's zlib decoder, equal ``sample_video`` on the same seeded model,
    inputs and generator seed within a level; K3 by ``sm90``."""
    from chip_smoke import read_png
    from lipreading_video_generation_tpu_torch import cli
    from lipreading_video_generation_tpu_torch.core.config import DiffusionConfig
    from lipreading_video_generation_tpu_torch.core.prng import seeded
    from lipreading_video_generation_tpu_torch.models.unet_audio import UNetAudio
    from lipreading_video_generation_tpu_torch.pipelines import sample_diffusion as tsd

    out = str(tmp_path / "clip")
    sm90 = att.flash_attention.route_counts["sm90"]
    assert cli.main(["sample-diffusion", "--frames", "3", "--ddim-steps", "4", "--seed", "1",
                     "--out", out] + _FEED_SET) == 0
    assert att.flash_attention.route_counts["sm90"] > sm90
    got = np.stack([read_png(f"{out}.{j:04d}.png") for j in range(3)])
    cfg = DiffusionConfig(im_size=64, base_channels=32, batch_size=4, num_timesteps=50)
    rng = np.random.default_rng(1)         # the CLI's draws without --cond-video
    cond = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    windows = rng.standard_normal((3, cfg.audio_samples)).astype(np.float32)
    model = seeded(lambda: UNetAudio(cfg), 1).to(cuda).eval()
    want = tsd.sample_video(model, cond, windows, cfg, num_inference_steps=4,
                            generator=torch.Generator(cuda).manual_seed(1)).cpu().numpy()
    assert got.shape == want.shape == (3, 64, 64, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_prefetch_to_device_hands_out_card_tensors_equal_to_the_host_batches(cuda):
    from lipreading_video_generation_tpu_torch.data.loader import prefetch_to_device

    rng = np.random.default_rng(0)
    host = [{"frames": rng.integers(0, 256, (4, 8, 8, 3), dtype=np.uint8),
             "audio": rng.standard_normal((4, 100)).astype(np.float32)} for _ in range(5)]
    it = iter(host)
    got = list(prefetch_to_device(lambda: next(it), depth=2))
    assert len(got) == 5
    for g, h in zip(got, host):
        for k in h:
            assert g[k].is_cuda and g[k].dtype == torch.from_numpy(h[k]).dtype
            np.testing.assert_array_equal(g[k].cpu().numpy(), h[k])


# --- the pretrained encoders' shapes -----------------------------------------

@pytest.mark.parametrize("b,s,e,h,causal,dtype,route", [
    (8, 12, 768, 12, False, torch.bfloat16, "sm90"),       # wav2vec2 at 4,000 samples
    (32, 5, 768, 12, False, torch.float32, "cuda_core"),   # AV-HuBERT, T 5
    (32, 5, 256, 4, False, torch.float32, "cuda_core"),    # the conformer encoder
    (16, 48, 256, 4, True, torch.float32, "cuda_core"),    # the expert's causal decoder
])
def test_small_mha_at_the_pretrained_encoders_shapes(cuda, b, s, e, h, causal, dtype, route):
    """K2 at the shapes the pretrained encoders give it, with q/k/v as each
    model's projections hand them over (three Linear outputs; the decoder's
    chunks of one fused qkv): the route, 2e-2 (bf16) / 1e-5 (float32) of
    ``_mha_einsum``, and in float32 the gradient of the einsum VJP."""
    if causal:
        q, k, v = _uniform((b, s, 3 * e), -2, 2, 110, cuda, dtype).chunk(3, dim=-1)
    else:
        q, k, v = (_uniform((b, s, e), -2, 2, 111 + i, cuda, dtype) for i in range(3))
    assert att.mha_route(h, s, s, e, dtype, q.device) == "small_mha"
    routed = att.small_mha.route_counts[route]
    got = att.mha(q, k, v, h, causal)
    torch.cuda.synchronize()
    assert att.small_mha.route_counts[route] == routed + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    want = att._mha_einsum(q, k, v, h, causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.float32:
        qs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        cot = _uniform((b, s, e), -1, 1, 115, cuda)
        (att.mha(*qs, h, causal) * cot).sum().backward()
        ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        (att._mha_einsum(*ref, h, causal) * cot).sum().backward()
        for t, r in zip(qs, ref):
            torch.testing.assert_close(t.grad, r.grad, rtol=1e-4, atol=1e-4)


def test_wav2vec2_on_a_long_wave_runs_k3(cuda):
    """The base encoder's attention on a 10.24 s wave (T′ = 511 > 128) is
    the flash forward K3, by the tensor-core route in bf16, within 1e-2 of
    ``flash_reference`` rounding P to bf16."""
    from lipreading_video_generation_tpu_torch.models.wav2vec2 import num_frames

    s = num_frames(163840)
    assert s == 511 and att.mha_route(12, s, s, 768, torch.bfloat16, cuda) == "flash"
    q, k, v = (_uniform((2, s, 768), -2, 2, 120 + i, cuda, torch.bfloat16) for i in range(3))
    routed = att.flash_attention.route_counts["sm90"]
    got = att.mha(q, k, v, 12)
    torch.cuda.synchronize()
    assert att.flash_attention.route_counts["sm90"] == routed + 1

    def split(x):
        return x.reshape(2, s, 12, 64).transpose(1, 2)

    want = att.flash_reference(split(q), split(k), split(v), p_dtype=torch.bfloat16)[0]
    torch.testing.assert_close(got.float(), want.transpose(1, 2).reshape(2, s, 768).float(),
                               rtol=1e-2, atol=1e-2)


def test_pretrained_encoders_on_card_match_cpu(cuda, monkeypatch):
    """A small wav2vec2, AV-HuBERT and seq2seq expert in float32 (K2 by
    cuda_core, one launch a layer) on the card against the same modules on
    the CPU: within 1e-4 (features) and 1e-5 relative (the loss). cuDNN's
    TF32 is off, as in the file's other float32 card-vs-CPU tests: the
    wav2vec2 feature extractor's and AV-HuBERT's convolutions go through
    cuDNN, which would otherwise run them in TF32 (about three decimal
    digits)."""
    from lipreading_video_generation_tpu_torch.core.prng import seeded
    from lipreading_video_generation_tpu_torch.models.avhubert import AVHubertVideoEncoder
    from lipreading_video_generation_tpu_torch.models.lip_expert import seq2seq_expert_loss
    from lipreading_video_generation_tpu_torch.models.wav2vec2 import Wav2Vec2Encoder
    from lipreading_video_generation_tpu_torch.pipelines.train_lip_expert import default_expert

    rng = np.random.default_rng(0)
    wave = torch.from_numpy(rng.standard_normal((2, 4000)).astype(np.float32))
    video = torch.from_numpy(rng.standard_normal((2, 5, 88, 88, 1)).astype(np.float32))
    rgb = torch.from_numpy(rng.uniform(0, 255, (2, 5, 96, 96, 3)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(2, 30, (2, 48)).astype(np.int64))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cases = [(seeded(lambda: Wav2Vec2Encoder(embed_dim=128, num_layers=2, num_heads=2,
                                            ffn_dim=256), 0), (wave,)),
             (seeded(lambda: AVHubertVideoEncoder(embed_dim=128, num_layers=2, num_heads=2,
                                                  ffn_dim=256, resnet_base=8), 1), (video,))]
    for model, args in cases:
        with torch.no_grad():
            want = model.eval()(*args)
            before = att.small_mha.route_counts["cuda_core"]
            got = model.to(cuda)(*(a.to(cuda) for a in args)).cpu()
        assert att.small_mha.route_counts["cuda_core"] == before + 2
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    expert = seeded(lambda: default_expert(embed_dim=64, stem_base=8), 2)
    want = seq2seq_expert_loss(expert, rgb, tokens)
    got = seq2seq_expert_loss(expert.to(cuda), rgb.to(cuda), tokens.to(cuda))
    torch.testing.assert_close(got.cpu(), want.detach(), rtol=1e-5, atol=1e-6)


# --- the DenseNet feature path -----------------------------------------------

def test_small_mha_at_the_feature_transformer_shape(cuda):
    """K2 as the FeatureTransformer at its defaults calls it: float32 q/k/v
    slices of one (64, 5, 3072) qkv tensor, 2 heads of 512: the CUDA-core
    route, within 1e-5 of ``_mha_einsum``, the einsum VJP's gradient within
    1e-4."""
    q, k, v = _uniform((64, 5, 3 * 1024), -2, 2, 130, cuda).chunk(3, dim=-1)
    assert att.mha_route(2, 5, 5, 1024, torch.float32, q.device) == "small_mha"
    routed = att.small_mha.route_counts["cuda_core"]
    got = att.mha(q, k, v, 2)
    torch.cuda.synchronize()
    assert att.small_mha.route_counts["cuda_core"] == routed + 1
    torch.testing.assert_close(got, att._mha_einsum(q, k, v, 2, False), rtol=1e-5, atol=1e-5)
    qs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    cot = _uniform((64, 5, 1024), -1, 1, 131, cuda)
    (att.mha(*qs, 2) * cot).sum().backward()
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    (att._mha_einsum(*ref, 2, False) * cot).sum().backward()
    for t, r in zip(qs, ref):
        torch.testing.assert_close(t.grad, r.grad, rtol=1e-4, atol=1e-4)


def test_densenet_on_card_matches_cpu(cuda, monkeypatch):
    """DenseNet121 at full width in float32 (cuDNN without TF32) on the card
    against the CPU on the same seeded weights: the features of 4 frames of
    64×64 within 1e-3 of the largest, and ``embed_frames`` likewise, zero
    for padded frames."""
    from lipreading_video_generation_tpu_torch.core.prng import seeded
    from lipreading_video_generation_tpu_torch.models.densenet import DenseNet121
    from lipreading_video_generation_tpu_torch.pipelines import feature_extraction as tfx

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    sd = seeded(DenseNet121, 0).state_dict()
    rng = np.random.default_rng(0)
    for name, v in sd.items():          # BatchNorm away from its init, where a swap shows
        if name.endswith(("running_mean", "bias")):
            sd[name] = torch.from_numpy(0.1 * rng.standard_normal(v.shape).astype(np.float32))
        elif name.endswith("running_var"):
            sd[name] = torch.from_numpy((0.5 + rng.uniform(0, 1, v.shape)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-2, 2, (4, 64, 64, 3)).astype(np.float32))
    model = DenseNet121()
    model.load_state_dict(sd)
    with torch.no_grad():
        want = model.eval()(x)
        got = model.to(cuda)(x.to(cuda)).cpu()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-3
    clips = rng.integers(1, 256, (2, 5, 32, 32, 1), dtype=np.uint8)
    clips[1, 3:] = 0
    got = tfx.embed_frames(sd, clips, batch_frames=4, device=cuda)
    want = tfx.embed_frames(sd, clips, batch_frames=4, device="cpu")
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
    assert np.abs(got[1, 3:]).max() == 0.0


def test_cli_feature_path_on_card(cuda, tmp_path, capsys):
    """``port-densenet --selftest`` and ``train-feature-transformer
    --synthetic --densenet-checkpoint`` on the card: K2 by cuda_core exactly
    twice a step (2 layers) and twice in the validation eval."""
    import json

    from lipreading_video_generation_tpu_torch import cli

    art = str(tmp_path / "densenet.pt")
    assert cli.main(["port-densenet", "--selftest", "--out", art]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["feature_l2"] > 0
    before = dict(att.small_mha.route_counts)
    assert cli.main(["train-feature-transformer", "--synthetic", "--max-clips", "40",
                     "--densenet-checkpoint", art, "--set", "feature_transformer.num_epochs=3",
                     "--set", "feature_transformer.num_classes=4"]) == 0
    torch.cuda.synchronize()
    took = {r: n - before[r] for r, n in att.small_mha.route_counts.items() if n != before[r]}
    assert took == {"cuda_core": 2 * (3 * 1 + 1)}       # 34 train clips: one step of 34 an epoch
    assert "val accuracy=" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# multi-GPU parallelism on one card


_DIFF = dict(im_size=16, base_channels=32, channel_mult=(1, 2), num_res_blocks=1,
             attention_resolutions=(1, 2), num_heads=2, time_embed_dim=32,
             audio_embed_dim=32, audio_proj_dim=8, im_cond_channels=4,
             audio_samples=800, num_timesteps=50, dropout=0.0, dtype="bfloat16")


def _diff_inputs(seed, b=4):
    rng = np.random.default_rng(seed)
    batch = {"target_frame": rng.integers(0, 256, (b, 16, 16, 3), dtype=np.uint8),
             "cond_frame": rng.integers(0, 256, (b, 16, 16, 3), dtype=np.uint8),
             "audio": rng.standard_normal((b, 800)).astype(np.float32)}
    return batch, (rng.integers(0, 50, b), rng.standard_normal((b, 16, 16, 3)).astype(np.float32))


def test_nccl_world_size_one_mesh_gives_mesh_none_bits(cuda, tmp_path):
    """A process group of one under NCCL: two diffusion steps and a ViViT
    request through ``build_mesh()`` (gradient all-reduce, gathers) equal
    ``mesh_spec=None``'s bit for bit."""
    import torch.distributed as dist

    from lipreading_video_generation_tpu_torch.core.config import DiffusionConfig, ViViTConfig
    from lipreading_video_generation_tpu_torch.core.prng import seeded
    from lipreading_video_generation_tpu_torch.models.vivit import ViViT
    from lipreading_video_generation_tpu_torch.parallel import distributed, mesh as pmesh
    from lipreading_video_generation_tpu_torch.pipelines import train_diffusion as ttd
    from lipreading_video_generation_tpu_torch.pipelines import train_vivit as ttv

    cfg = DiffusionConfig(**_DIFF)
    steps = [_diff_inputs(s) for s in (1, 2)]
    vivit = seeded(lambda: ViViT(ViViTConfig(num_layers=2, num_classes=8)), 0).to(cuda).eval()
    clips = np.random.default_rng(3).integers(0, 256, (5, 5, 32, 32, 1), dtype=np.uint8)

    def run(spec):
        state = pmesh.shard_state(spec, ttd.create_state(cfg, seed=0, device=cuda))
        for batch, (t, noise) in steps:
            pmesh.run_sharded(spec, ttd.train_step, state, batch, cfg, t, noise)
        return state.model.state_dict(), ttv.predict_sharded(vivit, clips, mesh_spec=spec)

    want_params, want_logp = run(None)
    distributed.initialize(rank=0, world_size=1, store=dist.FileStore(str(tmp_path / "s"), 1))
    try:
        spec = pmesh.build_mesh()
        assert dist.get_backend() == "nccl" and not pmesh.is_degenerate(spec)
        got_params, got_logp = run(spec)
    finally:
        distributed.shutdown()
    assert all(torch.equal(got_params[k], want_params[k]) for k in want_params)
    assert torch.equal(got_logp, want_logp)


def test_two_gloo_ranks_diffusion_step_on_one_card(cuda, tmp_path):
    """Two gloo ranks sharing the card (NCCL refuses two ranks on one
    device): a data-parallel bf16 diffusion step through K3-K5, the ranks'
    params bit-equal, ZeRO-1 bit-equal to plain data parallelism."""
    import torch_parallel_tasks as tasks
    from torch_parallel_tasks import LocalGroup

    from lipreading_video_generation_tpu_torch.core.config import DiffusionConfig
    from lipreading_video_generation_tpu_torch.core.prng import seeded
    from lipreading_video_generation_tpu_torch.models.unet_audio import UNetAudio

    params = {k: v.numpy() for k, v in seeded(lambda: UNetAudio(DiffusionConfig(**_DIFF)),
                                                0).state_dict().items()}
    batch, draw = _diff_inputs(4)
    with LocalGroup(2, str(tmp_path / "store"), device="cuda:0", backend="gloo") as group:
        plain = group.run(tasks.diffusion_dp, _DIFF, params, [batch] * 2, [draw] * 2, {},
                          None, "cuda:0")
        z1 = group.run(tasks.diffusion_dp, _DIFF, params, [batch] * 2, [draw] * 2,
                       {"zero1": True, "zero1_min_size": 0}, None, "cuda:0")
    for k in plain[0]["params"]:
        assert np.array_equal(plain[0]["params"][k], plain[1]["params"][k]), k
        assert np.array_equal(plain[0]["params"][k], z1[0]["params"][k]), k
    assert np.isfinite(plain[0]["losses"]).all()


def test_two_gloo_ranks_tensor_parallel_int8_frames_on_one_card(cuda, tmp_path):
    """Two gloo ranks sharing the card as two model ranks (tensor
    parallelism at the default threshold: the generator's two 512x1024x3x3
    decoder convs column-parallel): int8 ``generate_frames`` at width 1.0
    gives one process's frames, 0 levels apart (K6 is exact in integers
    and its scales are per output channel)."""
    import torch_parallel_tasks as tasks
    from torch_parallel_tasks import LocalGroup

    from lipreading_video_generation_tpu_torch.core.prng import seeded
    from lipreading_video_generation_tpu_torch.models.generator import TalkingFaceGenerator

    params = {k: v.numpy() for k, v in seeded(lambda: TalkingFaceGenerator(width=1.0),
                                                0).state_dict().items()}
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (6, 120, 160, 3), dtype=np.uint8)
    boxes = np.tile(np.asarray([10.0, 106.0, 30.0, 126.0], np.float32), (6, 1))
    mels = rng.standard_normal((6, 80, 16)).astype(np.float32)
    args = (params, frames, boxes, mels, 1.0, {"serve_int8": True}, 4)
    want = tasks.generate_frames_dp(*args, None, "cuda:0")
    with LocalGroup(2, str(tmp_path / "store"), device="cuda:0", backend="gloo") as group:
        got = group.run(tasks.generate_frames_dp, *args, {"model_parallel": 2}, "cuda:0")
    assert got[0].shape == want.shape == frames.shape
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[1], want)


def test_initialize_refuses_a_local_rank_without_a_card(cuda, monkeypatch):
    from lipreading_video_generation_tpu_torch.parallel import distributed

    monkeypatch.setenv("LOCAL_RANK", str(torch.cuda.device_count()))
    with pytest.raises(RuntimeError, match="has no card"):
        distributed.initialize(rank=0, world_size=1, init_method="tcp://localhost:1")
