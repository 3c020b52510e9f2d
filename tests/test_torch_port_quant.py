"""The port's int8 serving ops against the JAX package's, on the same numpy
inputs: the quantisers, the integer accumulators (equal), ``int8_conv`` and
``int8_dense`` (rtol/atol 1e-5: the dequantisation's float32 rounding), the
plain matmul behind the kernel K6 against ``lax.dot_general`` and against
the TPU script's ``mm_kernel`` in Pallas interpret mode, and the rerouting
rules of ``int8_serving``. On the CPU every integer product goes through
``matmul_reference``; the kernel itself is held on the card
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax import linen as fnn
from jax.experimental import pallas as pl
import torch
from torch import nn

from lipreading_video_generation_tpu.ops import quant as jq
from lipreading_video_generation_tpu_torch.models import layers as tl
from lipreading_video_generation_tpu_torch.ops import matmul_cuda as tmm
from lipreading_video_generation_tpu_torch.ops import quant as tq

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("shape,axis", [((3, 3, 5, 7), -1), ((64, 32), -1), ((32, 64), 0)])
def test_quantize_channelwise_matches_jax(shape, axis):
    w = _rand(shape, 0)
    w[..., 0] = 0.0 if axis == -1 else w[..., 0]      # an all-zero channel: scale 1e-8/127
    want_q, want_s = jq.quantize_channelwise(jnp.asarray(w), axis)
    got_q, got_s = tq.quantize_channelwise(torch.from_numpy(w), axis)
    assert got_q.dtype == torch.int8
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-7, atol=0)


@pytest.mark.parametrize("scale", [None, 0.031])
def test_activation_quantisers_match_jax(scale):
    x = _rand((2, 9, 8, 5), 1, 3.0)
    if scale is None:
        want_q, want_s = jq._dynamic_quantize(jnp.asarray(x))
        got_q, got_s = tq._dynamic_quantize(torch.from_numpy(x))
    else:
        want_q, want_s = jq._quantize_with_scale(jnp.asarray(x), scale)
        got_q, got_s = tq._quantize_with_scale(torch.from_numpy(x), scale)
        assert np.abs(np.asarray(want_q)).max() == 127          # the static scale clips
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_allclose(float(got_s), float(want_s), rtol=1e-7)


def _jax_conv_acc(x, w, strides, padding, act_scale):
    """JAX's integer accumulator of ``int8_conv`` (its first half)."""
    w_q, _ = jq.quantize_channelwise(jnp.asarray(w), axis=-1)
    x_q, _ = (jq._quantize_with_scale(jnp.asarray(x), act_scale) if act_scale is not None
              else jq._dynamic_quantize(jnp.asarray(x)))
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    return np.asarray(jax.lax.conv_general_dilated(
        x_q, w_q, strides, padding, dimension_numbers=dn, preferred_element_type=jnp.int32))


def _port_conv_acc(x, w, strides, padding, act_scale):
    xt = torch.from_numpy(x)
    w_nk, _ = tq._conv_weight(torch.from_numpy(w))
    q, _ = tq._quantized_values(xt, act_scale)
    pads = tq._explicit_padding(padding, x.shape[1:3], w.shape[:2], strides)
    cols, (b, oh, ow) = tq._im2col(q, w.shape[0], w.shape[1], strides, pads)
    assert cols.dtype == torch.int8 and cols.shape[1] % 16 == 0
    return tmm.int8_matmul(cols, w_nk.t()).view(b, oh, ow, -1).numpy()


_CONVS = [
    # x shape, kernel shape, strides, padding, bias, static scale
    ((2, 8, 8, 5), (3, 3, 5, 7), (2, 2), ((1, 1), (1, 1)), True, None),
    ((2, 20, 9, 4), (3, 3, 4, 6), (3, 1), ((1, 1), (1, 1)), True, None),
    ((2, 12, 12, 6), (7, 7, 6, 16), (1, 1), ((3, 3), (3, 3)), False, None),
    ((3, 5, 5, 16), (3, 3, 16, 8), (1, 1), ((0, 0), (0, 0)), True, 0.02),
    ((2, 6, 7, 32), (1, 1, 32, 3), (1, 1), ((0, 0), (0, 0)), True, None),      # no copy
    ((2, 6, 7, 5), (1, 1, 5, 3), (1, 1), ((0, 0), (0, 0)), False, 0.05),
    ((2, 9, 8, 3), (3, 3, 3, 4), (2, 2), "SAME", False, None),
    ((1, 9, 8, 3), (3, 2, 3, 4), (1, 1), "VALID", True, None),
    ((2, 10, 6, 4), (3, 3, 4, 5), (2, 1), ((2, 0), (1, 2)), True, 0.04),
]


@pytest.mark.parametrize("xs,ws,strides,padding,bias,scale", _CONVS)
def test_int8_conv_matches_jax(xs, ws, strides, padding, bias, scale):
    x, w = _rand(xs, 2), _rand(ws, 3)
    b = _rand((ws[-1],), 4) if bias else None
    np.testing.assert_array_equal(_port_conv_acc(x, w, strides, padding, scale),
                                  _jax_conv_acc(x, w, strides, padding, scale))
    want = jq.int8_conv(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
                        strides, padding, act_scale=scale)
    before = tmm.int8_matmul.launch_count
    got = tq.int8_conv(torch.from_numpy(x), torch.from_numpy(w),
                       None if b is None else torch.from_numpy(b), strides, padding,
                       act_scale=scale)
    assert tmm.int8_matmul.launch_count == before        # no kernel launch on the CPU
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("xs,ws,bias,scale", [((4, 64), (64, 32), True, None),
                                              ((2, 5, 24), (24, 7), False, None),
                                              ((3, 16), (16, 9), True, 0.02)])
def test_int8_dense_matches_jax(xs, ws, bias, scale):
    x, w = _rand(xs, 5), _rand(ws, 6, 0.1)
    b = _rand((ws[-1],), 7, 0.01) if bias else None
    # the integers
    jw, _ = jq.quantize_channelwise(jnp.asarray(w), -1)
    jx, _ = (jq._dynamic_quantize(jnp.asarray(x)) if scale is None
             else jq._quantize_with_scale(jnp.asarray(x), scale))
    want_acc = jax.lax.dot_general(jx, jw, (((x.ndim - 1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
    tw, _ = tq.quantize_channelwise(torch.from_numpy(w), -1)
    tx, _ = tq._quantized_values(torch.from_numpy(x), scale)
    got_acc = tmm.int8_matmul(tx.to(torch.int8).view(-1, xs[-1]), tw)
    np.testing.assert_array_equal(got_acc.numpy().reshape(np.shape(want_acc)),
                                  np.asarray(want_acc))
    want = jq.int8_dense(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
                         act_scale=scale)
    got = tq.int8_dense(torch.from_numpy(x), torch.from_numpy(w),
                        None if b is None else torch.from_numpy(b), act_scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _mm_kernel(a_ref, b_ref, o_ref, acc_dtype):
    """The body of scripts/microbench_int8_pallas.py::mm_kernel (the script
    itself sets up a device compile cache when imported, so it is not)."""
    k = pl.program_id(2)

    @pl.when(k == 0)
    def _():
        o_ref[...] = jnp.zeros_like(o_ref)

    o_ref[...] += jax.lax.dot_general(a_ref[...], b_ref[...], (((1,), (0,)), ((), ())),
                                      preferred_element_type=acc_dtype)


def _pallas_mm(a, b, acc_dtype, block=32):
    m, k = a.shape
    n = b.shape[1]
    return pl.pallas_call(
        functools.partial(_mm_kernel, acc_dtype=acc_dtype),
        grid=(m // block, n // block, k // block),
        in_specs=[pl.BlockSpec((block, block), lambda i, j, kk: (i, kk)),
                  pl.BlockSpec((block, block), lambda i, j, kk: (kk, j))],
        out_specs=pl.BlockSpec((block, block), lambda i, j, kk: (i, j)),
        out_shape=jax.ShapeDtypeStruct((m, n), acc_dtype), interpret=True)(a, b)


def test_matmul_reference_int8_matches_the_tpu_kernel_math():
    rng = np.random.default_rng(8)
    a = rng.integers(-127, 128, (64, 96)).astype(np.int8)
    b = rng.integers(-127, 128, (96, 32)).astype(np.int8)
    want = jax.lax.dot_general(jnp.asarray(a), jnp.asarray(b), (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    got = tmm.matmul_reference(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        _pallas_mm(jnp.asarray(a), jnp.asarray(b), jnp.int32)))
    np.testing.assert_array_equal(tmm.int8_matmul(torch.from_numpy(a), torch.from_numpy(b)),
                                  got)


def test_matmul_reference_bf16_matches_the_tpu_kernel_math():
    """float32 sums of exact bf16 products in another order: 1e-3 of the
    largest |C| (what the card's check holds K6 to) is far more than the
    ~1e-6 seen."""
    a = jnp.asarray(_rand((64, 96), 9, 0.1), jnp.bfloat16)
    b = jnp.asarray(_rand((96, 32), 10, 0.1), jnp.bfloat16)
    want = np.asarray(_pallas_mm(a, b, jnp.float32))
    ta = torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    tb = torch.from_numpy(np.array(b.astype(jnp.float32))).to(torch.bfloat16)
    got = tmm.matmul_reference(ta, tb)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-3 * np.abs(want).max()
    assert torch.equal(tmm.bf16_matmul(ta, tb), got)


def test_matmul_wrappers_check_their_operands():
    a = torch.zeros(4, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        tmm.int8_matmul(a.float(), a.float().t())
    with pytest.raises(ValueError, match="bfloat16"):
        tmm.bf16_matmul(a, a.t())
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        tmm.int8_matmul(a, a)
    with pytest.raises(ValueError, match="int8 or bfloat16"):
        tmm.matmul_reference(a.float(), a.float().t())
    strided = torch.arange(64, dtype=torch.int8).reshape(8, 8)[::2, ::2]      # any strides
    assert torch.equal(tmm.int8_matmul(strided, strided.t()),
                       strided.int() @ strided.int().t())


# chip_smoke.py's K6_SERVING_SHAPES (M, K, N): int8 serving's products, A the
# im2col matrix or the quantised activations, B the (N, K) weight transposed
_SERVING = [(65536, 304, 16), (65536, 16, 32), (65536, 720, 32), (128, 4608, 512),
            (65536, 32, 3), (65536, 1440, 64), (1179648, 1440, 64),
            (30720, 256, 768), (30720, 256, 1024), (30720, 1024, 256)]
_I8, _BF = torch.int8, torch.bfloat16


@pytest.mark.parametrize("m,k,n", _SERVING)
@pytest.mark.parametrize("dtype", [_I8, _BF])
def test_matmul_route_serving_shapes_take_the_tensor_cores(m, k, n, dtype):
    assert tmm.matmul_route(dtype, m, n, k, (k, 1), (1, k), 0, 0) == "sm90"
    # any multiple of 16 bytes as a base address
    assert tmm.matmul_route(dtype, m, n, k, (k, 1), (1, k), 4096, 512 + 16) == "sm90"


# (dtype, M, K, N, strides of A, strides of B, base addresses mod 16, route):
# "packed" wherever a tensor map of the wgmma kernel cannot read an operand
# as it lies, so the pack copies it to K-major rows first
_ROUTE_CASES = [
    # the microbench's operands in both layouts of B
    (_BF, 4096, 4096, 4096, (4096, 1), (4096, 1), 0, 0, "sm90"),        # row-major: MN-major B
    (_BF, 4096, 4096, 4096, (4096, 1), (1, 4096), 0, 0, "sm90"),
    (_I8, 4096, 4096, 4096, (4096, 1), (4096, 1), 0, 0, "packed"),    # no transposed int8 operand: B packed
    (_I8, 4096, 4096, 4096, (4096, 1), (1, 4096), 0, 0, "sm90"),
    # the tensor-core kernel's edges
    (_I8, 129, 144, 72, (144, 1), (1, 144), 0, 0, "sm90"),
    (_I8, 255, 4608, 8, (4608, 1), (1, 4608), 0, 0, "sm90"),
    (_I8, 1, 16, 1, (16, 1), (1, 16), 0, 0, "sm90"),
    (_BF, 1, 16, 1, (16, 1), (1, 16), 0, 0, "sm90"),
    (_I8, 2, 16, 65535 * 64 + 8, (16, 1), (1, 16), 0, 0, "sm90"),
    (_BF, 257, 136, 68, (136, 1), (68, 1), 0, 0, "packed"),           # 136-byte rows of B
    (_BF, 257, 136, 68, (136, 1), (72, 1), 0, 0, "sm90"),               # the same in rows of 144
    # odd K: rows of A (and of a transposed B) are not 16 bytes apart
    (_I8, 65536, 294, 16, (294, 1), (16, 1), 0, 0, "packed"),
    (_I8, 65536, 294, 16, (294, 1), (1, 294), 0, 0, "packed"),
    (_I8, 65536, 9, 32, (9, 1), (32, 1), 0, 0, "packed"),
    (_I8, 257, 131, 67, (131, 1), (67, 1), 0, 0, "packed"),
    (_I8, 5, 9, 3, (9, 1), (1, 9), 0, 0, "packed"),
    (_BF, 65536, 294, 16, (294, 1), (1, 294), 0, 0, "packed"),        # 588-byte rows
    (_BF, 65536, 296, 16, (296, 1), (1, 296), 0, 0, "sm90"),
    (_BF, 5, 9, 3, (9, 1), (3, 1), 0, 0, "packed"),
    # an odd K in rows padded to 16 bytes is taken: only row starts count
    (_I8, 64, 9, 32, (16, 1), (1, 16), 0, 0, "sm90"),
    # element strides
    (_I8, 64, 32, 32, (64, 2), (1, 32), 0, 0, "packed"),
    (_I8, 64, 32, 32, (32, 1), (64, 2), 0, 0, "packed"),
    (_BF, 64, 32, 32, (1, 64), (1, 32), 0, 0, "packed"),              # A transposed
    # unaligned views: a slice that starts one element in
    (_I8, 300, 64, 48, (80, 1), (1, 80), 1, 0, "packed"),
    (_I8, 300, 64, 48, (80, 1), (1, 80), 0, 1, "packed"),
    (_BF, 300, 64, 48, (80, 1), (1, 80), 2, 0, "packed"),
    (_BF, 300, 64, 48, (80, 1), (48, 1), 0, 2, "packed"),
    (_BF, 300, 64, 48, (80, 1), (1, 80), 32, 48, "sm90"),
    # broadcast and overlapping rows (a tensor map takes neither); one row may have any stride
    (_I8, 64, 32, 32, (0, 1), (1, 32), 0, 0, "packed"),
    (_I8, 64, 32, 32, (16, 1), (1, 32), 0, 0, "packed"),
    (_I8, 64, 32, 32, (32, 1), (1, 16), 0, 0, "packed"),
    (_BF, 64, 32, 32, (32, 1), (16, 1), 0, 0, "packed"),
    (_I8, 1, 32, 32, (0, 1), (1, 32), 0, 0, "sm90"),
]


@pytest.mark.parametrize("dtype,m,k,n,a_strides,b_strides,a_ptr,b_ptr,route", _ROUTE_CASES)
def test_matmul_route(dtype, m, k, n, a_strides, b_strides, a_ptr, b_ptr, route):
    assert tmm.matmul_route(dtype, m, n, k, a_strides, b_strides, a_ptr, b_ptr) == route


def _strided_operands(dtype, m, k, n, a_strides, b_strides, a_ptr, b_ptr, seed):
    """A (m, k) and B (k, n) with the given element strides, each a view of a
    buffer of its own at an element offset whose bytes are ``ptr`` mod 16
    (torch's allocator starts buffers on 64-byte boundaries), from numpy
    draws; and the
    numpy arrays of the same values (float32 for bf16)."""
    size = 1 if dtype == torch.int8 else 2
    out = []
    for i, (shape, strides, ptr) in enumerate((((m, k), a_strides, a_ptr),
                                               ((k, n), b_strides, b_ptr))):
        off = ptr // size
        span = off + 1 + sum((d - 1) * st for d, st in zip(shape, strides))
        rng = np.random.default_rng(seed + i)
        if dtype == torch.int8:
            buf = torch.from_numpy(rng.integers(-127, 128, span).astype(np.int8)).clone()
            flat = buf.numpy()
        else:
            buf = torch.from_numpy(rng.uniform(-1, 1, span).astype(np.float32)).to(dtype)
            flat = buf.float().numpy()
        assert buf.data_ptr() % 64 == 0
        view = buf.as_strided(shape, strides, off)
        ref = np.lib.stride_tricks.as_strided(flat[off:], shape,
                                              [st * flat.itemsize for st in strides])
        out.append((view, ref))
    return out


def _values(t):
    return t.numpy() if t.dtype == torch.int8 else t.float().numpy()


@pytest.mark.parametrize("dtype,m,k,n,a_strides,b_strides,a_ptr,b_ptr,route", _ROUTE_CASES)
def test_pack_reference_matches_numpy(dtype, m, k, n, a_strides, b_strides, a_ptr, b_ptr,
                                      route):
    """The pack's plain version on every layout of the route table (offsets,
    element strides, broadcast and overlapping rows, odd K, both types): A
    as (M, K) and B as (N, K) rows hold numpy's values, K contiguous, rows
    ``pad16(K·size)`` bytes apart: operands the wgmma kernel reads as they
    lie."""
    (a, a_np), (b, b_np) = _strided_operands(dtype, m, k, n, a_strides, b_strides, a_ptr,
                                             b_ptr, 30)
    size = 1 if dtype == torch.int8 else 2
    row = -(-k * size // 16) * 16 // size
    pa, pb = tmm.pack_reference(a), tmm.pack_reference(b.t())
    for packed, want in ((pa, a_np), (pb, b_np.T)):
        assert packed.dtype == dtype and packed.stride() == (row, 1)
        np.testing.assert_array_equal(_values(packed), want)
    assert tmm.pack_path(dtype, b.t().stride(), b_ptr) in ("rows", "transpose", "gather")
    assert tmm.matmul_route(dtype, m, n, k, pa.stride(), pb.t().stride(), 0, 0) == "sm90"


@pytest.mark.parametrize("dtype,m,k,n,a_strides,b_strides,a_ptr,b_ptr,route", _ROUTE_CASES)
def test_matmul_reference_on_packed_copies_equals_the_originals(
        dtype, m, k, n, a_strides, b_strides, a_ptr, b_ptr, route):
    """What the "packed" route multiplies: the operands ``matmul_route``
    sends to the pack, packed (``pack_k_major``, on the CPU its plain
    version), give the product of the originals: int8 equal, bf16 within
    1e-3 of max|C| (the same values; only the float32 matmul's order may
    differ). M is cut to keep each product under 2^26 multiply-adds."""
    (a, _), (b, _) = _strided_operands(dtype, m, k, n, a_strides, b_strides, a_ptr, b_ptr, 40)
    pack_a, pack_b = tmm._packs(dtype, m, n, k, a_strides, b_strides, a_ptr, b_ptr)
    assert (pack_a or pack_b) == (route == "packed")
    pa = tmm.pack_k_major(a) if pack_a else a
    pb = tmm.pack_k_major(b.t()).t() if pack_b else b
    rows = max(1, min(m, 2**26 // (n * k)))
    got, want = tmm.matmul_reference(pa[:rows], pb), tmm.matmul_reference(a[:rows], b)
    if dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item()


def test_matmul_route_of_the_operands_int8_serving_builds():
    """``_im2col`` pads the depth to 16 and ``_conv_weight`` stores (N, K):
    what ``int8_conv`` and a served ``Linear`` hand to K6 takes the
    tensor-core route (base addresses taken as aligned, as the card's
    allocator gives them)."""
    x = torch.from_numpy(_rand((2, 8, 8, 5), 20))
    w_nk, _ = tq._conv_weight(torch.from_numpy(_rand((3, 3, 5, 7), 21)))
    q, _ = tq._quantized_values(x, None)
    cols, _ = tq._im2col(q, 3, 3, (1, 1), ((1, 1), (1, 1)))
    b = w_nk.t()
    assert cols.shape[1] == 48 and b.stride() == (1, 48)
    assert tmm.matmul_route(torch.int8, cols.shape[0], b.shape[1], cols.shape[1], cols.stride(),
                            b.stride(), 0, 0) == "sm90"
    w_q, _ = tq.quantize_channelwise(torch.from_numpy(_rand((32, 64), 22)), axis=0)   # Linear
    assert tmm.matmul_route(torch.int8, 10, 32, 64, (64, 1), w_q.t().stride(), 0, 0) == "sm90"
    # int8_dense quantises a (in, out) kernel: B is row-major there, packed
    # to (N, K) rows by the transposing path
    w_io, _ = tq.quantize_channelwise(torch.from_numpy(_rand((64, 32), 23)), axis=-1)
    assert tmm.matmul_route(torch.int8, 10, 32, 64, (64, 1), w_io.stride(), 0, 0) == "packed"
    assert tmm.pack_path(torch.int8, w_io.t().stride(), 0) == "transpose"


def test_matmul_wrappers_count_no_route_on_cpu():
    a = torch.ones(4, 16, dtype=torch.int8)
    before = dict(tmm.int8_matmul.route_counts), tmm.int8_matmul.launch_count
    tmm.int8_matmul(a, a.t())
    assert (tmm.int8_matmul.route_counts, tmm.int8_matmul.launch_count) == before
    assert set(tmm.int8_matmul.route_counts) == set(tmm.bf16_matmul.route_counts) == {
        "sm90", "packed"}
    before = tmm.int8_matmul.pack_launch_count, dict(tmm.pack_k_major.path_counts)
    tmm.int8_matmul(a[:, 1:], a.t()[1:])                  # a "packed" layout: still no count
    tmm.pack_k_major(a[:, 1:])
    assert (tmm.int8_matmul.pack_launch_count, tmm.pack_k_major.path_counts) == before


class _JTiny(fnn.Module):
    """Conv → relu → mean → Dense, with a 1-D conv on the side."""

    @fnn.compact
    def __call__(self, x, seq):
        x = fnn.Conv(8, (3, 3), strides=(2, 1), padding=((1, 1), (1, 1)))(x)
        x = fnn.relu(x).mean(axis=(1, 2))
        s = fnn.Conv(8, (3,), padding=((1, 1),))(seq).mean(axis=1)
        return fnn.Dense(4)(x + s)


class _TTiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = tl.Conv2d(3, 8, 3, (2, 1), 1)
        self.side = tl.Conv1d(5, 8, 3, padding=1)
        self.head = tl.Linear(8, 4)

    def forward(self, x, seq):
        x = torch.relu(self.conv(x.permute(0, 3, 1, 2))).mean(dim=(2, 3))
        return self.head(x + self.side(seq.permute(0, 2, 1)).mean(dim=2))


@pytest.fixture(scope="module")
def tiny():
    x, seq = _rand((2, 8, 8, 3), 11), _rand((2, 6, 5), 12)
    jm = _JTiny()
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(0), x, seq)["params"])
    params = jax.tree_util.tree_map(lambda a: a + _rand(a.shape, 13, 0.1), params)
    tm = _TTiny().eval()
    tm.load_state_dict({
        "conv.weight": torch.from_numpy(params["Conv_0"]["kernel"].transpose(3, 2, 0, 1).copy()),
        "conv.bias": torch.from_numpy(params["Conv_0"]["bias"]),
        "side.weight": torch.from_numpy(params["Conv_1"]["kernel"].transpose(2, 1, 0).copy()),
        "side.bias": torch.from_numpy(params["Conv_1"]["bias"]),
        "head.weight": torch.from_numpy(params["Dense_0"]["kernel"].T.copy()),
        "head.bias": torch.from_numpy(params["Dense_0"]["bias"])})
    return jm, params, tm, x, seq


def test_quantized_apply_reroutes_conv2d_and_linear_like_jax(tiny):
    jm, params, tm, x, seq = tiny
    jf = np.asarray(jm.apply({"params": params}, x, seq))
    jq_out = np.asarray(jq.quantized_apply(jm, {"params": params}, x, seq))
    with torch.no_grad():
        tf = tm(torch.from_numpy(x), torch.from_numpy(seq)).numpy()
        tq_out = tq.quantized_apply(tm, torch.from_numpy(x), torch.from_numpy(seq)).numpy()
    np.testing.assert_allclose(tf, jf, rtol=1e-5, atol=1e-5)
    assert not np.allclose(tq_out, tf)                       # actually rerouted
    # the same float inputs reach both quantisers, so the integers agree
    np.testing.assert_allclose(tq_out, jq_out, rtol=1e-5, atol=1e-5)
    assert tq.active() is None                               # the context closed


def test_calibration_and_static_scales_match_jax(tiny):
    jm, params, tm, x, seq = tiny
    want = jq.calibrate_activation_scales(
        lambda a, s: jm.apply({"params": params}, a, s), [(x, seq), (2 * x, seq)])
    got = tq.calibrate_activation_scales(
        tm, [(torch.from_numpy(x), torch.from_numpy(seq)),
             (torch.from_numpy(2 * x), torch.from_numpy(seq))])
    names = {"Conv_0": "conv", "Conv_1": "side", "Dense_0": "head"}   # 1-D conv recorded too
    assert set(got) == set(names.values()) and len(got) == len(want)
    for jname, tname in names.items():
        assert got[tname] == pytest.approx(want[jname], rel=1e-5)
    j_static = np.asarray(jq.quantized_apply(jm, {"params": params}, x, seq, act_scales=want))
    with torch.no_grad():
        t_static = tq.quantized_apply(tm, torch.from_numpy(x), torch.from_numpy(seq),
                                      act_scales=got).numpy()
    np.testing.assert_allclose(t_static, j_static, rtol=1e-5, atol=1e-5)


def test_conv1d_and_unsupported_convs_pass_through_in_float(tiny):
    _, _, tm, x, seq = tiny
    s = torch.from_numpy(seq).permute(0, 2, 1)
    grouped = tl.Conv2d(4, 4, 3, padding=1, groups=2)
    dilated = tl.Conv2d(4, 4, 3, padding=2, dilation=2)
    xin = torch.from_numpy(_rand((1, 4, 6, 6), 14))
    with torch.no_grad():
        want = tm.side(s), grouped(xin), dilated(xin)
        with tq.int8_serving(tm):
            got = tm.side(s), grouped(xin), dilated(xin)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_serving_context_caches_weights_without_changing_results(tiny):
    _, _, tm, x, seq = tiny
    args = torch.from_numpy(x), torch.from_numpy(seq)
    with torch.no_grad(), tq.int8_serving(tm):
        first = tm(*args)
        serving = tq.active()
        cached = dict(serving._weights)
        second = tm(*args)
        assert set(serving._weights) == set(cached) == {id(tm.conv), id(tm.head)}
        assert all(serving._weights[k][0] is cached[k][0] for k in cached)
    assert torch.equal(first, second)
    with torch.no_grad():
        assert torch.equal(tq.quantized_apply(tm, *args), first)


def test_int8_linear_casts_to_the_compute_dtype():
    lin = tl.Linear(16, 8, dtype=torch.bfloat16)
    x = torch.from_numpy(_rand((3, 16), 15)).to(torch.bfloat16)
    with torch.no_grad(), tq.int8_serving(lin):
        out = lin(x)
    assert out.dtype == torch.bfloat16
    want = jq.int8_dense(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                         jnp.asarray(lin.weight.detach().numpy().T),
                         jnp.asarray(lin.bias.detach().numpy()), out_dtype=jnp.bfloat16)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)     # one bf16 rounding of the output
