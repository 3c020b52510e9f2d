// What both routes of K1 (CLAHE) share: a tile's LUT level from its CDF, a
// pixel's neighbouring tiles and blend weight, and the blend.
//
// Every formula repeats the float32 operations of the plain version
// (ops/clahe_cuda.py::clahe_luts_reference and clahe_reference) in the same
// order, with the rounding intrinsics, so that nvcc cannot contract a
// multiply and an add into one FMA that the plain version does not make.
#pragma once

#include <cuda_runtime.h>

namespace clahe {

constexpr float kRound = 12582912.f;   // 1.5 * 2^23: x + kRound - kRound rounds x half to even

// The LUT level of a CDF value: clip(round(cdf * (nbins - 1) / area), 0,
// nbins - 1) with the plain version's two roundings (a product, then a true
// division). The division is taken as a product with 1/area, which is
// within 2^-22 of the quotient in relative terms; only where that leaves
// the quotient within 2^-20 of a half (a rounding tie, or next to one) does
// the correctly rounded division decide. cdf >= 0.
__device__ __forceinline__ int lut_level(float cdf, float scale, float area, float inv_area,
                                         int nbins) {
  const float t = __fmul_rn(cdf, scale);
  float q = __fmul_rn(t, inv_area);
  const float r = __fsub_rn(__fadd_rn(q, kRound), kRound);
  if (fabsf(fabsf(__fsub_rn(q, r)) - 0.5f) <= fmaxf(q, 1.f) * 9.5367431640625e-07f)
    q = __fdiv_rn(t, area);
  if (q >= 4194304.f) return min(__float2int_rn(q), nbins - 1);   // past the trick's range
  const int level = __float_as_int(__fadd_rn(q, kRound)) - __float_as_int(kRound);
  return min(level, nbins - 1);
}

// Half-pixel tile-centre coordinate of pixel i along an axis padded to
// n_pad and cut into g tiles: the two (edge-clamped) neighbouring tiles and
// the weight of the second, from (i + 0.5) * g / n_pad - 0.5 in float32.
__device__ __forceinline__ void tile_coord(int i, int g, int n_pad, int* t0, int* t1, float* f) {
  const float src = __fsub_rn(
      __fdiv_rn(__fmul_rn(static_cast<float>(i) + 0.5f, static_cast<float>(g)),
                static_cast<float>(n_pad)),
      0.5f);
  const float fl = floorf(src);
  const int i0 = static_cast<int>(fl);
  *f = __fsub_rn(src, fl);
  *t0 = min(max(i0, 0), g - 1);
  *t1 = min(max(i0 + 1, 0), g - 1);
}

// The plain version's blend of four LUT levels.
__device__ __forceinline__ float blend(float l00, float l01, float l10, float l11, float fy,
                                       float fx) {
  const float gy = __fsub_rn(1.f, fy), gx = __fsub_rn(1.f, fx);
  const float top = __fadd_rn(__fmul_rn(gx, l00), __fmul_rn(fx, l01));
  const float bot = __fadd_rn(__fmul_rn(gx, l10), __fmul_rn(fx, l11));
  return __fadd_rn(__fmul_rn(gy, top), __fmul_rn(fy, bot));
}

}  // namespace clahe
