// K1: CLAHE, route "packed": one block an image, the tile histograms as
// 8-bit counters packed four to a word in shared memory.
//
// Replaces lipreading_video_generation_tpu/ops/clahe_pallas.py::_kernel
// (the Pallas kernel behind ops/image.py::clahe). The TPU kernel turns the
// histograms and the blend into one-hot matmuls, because its matrix unit is
// the fast path. Here nothing of the (pixels x nbins) one-hot exists. Per
// image (block of 256 threads):
//   1. each pixel is read from device memory once, its bin is kept in shared
//      memory as a byte, and a shared-memory atomic adds 1 << (8 * (bin % 4))
//      to the 32-bit word that packs its tile's counter with those of the
//      next three bins. A tile holds at most 255 pixels, so a counter never
//      carries into its neighbour. The edge-replicated padding is counted as
//      a weight on the last row and column (the route takes only grids whose
//      padding lies in the last tile row and column);
//   2. G lanes a tile (a power of two up to 32, G * tiles <= 256), each over
//      a run of the tile's words, clip each counter at L = 1, spread the
//      excess, scan (one shuffle scan over the group, the rest in order in
//      each lane), and write each LUT level over its counter: a level is
//      below nbins <= 256, and a byte holds it. A lane's run is padded by a
//      word and a tile's words start G banks on from the last tile's, so
//      that the 32 lanes of a warp read 32 banks at each step;
//   3. each pixel blends the four neighbouring LUT levels at its own bin.
// In steps 1 and 3 a row's float4s of pixels go to consecutive threads, and
// a thread keeps its columns for the whole image: their tiles and weights
// are read from the per-column table once, the row's from the per-row table
// once a row, and four bins move as one shared-memory word. At the main
// path's shape (48 x 48, 8 x 8 tiles of 36 pixels, 256 bins) that is 17 KB
// of counters, 2,304 bytes of bins and 1.5 KB of tables an image (int32
// counters would take 64 KB), so several images are resident on an SM.
//
// The route takes what the ViViT path gives K1 (ops/clahe_cuda.py::
// clahe_packed_layout; every other shape takes clahe.cu): L = 1, nbins a
// power of two from 4 to 256, tiles of at most 255 pixels with
// area * nbins^2 < 2^23, rows of whole float4s. There the scan is in
// integers: every partial sum of the CDF is exact in float32, the CDF at bin
// b is m / nbins for the integer m = C(b) * nbins + (b + 1) * excess, with
// C(b) the nonzero counters up to b, and the plain version's level is
// m * (nbins - 1) / (area * nbins) rounded half to even (see level_of_x): a
// multiply-high a bin. The clipped counts of a word are its nonzero bytes,
// and one multiply gives their prefix within the word.
//
// Bound: 8 bytes a pixel of device memory (one float read, one written),
// 10.6 us at 1920 x 48 x 48 on an H100. Every image also scans
// tiles x nbins counters (16,384 at the main path against 2,304 pixels), so
// the per-bin instructions set the time as much as the bytes do, and the
// blend's four lookups a pixel at random bins meet bank conflicts.
//
// Numerics: the plain version's (ops/clahe_cuda.py::clahe_luts_reference).
// Every partial sum is exact, so each LUT equals the plain version's bit for
// bit whatever the order of the sums.
//
// bench/clahe_phases.py times builds with parts cut out at compile time:
// -DCLAHE_PACKED_STOP=n returns before step n (1, 2 or 3), and
// -DCLAHE_PACKED_NO_SCAN leaves out step 2's loop.
#include <cstdint>

#include <cuda_runtime.h>

#include "clahe_common.cuh"

#ifndef CLAHE_PACKED_STOP
#define CLAHE_PACKED_STOP 4
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

struct Params {
  int h, w, gh, gw, th, tw, nbins;
  int group;        // lanes a tile in the scan
  int lane_words;   // words a lane scans
  int lane_shift;   // log2(lane_words) when a lane's run is padded, else 29
  int tile_words;   // a tile's stride in words
  // the tile area, 2 (nbins - 1), area * nbins and twice that,
  // floor(x / den) = umulhi(x, magic) >> shift, a_mul = nbins * 2 (nbins - 1)
  int iarea, two_top;
  unsigned half_den, den, magic, a_mul;
  int shift;
};

// float(u) for u < 2^23 without a conversion instruction.
__device__ __forceinline__ float small_uint_to_float(uint32_t u) {
  return __fsub_rn(__uint_as_float(0x4B000000u | u), 8388608.f);
}

// clip(round(v), 0, nbins - 1) without a conversion instruction (the bounds
// are integers, so clipping before rounding gives the same bin).
__device__ __forceinline__ int fast_bin(float v, float top) {
  const float c = fminf(fmaxf(v, 0.f), top);
  return __float_as_int(__fadd_rn(c, clahe::kRound)) - __float_as_int(clahe::kRound);
}

// The plain version's level where the CDF is m / nbins for an integer m,
// from x = 2 m (nbins - 1) + area nbins:
// t = cdf * (nbins - 1) is exact in float32 (m * (nbins - 1) < 2^23), and
// its quotient by the area lies at least 1 / (2 area nbins) from any half
// it does not equal, more than float32's half-ulp below nbins when
// area * nbins^2 < 2^23, so rounding the float quotient half to even is
// rounding m (nbins - 1) / (area nbins) half to even. Over den = 2 area
// nbins, q = floor(x / den) rounds half up; a remainder of 0 is a tie, which
// goes to the even one of q - 1 and q. The level is below nbins, so no clip
// is needed.
__device__ __forceinline__ int level_of_x(unsigned x, const Params& p) {
  const unsigned q = __umulhi(x, p.magic) >> p.shift;
  return static_cast<int>(q - (x - q * p.den == 0u ? (q & 1u) : 0u));
}

// (row or column) -> {tile of the histogram, first blend tile, second blend
// tile, weight of the second}; tiles already multiplied by `stride`.
__device__ __forceinline__ int4 axis_entry(int i, int tile_len, int g, int stride) {
  int t0, t1;
  float f;
  clahe::tile_coord(i, g, tile_len * g, &t0, &t1, &f);
  return make_int4(min(i / tile_len, g - 1) * stride, t0 * stride, t1 * stride,
                   __float_as_int(f));
}

__global__ void __launch_bounds__(kThreads)
clahe_packed_kernel(const float* __restrict__ in, float* __restrict__ out,
                    float* __restrict__ luts, Params p) {
  const int tiles = p.gh * p.gw;
  const int n_vec = (tiles * p.tile_words + 3) / 4;   // 16-byte words of counters
  const int tile_levels = p.tile_words * 4;           // a tile's stride in LUT levels
  const int pad_shift = p.lane_shift + 2;             // bin >> pad_shift: pad words before it

  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* hist = smem;                                        // 4 * n_vec words
  int4* rows = reinterpret_cast<int4*>(smem + 4 * n_vec);       // h entries
  int4* cols = rows + p.h;                                      // w entries
  uint32_t* bins = reinterpret_cast<uint32_t*>(cols + p.w);     // h * w / 4 words

  const size_t image = static_cast<size_t>(blockIdx.x) * p.h * p.w;
  const float* img = in + image;
  float* dst = out + image;
  const int tid = threadIdx.x;

  uint4* hist4 = reinterpret_cast<uint4*>(hist);
  for (int i = tid; i < n_vec; i += kThreads) hist4[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < p.h; i += kThreads) rows[i] = axis_entry(i, p.th, p.gh, p.gw * tile_levels);
  for (int i = tid; i < p.w; i += kThreads) cols[i] = axis_entry(i, p.tw, p.gw, tile_levels);
  __syncthreads();
  if (CLAHE_PACKED_STOP <= 1) return;

  // a row's `groups` float4s go to consecutive threads: thread tid takes
  // group g0 (and g0 + gstep, ...) of rows y0, y0 + ystep, ...; the threads
  // past the last whole set of rows idle
  const int groups = p.w / 4;
  int g0 = tid, gstep = kThreads, y0 = 0, ystep = 1;
  if (groups <= kThreads) {
    g0 = tid % groups;
    gstep = groups;
    ystep = kThreads / groups;
    y0 = tid / groups < ystep ? tid / groups : p.h;
  }

  // 1. bins and packed histograms; the last row and column also stand for
  // the padding below and right of them. A level's place in the tile is
  // its bin plus the pad words before it.
  const uint32_t pad_h = p.th * p.gh - p.h + 1, pad_w = p.tw * p.gw - p.w + 1;
  const float top = static_cast<float>(p.nbins - 1);
  for (int g = g0; g < groups; g += gstep) {
    int cx[4];
    uint32_t cw[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int x = g * 4 + k;
      cx[k] = cols[x].x;
      cw[k] = x == p.w - 1 ? pad_w : 1u;
    }
    for (int y = y0; y < p.h; y += ystep) {
      const int rx = rows[y].x;
      const uint32_t rw = y == p.h - 1 ? pad_h : 1u;
      const int pix = y * p.w + g * 4;
      const float4 q = *reinterpret_cast<const float4*>(img + pix);
      const float v[4] = {q.x, q.y, q.z, q.w};
      uint32_t packed = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int b = fast_bin(v[k], top);
        const uint32_t idx = static_cast<uint32_t>(rx + cx[k] + b + ((b >> pad_shift) << 2));
        atomicAdd(&hist[idx >> 2], (rw * cw[k]) << (8 * (idx & 3)));
        packed |= static_cast<uint32_t>(b) << (8 * k);
      }
      bins[pix >> 2] = packed;
    }
  }
  __syncthreads();
  if (CLAHE_PACKED_STOP <= 2) return;

  // 2. clip, redistribute, scan, LUT: lane gl of a group takes words
  // gl * lane_words .. + lane_words of its tile (past gl pad words). A
  // counter clipped at L = 1 is 1 iff it is not 0: a byte's top bit is set
  // iff its counter is not 0, the clipped counts of a word are those bits
  // >> 7, and their product with 0x01010101 is the word's inclusive prefix.
#ifndef CLAHE_PACKED_NO_SCAN
  const int grp = p.group;
  const int lane = tid & 31, gl = lane & (grp - 1);
  const unsigned group_mask = grp == 32 ? 0xffffffffu : ((1u << grp) - 1u) << (lane & ~(grp - 1));
  const int run_stride = p.lane_words + (grp > 1 ? 1 : 0);
  for (int item = tid; item < tiles * grp; item += kThreads) {
    uint32_t* wp = hist + (item / grp) * p.tile_words + gl * run_stride;
    auto nonzero = [](uint32_t word) {
      return (((word & 0x7f7f7f7fu) + 0x7f7f7f7fu) | word) & 0x80808080u;
    };
    int clipped = 0;
    for (int i = 0; i < p.lane_words; ++i) clipped += __popc(nonzero(wp[i]));
    int total = clipped;
    for (int off = 1; off < grp; off <<= 1) total += __shfl_xor_sync(group_mask, total, off);
    const unsigned e2 = static_cast<unsigned>(p.iarea - total) * static_cast<unsigned>(p.two_top);
    int incl = clipped;
    for (int off = 1; off < grp; off <<= 1) {
      const int n = __shfl_up_sync(group_mask, incl, off, grp);
      if (gl >= off) incl += n;
    }
    // x = 2 m (nbins - 1) + area nbins at bin b of the tile, with
    // m = C(b) nbins + (b + 1) excess: x = a_mul C(b) + (b + 1) e2 + half_den
    unsigned xw = p.a_mul * static_cast<unsigned>(incl - clipped) +
                  static_cast<unsigned>(gl * p.lane_words * 4 + 1) * e2 + p.half_den;
    const unsigned ke2[4] = {0u, e2, 2u * e2, 3u * e2};
    for (int i = 0; i < p.lane_words; ++i) {
      const uint32_t pre = (nonzero(wp[i]) >> 7) * 0x01010101u;
      uint32_t levels = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        levels |= static_cast<uint32_t>(
                      level_of_x(xw + ke2[k] + p.a_mul * ((pre >> (8 * k)) & 0xffu), p))
                  << (8 * k);
      wp[i] = levels;
      xw += p.a_mul * (pre >> 24) + 4u * e2;
    }
  }
#endif
  __syncthreads();
  if (CLAHE_PACKED_STOP <= 3) return;

  const uint8_t* lut = reinterpret_cast<const uint8_t*>(hist);
  if (luts != nullptr) {   // the LUTs themselves, for checks against the plain version
    float* lo = luts + static_cast<size_t>(blockIdx.x) * tiles * p.nbins;
    for (int i = tid; i < tiles * p.nbins; i += kThreads) {
      const int b = i % p.nbins;
      lo[i] = static_cast<float>(lut[(i / p.nbins) * tile_levels + b + ((b >> pad_shift) << 2)]);
    }
  }

  // 3. the blend at each pixel's own bin
  for (int g = g0; g < groups; g += gstep) {
    int4 c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = cols[g * 4 + k];
    for (int y = y0; y < p.h; y += ystep) {
      const int4 r = rows[y];
      const int pix = y * p.w + g * 4;
      const uint32_t packed = bins[pix >> 2];
      float o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int b = static_cast<int>((packed >> (8 * k)) & 0xffu);
        const int at = b + ((b >> pad_shift) << 2);
        o[k] = clahe::blend(small_uint_to_float(lut[r.y + c[k].y + at]),
                            small_uint_to_float(lut[r.y + c[k].z + at]),
                            small_uint_to_float(lut[r.z + c[k].y + at]),
                            small_uint_to_float(lut[r.z + c[k].z + at]), __int_as_float(r.w),
                            __int_as_float(c[k].w));
      }
      *reinterpret_cast<float4*>(dst + pix) = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

// cudaFuncSetAttribute for the kernel's dynamic shared memory on the current
// device, when a launch there asks for more than any launch before it (once
// per size and device, not per call).
cudaError_t reserve_smem(size_t bytes) {
  static int reserved[kMaxDevices] = {};
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && static_cast<int>(bytes) <= reserved[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(clahe_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && cached) reserved[dev] = static_cast<int>(bytes);
  return err;
}

bool pow2(long long x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

// in, out: (n, h, w) float32, contiguous, 16-byte aligned, on the current
// device; luts: null, or (n, gh * gw, nbins) float32 to receive the LUTs.
// limit: the clip limit L, which must be 1. The layout comes from
// ops/clahe_cuda.py::clahe_packed_layout: group (lanes a tile), lane_words
// (words a lane scans; a power of two when group > 1), tile_words (a tile's
// stride in 32-bit words) and smem (dynamic shared memory). Returns
// cudaErrorInvalidValue on a shape the route does not take, else
// cudaGetLastError() after the launch.
extern "C" int lvg_clahe_packed_f32(const void* in, void* out, void* luts, int n, int h, int w,
                                    int gh, int gw, int nbins, float limit, int group,
                                    int lane_words, int tile_words, int smem, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || gh <= 0 || gw <= 0 || w % 4 != 0 || limit != 1.f)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.h = h; p.w = w; p.gh = gh; p.gw = gw;
  p.th = (h + gh - 1) / gh;
  p.tw = (w + gw - 1) / gw;
  const long long area = static_cast<long long>(p.th) * p.tw;
  if (!pow2(nbins) || nbins < 4 || nbins > 256 || area > 255 ||
      area * nbins * nbins >= (1LL << 23) || (gh - 1) * p.th >= h || (gw - 1) * p.tw >= w ||
      !pow2(group) || group > 32 || lane_words * group * 4 != nbins ||
      (group > 1 && !pow2(lane_words)) ||
      tile_words < group * (lane_words + (group > 1 ? 1 : 0)) ||
      reinterpret_cast<uintptr_t>(in) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.nbins = nbins;
  p.group = group;
  p.lane_words = lane_words;
  p.lane_shift = group > 1 ? __builtin_ctz(lane_words) : 29;   // 29: no pad words
  p.tile_words = tile_words;
  p.iarea = static_cast<int>(area);
  p.two_top = 2 * (nbins - 1);
  // den < 2^22; x < 2^24 < 2^31, where umulhi(x, magic) >> (k - 1) is exact
  p.half_den = static_cast<unsigned>(area * nbins);
  p.den = 2u * p.half_den;
  int k = 1;
  while ((1ULL << k) < p.den) ++k;   // 2^(k-1) < den <= 2^k
  p.shift = k - 1;
  p.magic = static_cast<unsigned>(((1ULL << (31 + k)) + p.den - 1) / p.den);
  p.a_mul = static_cast<unsigned>(nbins) * static_cast<unsigned>(p.two_top);
  const size_t bytes = static_cast<size_t>(smem);
  const cudaError_t err = reserve_smem(bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  clahe_packed_kernel<<<n, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), static_cast<float*>(luts), p);
  return static_cast<int>(cudaGetLastError());
}
