// K1: CLAHE, route "tiled": the shapes the packed route
// (clahe_packed.cu) does not take; it takes any image, grid and bin count.
// The packed route takes only what the ViViT path gives K1, so this one
// takes clip limits with L above 1, bin counts that are not powers of two
// or above 256, tiles of more than 255 pixels (frames of 360 x 640), grids
// whose edge padding spans more than the last tile (48 x 48 in 17 x 17
// tiles of 3 rows), rows that are not whole float4s and images at an
// address that is not a multiple of 16.
//
// Replaces lipreading_video_generation_tpu/ops/clahe_pallas.py::_kernel,
// and ops/image.py::clahe_xla for the shapes that kernel does not take. Two
// kernels, one after the other on the caller's stream:
//   1. one block a (image, tile) builds the tile's histogram in shared
//      memory (int32 counters, 8,192 bins a pass: more bins take two passes
//      over the tile's pixels per 8,192, one for the clipped excess and one
//      for the scan), clips, redistributes and scans it with block-wide
//      reductions, and writes the tile's LUT to a float32 workspace
//      (n, tiles, nbins) in device memory, which the wrapper allocates;
//   2. one block an image row blends, at each pixel's bin, the four
//      neighbouring LUTs, read from the workspace (it stays in L2 at the
//      frame sizes of the paths: 4 MB for 64 frames of 8 x 8 tiles).
// The image is read twice (once a kernel), so the bound is 12 bytes a
// pixel and the LUT workspace, against the packed route's 8.
//
// Numerics: as clahe_packed.cu; the float32 operations of the plain version
// (ops/clahe_cuda.py::clahe_luts_reference) with its roundings.
#include <cuda_runtime.h>

#include "clahe_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8192;   // counters a pass holds in shared memory
constexpr unsigned kFullMask = 0xffffffffu;

struct Params {
  int h, w, gh, gw, th, tw, nbins;
  float limit, area, inv_area;
};

// clip(round(v), 0, nbins - 1), as jnp.round / torch.round (half to even).
__device__ __forceinline__ int to_bin(float v, int nbins) {
  return static_cast<int>(fminf(fmaxf(rintf(v), 0.f), static_cast<float>(nbins - 1)));
}

// The sum of v over the block, in every thread. scratch: kWarps floats.
__device__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFullMask, v, off));
  const int lane = threadIdx.x & 31;
  if (lane == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = lane < kWarps ? scratch[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t = __fadd_rn(t, __shfl_xor_sync(kFullMask, t, off));
  __syncthreads();   // scratch is free again
  return t;
}

// The sum of v over the threads before this one, and (*total) over all.
__device__ float block_exclusive_scan(float v, float* scratch, float* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl = __fadd_rn(incl, n);
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    float x = lane < kWarps ? scratch[lane] : 0.f;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const float n = __shfl_up_sync(kFullMask, x, off);
      if (lane >= off) x = __fadd_rn(x, n);
    }
    if (lane < kWarps) scratch[lane] = x;
  }
  __syncthreads();
  const float before = warp > 0 ? scratch[warp - 1] : 0.f;
  *total = scratch[kWarps - 1];
  __syncthreads();
  return __fadd_rn(before, __fsub_rn(incl, v));
}

__global__ void __launch_bounds__(kThreads)
clahe_tile_lut_kernel(const float* __restrict__ in, float* __restrict__ luts, Params p) {
  extern __shared__ int hist[];   // min(nbins, kChunk) counters
  __shared__ float scratch[kWarps];
  const int tiles = p.gh * p.gw;
  const long long blk = blockIdx.x;
  const int img = static_cast<int>(blk / tiles), tile = static_cast<int>(blk % tiles);
  const int tr = tile / p.gw, tc = tile - (tile / p.gw) * p.gw;
  const float* src = in + static_cast<size_t>(img) * p.h * p.w;
  float* lut = luts + static_cast<size_t>(blk) * p.nbins;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = min(p.nbins, kChunk);
  const int n_chunks = (p.nbins + chunk - 1) / chunk;

  // counters of bins [c0, c0 + chunk) over the tile's padded pixels (rows
  // and columns past the image repeat its last row and column)
  auto build = [&](int c0) {
    __syncthreads();   // the previous chunk's readers are done
    for (int i = tid; i < chunk; i += kThreads) hist[i] = 0;
    __syncthreads();
    for (int r = warp; r < p.th; r += kWarps) {
      const float* row = src + static_cast<size_t>(min(tr * p.th + r, p.h - 1)) * p.w;
      for (int c = lane; c < p.tw; c += 32) {
        const int b = to_bin(row[min(tc * p.tw + c, p.w - 1)], p.nbins) - c0;
        if (static_cast<unsigned>(b) < static_cast<unsigned>(chunk)) atomicAdd(&hist[b], 1);
      }
    }
    __syncthreads();
  };

  float excess = 0.f;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * chunk, len = min(chunk, p.nbins - c0);
    build(c0);
    for (int b = tid; b < len; b += kThreads) {
      const float hv = static_cast<float>(hist[b]);
      excess = __fadd_rn(excess, __fsub_rn(hv, fminf(hv, p.limit)));
    }
  }
  const float add = __fdiv_rn(block_sum(excess, scratch), static_cast<float>(p.nbins));
  const float scale = static_cast<float>(p.nbins - 1);

  float carry = 0.f;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * chunk, len = min(chunk, p.nbins - c0);
    if (n_chunks > 1) build(c0);   // one chunk: its counters are still there
    const int per = (len + kThreads - 1) / kThreads;
    const int b0 = min(tid * per, len), b1 = min(b0 + per, len);
    float own = 0.f;
    for (int b = b0; b < b1; ++b)
      own = __fadd_rn(own, __fadd_rn(fminf(static_cast<float>(hist[b]), p.limit), add));
    float total;
    float run = __fadd_rn(carry, block_exclusive_scan(own, scratch, &total));
    for (int b = b0; b < b1; ++b) {
      run = __fadd_rn(run, __fadd_rn(fminf(static_cast<float>(hist[b]), p.limit), add));
      lut[c0 + b] = static_cast<float>(clahe::lut_level(run, scale, p.area, p.inv_area, p.nbins));
    }
    carry = __fadd_rn(carry, total);
  }
}

__global__ void __launch_bounds__(kThreads)
clahe_tile_blend_kernel(const float* __restrict__ in, float* __restrict__ out,
                        const float* __restrict__ luts, Params p) {
  const long long row_id = blockIdx.x;   // image * h + row
  const int img = static_cast<int>(row_id / p.h), y = static_cast<int>(row_id % p.h);
  int r0, r1;
  float fy;
  clahe::tile_coord(y, p.gh, p.th * p.gh, &r0, &r1, &fy);
  const float* src = in + static_cast<size_t>(row_id) * p.w;
  float* dst = out + static_cast<size_t>(row_id) * p.w;
  const float* lut = luts + static_cast<size_t>(img) * p.gh * p.gw * p.nbins;
  const size_t row0 = static_cast<size_t>(r0) * p.gw * p.nbins;
  const size_t row1 = static_cast<size_t>(r1) * p.gw * p.nbins;
  for (int x = threadIdx.x; x < p.w; x += kThreads) {
    const int b = to_bin(src[x], p.nbins);
    int c0, c1;
    float fx;
    clahe::tile_coord(x, p.gw, p.tw * p.gw, &c0, &c1, &fx);
    const size_t k0 = static_cast<size_t>(c0) * p.nbins + b;
    const size_t k1 = static_cast<size_t>(c1) * p.nbins + b;
    dst[x] = clahe::blend(lut[row0 + k0], lut[row0 + k1], lut[row1 + k0], lut[row1 + k1], fy, fx);
  }
}

}  // namespace

// in, out: (n, h, w) float32, contiguous, on the current device; luts: the
// (n, gh * gw, nbins) float32 workspace that receives the LUTs. Returns
// cudaGetLastError() after the second launch (or the first error).
extern "C" int lvg_clahe_tiled_f32(const void* in, void* out, void* luts, int n, int h, int w,
                                   int gh, int gw, int nbins, float limit, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || gh <= 0 || gw <= 0 || nbins < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long lut_blocks = static_cast<long long>(n) * gh * gw;
  const long long rows = static_cast<long long>(n) * h;
  if (lut_blocks > 0x7fffffffLL || rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.h = h; p.w = w; p.gh = gh; p.gw = gw;
  p.th = (h + gh - 1) / gh;
  p.tw = (w + gw - 1) / gw;
  p.nbins = nbins;
  p.limit = limit;
  p.area = static_cast<float>(static_cast<long long>(p.th) * p.tw);
  p.inv_area = 1.f / p.area;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(min(nbins, kChunk)) * sizeof(int);
  clahe_tile_lut_kernel<<<static_cast<unsigned>(lut_blocks), kThreads, smem, cs>>>(
      static_cast<const float*>(in), static_cast<float*>(luts), p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  clahe_tile_blend_kernel<<<static_cast<unsigned>(rows), kThreads, 0, cs>>>(
      static_cast<const float*>(in), static_cast<float*>(out), static_cast<const float*>(luts), p);
  return static_cast<int>(cudaGetLastError());
}
