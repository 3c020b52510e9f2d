// K1: CLAHE (contrast-limited adaptive histogram equalisation), one image
// per block.
//
// Replaces lipreading_video_generation_tpu/ops/clahe_pallas.py::_kernel.
// The TPU kernel turns the histograms and the LUT blend into one-hot
// matmuls, because its VMEM is large and its matrix unit is the fast path.
// Here each block keeps the gh*gw tile histograms (256 bins each) in shared
// memory, fills them with shared-memory atomics, turns each into a LUT in
// place (clip, redistribute, inclusive scan: one warp per tile, eight bins
// per lane), and every thread blends the four neighbouring tile LUTs at its
// own pixel's bin. No one-hot and no (H*W x nbins) intermediate.
//
// Bound: device memory traffic is 8 bytes a pixel (one float read, one
// written), so at the main-path shape (48x48 images, 8x8 tiles) the kernel
// is bound by latency and shared-memory atomics, not by bandwidth or FLOPs.
// The 64 KB of int32 counts exceed the 48 KB static limit, so the block
// asks for dynamic shared memory.
//
// Numerics follow the port's plain version (ops/clahe_cuda.py::
// clahe_reference): rintf rounds half to even like jnp.round; histograms,
// CDF and LUT are exact; the LUT blend is float32.
#include <cuda_runtime.h>

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;
constexpr int kBinsPerLane = kBins / 32;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ int to_bin(float v) {
  return static_cast<int>(fminf(fmaxf(rintf(v), 0.f), static_cast<float>(kBins - 1)));
}

// Half-pixel tile-centre coordinate of pixel i along one axis, split into
// the two (edge-clamped) neighbouring tiles and the weight of the second.
__device__ __forceinline__ void tile_coord(int i, int grid, int padded,
                                           int* t0, int* t1, float* f) {
  const float src = (static_cast<float>(i) + 0.5f) * static_cast<float>(grid) /
                    static_cast<float>(padded) - 0.5f;
  const float fl = floorf(src);
  const int i0 = static_cast<int>(fl);
  *f = src - fl;
  *t0 = min(max(i0, 0), grid - 1);
  *t1 = min(max(i0 + 1, 0), grid - 1);
}

__global__ void __launch_bounds__(kThreads)
clahe_kernel(const float* __restrict__ in, float* __restrict__ out, int h, int w,
             int gh, int gw, int th, int tw, float limit) {
  extern __shared__ int hist[];  // gh*gw*kBins counts, then the LUTs as float
  const int tiles = gh * gw;
  const int hp = th * gh, wp = tw * gw;
  const float* img = in + static_cast<size_t>(blockIdx.x) * h * w;
  float* dst = out + static_cast<size_t>(blockIdx.x) * h * w;

  for (int i = threadIdx.x; i < tiles * kBins; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  // Histograms over the edge-replicated padded image.
  for (int p = threadIdx.x; p < hp * wp; p += blockDim.x) {
    const int y = p / wp, x = p - (p / wp) * wp;
    const float v = img[min(y, h - 1) * w + min(x, w - 1)];
    atomicAdd(&hist[((y / th) * gw + x / tw) * kBins + to_bin(v)], 1);
  }
  __syncthreads();

  // Clip at `limit`, spread the excess uniformly, scan, scale to a LUT.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float area = static_cast<float>(th * tw);
  for (int t = warp; t < tiles; t += nwarps) {
    int* row = hist + t * kBins + lane * kBinsPerLane;
    float c[kBinsPerLane];
    float excess = 0.f;
#pragma unroll
    for (int k = 0; k < kBinsPerLane; ++k) {
      const float hv = static_cast<float>(row[k]);
      c[k] = fminf(hv, limit);
      excess += hv - c[k];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) excess += __shfl_xor_sync(kFullMask, excess, off);
    const float add = excess / static_cast<float>(kBins);
    float run = 0.f;
#pragma unroll
    for (int k = 0; k < kBinsPerLane; ++k) {
      run += c[k] + add;
      c[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(kFullMask, incl, off);
      if (lane >= off) incl += n;
    }
    const float base = incl - run;
    float* lut = reinterpret_cast<float*>(row);  // each lane rewrites only its own bins
#pragma unroll
    for (int k = 0; k < kBinsPerLane; ++k) {
      const float cdf = base + c[k];
      lut[k] = fminf(fmaxf(rintf(cdf * static_cast<float>(kBins - 1) / area), 0.f),
                     static_cast<float>(kBins - 1));
    }
  }
  __syncthreads();

  // Bilinear blend of the four neighbouring tile LUTs at each pixel's bin.
  const float* lut = reinterpret_cast<const float*>(hist);
  for (int p = threadIdx.x; p < h * w; p += blockDim.x) {
    const int y = p / w, x = p - (p / w) * w;
    int r0, r1, c0, c1;
    float fy, fx;
    tile_coord(y, gh, hp, &r0, &r1, &fy);
    tile_coord(x, gw, wp, &c0, &c1, &fx);
    const int b = to_bin(img[p]);
    const float l00 = lut[(r0 * gw + c0) * kBins + b];
    const float l01 = lut[(r0 * gw + c1) * kBins + b];
    const float l10 = lut[(r1 * gw + c0) * kBins + b];
    const float l11 = lut[(r1 * gw + c1) * kBins + b];
    dst[p] = (1.f - fy) * ((1.f - fx) * l00 + fx * l01) +
             fy * ((1.f - fx) * l10 + fx * l11);
  }
}

}  // namespace

// in, out: (n, h, w) float32, contiguous, on the current device.
// Returns cudaGetLastError() after the launch.
extern "C" int lvg_clahe_f32(const void* in, void* out, int n, int h, int w,
                             int gh, int gw, float limit, void* stream) {
  const int th = (h + gh - 1) / gh, tw = (w + gw - 1) / gw;
  const size_t smem = static_cast<size_t>(gh) * gw * kBins * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      clahe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  clahe_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), h, w, gh, gw, th, tw, limit);
  return static_cast<int>(cudaGetLastError());
}
