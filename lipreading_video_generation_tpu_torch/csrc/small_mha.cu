// K2: small-sequence multi-head self-attention forward, one block per
// (batch element, head).
//
// Replaces lipreading_video_generation_tpu/ops/attention.py::
// _small_mha_kernel. The TPU kernel folds all heads of a batch element into
// one (H*S_pad)^2 matmul behind a block-diagonal mask, which costs H times
// the matrix work, to keep its sequential grid short. Blocks run in
// parallel here, so each block takes one head and does no cross-head work.
//
// Per block: K and V of the head are read straight from the (B, S, E)
// layout (row stride given, so the q/k/v column slices of a fused qkv
// projection need no copy) into shared memory as float; K rows are padded
// to d+1 floats so that lanes reading different keys hit different banks.
// Each warp then takes one query row at a time: its lanes compute the
// row's scores in float32 at scale 1/sqrt(d) (causal: keys j <= row only),
// the row softmax, round P to V's dtype (as the plain version's
// probs.to(v.dtype)), and accumulate P.V in float32 per output column.
//
// Bound: at the ViViT shape (S=80, d=32, 8 heads) a block moves 15 KB and
// does 0.8 MFLOP, so the kernel is bound by launch latency and the serial
// per-row work of each warp, not by bandwidth or FLOPs.
#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

// Strides are in elements: q/k/v element (b, s, h*d + c) lives at
// b*batch_stride + s*row_stride + h*d + c. The output is contiguous.
template <typename T>
__global__ void __launch_bounds__(kThreads)
small_mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                 long long v_bs, long long v_rs, int s, int heads, int d,
                 float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* ks = smem;                    // s x (d+1)
  float* vs = ks + s * ld;             // s x d
  float* qrow = vs + s * d;            // kWarps x d
  float* prow = qrow + kWarps * d;     // kWarps x s

  const int b = blockIdx.x / heads, h = blockIdx.x - (blockIdx.x / heads) * heads;
  const int e = heads * d;
  const T* kb = k + b * k_bs + h * d;
  const T* vb = v + b * v_bs + h * d;
  const T* qb = q + b * q_bs + h * d;
  T* ob = o + static_cast<long long>(b) * s * e + h * d;

  for (int i = threadIdx.x; i < s * d; i += blockDim.x) {
    const int j = i / d, c = i - (i / d) * d;
    ks[j * ld + c] = to_float(kb[j * k_rs + c]);
    vs[j * d + c] = to_float(vb[j * v_rs + c]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* qr = qrow + warp * d;
  float* pr = prow + warp * s;
  for (int r = warp; r < s; r += kWarps) {
    for (int c = lane; c < d; c += 32) qr[c] = to_float(qb[r * q_rs + c]);
    __syncwarp();
    const int n_keys = causal ? r + 1 : s;

    float m = -INFINITY;
    for (int j = lane; j < n_keys; j += 32) {
      float acc = 0.f;
      for (int c = 0; c < d; ++c) acc += qr[c] * ks[j * ld + c];
      acc *= scale;
      pr[j] = acc;
      m = fmaxf(m, acc);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n_keys; j += 32) {
      const float p = expf(pr[j] - m);
      pr[j] = p;
      l += p;
    }
    l = warp_sum(l);
    for (int j = lane; j < n_keys; j += 32) pr[j] = to_float(from_float<T>(pr[j] / l));
    __syncwarp();

    for (int c = lane; c < d; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < n_keys; ++j) acc += pr[j] * vs[j * d + c];
      ob[static_cast<long long>(r) * e + c] = from_float<T>(acc);
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           long long q_bs, long long q_rs, long long k_bs, long long k_rs,
           long long v_bs, long long v_rs, int s, int heads, int d, float scale,
           int causal, void* stream) {
  const size_t smem = (static_cast<size_t>(s) * (2 * d + 1) + kWarps * (d + s)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      small_mha_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  small_mha_kernel<T><<<batch * heads, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, s, heads, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: (batch, s, heads*d) with unit column stride and the given batch
// and row strides; o: contiguous (batch, s, heads*d) of the same dtype.
// scale is the softmax scale (1/sqrt(d)). Returns cudaGetLastError() after
// the launch.
extern "C" int lvg_small_mha_bf16(const void* q, const void* k, const void* v, void* o,
                                  int batch, long long q_bs, long long q_rs,
                                  long long k_bs, long long k_rs, long long v_bs,
                                  long long v_rs, int s, int heads, int d, float scale,
                                  int causal, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, batch, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                               s, heads, d, scale, causal, stream);
}

extern "C" int lvg_small_mha_f32(const void* q, const void* k, const void* v, void* o,
                                 int batch, long long q_bs, long long q_rs,
                                 long long k_bs, long long k_rs, long long v_bs,
                                 long long v_rs, int s, int heads, int d, float scale,
                                 int causal, void* stream) {
  return launch<float>(q, k, v, o, batch, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                       s, heads, d, scale, causal, stream);
}
