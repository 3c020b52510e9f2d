// K3: flash-attention forward (online softmax), returning O and the
// per-row logsumexp.
//
// Replaces lipreading_video_generation_tpu/ops/attention.py::_flash_kernel
// (driven by _flash_forward; scripts/profile_flash_dpad.py launches the same
// kernel body). It computes what that kernel computes: q scaled in float32,
// QK^T, the probabilities P and P.V all in float32 (P is not rounded to V's
// dtype), output in q's dtype, lse = m + log(l) in float32. Causal masking
// is bottom-right aligned (key j is visible to row i iff j <= i + s_k - s_q).
// Rows with no visible key come out as the uniform mean of V over the s_k
// real keys, as attention_reference gives them (the TPU kernel averages over
// its padded key length there instead).
//
// Not a carry-over of the TPU blocking: on the TPU the kv axis of the grid
// is sequential and the running (m, l, acc) live in VMEM scratch between
// grid steps. Here one block of 256 threads owns one 64-row query tile of
// one (batch, head) and walks all 64-key K/V tiles itself, so nothing is
// carried between blocks. Per block:
//   - the Q tile, scaled, is stored transposed (Qt[c][row]) in shared memory
//     as float, once;
//   - per key tile, K transposed (Kt[c][key]) and V (Vs[key][c]) are staged
//     in shared memory as float (zero-filled past s_k and past d);
//   - thread (ty, tx), ty, tx in 0..15, computes the 4x4 scores of rows
//     4ty..4ty+3 and keys 4tx..4tx+3 with one float4 of Qt and one of Kt per
//     step of the head dim; the 16 threads of a row reduce its max and sum
//     with xor shuffles (they are one half of a warp);
//   - P goes through shared memory, and the same thread accumulates the 4
//     rows of O at columns 64n + 4tx .. 64n + 4tx + 3 in registers (float32).
// The head dim is padded to DP in {64, 128, 256} inside the kernel; q, k, v
// are read through (batch, head, row) strides with unit column stride, so
// the column slices of the U-Net's fused qkv projection need no copy, and O
// is written through strides too, so (B, S, H, D) comes out without a
// transpose.
//
// Bound: CUDA-core float32 FMAs. At the U-Net's 16384-token d=64 shape the
// kernel does 4*S^2*d = 6.9e10 FLOP per (batch, head) and reads K/V from L2
// once per query tile; the inner loops issue 16 FMAs per two 16-byte shared
// loads, so FMA throughput (67 TFLOP/s peak) and not bandwidth is the
// ceiling. Tensor cores (mma.sync / wgmma, with P kept at float precision
// by splitting it into two bf16 halves) are the way past it, in a later
// change.
#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per shared-memory tile
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kPad = 4;          // row padding in floats (keeps float4 alignment)
constexpr float kNegInf = -1.7014117331926443e38f;   // finfo(float32).min / 2
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Max and sum over the 16 lanes of a half warp (one query row).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

// Shared-memory layout of one block, in floats.
template <int DP> struct Layout {
  static constexpr int ld_q = kBQ + kPad;   // Qt[c][row]
  static constexpr int ld_k = kBK + kPad;   // Kt[c][key]
  static constexpr int ld_v = DP + kPad;    // Vs[key][c]
  static constexpr int ld_p = kBK + kPad;   // Ps[row][key]
  static constexpr int q = DP * ld_q;
  static constexpr int k = DP * ld_k;
  static constexpr int v = kBK * ld_v;
  static constexpr int p = kBQ * ld_p;
  static constexpr size_t bytes = static_cast<size_t>(q + k + v + p) * sizeof(float);
};

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int heads, int s_q, int s_k,
                 int d, long long q_bs, long long q_hs, long long q_ss, long long k_bs,
                 long long k_hs, long long k_ss, long long v_bs, long long v_hs,
                 long long v_ss, long long o_bs, long long o_hs, long long o_ss,
                 float scale, int causal) {
  using L = Layout<DP>;
  constexpr int NC = DP / 64;   // float4 column groups of O per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;
  float* kt = qt + L::q;
  float* vs = kt + L::k;
  float* ps = vs + L::v;

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh - (bh / heads) * heads;
  const int r0 = blockIdx.x * kBQ;
  const T* qb = q + b * q_bs + h * q_hs;
  const T* kb = k + b * k_bs + h * k_hs;
  const T* vb = v + b * v_bs + h * v_hs;
  T* ob = o + b * o_bs + h * o_hs;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = lane & 15;                       // key / column group
  const int ty = (tid >> 5) * 2 + (lane >> 4);    // row group

  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, c = i - (i / DP) * DP;
    float x = 0.f;
    if (r0 + r < s_q && c < d) x = to_float(qb[(r0 + r) * q_ss + c]) * scale;
    qt[c * L::ld_q + r] = x;
  }

  float acc[4][4 * NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  // Causal: tiles past the block's last visible key are skipped, unless a
  // row of the block sees no key at all (it averages V over every key).
  const int off = s_k - s_q;
  int n_tiles = (s_k + kBK - 1) / kBK;
  if (causal && r0 + off >= 0) n_tiles = min(s_k - 1, r0 + kBQ - 1 + off) / kBK + 1;

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kBK;
    __syncthreads();   // Q stored / the previous tile's readers done
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int j = i / DP, c = i - (i / DP) * DP;
      float kx = 0.f, vx = 0.f;
      if (j0 + j < s_k && c < d) {
        kx = to_float(kb[(j0 + j) * k_ss + c]);
        vx = to_float(vb[(j0 + j) * v_ss + c]);
      }
      kt[c * L::ld_k + j] = kx;
      vs[j * L::ld_v + c] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + c * L::ld_q + 4 * ty);
      const float4 ka = *reinterpret_cast<const float4*>(kt + c * L::ld_k + 4 * tx);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int key = j0 + 4 * tx + jj;
        if (key >= s_k) s[i][jj] = -INFINITY;                  // not a key: weight 0
        else if (causal && key > row + off) s[i][jj] = kNegInf;  // masked, as in JAX
        mx = fmaxf(mx, s[i][jj]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));   // finite: key j0 is real
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[i][jj] = expf(s[i][jj] - m_new);
        sum += s[i][jj];
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
      *reinterpret_cast<float4*>(ps + (4 * ty + i) * L::ld_p + 4 * tx) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 pa = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * L::ld_p + j);
        p[i][0] = pa.x; p[i][1] = pa.y; p[i][2] = pa.z; p[i][3] = pa.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const float4 va =
              *reinterpret_cast<const float4*>(vs + (j + jj) * L::ld_v + 64 * n + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * n + 0] = fmaf(p[i][jj], va.x, acc[i][4 * n + 0]);
            acc[i][4 * n + 1] = fmaf(p[i][jj], va.y, acc[i][4 * n + 1]);
            acc[i][4 * n + 2] = fmaf(p[i][jj], va.z, acc[i][4 * n + 2]);
            acc[i][4 * n + 3] = fmaf(p[i][jj], va.w, acc[i][4 * n + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= s_q) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int c = 64 * n + 4 * tx + cc;
        if (c < d) ob[row * o_ss + c] = from_float<T>(acc[i][4 * n + cc] / denom);
      }
    if (tx == 0) lse[static_cast<long long>(bh) * s_q + row] = m[i] + logf(denom);
  }
}

template <typename T, int DP>
int launch_dp(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
              int heads, int s_q, int s_k, int d, const long long* st, float scale,
              int causal, cudaStream_t stream) {
  const size_t smem = Layout<DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s_q + kBQ - 1) / kBQ, batch * heads);
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), heads, s_q, s_k, d, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
           int heads, int s_q, int s_k, int d, const long long* st, float scale, int causal,
           void* stream) {
  if (batch * heads > 65535 || s_q <= 0 || s_k <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_dp<T, 64>(q, k, v, o, lse, batch, heads, s_q, s_k, d, st, scale, causal, cs);
  if (d <= 128) return launch_dp<T, 128>(q, k, v, o, lse, batch, heads, s_q, s_k, d, st, scale, causal, cs);
  if (d <= 256) return launch_dp<T, 256>(q, k, v, o, lse, batch, heads, s_q, s_k, d, st, scale, causal, cs);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v: (batch, heads, s, d) element (b, h, r, c) at b*bs + h*hs + r*ss + c
// (strides in elements, st = {q_bs, q_hs, q_ss, k_bs, k_hs, k_ss, v_bs, v_hs,
// v_ss, o_bs, o_hs, o_ss}); o: same dtype, written through its strides;
// lse: contiguous float32 (batch*heads, s_q). d <= 256. Returns
// cudaGetLastError() after the launch.
extern "C" int lvg_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int batch, int heads, int s_q, int s_k, int d,
                                  const long long* strides, float scale, int causal,
                                  void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, lse, batch, heads, s_q, s_k, d, strides, scale,
                               causal, stream);
}

extern "C" int lvg_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int batch, int heads, int s_q, int s_k, int d,
                                 const long long* strides, float scale, int causal,
                                 void* stream) {
  return launch<float>(q, k, v, o, lse, batch, heads, s_q, s_k, d, strides, scale, causal,
                       stream);
}
