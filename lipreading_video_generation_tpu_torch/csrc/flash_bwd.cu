// K4 and K5: the flash-attention backward (FlashAttention-2), dK/dV pass
// and dQ pass, on CUDA cores. These kernels serve float32 inputs (tensor
// cores would mean TF32) and bf16 inputs whose base addresses or strides
// are not multiples of 16 bytes; aligned bf16 inputs run the tensor-core
// kernels of flash_bwd_sm90.cu (ops/attention.py::flash_route decides).
//
// Replace lipreading_video_generation_tpu/ops/attention.py::_bwd_dkv_kernel
// (K4) and ::_bwd_dq_kernel (K5), driven by _flash_backward_pallas. They
// compute what those kernels compute, from the forward's per-row logsumexp
// and Delta = sum_c dO*O (formed outside, with torch ops, as JAX forms it
// with XLA):
//   s  = (Q K^T) * scale          (scaled after the product, as in JAX)
//   P  = exp(s - lse)             (float32; never rounded to the input type)
//   dP = dO V^T,   dS = P * (dP - Delta) * scale
//   K4: dV = P^T dO,   dK = dS^T Q        K5: dQ = dS K
// all in float32, gradients written in the input type. Causal masking is
// bottom-right aligned (key j visible to row i iff j <= i + s_k - s_q);
// masked pairs get dS = 0. A row that sees no key at all (causal with
// s_q > s_k) follows autograd through attention_reference, not JAX's
// kernel: its forward output is the mean of V over the s_k keys, so it
// adds dO/s_k to every dV row and nothing to dQ or dK. (Its lse has
// absorbed log s_k into finfo.min/2, so exp(s - lse) would give 1, not
// 1/s_k: the kernels do not use it there.)
//
// Not a carry-over of the TPU blocking: on the TPU the inner axis of each
// grid is sequential and the accumulators live in VMEM between grid steps.
// Here each block owns its output tile and walks the other axis itself:
//   K4: one block of 256 threads per (batch*head, 64-key tile); K and V of
//       the tile stay in shared memory; per query tile it stages Q, dO,
//       lse and Delta, recomputes s and dP (thread (ty, tx) owns query rows
//       RQ*ty .. RQ*ty+RQ-1 and keys tx, tx+16, tx+32, tx+48, so the K/V
//       rows that 16 neighbouring lanes read lie in different banks), puts
//       P and dS through shared memory, then accumulates dV and dK for keys
//       4ty .. 4ty+3 and columns 64n + 4tx .. 64n + 4tx + 3 in registers.
//       Query tiles that see none of the block's keys are skipped, unless
//       they hold a row that sees no key (its P reaches every key).
//   K5: one block per (batch*head, query tile); Q and dO stay in shared
//       memory; per 64-key tile it stages K and V, recomputes s and dP the
//       same way, puts dS through shared memory and accumulates dQ for its
//       RQ rows and the same columns in registers. Key tiles past the
//       tile's last visible key are skipped.
// Every tile is row-major float in shared memory with rows padded by 4
// floats (16-byte aligned float4 loads, conflict-free across 8 lanes).
// The head dim is padded to DP in {64, 128, 256} inside the kernel; at
// DP = 256 the query tile is 32 rows (BQ) so that K, V, Q and dO tiles fit
// the 227 KB a block may use (K4: 217,344 B, K5: 208,384 B). Head dims
// above 256 walk d in slices of 256 columns with DP = 256's tiles (the
// "sliced" kernels): s = Q.K^T and dP = dO.V^T sum over slices of Q, dO, K
// and V staged one after the other, and blockIdx.y picks the 256 columns of
// dK and dV (K4) or dQ (K5) that the block accumulates and writes, so shared
// memory does not grow with d (s and dP are recomputed once for each slice
// of the output, and the slices of the block's own tile are staged again
// for each tile of the other axis). q, k, v and dO are read, and dQ/dK/dV written, through (batch, head, row) strides
// with unit column stride, so the column slices of the U-Net's fused qkv
// projection need no copy, and the gradients come out as (B, S, H, D).
//
// Bound: CUDA-core float32 FMAs, like K3. K4 does 4 products of
// BQ x 64 x DP per query tile and K5 3 (Q K^T and dO V^T are recomputed by
// both), 14 S^2 d FLOP per (batch, head) in all against the forward's
// 4 S^2 d; their inner loops run 16 FMAs per two 16-byte shared loads
// (products with K^T/V^T) or 32 per 2 + 2*NC (the accumulations). A
// one-pass backward with an atomic dQ is a later change.
#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kPad = 4;          // row padding in floats

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// N (4 or 2) consecutive floats from an address aligned to 4 N bytes.
__device__ __forceinline__ void ldn(float (&dst)[4], const float* p) {
  const float4 x = ld4(p);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}
__device__ __forceinline__ void ldn(float (&dst)[2], const float* p) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  dst[0] = x.x; dst[1] = x.y;
}

// Tile shapes and shared-memory layout (in floats) for head dim DP.
template <int DP> struct Tiles {
  static constexpr int BQ = DP == 256 ? 32 : 64;   // query rows per tile
  static constexpr int BK = 64;                    // keys per tile
  static constexpr int RQ = BQ / 16;               // query rows per thread in s, dP
  static constexpr int KQ = BK / 16;               // keys per thread
  static constexpr int NC = DP / 64;               // float4 column groups per thread
  static constexpr int LD = DP + kPad;             // row stride of Q, dO, K, V
  static constexpr int LDP = BK + kPad;            // row stride of P, dS
  static constexpr size_t dkv_bytes =
      static_cast<size_t>(2 * BQ * LD + 2 * BK * LD + 2 * BQ * LDP + 2 * BQ) * sizeof(float);
  static constexpr size_t dq_bytes =
      static_cast<size_t>(2 * BQ * LD + 2 * BK * LD + BQ * LDP) * sizeof(float);
};

struct Params {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *g0, *g1;                 // K4: dK, dV; K5: dQ
  int heads, s_q, s_k, d;
  long long st[18];              // (batch, head, row) strides of q, k, v, dO, g0, g1
  float scale;
  int causal;
};

// rows [r0, r0 + rows) of a (row, column) matrix at src (row stride ss) into
// dst[r][c] (row stride LD), zero past n_rows and past d.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long ss, int r0,
                                          int rows, int n_rows, int d) {
  for (int i = threadIdx.x; i < rows * DP; i += kThreads) {
    const int r = i / DP, c = i - (i / DP) * DP;
    float x = 0.f;
    if (r0 + r < n_rows && c < d) x = to_float(src[(r0 + r) * ss + c]);
    dst[r * Tiles<DP>::LD + c] = x;
  }
}

template <int DP>
__device__ __forceinline__ void zero(float (&s)[Tiles<DP>::RQ][Tiles<DP>::KQ],
                                     float (&t)[Tiles<DP>::RQ][Tiles<DP>::KQ]) {
#pragma unroll
  for (int i = 0; i < Tiles<DP>::RQ; ++i)
#pragma unroll
    for (int jj = 0; jj < Tiles<DP>::KQ; ++jj) s[i][jj] = t[i][jj] = 0.f;
}

// s[i][jj] += a[ra + i] . b[tx + 16 jj] and t[i][jj] += c[ra + i] . e[tx + 16 jj]
// over the DP columns of row-major tiles.
template <int DP>
__device__ __forceinline__ void two_products(const float* a, const float* b, const float* c,
                                             const float* e, int ra, int tx,
                                             float (&s)[Tiles<DP>::RQ][Tiles<DP>::KQ],
                                             float (&t)[Tiles<DP>::RQ][Tiles<DP>::KQ]) {
  constexpr int RQ = Tiles<DP>::RQ, KQ = Tiles<DP>::KQ, LD = Tiles<DP>::LD;
#pragma unroll 2
  for (int col = 0; col < DP; col += 4) {
    float4 av[RQ], cv[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      av[i] = ld4(a + (ra + i) * LD + col);
      cv[i] = ld4(c + (ra + i) * LD + col);
    }
#pragma unroll
    for (int jj = 0; jj < KQ; ++jj) {
      const float4 bv = ld4(b + (tx + 16 * jj) * LD + col);
      const float4 ev = ld4(e + (tx + 16 * jj) * LD + col);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        s[i][jj] = dot4(av[i], bv, s[i][jj]);
        t[i][jj] = dot4(cv[i], ev, t[i][jj]);
      }
    }
  }
}

template <typename T, int DP, bool SLICED>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_kernel(Params p) {
  using L = Tiles<DP>;
  constexpr int BQ = L::BQ, BK = L::BK, RQ = L::RQ, KQ = L::KQ, NC = L::NC, LD = L::LD,
                LDP = L::LDP;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + BK * LD;
  float* qs = vs + BK * LD;
  float* dos = qs + BQ * LD;
  float* ps = dos + BQ * LD;
  float* dss = ps + BQ * LDP;
  float* lse_s = dss + BQ * LDP;
  float* delta_s = lse_s + BQ;

  // blockIdx.x folds (batch * head, key tile), the tile running fastest
  const int n_blk = (p.s_k + BK - 1) / BK;
  const int bh = blockIdx.x / n_blk, blk = blockIdx.x - (blockIdx.x / n_blk) * n_blk;
  const int b = bh / p.heads, h = bh - (bh / p.heads) * p.heads;
  const T* qb = static_cast<const T*>(p.q) + b * p.st[0] + h * p.st[1];
  const T* kb = static_cast<const T*>(p.k) + b * p.st[3] + h * p.st[4];
  const T* vb = static_cast<const T*>(p.v) + b * p.st[6] + h * p.st[7];
  const T* dob = static_cast<const T*>(p.dout) + b * p.st[9] + h * p.st[10];
  T* dkb = static_cast<T*>(p.g0) + b * p.st[12] + h * p.st[13];
  T* dvb = static_cast<T*>(p.g1) + b * p.st[15] + h * p.st[16];
  const float* lse = p.lse + static_cast<long long>(bh) * p.s_q;
  const float* delta = p.delta + static_cast<long long>(bh) * p.s_q;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = lane & 15;
  const int ty = (tid >> 5) * 2 + (lane >> 4);
  const int ra = RQ * ty;                 // this thread's rows of a query tile
  const int j0 = blk * BK;
  const int off = p.s_k - p.s_q;
  const float inv_sk = 1.f / static_cast<float>(p.s_k);
  // sliced: the slices of d that s and dP sum over, and the first column of
  // the block's slice of dK and dV (and of the Q and dO they accumulate)
  const int n_slices = SLICED ? (p.d + DP - 1) / DP : 1;
  const int v0 = SLICED ? static_cast<int>(blockIdx.y) * DP : 0;
  const int c_last = (n_slices - 1) * DP;

  if (!SLICED) {
    load_tile<T, DP>(ks, kb, p.st[5], j0, BK, p.s_k, p.d);
    load_tile<T, DP>(vs, vb, p.st[8], j0, BK, p.s_k, p.d);
  }

  float dk[KQ][4 * NC], dv[KQ][4 * NC];
#pragma unroll
  for (int i = 0; i < KQ; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int n_tiles = (p.s_q + BQ - 1) / BQ;
  for (int t = 0; t < n_tiles; ++t) {
    const int r0 = t * BQ;
    // Causal: skip a query tile that sees none of these keys, unless one of
    // its rows sees no key at all (its P is 1/s_k at every key).
    if (p.causal && j0 > r0 + BQ - 1 + off && r0 + off >= 0) continue;
    float s[RQ][KQ], dp[RQ][KQ];
    zero<DP>(s, dp);
    for (int sl = 0; sl < n_slices; ++sl) {
      const int c0 = sl * DP;
      __syncthreads();   // the previous tile's or slice's readers are done
      if (SLICED) {
        load_tile<T, DP>(ks, kb + c0, p.st[5], j0, BK, p.s_k, p.d - c0);
        load_tile<T, DP>(vs, vb + c0, p.st[8], j0, BK, p.s_k, p.d - c0);
      }
      load_tile<T, DP>(qs, qb + c0, p.st[2], r0, BQ, p.s_q, p.d - c0);
      load_tile<T, DP>(dos, dob + c0, p.st[11], r0, BQ, p.s_q, p.d - c0);
      if (sl == 0 && tid < BQ) {
        const bool in = r0 + tid < p.s_q;
        lse_s[tid] = in ? lse[r0 + tid] : 0.f;
        delta_s[tid] = in ? delta[r0 + tid] : 0.f;
      }
      __syncthreads();
      two_products<DP>(qs, ks, dos, vs, ra, tx, s, dp);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = r0 + ra + i;
      const bool blind = p.causal && row + off < 0;   // sees no key
#pragma unroll
      for (int jj = 0; jj < KQ; ++jj) {
        const int key = j0 + tx + 16 * jj;
        const bool real = key < p.s_k && row < p.s_q;
        const bool vis = real && !(p.causal && key > row + off);
        float pv = 0.f, dsv = 0.f;
        if (vis) {
          pv = expf(s[i][jj] * p.scale - lse_s[ra + i]);
          dsv = pv * (dp[i][jj] - delta_s[ra + i]) * p.scale;
        } else if (real && blind) {
          pv = inv_sk;
        }
        ps[(ra + i) * LDP + tx + 16 * jj] = pv;
        dss[(ra + i) * LDP + tx + 16 * jj] = dsv;
      }
    }
    if (SLICED && v0 != c_last) {   // the Q and dO columns of the block's slice
      __syncthreads();
      load_tile<T, DP>(qs, qb + v0, p.st[2], r0, BQ, p.s_q, p.d - v0);
      load_tile<T, DP>(dos, dob + v0, p.st[11], r0, BQ, p.s_q, p.d - v0);
    }
    __syncthreads();

#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float pk[KQ], dsk[KQ];
      ldn(pk, ps + r * LDP + KQ * ty);
      ldn(dsk, dss + r * LDP + KQ * ty);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float4 gv = ld4(dos + r * LD + 64 * n + 4 * tx);
        const float4 qv = ld4(qs + r * LD + 64 * n + 4 * tx);
#pragma unroll
        for (int i = 0; i < KQ; ++i) {
          dv[i][4 * n + 0] = fmaf(pk[i], gv.x, dv[i][4 * n + 0]);
          dv[i][4 * n + 1] = fmaf(pk[i], gv.y, dv[i][4 * n + 1]);
          dv[i][4 * n + 2] = fmaf(pk[i], gv.z, dv[i][4 * n + 2]);
          dv[i][4 * n + 3] = fmaf(pk[i], gv.w, dv[i][4 * n + 3]);
          dk[i][4 * n + 0] = fmaf(dsk[i], qv.x, dk[i][4 * n + 0]);
          dk[i][4 * n + 1] = fmaf(dsk[i], qv.y, dk[i][4 * n + 1]);
          dk[i][4 * n + 2] = fmaf(dsk[i], qv.z, dk[i][4 * n + 2]);
          dk[i][4 * n + 3] = fmaf(dsk[i], qv.w, dk[i][4 * n + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KQ; ++i) {
    const int key = j0 + KQ * ty + i;
    if (key >= p.s_k) continue;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int c = v0 + 64 * n + 4 * tx + cc;
        if (c < p.d) {
          dkb[key * p.st[14] + c] = from_float<T>(dk[i][4 * n + cc]);
          dvb[key * p.st[17] + c] = from_float<T>(dv[i][4 * n + cc]);
        }
      }
  }
}

template <typename T, int DP, bool SLICED>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(Params p) {
  using L = Tiles<DP>;
  constexpr int BQ = L::BQ, BK = L::BK, RQ = L::RQ, KQ = L::KQ, NC = L::NC, LD = L::LD,
                LDP = L::LDP;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + BQ * LD;
  float* ks = dos + BQ * LD;
  float* vs = ks + BK * LD;
  float* dss = vs + BK * LD;

  // blockIdx.x folds (batch * head, query tile), the tile running fastest
  const int n_blk = (p.s_q + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_blk, blk = blockIdx.x - (blockIdx.x / n_blk) * n_blk;
  const int b = bh / p.heads, h = bh - (bh / p.heads) * p.heads;
  const T* qb = static_cast<const T*>(p.q) + b * p.st[0] + h * p.st[1];
  const T* kb = static_cast<const T*>(p.k) + b * p.st[3] + h * p.st[4];
  const T* vb = static_cast<const T*>(p.v) + b * p.st[6] + h * p.st[7];
  const T* dob = static_cast<const T*>(p.dout) + b * p.st[9] + h * p.st[10];
  T* dqb = static_cast<T*>(p.g0) + b * p.st[12] + h * p.st[13];
  const float* lse = p.lse + static_cast<long long>(bh) * p.s_q;
  const float* delta = p.delta + static_cast<long long>(bh) * p.s_q;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = lane & 15;
  const int ty = (tid >> 5) * 2 + (lane >> 4);
  const int ra = RQ * ty;
  const int r0 = blk * BQ;
  const int off = p.s_k - p.s_q;
  // sliced: as in K4, with dQ's slice and the K columns it accumulates
  const int n_slices = SLICED ? (p.d + DP - 1) / DP : 1;
  const int v0 = SLICED ? static_cast<int>(blockIdx.y) * DP : 0;
  const int c_last = (n_slices - 1) * DP;

  if (!SLICED) {
    load_tile<T, DP>(qs, qb, p.st[2], r0, BQ, p.s_q, p.d);
    load_tile<T, DP>(dos, dob, p.st[11], r0, BQ, p.s_q, p.d);
  }
  float lse_r[RQ], delta_r[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const bool in = r0 + ra + i < p.s_q;
    lse_r[i] = in ? lse[r0 + ra + i] : 0.f;
    delta_r[i] = in ? delta[r0 + ra + i] : 0.f;
  }

  float acc[RQ][4 * NC];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;

  // Causal: key tiles past the tile's last visible key add nothing (rows
  // that see no key get dQ = 0).
  int n_tiles = (p.s_k + BK - 1) / BK;
  if (p.causal) {
    const int last = min(p.s_k - 1, r0 + BQ - 1 + off);
    n_tiles = last < 0 ? 0 : last / BK + 1;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * BK;
    float s[RQ][KQ], dp[RQ][KQ];
    zero<DP>(s, dp);
    for (int sl = 0; sl < n_slices; ++sl) {
      const int c0 = sl * DP;
      __syncthreads();   // Q/dO stored / the previous tile's or slice's readers done
      if (SLICED) {
        load_tile<T, DP>(qs, qb + c0, p.st[2], r0, BQ, p.s_q, p.d - c0);
        load_tile<T, DP>(dos, dob + c0, p.st[11], r0, BQ, p.s_q, p.d - c0);
      }
      load_tile<T, DP>(ks, kb + c0, p.st[5], j0, BK, p.s_k, p.d - c0);
      load_tile<T, DP>(vs, vb + c0, p.st[8], j0, BK, p.s_k, p.d - c0);
      __syncthreads();
      two_products<DP>(qs, ks, dos, vs, ra, tx, s, dp);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = r0 + ra + i;
#pragma unroll
      for (int jj = 0; jj < KQ; ++jj) {
        const int key = j0 + tx + 16 * jj;
        const bool vis = key < p.s_k && row < p.s_q && !(p.causal && key > row + off);
        float dsv = 0.f;
        if (vis) {
          const float pv = expf(s[i][jj] * p.scale - lse_r[i]);
          dsv = pv * (dp[i][jj] - delta_r[i]) * p.scale;
        }
        dss[(ra + i) * LDP + tx + 16 * jj] = dsv;
      }
    }
    if (SLICED && v0 != c_last) {   // the K columns of the block's slice
      __syncthreads();
      load_tile<T, DP>(ks, kb + v0, p.st[5], j0, BK, p.s_k, p.d - v0);
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float dsj[RQ][4];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float4 da = ld4(dss + (ra + i) * LDP + j);
        dsj[i][0] = da.x; dsj[i][1] = da.y; dsj[i][2] = da.z; dsj[i][3] = da.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const float4 kv = ld4(ks + (j + jj) * LD + 64 * n + 4 * tx);
#pragma unroll
          for (int i = 0; i < RQ; ++i) {
            acc[i][4 * n + 0] = fmaf(dsj[i][jj], kv.x, acc[i][4 * n + 0]);
            acc[i][4 * n + 1] = fmaf(dsj[i][jj], kv.y, acc[i][4 * n + 1]);
            acc[i][4 * n + 2] = fmaf(dsj[i][jj], kv.z, acc[i][4 * n + 2]);
            acc[i][4 * n + 3] = fmaf(dsj[i][jj], kv.w, acc[i][4 * n + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = r0 + ra + i;
    if (row >= p.s_q) continue;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int c = v0 + 64 * n + 4 * tx + cc;
        if (c < p.d) dqb[row * p.st[14] + c] = from_float<T>(acc[i][4 * n + cc]);
      }
  }
}

template <typename T, int DP, bool SLICED = false>
int launch_dp(bool dkv, const Params& p, int batch, cudaStream_t stream) {
  using L = Tiles<DP>;
  const size_t smem = dkv ? L::dkv_bytes : L::dq_bytes;
  auto kernel = dkv ? flash_bwd_dkv_kernel<T, DP, SLICED> : flash_bwd_dq_kernel<T, DP, SLICED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = dkv ? p.s_k : p.s_q;
  const int tile = dkv ? L::BK : L::BQ;
  const long long blocks = static_cast<long long>((rows + tile - 1) / tile) * batch * p.heads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), SLICED ? (p.d + DP - 1) / DP : 1);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(bool dkv, const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* g0, void* g1, int batch, int heads,
           int s_q, int s_k, int d, const long long* strides, float scale, int causal,
           void* stream) {
  if (batch <= 0 || heads <= 0 || s_q <= 0 || s_k <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.g0 = g0; p.g1 = g1;
  p.heads = heads; p.s_q = s_q; p.s_k = s_k; p.d = d;
  for (int i = 0; i < (dkv ? 18 : 15); ++i) p.st[i] = strides[i];
  p.scale = scale;
  p.causal = causal;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_dp<T, 64>(dkv, p, batch, cs);
  if (d <= 128) return launch_dp<T, 128>(dkv, p, batch, cs);
  if (d <= 256) return launch_dp<T, 256>(dkv, p, batch, cs);
  return launch_dp<T, 256, true>(dkv, p, batch, cs);
}

}  // namespace

// q, k, v, dout: (batch, heads, s, d), element (b, h, r, c) at
// b*bs + h*hs + r*ss + c; lse, delta: contiguous float32 (batch*heads, s_q).
// K4 writes dk, dv (shape of k) and takes strides {q, k, v, dout, dk, dv} x
// {bs, hs, ss}; K5 writes dq (shape of q) and takes {q, k, v, dout, dq} x
// {bs, hs, ss}. Any d >= 1. Each returns cudaGetLastError() after the launch.
extern "C" int lvg_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, int batch, int heads, int s_q,
                                      int s_k, int d, const long long* strides, float scale,
                                      int causal, void* stream) {
  return launch<__nv_bfloat16>(true, q, k, v, dout, lse, delta, dk, dv, batch, heads, s_q,
                               s_k, d, strides, scale, causal, stream);
}

extern "C" int lvg_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, int batch, int heads, int s_q,
                                     int s_k, int d, const long long* strides, float scale,
                                     int causal, void* stream) {
  return launch<float>(true, q, k, v, dout, lse, delta, dk, dv, batch, heads, s_q, s_k, d,
                       strides, scale, causal, stream);
}

extern "C" int lvg_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, int batch, int heads, int s_q, int s_k, int d,
                                     const long long* strides, float scale, int causal,
                                     void* stream) {
  return launch<__nv_bfloat16>(false, q, k, v, dout, lse, delta, dq, nullptr, batch, heads,
                               s_q, s_k, d, strides, scale, causal, stream);
}

extern "C" int lvg_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, int batch, int heads, int s_q, int s_k, int d,
                                    const long long* strides, float scale, int causal,
                                    void* stream) {
  return launch<float>(false, q, k, v, dout, lse, delta, dq, nullptr, batch, heads, s_q, s_k,
                       d, strides, scale, causal, stream);
}
