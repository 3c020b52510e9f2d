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
//
// Two variants (ops/attention.py::flash_bwd_variant picks; each entry point
// takes the index of its answer in _FLASH_BWD_VARIANTS):
//   "general": the kernels above, unchanged: bf16, unaligned views, d % 4
//       != 0, and every head dim above 256 (in slices of 256).
//   "tiled": float32 with d % 4 == 0, d <= 256, every (batch, head, row)
//       stride a multiple of 4 elements and every base on 16 bytes: the
//       float32 U-Net's head dims 64, 128 and 256, and the column slices of
//       its fused qkv projection. The kernels below (namespace tiled).
// What bounds both on this card is the float32 FMAs (67 TFLOP/s off the
// tensor cores); at (2,1,4096,64) the general kernels reach about a third of
// that bound. What held them there, and what the tiled kernels do instead
// (read from CUDA-graph times on an H100 80GB HBM3 at 700 W of builds with
// one change, or one part cut out):
//   1. Warps and grid: 256-thread blocks, one an SM (two warps a scheduler),
//      64-key (K4) or 64-query (K5) blocks: 128 blocks for 132 SMs, and a
//      barrier idles the whole SM. Tiled: 128-thread blocks under
//      __launch_bounds__(128, 2), 32 keys a K4 block and 32 queries a K5
//      block at d 64: 256 blocks at that shape, two an SM (106,496 and
//      96,256 B of shared memory), so one block's barriers and loads overlap
//      the other's products.
//   2. Staging: scalar copies between barriers, four barriers a tile.
//      Tiled: the streamed tiles (Q and dO for K4, K and V for K5) arrive by
//      16-byte cp.async.cg into two stages, zero-filled past s and d by the
//      source-size operand, each thread's addresses worked out once a block
//      (per-chunk 64-bit address arithmetic was ~400 instructions a tile);
//      two barriers a tile. K and V of a K4 block (Q and dO of a K5 block)
//      are staged once. Every block streams its head's whole other operand
//      through L2 (512 MB a call at that shape, 4-5 TB/s when nothing else
//      runs) and the copies cost a few percent beside the FMAs; issued after
//      the first pair of products instead of right after the barrier, where
//      all warps' copies queue behind each other, a little less
//      (bench/flash_bwd_phases.py times builds with each of these cut).
//   3. P and dS through shared memory by scalar stores, and masks computed
//      on every tile. Tiled: a thread's four scores of a row are four
//      consecutive keys, stored as one float4: K4 keeps K^T and V^T
//      (transposed once a block) so that S and dP come out four keys wide;
//      K5 stores dS^T, four rows wide, which is the layout its dQ = dS K
//      product reads. P = 2^(s scale log2e - lse log2e) in one MUFU.EX2;
//      the masks only in tiles with an edge or a causal mask.
//   4. Loads per FMA: both keep 4x4 register micro-tiles, 8 FMAs a 16-byte
//      shared load (10.7 and 12.8 in K5's dQ product at d 128 and 256), so
//      every thread needs half a float of shared memory an FMA: at the FMA
//      pipes' full rate that is twice the 128 bytes a cycle an SM's shared
//      memory delivers, and the kernels stay near half of their bound, with
//      the streamed copies or without them. Larger tiles do not
//      fit this shape: 16 FMAs a load takes 8x8 tiles, 64 accumulators a
//      product a thread, and dK and dV of both heads are 32 floats a thread
//      of 256 threads on each SM. Splitting each pair of products over two
//      warp groups (S, P, dV on warps 0-1; dP, dS, dK on 2-3; 8x4 tiles,
//      10.7 FMAs a load) ran K4 slower in a trial build (the exchange of P
//      and a third barrier cost more than the loads saved); register
//      double-buffering of the operands, deeper unrolling, a bank-spread
//      warp layout and three single-stage blocks an SM were each slower or
//      within 1% in trial builds. None of these was kept.
// Semantics as the general kernels: bottom-right causal masks, K4 skipping
// query tiles that see none of its keys unless they hold a row that sees no
// key (those add dO/s_k to every dV row), K5 stopping after the last
// visible key, ragged s_q and s_k, (batch, head, tile) folded onto
// blockIdx.x. No atomics: each output element is written by one thread, and
// two launches give equal bits.
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kPad = 4;          // row padding in floats
// The variants, numbered as ops/attention.py's _FLASH_BWD_VARIANTS
constexpr int kGeneral = 0, kTiled = 1;

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

// ---------------------------------------------------------------------------
// The "tiled" variant: float32, 16-byte rows (see the note at the top).
namespace tiled {

constexpr int kT = 128;        // threads a block (4 warps)
constexpr float kLog2e = 1.4426950408889634f;

// Compile-time cuts, for builds that time one part of the tiled kernels
// (bench/flash_bwd_phases.py): -DFLASH_BWD_NO_PRODUCTS runs no step of the
// product loops, -DFLASH_BWD_NO_STREAM stages only the first tile (every
// tile computes on it), -DFLASH_BWD_COPY_AT_TOP issues the next tile's
// copies right after the tile's first barrier. The gradients of a cut build
// are wrong; the kernels as built by ops/_build.py have none of them.
#ifdef FLASH_BWD_NO_PRODUCTS
constexpr bool kProducts = false;
#else
constexpr bool kProducts = true;
#endif
#ifdef FLASH_BWD_NO_STREAM
constexpr bool kStream = false;
#else
constexpr bool kStream = true;
#endif
#ifdef FLASH_BWD_COPY_AT_TOP
constexpr bool kCopyAtTop = true;
#else
constexpr bool kCopyAtTop = false;
#endif

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// 16 bytes global -> shared, asynchronously; a source size of 0 writes zeros
// (the source address is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 2^x in one MUFU.EX2 (relative error about 2^-22; 0 for large negative x).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A thread's share of staging ROWS rows of a row-major float matrix (row
// stride ss, in elements) into a tile of row stride LD floats by cp.async:
// one 16-byte column chunk c of the rows r_base, r_base + RSTEP, ...
// (consecutive threads take consecutive chunks of a row). Its source and
// destination offsets are worked out once, so a tile costs a few adds a
// chunk; zeros past n_rows and past column d (d % 4 == 0, so a chunk is all
// in or all out).
template <int ROWS, int DP, int LD>
struct Stager {
  static constexpr int C4 = DP / 4, RSTEP = kT / C4, N = ROWS / RSTEP;
  static_assert(kT % C4 == 0 && ROWS % RSTEP == 0, "a whole number of chunks a thread");
  const float* src;     // the thread's chunk of row 0
  long long step;       // RSTEP rows
  long long ss;
  int dst_off, r_base;
  bool col_ok;

  __device__ __forceinline__ Stager(const float* base, long long ss_, int d) : ss(ss_) {
    const int tid = threadIdx.x;
    r_base = tid / C4;
    const int c = (tid - r_base * C4) * 4;
    col_ok = c < d;
    src = base + r_base * ss_ + c;
    step = RSTEP * ss_;
    dst_off = r_base * LD + c;
  }

  // rows [r0, r0 + ROWS) into dst
  __device__ __forceinline__ void stage(float* dst, int r0, int n_rows) const {
    const float* s = src + r0 * ss;
    float* t = dst + dst_off;
    if (col_ok && r0 + ROWS <= n_rows) {
#pragma unroll
      for (int it = 0; it < N; ++it) cp_async16(t + it * RSTEP * LD, s + it * step, true);
    } else {
#pragma unroll
      for (int it = 0; it < N; ++it) {
        const bool ok = col_ok && r0 + r_base + it * RSTEP < n_rows;
        cp_async16(t + it * RSTEP * LD, ok ? s + it * step : src, ok);
      }
    }
  }
};

// The same rows written transposed, dst[c][r] (row stride LDT floats), by
// 16-byte global loads and scalar shared stores: once a K4 block, for K^T
// and V^T. Consecutive threads take consecutive rows of one column chunk.
template <int ROWS, int DP, int LDT>
__device__ __forceinline__ void load_transposed(float* dst, const float* src, long long ss,
                                                int r0, int n_rows, int d) {
  constexpr int C4 = DP / 4;
  static_assert(ROWS * C4 % kT == 0, "a whole number of chunks a thread");
#pragma unroll
  for (int it = 0; it < ROWS * C4 / kT; ++it) {
    const int i = static_cast<int>(threadIdx.x) + it * kT;
    const int r = i % ROWS, c = (i / ROWS) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n_rows && c < d) x = ld4(src + (r0 + r) * ss + c);
    dst[(c + 0) * LDT + r] = x.x;
    dst[(c + 1) * LDT + r] = x.y;
    dst[(c + 2) * LDT + r] = x.z;
    dst[(c + 3) * LDT + r] = x.w;
  }
}

// K4: a block owns BK keys and walks the query tiles of BQ rows.
//   S, dP phase: thread (tx, ty) holds the scores of keys 4tx .. 4tx+3 for
//   rows ty + RG i (i < RM); a row of Q (dO) is read 4 columns at a time
//   and multiplied by 4 rows of K^T (V^T), each 4 keys wide.
//   dK, dV phase: thread (tx2, ty2) owns keys KM ty2 .. KM ty2 + KM - 1 and
//   columns 64 n + 4 tx2 .. + 3; per query row it reads KM values of P and
//   of dS and 4 NC columns of dO and of Q.
template <int DP> struct DkvTiles {
  static constexpr int BK = DP == 256 ? 16 : 32;   // keys a block
  static constexpr int BQ = DP == 64 ? 64 : 32;    // query rows a tile
  static constexpr int KG = BK / 4;                // key groups (S, dP phase)
  static constexpr int RG = kT / KG;               // row groups
  static constexpr int RM = BQ / RG;               // rows a thread
  static constexpr int KM = BK / 8;                // keys a thread (dK, dV phase)
  static constexpr int NC = DP / 64;               // float4 column groups a thread
  static constexpr int LD = DP + kPad;             // row stride of Q, dO
  static constexpr int LDT = BK + kPad;            // row stride of K^T, V^T, P, dS
  static constexpr size_t bytes =
      static_cast<size_t>(2 * DP * LDT + 4 * BQ * LD + 2 * BQ * LDT) * sizeof(float);
  static_assert(RG * RM == BQ && KG * RG == kT && KM * 8 == BK, "tile shapes");
};

template <int DP>
__global__ void __launch_bounds__(kT, 2) dkv_kernel(Params p) {
  using L = DkvTiles<DP>;
  constexpr int BK = L::BK, BQ = L::BQ, RG = L::RG, RM = L::RM, KM = L::KM, NC = L::NC,
                LD = L::LD, LDT = L::LDT;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                     // K^T [DP][LDT]
  float* vt = kt + DP * LDT;            // V^T
  float* qs = vt + DP * LDT;            // Q [2][BQ][LD]
  float* dos = qs + 2 * BQ * LD;        // dO [2][BQ][LD]
  float* ps = dos + 2 * BQ * LD;        // P [BQ][LDT]
  float* dss = ps + BQ * LDT;           // dS [BQ][LDT]

  // blockIdx.x folds (batch * head, key tile), the tile running fastest
  const int n_blk = (p.s_k + BK - 1) / BK;
  const int bh = blockIdx.x / n_blk, blk = blockIdx.x - (blockIdx.x / n_blk) * n_blk;
  const int b = bh / p.heads, h = bh - (bh / p.heads) * p.heads;
  const float* qb = static_cast<const float*>(p.q) + b * p.st[0] + h * p.st[1];
  const float* kb = static_cast<const float*>(p.k) + b * p.st[3] + h * p.st[4];
  const float* vb = static_cast<const float*>(p.v) + b * p.st[6] + h * p.st[7];
  const float* dob = static_cast<const float*>(p.dout) + b * p.st[9] + h * p.st[10];
  float* dkb = static_cast<float*>(p.g0) + b * p.st[12] + h * p.st[13];
  float* dvb = static_cast<float*>(p.g1) + b * p.st[15] + h * p.st[16];
  const float* lse = p.lse + static_cast<long long>(bh) * p.s_q;
  const float* delta = p.delta + static_cast<long long>(bh) * p.s_q;

  const int tid = threadIdx.x;
  const int tx = tid % L::KG, ty = tid / L::KG;      // S, dP phase
  const int tx2 = tid & 15, ty2 = tid >> 4;          // dK, dV phase
  const int j0 = blk * BK;
  const int off = p.s_k - p.s_q;
  const float inv_sk = 1.f / static_cast<float>(p.s_k);

  load_transposed<BK, DP, LDT>(kt, kb, p.st[5], j0, p.s_k, p.d);
  load_transposed<BK, DP, LDT>(vt, vb, p.st[8], j0, p.s_k, p.d);
  const Stager<BQ, DP, LD> q_stage(qb, p.st[2], p.d), do_stage(dob, p.st[11], p.d);
  const float scale2 = p.scale * kLog2e;

  float dk[KM][4 * NC], dv[KM][4 * NC];
#pragma unroll
  for (int i = 0; i < KM; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) dk[i][c] = dv[i][c] = 0.f;

  // Causal: a query tile that sees none of these keys adds nothing, unless
  // one of its rows sees no key at all (its P is 1/s_k at every key).
  const int n_tiles = (p.s_q + BQ - 1) / BQ;
  auto needed = [&](int t) {
    return !(p.causal && j0 > t * BQ + BQ - 1 + off && t * BQ + off >= 0);
  };
  int t = 0;
  while (t < n_tiles && !needed(t)) ++t;
  if (t < n_tiles) {
    q_stage.stage(qs, t * BQ, p.s_q);
    do_stage.stage(dos, t * BQ, p.s_q);
  }
  cp_async_commit();
  int stage = 0;
  while (t < n_tiles) {
    int tn = t + 1;
    while (tn < n_tiles && !needed(tn)) ++tn;
    cp_async_wait_all();
    __syncthreads();   // tile t landed; every thread is done with tile t - 1
    const float* qt = qs + stage * BQ * LD;
    const float* dot = dos + stage * BQ * LD;
    const int r0 = t * BQ;
    // the next tile's copies; issued after the S and dP products (below)
    // rather than right after the barrier, where every warp's copies queue
    // behind each other and delay the first FMAs
    auto copy_next = [&] {
      if (kStream && tn < n_tiles) {
        q_stage.stage(qs + (stage ^ 1) * BQ * LD, tn * BQ, p.s_q);
        do_stage.stage(dos + (stage ^ 1) * BQ * LD, tn * BQ, p.s_q);
      }
      cp_async_commit();
    };
    if (kCopyAtTop) copy_next();

    float lse_r[RM], del_r[RM];      // lse in log2 units
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = r0 + ty + RG * i;
      lse_r[i] = row < p.s_q ? lse[row] * kLog2e : 0.f;
      del_r[i] = row < p.s_q ? delta[row] : 0.f;
    }
    float s[RM][4], dp[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; kProducts && c < DP; c += 4) {
      float4 kk[4], vv[4];
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        kk[dd] = ld4(kt + (c + dd) * LDT + 4 * tx);
        vv[dd] = ld4(vt + (c + dd) * LDT + 4 * tx);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 a = ld4(qt + (ty + RG * i) * LD + c);
        const float4 g = ld4(dot + (ty + RG * i) * LD + c);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) {
          s[i][0] = fmaf(av[dd], kk[dd].x, s[i][0]);
          s[i][1] = fmaf(av[dd], kk[dd].y, s[i][1]);
          s[i][2] = fmaf(av[dd], kk[dd].z, s[i][2]);
          s[i][3] = fmaf(av[dd], kk[dd].w, s[i][3]);
          dp[i][0] = fmaf(gv[dd], vv[dd].x, dp[i][0]);
          dp[i][1] = fmaf(gv[dd], vv[dd].y, dp[i][1]);
          dp[i][2] = fmaf(gv[dd], vv[dd].z, dp[i][2]);
          dp[i][3] = fmaf(gv[dd], vv[dd].w, dp[i][3]);
        }
      }
    }
    if (!kCopyAtTop) copy_next();
    // P and dS without branches; the masks only where the tile has an
    // edge or a causal mask (the same for the whole block)
    const bool whole = !p.causal && r0 + BQ <= p.s_q && j0 + BK <= p.s_k;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = r0 + ty + RG * i;
      const bool blind = p.causal && row + off < 0;   // sees no key
      float pv[4], dsv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pv[j] = ex2(fmaf(s[i][j], scale2, -lse_r[i]));
        dsv[j] = pv[j] * (dp[i][j] - del_r[i]) * p.scale;
        if (!whole) {
          const int key = j0 + 4 * tx + j;
          const bool real = key < p.s_k && row < p.s_q;
          const bool vis = real && !(p.causal && key > row + off);
          pv[j] = vis ? pv[j] : (real && blind ? inv_sk : 0.f);
          dsv[j] = vis ? dsv[j] : 0.f;
        }
      }
      st4(ps + (ty + RG * i) * LDT + 4 * tx, pv[0], pv[1], pv[2], pv[3]);
      st4(dss + (ty + RG * i) * LDT + 4 * tx, dsv[0], dsv[1], dsv[2], dsv[3]);
    }
    __syncthreads();   // P and dS of the tile stored

#pragma unroll 16
    for (int r = 0; kProducts && r < BQ; ++r) {
      float pk[KM], dsk[KM];
      ldn(pk, ps + r * LDT + KM * ty2);
      ldn(dsk, dss + r * LDT + KM * ty2);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float4 g = ld4(dot + r * LD + 64 * n + 4 * tx2);
        const float4 a = ld4(qt + r * LD + 64 * n + 4 * tx2);
#pragma unroll
        for (int i = 0; i < KM; ++i) {
          dv[i][4 * n + 0] = fmaf(pk[i], g.x, dv[i][4 * n + 0]);
          dv[i][4 * n + 1] = fmaf(pk[i], g.y, dv[i][4 * n + 1]);
          dv[i][4 * n + 2] = fmaf(pk[i], g.z, dv[i][4 * n + 2]);
          dv[i][4 * n + 3] = fmaf(pk[i], g.w, dv[i][4 * n + 3]);
          dk[i][4 * n + 0] = fmaf(dsk[i], a.x, dk[i][4 * n + 0]);
          dk[i][4 * n + 1] = fmaf(dsk[i], a.y, dk[i][4 * n + 1]);
          dk[i][4 * n + 2] = fmaf(dsk[i], a.z, dk[i][4 * n + 2]);
          dk[i][4 * n + 3] = fmaf(dsk[i], a.w, dk[i][4 * n + 3]);
        }
      }
    }
    if (kStream) stage ^= 1;
    t = tn;
  }

#pragma unroll
  for (int i = 0; i < KM; ++i) {
    const int key = j0 + KM * ty2 + i;
    if (key >= p.s_k) continue;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int c = 64 * n + 4 * tx2;
      if (c < p.d) {
        st4(dkb + key * p.st[14] + c, dk[i][4 * n], dk[i][4 * n + 1], dk[i][4 * n + 2],
            dk[i][4 * n + 3]);
        st4(dvb + key * p.st[17] + c, dv[i][4 * n], dv[i][4 * n + 1], dv[i][4 * n + 2],
            dv[i][4 * n + 3]);
      }
    }
  }
}

// K5: a block owns BQ = 32 query rows and walks the key tiles of BK keys.
//   S, dP phase: thread (tx, ty) holds the scores of rows 4ty .. 4ty+3 and
//   keys tx + 16 jj (jj < KN), dot products 4 columns at a time; it stores
//   dS^T[key][4ty .. 4ty+3] as one float4.
//   dQ phase: the same thread owns rows 4ty .. 4ty+3 and columns
//   64 n + 4 tx .. + 3; per key it reads 4 rows of dS^T and 4 NC columns of K.
template <int DP> struct DqTiles {
  static constexpr int BQ = 32;
  static constexpr int BK = DP == 64 ? 64 : (DP == 128 ? 32 : 16);
  static constexpr int KN = BK / 16;          // keys a thread (S, dP phase)
  static constexpr int NC = DP / 64;
  static constexpr int LD = DP + kPad;        // row stride of Q, dO, K, V
  static constexpr int LDS = BQ + kPad;       // row stride of dS^T
  static constexpr size_t bytes =
      static_cast<size_t>(2 * BQ * LD + 4 * BK * LD + BK * LDS) * sizeof(float);
};

template <int DP>
__global__ void __launch_bounds__(kT, 2) dq_kernel(Params p) {
  using L = DqTiles<DP>;
  constexpr int BQ = L::BQ, BK = L::BK, KN = L::KN, NC = L::NC, LD = L::LD, LDS = L::LDS;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                     // Q [BQ][LD]
  float* dos = qs + BQ * LD;            // dO
  float* ks = dos + BQ * LD;            // K [2][BK][LD]
  float* vs = ks + 2 * BK * LD;         // V [2][BK][LD]
  float* dst = vs + 2 * BK * LD;        // dS^T [BK][LDS]

  // blockIdx.x folds (batch * head, query tile), the tile running fastest
  const int n_blk = (p.s_q + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_blk, blk = blockIdx.x - (blockIdx.x / n_blk) * n_blk;
  const int b = bh / p.heads, h = bh - (bh / p.heads) * p.heads;
  const float* qb = static_cast<const float*>(p.q) + b * p.st[0] + h * p.st[1];
  const float* kb = static_cast<const float*>(p.k) + b * p.st[3] + h * p.st[4];
  const float* vb = static_cast<const float*>(p.v) + b * p.st[6] + h * p.st[7];
  const float* dob = static_cast<const float*>(p.dout) + b * p.st[9] + h * p.st[10];
  float* dqb = static_cast<float*>(p.g0) + b * p.st[12] + h * p.st[13];
  const float* lse = p.lse + static_cast<long long>(bh) * p.s_q;
  const float* delta = p.delta + static_cast<long long>(bh) * p.s_q;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int r0 = blk * BQ;
  const int off = p.s_k - p.s_q;

  Stager<BQ, DP, LD>(qb, p.st[2], p.d).stage(qs, r0, p.s_q);
  Stager<BQ, DP, LD>(dob, p.st[11], p.d).stage(dos, r0, p.s_q);
  const Stager<BK, DP, LD> k_stage(kb, p.st[5], p.d), v_stage(vb, p.st[8], p.d);
  const float scale2 = p.scale * kLog2e;
  // Causal: key tiles past the tile's last visible key add nothing (rows
  // that see no key get dQ = 0).
  int n_tiles = (p.s_k + BK - 1) / BK;
  if (p.causal) {
    const int last = min(p.s_k - 1, r0 + BQ - 1 + off);
    n_tiles = last < 0 ? 0 : last / BK + 1;
  }
  if (n_tiles > 0) {
    k_stage.stage(ks, 0, p.s_k);
    v_stage.stage(vs, 0, p.s_k);
  }
  cp_async_commit();

  float lse_r[4], del_r[4];      // lse in log2 units
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    lse_r[i] = row < p.s_q ? lse[row] * kLog2e : 0.f;
    del_r[i] = row < p.s_q ? delta[row] : 0.f;
  }
  float acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;

  int stage = 0;
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();   // tile t landed; every thread is done with tile t - 1
    const float* kt = ks + stage * BK * LD;
    const float* vt = vs + stage * BK * LD;
    const int j0 = t * BK;
    auto copy_next = [&] {   // as in K4
      if (kStream && t + 1 < n_tiles) {
        k_stage.stage(ks + (stage ^ 1) * BK * LD, (t + 1) * BK, p.s_k);
        v_stage.stage(vs + (stage ^ 1) * BK * LD, (t + 1) * BK, p.s_k);
      }
      cp_async_commit();
    };
    if (kCopyAtTop) copy_next();

    float s[4][KN], dp[4][KN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < KN; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 4
    for (int c = 0; kProducts && c < DP; c += 4) {
      float4 a[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = ld4(qs + (4 * ty + i) * LD + c);
        g[i] = ld4(dos + (4 * ty + i) * LD + c);
      }
#pragma unroll
      for (int jj = 0; jj < KN; ++jj) {
        const float4 kv = ld4(kt + (tx + 16 * jj) * LD + c);
        const float4 vv = ld4(vt + (tx + 16 * jj) * LD + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][jj] = dot4(a[i], kv, s[i][jj]);
          dp[i][jj] = dot4(g[i], vv, dp[i][jj]);
        }
      }
    }
    if (!kCopyAtTop) copy_next();
    const bool whole = !p.causal && r0 + BQ <= p.s_q && j0 + BK <= p.s_k;
#pragma unroll
    for (int jj = 0; jj < KN; ++jj) {
      const int key = j0 + tx + 16 * jj;
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = ex2(fmaf(s[i][jj], scale2, -lse_r[i]));
        dsv[i] = pv * (dp[i][jj] - del_r[i]) * p.scale;
        if (!whole) {
          const int row = r0 + 4 * ty + i;
          const bool vis = key < p.s_k && row < p.s_q && !(p.causal && key > row + off);
          dsv[i] = vis ? dsv[i] : 0.f;
        }
      }
      st4(dst + (tx + 16 * jj) * LDS + 4 * ty, dsv[0], dsv[1], dsv[2], dsv[3]);
    }
    __syncthreads();   // dS^T of the tile stored

#pragma unroll 8
    for (int j = 0; kProducts && j < BK; ++j) {
      const float4 dsj = ld4(dst + j * LDS + 4 * ty);
      const float dv4[4] = {dsj.x, dsj.y, dsj.z, dsj.w};
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float4 kv = ld4(kt + j * LD + 64 * n + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * n + 0] = fmaf(dv4[i], kv.x, acc[i][4 * n + 0]);
          acc[i][4 * n + 1] = fmaf(dv4[i], kv.y, acc[i][4 * n + 1]);
          acc[i][4 * n + 2] = fmaf(dv4[i], kv.z, acc[i][4 * n + 2]);
          acc[i][4 * n + 3] = fmaf(dv4[i], kv.w, acc[i][4 * n + 3]);
        }
      }
    }
    if (kStream) stage ^= 1;
  }
  cp_async_wait_all();   // nothing left in flight when the block ends

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= p.s_q) continue;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int c = 64 * n + 4 * tx;
      if (c < p.d)
        st4(dqb + row * p.st[14] + c, acc[i][4 * n], acc[i][4 * n + 1], acc[i][4 * n + 2],
            acc[i][4 * n + 3]);
    }
  }
}

template <int DP>
int launch_dp(bool dkv, const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = dkv ? DkvTiles<DP>::bytes : DqTiles<DP>::bytes;
  auto kernel = dkv ? dkv_kernel<DP> : dq_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = dkv ? p.s_k : p.s_q;
  const int tile = dkv ? DkvTiles<DP>::BK : DqTiles<DP>::BQ;
  const long long blocks = static_cast<long long>((rows + tile - 1) / tile) * batch * p.heads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// What the tiled kernels take: d % 4 == 0 up to 256, every stride a
// multiple of 4 elements, every tensor on 16 bytes (lse and delta are read
// an element at a time).
bool takes(const Params& p, bool dkv) {
  if (p.d % 4 != 0 || p.d > 256) return false;
  for (int i = 0; i < (dkv ? 18 : 15); ++i)
    if (p.st[i] % 4 != 0) return false;
  return aligned16(p.q) && aligned16(p.k) && aligned16(p.v) && aligned16(p.dout) &&
         aligned16(p.g0) && (!dkv || aligned16(p.g1));
}

}  // namespace tiled

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
           int variant, void* stream) {
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
  if (variant == kTiled) {
    if constexpr (sizeof(T) == 4) {
      if (!tiled::takes(p, dkv)) return static_cast<int>(cudaErrorInvalidValue);
      if (d <= 64) return tiled::launch_dp<64>(dkv, p, batch, cs);
      if (d <= 128) return tiled::launch_dp<128>(dkv, p, batch, cs);
      return tiled::launch_dp<256>(dkv, p, batch, cs);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant != kGeneral) return static_cast<int>(cudaErrorInvalidValue);
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
// {bs, hs, ss}. Any d >= 1. variant: 0 "general", 1 "tiled" (float32 only;
// d % 4 == 0 up to 256, strides multiples of 4 elements, q, k, v, dout and
// the gradients on 16 bytes). Each returns cudaErrorInvalidValue for a
// variant the inputs do not meet, else cudaGetLastError() after the launch.
extern "C" int lvg_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, int batch, int heads, int s_q,
                                      int s_k, int d, const long long* strides, float scale,
                                      int causal, int variant, void* stream) {
  return launch<__nv_bfloat16>(true, q, k, v, dout, lse, delta, dk, dv, batch, heads, s_q,
                               s_k, d, strides, scale, causal, variant, stream);
}

extern "C" int lvg_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, int batch, int heads, int s_q,
                                     int s_k, int d, const long long* strides, float scale,
                                     int causal, int variant, void* stream) {
  return launch<float>(true, q, k, v, dout, lse, delta, dk, dv, batch, heads, s_q, s_k, d,
                       strides, scale, causal, variant, stream);
}

extern "C" int lvg_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, int batch, int heads, int s_q, int s_k, int d,
                                     const long long* strides, float scale, int causal,
                                     int variant, void* stream) {
  return launch<__nv_bfloat16>(false, q, k, v, dout, lse, delta, dq, nullptr, batch, heads,
                               s_q, s_k, d, strides, scale, causal, variant, stream);
}

extern "C" int lvg_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, int batch, int heads, int s_q, int s_k, int d,
                                    const long long* strides, float scale, int causal,
                                    int variant, void* stream) {
  return launch<float>(false, q, k, v, dout, lse, delta, dq, nullptr, batch, heads, s_q, s_k,
                       d, strides, scale, causal, variant, stream);
}
