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
// The head dim is padded to DP in {64, 128, 256} inside the kernel. Head
// dims above 256 walk d in slices of 256 columns with DP = 256's tiles (the
// "sliced" kernel; float tiles of a wider DP would not fit the 227 KB a
// block may use): S = Q.K^T sums over the Q and K slices, staged one after
// the other for each key tile, and blockIdx.y picks the 256 columns of V and
// O that the block accumulates and writes, so shared memory does not grow
// with d (S is recomputed once for each slice of O).
// Aligned bf16 inputs up to head dim 256 run the tensor-core kernel of
// flash_fwd_sm90.cu instead (ops/attention.py::flash_route decides). q, k, v
// are read through (batch, head, row) strides with unit column stride, so
// the column slices of the U-Net's fused qkv projection need no copy, and O
// is written through strides too, so (B, S, H, D) comes out without a
// transpose.
//
// Bound: CUDA-core float32 FMAs. At the U-Net's 16384-token d=64 shape the
// kernel does 4*S^2*d = 6.9e10 FLOP per (batch, head) and reads K/V from L2
// once per query tile; the inner loops issue 16 FMAs per two 16-byte shared
// loads, so FMA throughput (67 TFLOP/s peak) and not bandwidth is the
// ceiling. This kernel serves float32 inputs (tensor cores would mean
// TF32), bf16 inputs that 16-byte copies cannot read, and head dims above
// 256; the tensor-core kernel of flash_fwd_sm90.cu serves the rest.
//
// Two variants (ops/attention.py::flash_fwd_variant picks; each entry point
// takes the index of its answer in _FLASH_FWD_VARIANTS):
//   "general": the kernel above, unchanged: bf16, unaligned views, d % 4
//       != 0, and every head dim above 256 (in slices of 256).
//   "tiled": float32 with d % 4 == 0, d <= 256, every (batch, head, row)
//       stride a multiple of 4 elements and every base on 16 bytes: the
//       float32 U-Net's head dims 64, 128 and 256, and the column slices of
//       its fused qkv projection. The kernels below (namespace tiled), with
//       the helpers they share with flash_bwd.cu's tiled kernels
//       (flash_tiled_common.cuh).
// What held the general kernel, and what the tiled one does instead (read
// from CUDA-graph times on an H100 80GB HBM3 at 700 W, bench/flash_fwd_timing.py
// and, with parts cut out, bench/flash_fwd_phases.py; the general kernel
// takes 0.54 ms at (2,1,4096,64), 24% of its FMA bound, and the tiled one
// 0.277 ms, 46%):
//   1. Warps and grid: 256-thread blocks of 64 query rows, one an SM (two
//      warps a scheduler; a barrier idles the whole SM): 128 blocks at
//      (2,1,4096,64), 32 at (2,1,1024,128) and 8 at (2,1,256,256) for 132
//      SMs. Tiled: 128-thread blocks under __launch_bounds__(128, 2), key
//      tiles of 64, 32 and 16 keys at padded d 64, 128 and 256, two blocks
//      an SM at every d (104,448, 110,080 and 102,144 B of shared memory).
//      Where the row blocks do not fill the card (fewer than 132:
//      ops/attention.py::flash_fwd_splits), the key axis is split into runs
//      of whole tiles, a block each (blockIdx.y), as many as one wave of two
//      blocks an SM holds, two tiles a run at least: at (2,1,4096,64) 2 runs
//      (0.343 -> 0.277 ms), at (2,1,1024,128) 8 (0.171 -> 0.045), at
//      (2,1,256,256) 8 (0.063 -> 0.016; 16 runs of one tile: 0.018). Each
//      split writes its m, l and unnormalised O apart (not an lse: for a row
//      that sees no key, m has absorbed log l, and a combine over lse would
//      sum the splits' means of V instead of averaging them); combine_kernel
//      joins them in split order (about 4 us). No atomics: two launches
//      give equal bits.
//   2. Staging: scalar copies with an integer division an element, Q and K
//      stored transposed (a 4-way bank conflict on every store), three
//      barriers a key tile and nothing in flight during the products.
//      Tiled: Q once a block, K and V by 16-byte cp.async.cg into two
//      stages, zero-filled past s_k and d by the source-size operand, each
//      thread's addresses worked out once (Stager); the next tile's copies
//      issued after the S product; two barriers a tile. Streaming K and V
//      through L2 (a block reads its head's whole K and V) now costs 5% at
//      (2,1,4096,64) and (2,1,16384,64) (builds without it: 0.264, 4.04 ms).
//   3. Softmax: expf on every score and on alpha, masks on every tile.
//      Tiled: scores in log2 units (scale log2(e) folded into the score), one
//      MUFU.EX2 a score and a row's alpha; masks only in tiles with an edge
//      or a causal cut; P stored transposed, four rows of a key as one
//      float4, the layout the P.V product reads. What is left besides the
//      products (the softmax's shuffles and exponentials, the barriers, Q
//      and the output) is 0.070 of 0.277 ms and 0.96 of 4.28 ms (builds
//      without the products and the stream).
//   4. Loads per FMA: 4x4 register micro-tiles, 8 FMAs a 16-byte shared
//      load. Tiled: 8x4 (8 query rows a thread, 64-row blocks: 10.7 FMAs a
//      load) up to head dim 128, 4x4 at 256 (64 accumulators of O a thread
//      already). The first tiled build had 4x4 tiles at every d (32-row
//      blocks, no split at 4096 tokens): 0.335 and 5.24 ms at (2,1,4096,64)
//      and (2,1,16384,64), 38% and 39% of the bound, against 0.277 and
//      4.28 ms (46% and 48%); at 4096 tokens the 8x4 tiles win only with the
//      key split, which their 128 row blocks need (0.343 ms without it).

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_tiled_common.cuh"

namespace {

constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kPad = 4;          // row padding in floats (keeps float4 alignment)
constexpr float kNegInf = -1.7014117331926443e38f;   // finfo(float32).min / 2
constexpr unsigned kFullMask = 0xffffffffu;
// The variants, numbered as ops/attention.py's _FLASH_FWD_VARIANTS
constexpr int kGeneral = 0, kTiled = 1;

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

// Four consecutive floats from a 16-byte aligned address, and back.
__device__ __forceinline__ void ldn(float (&dst)[4], const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}
__device__ __forceinline__ void stn(float* p, const float (&src)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(src[0], src[1], src[2], src[3]);
}

// Tile shape and shared-memory layout of one block, in floats.
template <int DP> struct Layout {
  static constexpr int BQ = 64;             // query rows per block
  static constexpr int BK = 64;             // keys per shared-memory tile
  static constexpr int RQ = BQ / 16;               // rows per thread
  static constexpr int RK = BK / 16;               // keys per thread
  static constexpr int ld_q = BQ + kPad;    // Qt[c][row]
  static constexpr int ld_k = BK + kPad;    // Kt[c][key]
  static constexpr int ld_v = DP + kPad;    // Vs[key][c]
  static constexpr int ld_p = BK + kPad;    // Ps[row][key]
  static constexpr int q = DP * ld_q;
  static constexpr int k = DP * ld_k;
  static constexpr int v = BK * ld_v;
  static constexpr int p = BQ * ld_p;
  static constexpr size_t bytes = static_cast<size_t>(q + k + v + p) * sizeof(float);
};

template <typename T, int DP, bool SLICED>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int heads, int s_q, int s_k,
                 int d, long long q_bs, long long q_hs, long long q_ss, long long k_bs,
                 long long k_hs, long long k_ss, long long v_bs, long long v_hs,
                 long long v_ss, long long o_bs, long long o_hs, long long o_ss,
                 float scale, int causal) {
  using L = Layout<DP>;
  constexpr int kBQ = L::BQ, kBK = L::BK, RQ = L::RQ, RK = L::RK;
  constexpr int NC = DP / 64;   // float4 column groups of O per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;
  float* kt = qt + L::q;
  float* vs = kt + L::k;
  float* ps = vs + L::v;

  // blockIdx.x folds (batch * head, query tile), the tile running fastest
  const int n_blk = (s_q + kBQ - 1) / kBQ;
  const int bh = blockIdx.x / n_blk;
  const int b = bh / heads, h = bh - (bh / heads) * heads;
  const int r0 = (blockIdx.x - (blockIdx.x / n_blk) * n_blk) * kBQ;
  const T* qb = q + b * q_bs + h * q_hs;
  const T* kb = k + b * k_bs + h * k_hs;
  const T* vb = v + b * v_bs + h * v_hs;
  T* ob = o + b * o_bs + h * o_hs;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = lane & 15;                       // key / column group
  const int ty = (tid >> 5) * 2 + (lane >> 4);    // row group
  // sliced: the slices of d that S sums over, and the first column of the
  // block's slice of V and O
  const int n_slices = SLICED ? (d + DP - 1) / DP : 1;
  const int v0 = SLICED ? static_cast<int>(blockIdx.y) * DP : 0;

  auto stage_q = [&](int c0) {   // columns c0 .. c0 + DP - 1 of the Q tile, scaled
    for (int i = tid; i < kBQ * DP; i += kThreads) {
      const int r = i / DP, c = i - (i / DP) * DP;
      float x = 0.f;
      if (r0 + r < s_q && c0 + c < d) x = to_float(qb[(r0 + r) * q_ss + c0 + c]) * scale;
      qt[c * L::ld_q + r] = x;
    }
  };
  if (!SLICED) stage_q(0);

  float acc[RQ][4 * NC];
  float m[RQ], l[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
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
    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int jj = 0; jj < RK; ++jj) s[i][jj] = 0.f;
    for (int sl = 0; sl < n_slices; ++sl) {
      const int c0 = sl * DP;
      const bool last = sl == n_slices - 1;   // V's slice is staged with K's last one
      __syncthreads();   // Q stored / the previous tile's or slice's readers done
      if (SLICED) stage_q(c0);
      for (int i = tid; i < kBK * DP; i += kThreads) {
        const int j = i / DP, c = i - (i / DP) * DP;
        float kx = 0.f, vx = 0.f;
        if (j0 + j < s_k) {
          if (c0 + c < d) kx = to_float(kb[(j0 + j) * k_ss + c0 + c]);
          if (last && v0 + c < d) vx = to_float(vb[(j0 + j) * v_ss + v0 + c]);
        }
        kt[c * L::ld_k + j] = kx;
        if (last) vs[j * L::ld_v + c] = vx;
      }
      __syncthreads();

#pragma unroll 8
      for (int c = 0; c < DP; ++c) {
        float qv[RQ], kv[RK];
        ldn(qv, qt + c * L::ld_q + RQ * ty);
        ldn(kv, kt + c * L::ld_k + RK * tx);
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int jj = 0; jj < RK; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
      }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = r0 + RQ * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < RK; ++jj) {
        const int key = j0 + RK * tx + jj;
        if (key >= s_k) s[i][jj] = -INFINITY;                  // not a key: weight 0
        else if (causal && key > row + off) s[i][jj] = kNegInf;  // masked, as in JAX
        mx = fmaxf(mx, s[i][jj]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));   // finite: key j0 is real
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < RK; ++jj) {
        s[i][jj] = expf(s[i][jj] - m_new);
        sum += s[i][jj];
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
      stn(ps + (RQ * ty + i) * L::ld_p + RK * tx, s[i]);
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float p[RQ][4];
#pragma unroll
      for (int i = 0; i < RQ; ++i) ldn(p[i], ps + (RQ * ty + i) * L::ld_p + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const float4 va =
              *reinterpret_cast<const float4*>(vs + (j + jj) * L::ld_v + 64 * n + 4 * tx);
#pragma unroll
          for (int i = 0; i < RQ; ++i) {
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
  for (int i = 0; i < RQ; ++i) {
    const int row = r0 + RQ * ty + i;
    if (row >= s_q) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int c = v0 + 64 * n + 4 * tx + cc;
        if (c < d) ob[row * o_ss + c] = from_float<T>(acc[i][4 * n + cc] / denom);
      }
    if (tx == 0 && v0 == 0) lse[static_cast<long long>(bh) * s_q + row] = m[i] + logf(denom);
  }
}

template <typename T, int DP, bool SLICED = false>
int launch_dp(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
              int heads, int s_q, int s_k, int d, const long long* st, float scale,
              int causal, cudaStream_t stream) {
  const size_t smem = Layout<DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP, SLICED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>((s_q + Layout<DP>::BQ - 1) / Layout<DP>::BQ) * batch * heads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), SLICED ? (d + DP - 1) / DP : 1);
  flash_fwd_kernel<T, DP, SLICED><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), heads, s_q, s_k, d, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale, causal);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// The "tiled" variant: float32, 16-byte rows (see the note at the top).
namespace tiled {

using flash_tiled::cp_async_commit;
using flash_tiled::cp_async_wait_all;
using flash_tiled::dot4;
using flash_tiled::ex2;
using flash_tiled::kLog2e;
using flash_tiled::kT;
using flash_tiled::ld4;
using flash_tiled::st4;
using flash_tiled::Stager;

constexpr float kLn2 = 0.6931471805599453f;
// The score, in log2 units, of every key of a row that sees no key: the
// masked score finfo.min/2 of the plain version, times log2(e). Such a row
// then weighs each real key alike, and its lse comes out as finfo.min/2.
constexpr float kNegInf2 = kNegInf * kLog2e;

// Compile-time cuts and trials, for builds that time one part of the tiled
// kernel (bench/flash_fwd_phases.py): -DFLASH_FWD_NO_PRODUCTS runs no step
// of the two product loops, -DFLASH_FWD_NO_STREAM stages only the block's
// first key tile (every tile computes on it), -DFLASH_FWD_ROWS4 gives each
// thread 4 query rows (4x4 micro-tiles, 32-row blocks) at every head dim,
// as the first build did. The output of a cut build is wrong, and a ROWS4
// build's blocks are not the ones ops/attention.py::flash_fwd_splits
// counts; the kernel as built by ops/_build.py has none of them.
#ifdef FLASH_FWD_NO_PRODUCTS
constexpr bool kProducts = false;
#else
constexpr bool kProducts = true;
#endif
#ifdef FLASH_FWD_NO_STREAM
constexpr bool kStream = false;
#else
constexpr bool kStream = true;
#endif
#ifdef FLASH_FWD_ROWS4
constexpr int kRowsUpTo128 = 4;
#else
constexpr int kRowsUpTo128 = 8;
#endif

// A block owns BQ query rows and walks key tiles of BK keys.
//   S phase: thread (tx, ty) holds the scores of rows RM ty .. RM ty + RM - 1
//   and keys tx + 16 jj (jj < KN), dot products 4 columns at a time; it
//   stores P^T[key][RM ty .. RM ty + RM - 1], RM / 4 float4s a key.
//   P.V phase: the same thread owns the same rows and columns
//   64 n + 4 tx .. + 3 of O; per key it reads RM values of P^T and 4 NC
//   columns of V.
template <int DP> struct FwdTiles {
  static constexpr int RM = DP == 256 ? 4 : kRowsUpTo128;   // rows a thread
  static constexpr int BQ = 8 * RM;                         // 8 row groups
  static constexpr int BK = DP == 64 ? 64 : (DP == 128 ? 32 : 16);
  static constexpr int KN = BK / 16;          // keys a thread (S phase)
  static constexpr int NC = DP / 64;          // float4 column groups of O a thread
  static constexpr int LD = DP + kPad;        // row stride of Q, K, V
  static constexpr int LDP = BQ + kPad;       // row stride of P^T
  static constexpr size_t bytes =
      static_cast<size_t>(BQ * LD + 4 * BK * LD + BK * LDP) * sizeof(float);
  static_assert(RM % 4 == 0 && kT == 8 * 16, "8 row groups of 16 lanes");
};

struct Params {
  const float *q, *k, *v;
  float *o, *lse;
  float *acc, *m, *l;        // the splits' partials (n_split > 1), else unused
  int heads, bh, s_q, s_k, d, n_split, tiles_per_split;
  long long st[12];          // (batch, head, row) strides of q, k, v, o
  float scale;
  int causal;
};

template <int DP>
__global__ void __launch_bounds__(kT, 2) fwd_kernel(Params p) {
  using L = FwdTiles<DP>;
  constexpr int BQ = L::BQ, BK = L::BK, RM = L::RM, KN = L::KN, NC = L::NC, LD = L::LD,
                LDP = L::LDP;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                     // Q [BQ][LD]
  float* ks = qs + BQ * LD;             // K [2][BK][LD]
  float* vs = ks + 2 * BK * LD;         // V [2][BK][LD]
  float* pt = vs + 2 * BK * LD;         // P^T [BK][LDP]

  // blockIdx.x folds (batch * head, query tile), the tile running fastest;
  // blockIdx.y is the split of the key axis
  const int n_blk = (p.s_q + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_blk, blk = blockIdx.x - (blockIdx.x / n_blk) * n_blk;
  const int b = bh / p.heads, h = bh - (bh / p.heads) * p.heads;
  const int split = blockIdx.y;
  const float* qb = p.q + b * p.st[0] + h * p.st[1];
  const float* kb = p.k + b * p.st[3] + h * p.st[4];
  const float* vb = p.v + b * p.st[6] + h * p.st[7];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int r0 = blk * BQ;
  const int off = p.s_k - p.s_q;
  // the split's key tiles [t0, t1); causal: tiles past the block's last
  // visible key add nothing, unless a row of the block sees no key (it
  // weighs every key alike)
  const int t0 = split * p.tiles_per_split;
  int t1 = min((p.s_k + BK - 1) / BK, t0 + p.tiles_per_split);
  if (p.causal && r0 + off >= 0) t1 = min(t1, min(p.s_k - 1, r0 + BQ - 1 + off) / BK + 1);

  const Stager<BK, DP, LD> k_stage(kb, p.st[5], p.d), v_stage(vb, p.st[8], p.d);
  Stager<BQ, DP, LD>(qb, p.st[2], p.d).stage(qs, r0, p.s_q);
  if (t0 < t1) {
    k_stage.stage(ks, t0 * BK, p.s_k);
    v_stage.stage(vs, t0 * BK, p.s_k);
  }
  cp_async_commit();
  const float scale2 = p.scale * kLog2e;

  // the running max (log2 units), sum and unnormalised O of each row
  float m[RM], l[RM], acc[RM][4 * NC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  int stage = 0;
  for (int t = t0; t < t1; ++t) {
    cp_async_wait_all();
    __syncthreads();   // tile t landed; every thread is done with tile t - 1
    const float* kt = ks + stage * BK * LD;
    const float* vt = vs + stage * BK * LD;
    const int j0 = t * BK;

    float s[RM][KN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int jj = 0; jj < KN; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int c = 0; kProducts && c < DP; c += 4) {
      float4 a[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = ld4(qs + (RM * ty + i) * LD + c);
#pragma unroll
      for (int jj = 0; jj < KN; ++jj) {
        const float4 kv = ld4(kt + (tx + 16 * jj) * LD + c);
#pragma unroll
        for (int i = 0; i < RM; ++i) s[i][jj] = dot4(a[i], kv, s[i][jj]);
      }
    }
    // the next tile's copies, issued after the S product rather than right
    // after the barrier (as in flash_bwd.cu's tiled kernels)
    if (kStream && t + 1 < t1) {
      k_stage.stage(ks + (stage ^ 1) * BK * LD, (t + 1) * BK, p.s_k);
      v_stage.stage(vs + (stage ^ 1) * BK * LD, (t + 1) * BK, p.s_k);
    }
    cp_async_commit();

    // online softmax in log2 units, one MUFU.EX2 a score and a row's alpha;
    // the masks only where the tile has an edge or a causal cut (the same
    // for the whole block)
    const bool whole = j0 + BK <= p.s_k && (!p.causal || j0 + BK - 1 <= r0 + off);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = r0 + RM * ty + i;
      const bool blind = p.causal && row + off < 0;   // sees no key
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < KN; ++jj) {
        float x = s[i][jj] * scale2;
        if (!whole) {
          const int key = j0 + tx + 16 * jj;
          const bool real = key < p.s_k;
          const bool vis = real && !(p.causal && key > row + off);
          x = vis ? x : (real && blind ? kNegInf2 : -INFINITY);
        }
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      // a row with no key yet in this split keeps m = -inf, l = 0, acc = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = ex2(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < KN; ++jj) {
        s[i][jj] = ex2(s[i][jj] - m_use);
        sum += s[i][jj];
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int jj = 0; jj < KN; ++jj)
#pragma unroll
      for (int i = 0; i < RM; i += 4)
        st4(pt + (tx + 16 * jj) * LDP + RM * ty + i, s[i][jj], s[i + 1][jj], s[i + 2][jj],
            s[i + 3][jj]);
    __syncthreads();   // P^T of the tile stored

#pragma unroll 8
    for (int j = 0; kProducts && j < BK; ++j) {
      float pj[RM];
#pragma unroll
      for (int i = 0; i < RM; i += 4) {
        const float4 x = ld4(pt + j * LDP + RM * ty + i);
        pj[i] = x.x; pj[i + 1] = x.y; pj[i + 2] = x.z; pj[i + 3] = x.w;
      }
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float4 vv = ld4(vt + j * LD + 64 * n + 4 * tx);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          acc[i][4 * n + 0] = fmaf(pj[i], vv.x, acc[i][4 * n + 0]);
          acc[i][4 * n + 1] = fmaf(pj[i], vv.y, acc[i][4 * n + 1]);
          acc[i][4 * n + 2] = fmaf(pj[i], vv.z, acc[i][4 * n + 2]);
          acc[i][4 * n + 3] = fmaf(pj[i], vv.w, acc[i][4 * n + 3]);
        }
      }
    }
    if (kStream) stage ^= 1;
  }
  cp_async_wait_all();   // nothing left in flight when the block ends

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = r0 + RM * ty + i;
    if (row >= p.s_q) continue;
    if (p.n_split == 1) {   // O and lse
      const float denom = fmaxf(l[i], 1e-30f);
      float* orow = p.o + b * p.st[9] + h * p.st[10] + row * p.st[11];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int c = 64 * n + 4 * tx;
        if (c < p.d)
          st4(orow + c, acc[i][4 * n] / denom, acc[i][4 * n + 1] / denom,
              acc[i][4 * n + 2] / denom, acc[i][4 * n + 3] / denom);
      }
      if (tx == 0) p.lse[static_cast<long long>(bh) * p.s_q + row] = m[i] * kLn2 + logf(denom);
    } else {                // the split's m, l and unnormalised O
      const long long r = (static_cast<long long>(split) * p.bh + bh) * p.s_q + row;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int c = 64 * n + 4 * tx;
        if (c < p.d)
          st4(p.acc + r * p.d + c, acc[i][4 * n], acc[i][4 * n + 1], acc[i][4 * n + 2],
              acc[i][4 * n + 3]);
      }
      if (tx == 0) {
        p.m[r] = m[i];
        p.l[r] = l[i];
      }
    }
  }
}

// The splits' partials of one row, combined in split order: m = max m_i,
// l = sum l_i 2^(m_i - m), O = sum acc_i 2^(m_i - m) / max(l, 1e-30),
// lse = m ln 2 + log max(l, 1e-30). A thread a float4 of O.
struct CombineParams {
  const float *acc, *m, *l;
  float *o, *lse;
  int heads, bh, s_q, d, n_split;
  long long st[3];           // (batch, head, row) strides of o
};

__global__ void __launch_bounds__(kT) combine_kernel(CombineParams p) {
  const int c4 = p.d / 4;
  const long long rows = static_cast<long long>(p.bh) * p.s_q;
  const long long idx = static_cast<long long>(blockIdx.x) * kT + threadIdx.x;
  if (idx >= rows * c4) return;
  const long long r = idx / c4;             // (batch * head) * s_q + row
  const int c = static_cast<int>(idx - r * c4) * 4;
  float mx = -INFINITY;
  for (int i = 0; i < p.n_split; ++i) mx = fmaxf(mx, p.m[i * rows + r]);
  const float mu = mx == -INFINITY ? 0.f : mx;
  float l = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < p.n_split; ++i) {
    const float w = ex2(p.m[i * rows + r] - mu);
    l = fmaf(p.l[i * rows + r], w, l);
    const float4 x = ld4(p.acc + (i * rows + r) * p.d + c);
    a.x = fmaf(x.x, w, a.x);
    a.y = fmaf(x.y, w, a.y);
    a.z = fmaf(x.z, w, a.z);
    a.w = fmaf(x.w, w, a.w);
  }
  const float denom = fmaxf(l, 1e-30f);
  const int bh = static_cast<int>(r / p.s_q), row = static_cast<int>(r - bh * static_cast<long long>(p.s_q));
  const int b = bh / p.heads, h = bh - (bh / p.heads) * p.heads;
  st4(p.o + b * p.st[0] + h * p.st[1] + row * p.st[2] + c, a.x / denom, a.y / denom,
      a.z / denom, a.w / denom);
  if (c == 0) p.lse[r] = mx * kLn2 + logf(denom);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <int DP>
int launch_dp(const Params& p, int batch, cudaStream_t stream) {
  using L = FwdTiles<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>((p.s_q + L::BQ - 1) / L::BQ) * batch * p.heads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Params q = p;
  const int n_tiles = (p.s_k + L::BK - 1) / L::BK;
  q.tiles_per_split = (n_tiles + p.n_split - 1) / p.n_split;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(p.n_split));
  fwd_kernel<DP><<<grid, kT, L::bytes, stream>>>(q);
  return static_cast<int>(cudaGetLastError());
}

// What the tiled kernel takes: d % 4 == 0 up to 256, every stride a
// multiple of 4 elements, q, k, v and o on 16 bytes; with n_split > 1 (up to
// 65,535) a partials workspace on 16 bytes.
bool takes(const Params& p) {
  if (p.d % 4 != 0 || p.d > 256 || p.n_split < 1 || p.n_split > 65535) return false;
  for (int i = 0; i < 12; ++i)
    if (p.st[i] % 4 != 0) return false;
  if (p.n_split > 1 && !(aligned16(p.acc) && p.m != nullptr && p.l != nullptr)) return false;
  return aligned16(p.q) && aligned16(p.k) && aligned16(p.v) && aligned16(p.o);
}

}  // namespace tiled

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
           int heads, int s_q, int s_k, int d, const long long* st, float scale, int causal,
           int variant, int n_split, void* acc, void* m, void* l, void* stream) {
  if (batch <= 0 || heads <= 0 || s_q <= 0 || s_k <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (variant == kTiled) {
    if constexpr (sizeof(T) == 4) {
      tiled::Params p{};
      p.q = static_cast<const float*>(q);
      p.k = static_cast<const float*>(k);
      p.v = static_cast<const float*>(v);
      p.o = static_cast<float*>(o);
      p.lse = static_cast<float*>(lse);
      p.acc = static_cast<float*>(acc);
      p.m = static_cast<float*>(m);
      p.l = static_cast<float*>(l);
      p.heads = heads; p.bh = batch * heads; p.s_q = s_q; p.s_k = s_k; p.d = d;
      p.n_split = n_split;
      for (int i = 0; i < 12; ++i) p.st[i] = st[i];
      p.scale = scale;
      p.causal = causal;
      if (!tiled::takes(p)) return static_cast<int>(cudaErrorInvalidValue);
      if (d <= 64) return tiled::launch_dp<64>(p, batch, cs);
      if (d <= 128) return tiled::launch_dp<128>(p, batch, cs);
      return tiled::launch_dp<256>(p, batch, cs);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant != kGeneral || n_split != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (d <= 64) return launch_dp<T, 64>(q, k, v, o, lse, batch, heads, s_q, s_k, d, st, scale, causal, cs);
  if (d <= 128) return launch_dp<T, 128>(q, k, v, o, lse, batch, heads, s_q, s_k, d, st, scale, causal, cs);
  if (d <= 256) return launch_dp<T, 256>(q, k, v, o, lse, batch, heads, s_q, s_k, d, st, scale, causal, cs);
  return launch_dp<T, 256, true>(q, k, v, o, lse, batch, heads, s_q, s_k, d, st, scale, causal, cs);
}

}  // namespace

// q, k, v: (batch, heads, s, d) element (b, h, r, c) at b*bs + h*hs + r*ss + c
// (strides in elements, st = {q_bs, q_hs, q_ss, k_bs, k_hs, k_ss, v_bs, v_hs,
// v_ss, o_bs, o_hs, o_ss}); o: same dtype, written through its strides;
// lse: contiguous float32 (batch*heads, s_q). Any d >= 1. variant: 0
// "general" (n_split 1), 1 "tiled" (float32 only; d % 4 == 0 up to 256,
// strides multiples of 4 elements, q, k, v, o on 16 bytes). With n_split > 1
// the tiled kernel splits the key axis into n_split runs of whole tiles and
// writes, instead of o and lse, each split's partials: acc (n_split,
// batch*heads, s_q, d), m and l (n_split, batch*heads, s_q), contiguous
// float32 (m in log2 units); lvg_flash_fwd_combine then gives o and lse.
// Each returns cudaErrorInvalidValue for a variant or split the inputs do
// not meet, else cudaGetLastError() after the launch.
extern "C" int lvg_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int batch, int heads, int s_q, int s_k, int d,
                                  const long long* strides, float scale, int causal,
                                  int variant, int n_split, void* acc, void* m, void* l,
                                  void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, lse, batch, heads, s_q, s_k, d, strides, scale,
                               causal, variant, n_split, acc, m, l, stream);
}

extern "C" int lvg_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int batch, int heads, int s_q, int s_k, int d,
                                 const long long* strides, float scale, int causal,
                                 int variant, int n_split, void* acc, void* m, void* l,
                                 void* stream) {
  return launch<float>(q, k, v, o, lse, batch, heads, s_q, s_k, d, strides, scale, causal,
                       variant, n_split, acc, m, l, stream);
}

// The splits' partials (as lvg_flash_fwd_f32 writes them with n_split > 1)
// combined into o (float32, (batch, heads, s_q, d) through the strides
// {o_bs, o_hs, o_ss}, each a multiple of 4 elements, on 16 bytes) and lse
// (contiguous float32 (batch*heads, s_q)); d % 4 == 0. Returns
// cudaErrorInvalidValue for inputs it does not take, else
// cudaGetLastError() after the launch.
extern "C" int lvg_flash_fwd_combine(const void* acc, const void* m, const void* l, void* o,
                                     void* lse, int batch, int heads, int s_q, int d,
                                     int n_split, const long long* strides, void* stream) {
  if (batch <= 0 || heads <= 0 || s_q <= 0 || d <= 0 || d % 4 != 0 || n_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  tiled::CombineParams p{};
  p.acc = static_cast<const float*>(acc);
  p.m = static_cast<const float*>(m);
  p.l = static_cast<const float*>(l);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.heads = heads; p.bh = batch * heads; p.s_q = s_q; p.d = d; p.n_split = n_split;
  for (int i = 0; i < 3; ++i) {
    p.st[i] = strides[i];
    if (strides[i] % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!(tiled::aligned16(acc) && tiled::aligned16(o))) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(p.bh) * s_q * (d / 4);
  const long long blocks = (threads + tiled::kT - 1) / tiled::kT;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  tiled::combine_kernel<<<static_cast<unsigned>(blocks), tiled::kT, 0,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
