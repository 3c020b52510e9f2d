// K2 on the CUDA cores: small-sequence multi-head self-attention forward for
// what csrc/small_mha_sm90.cu does not take: float32 (tensor cores would mean
// TF32, about three digits), and bf16 past 128 tokens, unaligned, or with a
// head dim that is not a multiple of 8.
//
// Replaces lipreading_video_generation_tpu/ops/attention.py::
// _small_mha_kernel for those inputs. The TPU kernel folds all heads of a
// batch element into one (H*S_pad)^2 matmul behind a block-diagonal mask, to
// keep its sequential grid short; here blocks run in parallel and no work
// crosses heads. Same function as there and as the plain version
// (_mha_einsum): float32 scores with the scale 1/sqrt(d) applied after QK^T
// (folded with log2(e) into one factor, so that the softmax is one exp2 a
// score), causal rows see keys j <= row, the row softmax with one reciprocal
// a row, P normalised and then rounded to V's dtype, P.V summed in float32, O
// in the input's dtype. No atomics: two launches give equal bits. q, k and v
// are read through their batch and row strides, so the column slices of a
// fused qkv projection need no copy; O is contiguous.
//
// Bound. At the main paths' shapes (float32: the word LM's (100, 31, 64) with
// 4 heads, causal; AV-HuBERT's (16, 5, 768) with 12; the seq2seq expert's
// (16, 5, 256) and causal (16, 48, 256) with 4; the FeatureTransformer's
// (64, 5, 1024) with 2, d 512) a call moves 0.3-5.2 MB and does at most 38
// MFLOP: 0.1-1.6 us of bytes at 3.35 TB/s, less of operations at 67 TFLOP/s.
// That is below one launch's latency, so what bounds the kernel is latency:
// one round trip to memory for q, K and V, and the chain of dependent
// products, shuffles and exponentials of a row.
//
// The variants (ops/attention.py::small_mha_variant picks; numbered as
// _SMALL_MHA_VARIANTS there):
//   - "rows" and "rows_vec4", S <= 64 (the five main-path shapes): a group of
//     L lanes (a power of two from 4 to 32) takes one query row, its lanes
//     over d, so every lane of a warp works at every S and d (d 16: eight
//     rows a warp; d 64: two; d 512: one, four chunks a lane). A block takes whole
//     heads (several when there are heads enough to keep more than two
//     blocks an SM and each takes at most 256 threads: the grid fills the
//     card either way) or, past 256 threads a head, 256 / L rows of one head.
//     Its threads first copy the K and V rows of its heads (causal: only the
//     keys its rows see) into shared memory as float, all copies in flight
//     together: 16-byte cp.async in "rows_vec4" (float32, d, the row and
//     batch strides multiples of 4, 16-byte bases), element loads in "rows";
//     each query row goes straight to its lanes' registers meanwhile. So a
//     key row crosses from L2 once a block, not once a query row (a first
//     version that read K and V from global memory in every row group moved
//     several times the bytes through L2 and was slowest where S was
//     largest). Keys then go in tiles of 8 read from shared memory. A
//     tile's 8 partial dot products are summed over the group by a
//     reduce-scatter (6-9 shuffles where 8 butterflies took 16-40), after
//     which each lane holds the scores of 8 / L of the tile's keys (one,
//     when L >= 8): the lane scales, masks and exponentiates only those, so
//     the row's max and sum take one butterfly each, and P.V, on the same
//     lanes over the same columns, takes each probability from its lane by
//     one shuffle. (A version that summed every dot product by a butterfly
//     and exponentiated every score on every lane of the group took a
//     quarter longer at the expert decoder's S 48 over 16 lanes.) Every
//     lane of a warp takes part in every shuffle: a lane past its block's
//     last row computes that row again and stores nothing, and a warp walks
//     key tiles up to the largest key count among its rows.
//   - "general" and "general_vec4", everything else (S up to 768, d up to
//     the shared memory): one block of 8 warps a (batch, head), the layout
//     of the kernel these variants replaced: K (rows padded to d + 1
//     floats, so lanes reading different keys hit different banks) and V
//     staged in shared memory as float, a warp staging a key row with its
//     lanes over columns (16-byte loads in "general_vec4"), then a warp a
//     query row, its lanes over keys.
// The shared-memory attribute is set once a kernel and device, not every
// launch.
#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>

#include "sm90_common.cuh"

namespace {

using lvg_sm90::cp_async16;
using lvg_sm90::cp_async4;
using lvg_sm90::kLog2e;
using lvg_sm90::smem_u32;

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxDevices = 64;

// ops/attention.py::_SMALL_MHA_VARIANTS, in its order
enum Variant : int { kGeneral = 0, kGeneralVec4 = 1, kRows = 2, kRowsVec4 = 3 };

constexpr int kRowsMaxS = 64;          // a row's scores are registers
constexpr int kRowsMaxChunks = 128;    // 32 lanes x 4 chunks of a row
constexpr int kKeyTile = 8;            // keys read together from shared memory
constexpr int kRowsThreads = 256;      // the most threads of a rows block
constexpr int kRowsGridBlocks = 2 * 132;   // more than two blocks an SM
constexpr int kGenThreads = 256;
constexpr int kGenWarps = kGenThreads / 32;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kSmemPerBlock = 227 * 1024;

struct Params {
  const void *q, *k, *v;
  void* o;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs;   // batch and row strides, elements
  int s, heads, d;
  float scale2;                                   // 1/sqrt(d) * log2(e)
  int causal;
};

// How a rows launch is cut (rows_layout on the host).
struct RowsLayout {
  int heads;        // (batch, head) pairs a block
  int rows;         // query rows of a pair a block (all s when heads > 1)
  int chunks;       // blocks a pair: ceil(s / rows)
  int n_bh;         // (batch, head) pairs in all
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the plain version's probs.to(v.dtype)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
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

// The butterfly max or sum over an aligned group of L lanes.
template <int L, bool MAX>
__device__ __forceinline__ float group_reduce(float x) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(kFullMask, x, off);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  return x;
}

// Reduce-scatter of a tile's kKeyTile partial dot products over an aligned
// group of lanes: at offset OFF a lane keeps the half of its N values that
// the bit OFF of its lane index picks and adds its partner's half of them, so
// the first three levels halve N with N / 2 shuffles each (4 + 2 + 1), and
// the levels past them add one value (1 each): 8-9 shuffles for the 8 dot
// products over 16 or 32 lanes, where a butterfly for each took 32 or 40
// (6 over 4 lanes, where it took 16).
// Afterwards x[0 .. N) hold the sums of keys scatter_key0 ... + N - 1.
template <int N, int OFF>
__device__ __forceinline__ void reduce_scatter(float (&x)[kKeyTile], int sub) {
  if constexpr (OFF >= 1) {
    if constexpr (N > 1) {
      const bool hi = sub & OFF;
#pragma unroll
      for (int u = 0; u < N / 2; ++u) {
        const float send = hi ? x[u] : x[u + N / 2];
        const float keep = hi ? x[u + N / 2] : x[u];
        x[u] = keep + __shfl_xor_sync(kFullMask, send, OFF);
      }
      reduce_scatter<N / 2, OFF / 2>(x, sub);
    } else {
      x[0] += __shfl_xor_sync(kFullMask, x[0], OFF);
      reduce_scatter<1, OFF / 2>(x, sub);
    }
  }
}

// After reduce_scatter over L lanes, the first of the kKeyTile / L keys (one
// when L >= kKeyTile) a tile's lane `sub` holds ...
template <int L>
__device__ __forceinline__ int scatter_key0(int sub) {
  int key = 0;
#pragma unroll
  for (int k = 0, n = kKeyTile; k < 3 && (L >> (k + 1)) >= 1; ++k, n /= 2)
    if (sub & (L >> (k + 1))) key += n / 2;
  return key;
}

// ... and the first of the lanes that hold key u (those past it, L / kKeyTile
// of them in all when L > kKeyTile, hold the same sum).
template <int L>
__device__ __forceinline__ int scatter_owner(int u) {
  int sub = 0;
#pragma unroll
  for (int k = 0, n = kKeyTile; k < 3 && (L >> (k + 1)) >= 1; ++k, n /= 2)
    if (u % n >= n / 2) sub += L >> (k + 1);
  return sub;
}

// VEC elements at p as float: one 16-byte load (VEC 4, float) or one element.
template <int VEC, typename T>
__device__ __forceinline__ void load_vec(float* x, const T* __restrict__ p) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    x[0] = to_float(p[0]);
  }
}

// A lane's part of a row in the rows kernel (global or shared memory): chunk
// n is the VEC elements from column VEC * (n * lanes + sub); columns at or
// past d, and every column of a row that is not `valid`, read as 0.
template <int VEC, int NC, typename T>
__device__ __forceinline__ void load_row(float (&x)[NC * VEC], const T* row, int sub, int lanes,
                                         int d, bool valid = true) {
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    const int c = (n * lanes + sub) * VEC;
    if (valid && c < d) {
      load_vec<VEC>(x + n * VEC, row + c);
    } else {
#pragma unroll
      for (int u = 0; u < VEC; ++u) x[n * VEC + u] = 0.f;
    }
  }
}

// The same part of a K or V row, global -> shared as float: 16-byte (VEC 4)
// or 4-byte cp.async for float, which leave the copies in flight; a load
// and a conversion for bf16.
template <int VEC, int NC, typename T>
__device__ __forceinline__ void stage_row(float* dst, const T* src, int sub, int lanes, int d) {
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    const int c = (n * lanes + sub) * VEC;
    if (c >= d) continue;
    if constexpr (VEC == 4) {
      cp_async16(smem_u32(dst + c), src + c, 16);
    } else if constexpr (sizeof(T) == 4) {
      cp_async4(smem_u32(dst + c), src + c, 4);
    } else {
      dst[c] = to_float(src[c]);
    }
  }
}

template <int VEC, int NC, typename T>
__device__ __forceinline__ void store_row(T* row, const float (&x)[NC * VEC], int sub, int lanes,
                                          int d) {
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    const int c = (n * lanes + sub) * VEC;
    if (c >= d) continue;
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(row + c) =
          make_float4(x[n * VEC], x[n * VEC + 1], x[n * VEC + 2], x[n * VEC + 3]);
    } else {
      row[c] = from_float<T>(x[n]);
    }
  }
}

// "rows" / "rows_vec4": block i takes pairs lay.heads * (i / lay.chunks) ...
// (at most lay.heads of them) and, of each, query rows lay.rows * (i %
// lay.chunks) ... (at most lay.rows); a group of L lanes a row. Shared
// memory: K, then V, of the block's pairs, lay.heads * s rows of d floats
// each. MAXS (8 or 64) is the longest row the scores' registers hold; NC
// chunks of VEC elements a lane.
template <typename T, int VEC, int NC, int L, int MAXS>
__global__ void __launch_bounds__(kRowsThreads) small_mha_rows(Params p, RowsLayout lay) {
  constexpr int V = L >= kKeyTile ? 1 : kKeyTile / L;   // keys of a tile a lane holds
  constexpr int DUP = L > kKeyTile ? L / kKeyTile : 1;  // lanes that hold each
  extern __shared__ float smem[];
  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  const int d = p.d;
  const int sub = threadIdx.x & (L - 1);
  const int group = threadIdx.x / L;
  const int n_groups = blockDim.x / L;
  const int chunk = blockIdx.x % lay.chunks;
  const int bh0 = static_cast<int>(blockIdx.x) / lay.chunks * lay.heads;
  const int heads_here = min(lay.heads, lay.n_bh - bh0);
  const int r0 = chunk * lay.rows, r_end = min(p.s, r0 + lay.rows);
  const int nk = p.causal ? r_end : p.s;   // the keys the block's rows see
  float* ks = smem;
  float* vs = smem + static_cast<size_t>(lay.heads) * p.s * d;

  for (int i = group; i < heads_here * nk; i += n_groups) {
    const int hl = i / nk, j = i - hl * nk;
    const int b = (bh0 + hl) / p.heads, h = bh0 + hl - b * p.heads;
    stage_row<VEC, NC>(ks + static_cast<size_t>(i) * d, k + b * p.k_bs + j * p.k_rs + h * d, sub,
                       L, d);
    stage_row<VEC, NC>(vs + static_cast<size_t>(i) * d, v + b * p.v_bs + j * p.v_rs + h * d, sub,
                       L, d);
  }
  lvg_sm90::cp_async_commit();

  // this group's query row; a group past the block's last row takes that row
  // again and stores nothing
  const int rows_here = r_end - r0;
  int hl = group / rows_here, r = r0 + group - hl * rows_here;
  const bool live = hl < heads_here;
  if (!live) hl = heads_here - 1, r = r_end - 1;
  const int b = (bh0 + hl) / p.heads, h = bh0 + hl - b * p.heads;
  float qv[NC * VEC];
  load_row<VEC, NC>(qv, q + b * p.q_bs + r * p.q_rs + h * d, sub, L, d);
  const int n_keys = p.causal ? r + 1 : p.s;
  const int warp_keys = __reduce_max_sync(kFullMask, n_keys);
  const int key0 = scatter_key0<L>(sub);
  const float* kh = ks + static_cast<size_t>(hl) * nk * d;
  const float* vh = vs + static_cast<size_t>(hl) * nk * d;
  lvg_sm90::cp_async_wait<0>();
  __syncthreads();

  // the scores of the keys this lane holds: V a tile
  float sc[MAXS / kKeyTile][V];
#pragma unroll
  for (int t = 0; t < MAXS; t += kKeyTile) {
    if (t < warp_keys) {
      float kv[kKeyTile][NC * VEC], dot[kKeyTile];
#pragma unroll
      for (int u = 0; u < kKeyTile; ++u)
        load_row<VEC, NC>(kv[u], kh + (t + u) * d, sub, L, d, t + u < nk);
#pragma unroll
      for (int u = 0; u < kKeyTile; ++u) {
        dot[u] = 0.f;
#pragma unroll
        for (int i = 0; i < NC * VEC; ++i) dot[u] = fmaf(qv[i], kv[u][i], dot[u]);
      }
      reduce_scatter<kKeyTile, L / 2>(dot, sub);
#pragma unroll
      for (int w = 0; w < V; ++w)
        sc[t / kKeyTile][w] = t + key0 + w < n_keys ? dot[w] * p.scale2 : -INFINITY;
    } else {
#pragma unroll
      for (int w = 0; w < V; ++w) sc[t / kKeyTile][w] = -INFINITY;
    }
  }

  // the row softmax: each lane exponentiates the scores it holds, the group
  // reduces once (key 0 is visible to every row, so the max is finite; a key
  // held by DUP lanes enters the sum once)
  float m = -INFINITY;
#pragma unroll
  for (int t = 0; t < MAXS; t += kKeyTile)
#pragma unroll
    for (int w = 0; w < V; ++w) m = fmaxf(m, sc[t / kKeyTile][w]);
  m = group_reduce<L, true>(m);
  float l = 0.f;
#pragma unroll
  for (int t = 0; t < MAXS; t += kKeyTile) {
    if (t < warp_keys) {
#pragma unroll
      for (int w = 0; w < V; ++w) {
        sc[t / kKeyTile][w] = exp2f(sc[t / kKeyTile][w] - m);
        l += sc[t / kKeyTile][w];
      }
    }
  }
  if (sub % DUP) l = 0.f;
  const float inv = 1.f / group_reduce<L, false>(l);

  // P.V: key u's probability comes from the lane that holds it, normalised
  // and rounded to V's dtype on every lane alike
  const int base = (threadIdx.x & 31) & ~(L - 1);
  float acc[NC * VEC];
#pragma unroll
  for (int i = 0; i < NC * VEC; ++i) acc[i] = 0.f;
#pragma unroll
  for (int t = 0; t < MAXS; t += kKeyTile) {
    if (t < warp_keys) {
      float vv[kKeyTile][NC * VEC];
#pragma unroll
      for (int u = 0; u < kKeyTile; ++u)
        load_row<VEC, NC>(vv[u], vh + (t + u) * d, sub, L, d, t + u < nk);
#pragma unroll
      for (int u = 0; u < kKeyTile; ++u) {
        const float e2 =
            __shfl_sync(kFullMask, sc[t / kKeyTile][u % V], base + scatter_owner<L>(u));
        const float pj = round_to<T>(e2 * inv);
#pragma unroll
        for (int i = 0; i < NC * VEC; ++i) acc[i] = fmaf(pj, vv[u][i], acc[i]);
      }
    }
  }
  if (live) {
    T* o = static_cast<T*>(p.o) + (static_cast<long long>(b) * p.s + r) * (p.heads * d) + h * d;
    store_row<VEC, NC>(o, acc, sub, L, d);
  }
}

// "general" / "general_vec4": one block a (batch, head), the earlier layout.
template <typename T, int VEC>
__global__ void __launch_bounds__(kGenThreads) small_mha_general(Params p) {
  extern __shared__ float smem[];
  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  const int s = p.s, d = p.d, ld = d + 1, e = p.heads * d;
  float* ks = smem;                     // s x (d+1)
  float* vs = ks + s * ld;              // s x d
  float* qrow = vs + s * d;             // kGenWarps x d
  float* prow = qrow + kGenWarps * d;   // kGenWarps x s

  const int b = static_cast<int>(blockIdx.x) / p.heads;
  const int h = static_cast<int>(blockIdx.x) - b * p.heads;
  const T* kb = k + b * p.k_bs + h * d;
  const T* vb = v + b * p.v_bs + h * d;
  const T* qb = q + b * p.q_bs + h * d;
  T* ob = static_cast<T*>(p.o) + static_cast<long long>(b) * s * e + h * d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int j = warp; j < s; j += kGenWarps) {
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      float x[VEC], y[VEC];
      load_vec<VEC>(x, kb + j * p.k_rs + c);
      load_vec<VEC>(y, vb + j * p.v_rs + c);
#pragma unroll
      for (int u = 0; u < VEC; ++u) ks[j * ld + c + u] = x[u], vs[j * d + c + u] = y[u];
    }
  }
  __syncthreads();

  float* qr = qrow + warp * d;
  float* pr = prow + warp * s;
  for (int r = warp; r < s; r += kGenWarps) {
    for (int c = lane * VEC; c < d; c += 32 * VEC) load_vec<VEC>(qr + c, qb + r * p.q_rs + c);
    __syncwarp();
    const int n_keys = p.causal ? r + 1 : s;

    float m = -INFINITY;
    for (int j = lane; j < n_keys; j += 32) {
      float acc = 0.f;
      for (int c = 0; c < d; ++c) acc = fmaf(qr[c], ks[j * ld + c], acc);
      acc *= p.scale2;
      pr[j] = acc;
      m = fmaxf(m, acc);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n_keys; j += 32) {
      const float e2 = exp2f(pr[j] - m);
      pr[j] = e2;
      l += e2;
    }
    const float inv = 1.f / warp_sum(l);
    for (int j = lane; j < n_keys; j += 32) pr[j] = round_to<T>(pr[j] * inv);
    __syncwarp();

    for (int c = lane; c < d; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < n_keys; ++j) acc = fmaf(pr[j], vs[j * d + c], acc);
      ob[static_cast<long long>(r) * e + c] = from_float<T>(acc);
    }
    __syncwarp();
  }
}

size_t general_smem_bytes(int s, int d) {
  return (static_cast<size_t>(s) * (2 * d + 1) + kGenWarps * static_cast<size_t>(d + s)) *
         sizeof(float);
}

// Lets `kernel` take up to 227 KB of dynamic shared memory on the current
// device, once a device (`reserved`, one for each kernel), for a launch that
// needs more than the default 48 KB.
cudaError_t reserve_smem(const void* kernel, size_t bytes, bool (&reserved)[kMaxDevices]) {
  if (bytes <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  if (bytes > static_cast<size_t>(kSmemPerBlock)) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && reserved[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemPerBlock);
  if (err == cudaSuccess && cached) reserved[dev] = true;
  return err;
}

// Pairs a block and rows a block: whole pairs while a pair takes at most
// kRowsThreads threads, several of them where there are pairs enough for
// kRowsGridBlocks blocks and their K and V fit 48 KB; else a block takes
// kRowsThreads / lanes rows of one pair.
RowsLayout rows_layout(int s, int d, int lanes, int n_bh) {
  RowsLayout lay{1, s, 1, n_bh};
  const int per_pair = s * lanes;
  if (per_pair <= kRowsThreads) {
    lay.heads = std::min({kRowsThreads / per_pair, std::max(1, n_bh / kRowsGridBlocks),
                          std::max(1, static_cast<int>(kDefaultSmem / (8LL * s * d)))});
  } else {
    lay.rows = kRowsThreads / lanes;
    lay.chunks = (s + lay.rows - 1) / lay.rows;
  }
  return lay;
}

template <typename T, int VEC, int NC, int L, int MAXS>
int launch_rows(const Params& p, int batch, cudaStream_t stream) {
  static bool reserved[kMaxDevices] = {};
  const RowsLayout lay = rows_layout(p.s, p.d, L, batch * p.heads);
  const size_t smem = 2 * static_cast<size_t>(lay.heads) * p.s * p.d * sizeof(float);
  const cudaError_t err = reserve_smem(
      reinterpret_cast<const void*>(small_mha_rows<T, VEC, NC, L, MAXS>), smem, reserved);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = (lay.heads * lay.rows * L + 31) / 32 * 32;
  const long long blocks =
      (lay.n_bh + lay.heads - 1) / lay.heads * static_cast<long long>(lay.chunks);
  small_mha_rows<T, VEC, NC, L, MAXS>
      <<<static_cast<unsigned>(blocks), threads, smem, stream>>>(p, lay);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC, int NC, int L>
int launch_rows_s(const Params& p, int batch, cudaStream_t stream) {
  return p.s <= kKeyTile ? launch_rows<T, VEC, NC, L, kKeyTile>(p, batch, stream)
                         : launch_rows<T, VEC, NC, L, kRowsMaxS>(p, batch, stream);
}

// The lanes of a row: its chunks of VEC elements one a lane, at least 4 lanes
// (a power of two); past 32 chunks 32 lanes with 2 or 4 chunks each.
template <typename T, int VEC>
int rows(const Params& p, int batch, cudaStream_t stream) {
  const int chunks = (p.d + VEC - 1) / VEC;
  if (p.s < 1 || p.s > kRowsMaxS || chunks > kRowsMaxChunks) return cudaErrorInvalidValue;
  if (chunks > 64) return launch_rows_s<T, VEC, 4, 32>(p, batch, stream);
  if (chunks > 32) return launch_rows_s<T, VEC, 2, 32>(p, batch, stream);
  if (chunks > 16) return launch_rows_s<T, VEC, 1, 32>(p, batch, stream);
  if (chunks > 8) return launch_rows_s<T, VEC, 1, 16>(p, batch, stream);
  if (chunks > 4) return launch_rows_s<T, VEC, 1, 8>(p, batch, stream);
  return launch_rows_s<T, VEC, 1, 4>(p, batch, stream);
}

template <typename T, int VEC>
int general(const Params& p, int batch, cudaStream_t stream) {
  static bool reserved[kMaxDevices] = {};
  const size_t smem = general_smem_bytes(p.s, p.d);
  const cudaError_t err =
      reserve_smem(reinterpret_cast<const void*>(small_mha_general<T, VEC>), smem, reserved);
  if (err != cudaSuccess) return static_cast<int>(err);
  small_mha_general<T, VEC><<<batch * p.heads, kGenThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch, long long q_bs,
           long long q_rs, long long k_bs, long long k_rs, long long v_bs, long long v_rs, int s,
           int heads, int d, float scale, int causal, int variant, void* stream) {
  const Params p{q, k, v, o, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, s, heads, d, scale * kLog2e,
                 causal};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(batch) * heads > INT_MAX) return cudaErrorInvalidValue;
  if (variant == kGeneralVec4 || variant == kRowsVec4) {
    // 16-byte loads: float32, d and every stride a multiple of 4 elements,
    // every base on 16 bytes (O is contiguous, so its rows are then too)
    const bool ok = sizeof(T) == 4 && d % 4 == 0 && q_bs % 4 == 0 && q_rs % 4 == 0 &&
                    k_bs % 4 == 0 && k_rs % 4 == 0 && v_bs % 4 == 0 && v_rs % 4 == 0 &&
                    aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
    if (!ok) return cudaErrorInvalidValue;
  }
  switch (variant) {
    case kGeneral: return general<T, 1>(p, batch, st);
    case kRows: return rows<T, 1>(p, batch, st);
    case kGeneralVec4: if constexpr (sizeof(T) == 4) return general<T, 4>(p, batch, st); break;
    case kRowsVec4: if constexpr (sizeof(T) == 4) return rows<T, 4>(p, batch, st); break;
    default: break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v: (batch, s, heads*d) with unit column stride and the given batch
// and row strides; o: contiguous (batch, s, heads*d) of the same dtype.
// scale is the softmax scale (1/sqrt(d)); variant is the index of
// ops/attention.py::small_mha_variant's answer in _SMALL_MHA_VARIANTS (the
// vec4 variants take float32 only). Returns cudaErrorInvalidValue for a shape
// or layout the variant does not take, else cudaGetLastError() after the
// launch.
extern "C" int lvg_small_mha_bf16(const void* q, const void* k, const void* v, void* o,
                                  int batch, long long q_bs, long long q_rs,
                                  long long k_bs, long long k_rs, long long v_bs,
                                  long long v_rs, int s, int heads, int d, float scale,
                                  int causal, int variant, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, batch, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, s, heads,
                               d, scale, causal, variant, stream);
}

extern "C" int lvg_small_mha_f32(const void* q, const void* k, const void* v, void* o,
                                 int batch, long long q_bs, long long q_rs,
                                 long long k_bs, long long k_rs, long long v_bs,
                                 long long v_rs, int s, int heads, int d, float scale,
                                 int causal, int variant, void* stream) {
  return launch<float>(q, k, v, o, batch, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, s, heads, d,
                       scale, causal, variant, stream);
}
