// K3 on Hopper's tensor cores: the flash-attention forward (online softmax),
// O and the per-row logsumexp, for bf16 inputs whose base addresses and
// (batch, head, row) strides are multiples of 16 bytes and whose head dim is
// a multiple of 8 up to 256.
//
// Replaces lipreading_video_generation_tpu/ops/attention.py::_flash_kernel
// (driven by _flash_forward; scripts/profile_flash_dpad.py launches the same
// kernel body) for those inputs; float32, unaligned inputs and head dims
// above 256 keep the CUDA-core kernel of flash_fwd.cu. Same function, masks
// and edges as there (see its header): per query tile the key/value tiles
// are streamed, a running max m and sum l are kept per row, P V is summed in
// float32, O is written in bf16 through its strides and lse = m + log l in
// float32. Causal masking is bottom-right aligned (key j visible to row i iff
// j <= i + s_k - s_q); key tiles past the block's last visible key are
// skipped; rows that see no key come out as the mean of V over the s_k real
// keys, their lse as finfo(float32).min / 2. No atomics: the same bits from
// run to run. Two things differ from the CUDA-core kernel in rounding only:
// the scores are scaled after the product (bf16 Q cannot be scaled first in
// float32), and P is rounded to bf16 before P V (l sums the float32 P).
//
// Bound: operations (4 S^2 d FLOP per (batch, head) against four (S, d)
// tensors moved), and beside the tensor cores the exponentials: one ex2 per
// score, 16 a clock on an SM, which at head dim 64 takes about as long as
// the two products of the tile. What the design does about it:
//   - Q, K, V stay bf16 from device memory to the tensor core, in the
//     128-byte-swizzled tiles of sm90_common.cuh. Q is loaded once. K and V
//     each go through a ring of two stages filled by 16-byte cp.async (zero
//     fill past the last row and past d): during tile t the copies of K of
//     tile t + 2 and V of tile t + 1 are in flight.
//   - S = Q K^T is wgmma m64nNk16 with the queries as M and K as the K-major
//     B operand; its accumulator stays in registers. Scale, mask, row max,
//     ex2 (log2 e folded into the scale) and the row sum run on the
//     accumulator layout, where a row's values sit in the four threads of a
//     quad (two shuffles a reduction, no shared memory). P is rounded to
//     bf16 in registers and is the A operand from registers of O += P V,
//     with V as the MN-major B operand of the same tile layout. P never
//     touches shared memory.
//   - Software pipeline within a warpgroup: once P of tile t is packed, the
//     score accumulator is free, so S of tile t + 1 and O += P V of tile t
//     are started together and the softmax of tile t + 1 runs while the
//     second is still in flight; O is rescaled by exp2(m_old - m_new) after
//     it has landed. The tensor cores work under the exponentials. One
//     __syncthreads a tile (before the freed stages are refilled).
//   - Registers: a 64 x N float32 accumulator is N / 2 a thread. Head dim
//     64: two warpgroups a block (128 queries), 64-key tiles (S 32, P 16, O
//     32 registers), so that a thread stays within 128 registers and two
//     blocks share an SM: their four warpgroups drift out of phase, and one
//     block's products and copies run under the other's exponentials, which
//     one block's two warpgroups, in step between the __syncthreads, cannot
//     do. Head dim 128: two warpgroups, 128-key tiles (S 64, P 32, O 64), one
//     block an SM. Head dim 256: one warpgroup of 64 queries a block (so that
//     1024 tokens still give 16 blocks a head), 64-key tiles (S 32, P 16, O
//     128).
//   - Few instructions a tile beside the softmax's: with two warps a
//     scheduler, a warp's own chain of instructions is what a tile takes, so
//     each thread forms its copy addresses once and steps them by additions
//     (RowLoader), and the descriptors of a product differ from its first by
//     a constant (desc_at) and stay in uniform registers.
#include <cmath>

#include "sm90_common.cuh"

namespace {

using namespace lvg_sm90;

constexpr float kLn2 = 0.6931471805599453f;
// A causally hidden score, in the log2 domain: finfo(float32).min / 2 (what
// the CUDA-core kernel and the plain version put there) times log2(e), still
// finite, so that a row of hidden keys only gets lse = finfo.min / 2.
constexpr float kHidden2 = -1.7014117331926443e38f * kLog2e;
constexpr unsigned kFullMask = 0xffffffffu;

struct Params {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* o;
  float* lse;
  int n_bh, heads, s_q, s_k, d;   // n_bh = batch * heads
  long long st[12];              // (batch, head, row) strides of q, k, v, o
  float scale;
  int causal;
};

template <int DP> struct FwdCfg {
  static constexpr int NWG = DP == 256 ? 1 : 2;      // warpgroups, 64 queries each
  static constexpr int BQ = 64 * NWG;                // query rows per block
  static constexpr int BK = DP == 128 ? 128 : 64;    // keys per tile
  static constexpr int min_blocks = DP == 64 ? 2 : 1;   // blocks an SM the registers must allow
  static constexpr int NI = DP == 64 ? 64 : 128;     // columns of O per product
  static constexpr int threads = 128 * NWG;
  static constexpr int q_bytes = BQ * DP * 2;
  static constexpr int kv_bytes = BK * DP * 2;
  static constexpr int smem_bytes = q_bytes + 4 * kv_bytes + 1024;
};

// One online-softmax step on a 64-query x BK-key tile of raw scores: element
// i of s is query row0 + 8 (i / 2 % 2), key j0 + 8 (i / 4) + 2 (lane % 4) +
// i % 2. s <- P = exp2(s scale2 - m), with m the running row max (log2
// domain) after this tile; l <- l alpha + this thread's part of the row sum,
// alpha = exp2(m_old - m). MASK: keys past s_k get weight 0 and causally
// hidden pairs the score kHidden2; without it scale2 must not be negative
// (the max is taken before scaling).
template <bool MASK, int BK>
__device__ __forceinline__ void softmax_step(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale2, int j0, int row0,
                                             int lane, int off, int s_k, int causal) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int hi = (i >> 1) & 1;
    if (MASK) {
      const int key = j0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      float x = s[i] * scale2;
      if (key >= s_k) x = -INFINITY;
      else if (causal && key > row0 + 8 * hi + off) x = kHidden2;
      s[i] = x;
    }
    mx[hi] = fmaxf(mx[hi], s[i]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFullMask, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFullMask, mx[h], 2));
    // finite: the tile's first key is real, so every row has a finite score
    const float m_new = fmaxf(m[h], MASK ? mx[h] : mx[h] * scale2);
    alpha[h] = ex2(m[h] - m_new);
    m[h] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int hi = (i >> 1) & 1;
    s[i] = MASK ? ex2(s[i] - m[hi]) : ex2(fmaf(s[i], scale2, -m[hi]));
    sum[hi] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = fmaf(l[h], alpha[h], sum[h]);
}

// softmax_step on the tile of keys from j0, of a warpgroup whose first row
// is wg_r0: without the masks where every pair of the tile is visible.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale2, int j0, int wg_r0,
                                             int row0, int lane, int off, int s_k, int causal) {
  const bool full =
      scale2 >= 0.f && j0 + BK <= s_k && (!causal || j0 + BK - 1 <= wg_r0 + off);
  if (full)
    softmax_step<false, BK>(s, m, l, alpha, scale2, j0, row0, lane, off, s_k, causal);
  else
    softmax_step<true, BK>(s, m, l, alpha, scale2, j0, row0, lane, off, s_k, causal);
}

// P rounded to bf16 as the A fragments of the next product: two neighbouring
// keys of one row a register, in the accumulator's order.
template <int N>
__device__ __forceinline__ void pack_probs(uint32_t (&pa)[N / 2], const float (&s)[N]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// O (64 x DP) += P V over the BK keys of the V tile at st, NI columns a
// product.
template <int DP, int NI, int BK>
__device__ __forceinline__ void pv_accumulate(float (&o)[DP / 2], const uint32_t (&pa)[BK / 4],
                                              uint32_t st) {
#pragma unroll
  for (int n = 0; n < DP / NI; ++n)
    product_rs<BK, NI, 0, BK / 16>(reinterpret_cast<float (&)[NI / 2]>(o[n * (NI / 2)]), pa,
                                   st + n * (NI / 64) * (BK * 128));
}

template <int DP>
__global__ void __launch_bounds__(FwdCfg<DP>::threads, FwdCfg<DP>::min_blocks)
flash_fwd_sm90_kernel(Params p) {
  using C = FwdCfg<DP>;
  constexpr int BQ = C::BQ, BK = C::BK, NI = C::NI, NT = C::threads;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t qs = base, ks0 = qs + C::q_bytes, vs0 = ks0 + 2 * C::kv_bytes;

  const int bh = head_of_block();
  if (bh >= p.n_bh) return;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const __nv_bfloat16* qb = p.q + b * p.st[0] + h * p.st[1];
  const __nv_bfloat16* kb = p.k + b * p.st[3] + h * p.st[4];
  const __nv_bfloat16* vb = p.v + b * p.st[6] + h * p.st[7];

  const int tid = threadIdx.x;
  // the warpgroup's index through a shuffle: the compiler then knows it is
  // the same in every lane and keeps the descriptors in uniform registers
  const int wg = __shfl_sync(kFullMask, tid >> 7, 0), warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = blockIdx.x * BQ;
  const int row0 = r0 + wg * 64 + 16 * warp + (lane >> 2);   // and row0 + 8
  const int off = p.s_k - p.s_q;
  const float scale2 = p.scale * kLog2e;
  const uint32_t q_wg = qs + wg * 8192;

  // Causal: key tiles past the block's last visible key are skipped, unless
  // a row of the block sees no key at all (it averages V over every key).
  int n_iter = (p.s_k + BK - 1) / BK;
  if (p.causal && r0 + off >= 0) n_iter = min(p.s_k - 1, r0 + BQ - 1 + off) / BK + 1;

  // tiles are asked for in rising order, each once
  RowLoader<BK, DP, NT> k_rows(kb, p.st[5], p.s_k, p.d, tid), v_rows(vb, p.st[8], p.s_k, p.d, tid);
  auto load_k = [&](int t) { k_rows.next(ks0 + (t & 1) * C::kv_bytes); };
  auto load_v = [&](int t) { v_rows.next(vs0 + (t & 1) * C::kv_bytes); };

  load_rows<BQ, DP, NT>(qs, qb, p.st[2], r0, p.s_q, p.d, tid);
  load_k(0);
  load_v(0);
  cp_async_commit();
  if (n_iter > 1) load_k(1);
  cp_async_commit();
  cp_async_wait<1>();   // Q, K and V of tile 0
  fence_async_proxy();
  __syncthreads();

  float s[BK / 2], o[DP / 2];
  uint32_t pa[BK / 4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

  const int wg_r0 = r0 + wg * 64;   // the warpgroup's first row

  wgmma_fence();
  product_ss<DP, BQ, BK>(s, q_wg, ks0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(s);
  softmax_tile<BK>(s, m, l, alpha, scale2, 0, wg_r0, row0, lane, off, p.s_k, p.causal);
  pack_probs(pa, s);

  for (int t = 0; t + 1 < n_iter; ++t) {
    cp_async_wait<0>();   // K of tile t + 1, V of tile t
    fence_async_proxy();
    __syncthreads();      // and every warp is done with K of tile t, V of tile t - 1
    if (t + 2 < n_iter) load_k(t + 2);
    load_v(t + 1);
    cp_async_commit();

    // S of tile t + 1 and O += P V of tile t, both in flight under the
    // softmax of tile t + 1
    fence_acc(o);
    fence_regs(pa);
    wgmma_fence();
    product_ss<DP, BQ, BK>(s, q_wg, ks0 + ((t + 1) & 1) * C::kv_bytes);
    wgmma_commit();
    pv_accumulate<DP, NI, BK>(o, pa, vs0 + (t & 1) * C::kv_bytes);
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(s);
    softmax_tile<BK>(s, m, l, alpha, scale2, (t + 1) * BK, wg_r0, row0, lane, off, p.s_k,
                     p.causal);
    fence_acc(s);   // P is formed before the wait for O
    wgmma_wait<0>();
    fence_acc(o);
    fence_regs(pa);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    pack_probs(pa, s);
  }

  // the last tile's O += P V
  cp_async_wait<0>();
  fence_async_proxy();
  __syncthreads();
  fence_acc(o);
  fence_regs(pa);
  wgmma_fence();
  pv_accumulate<DP, NI, BK>(o, pa, vs0 + ((n_iter - 1) & 1) * C::kv_bytes);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(o);
  fence_regs(pa);

  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(kFullMask, l[hh], 1);
    l[hh] += __shfl_xor_sync(kFullMask, l[hh], 2);
    l[hh] = fmaxf(l[hh], 1e-30f);
    inv[hh] = 1.f / l[hh];
  }
  __nv_bfloat16* ob = p.o + b * p.st[9] + h * p.st[10];
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int hi = (i >> 1) & 1;
    const int row = row0 + 8 * hi;
    const int c = 8 * (i >> 2) + 2 * (lane & 3);
    if (row < p.s_q && c < p.d)
      *reinterpret_cast<uint32_t*>(ob + row * p.st[11] + c) =
          pack_bf16(o[i] * inv[hi], o[i + 1] * inv[hi]);
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (row0 + 8 * hh < p.s_q)
        p.lse[static_cast<long long>(bh) * p.s_q + row0 + 8 * hh] = m[hh] * kLn2 + logf(l[hh]);
  }
}

template <int DP> int launch_dp(const Params& p, cudaStream_t stream) {
  using C = FwdCfg<DP>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = tile_head_grid((p.s_q + C::BQ - 1) / C::BQ, p.n_bh);
  flash_fwd_sm90_kernel<DP><<<grid, C::threads, C::smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The interface of flash_fwd.cu's entry points, for bf16 q, k, v, o whose
// base addresses are multiples of 16 bytes and whose strides and d are
// multiples of 8 elements, d <= 256 (anything else returns an error and
// launches nothing). Returns cudaGetLastError() after the launch.
extern "C" int lvg_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int batch, int heads, int s_q, int s_k, int d,
                                  const long long* strides, float scale, int causal,
                                  void* stream) {
  if (batch <= 0 || heads <= 0 || s_q <= 0 || s_k <= 0 || d <= 0 || d > 256 || d % 8 ||
      static_cast<long long>(batch) * heads > kMaxHeads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.n_bh = batch * heads; p.heads = heads; p.s_q = s_q; p.s_k = s_k; p.d = d;
  for (int i = 0; i < 12; ++i) {
    if (strides[i] % 8) return static_cast<int>(cudaErrorMisalignedAddress);
    p.st[i] = strides[i];
  }
  p.scale = scale;
  p.causal = causal;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_dp<64>(p, cs);
  if (d <= 128) return launch_dp<128>(p, cs);
  return launch_dp<256>(p, cs);
}
