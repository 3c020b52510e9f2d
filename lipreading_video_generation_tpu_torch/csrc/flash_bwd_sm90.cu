// K4 and K5 on Hopper's tensor cores: the flash-attention backward
// (FlashAttention-2), dK/dV pass and dQ pass, for bf16 inputs whose base
// addresses and (batch, head, row) strides are multiples of 16 bytes.
//
// Replace lipreading_video_generation_tpu/ops/attention.py::_bwd_dkv_kernel
// (K4) and ::_bwd_dq_kernel (K5) for those inputs; float32 and unaligned
// inputs keep the CUDA-core kernels of flash_bwd.cu. Same function, masks
// and edges as there (see its header): s = Q K^T scale, P = exp(s - lse),
// dP = dO V^T, dS = P (dP - Delta) scale, dV = P^T dO, dK = dS^T Q,
// dQ = dS K; causal masking bottom-right aligned; rows that see no key get
// P = 1/s_k over the real keys and dS = 0. Two passes, no atomics: the same
// bits from run to run.
//
// Bound: operations (14 S^2 d FLOP per (batch, head) over the two kernels
// against 5-6 (B, H, S, d) tensors moved). What the design does about it:
//   - Q, K, V, dO stay bf16 from device memory to the tensor core. Tiles lie
//     in shared memory as blocks of 64 columns, each row 128 bytes, 16-byte
//     chunk c of row r at chunk (c ^ (r & 7)): the 128-byte swizzle that
//     wgmma descriptors read without bank conflicts. One such tile serves as
//     a K-major operand (the head dim is contracted: Q K^T, dO V^T) and as
//     an MN-major B operand (the rows are contracted: P^T dO, dS^T Q, dS K).
//   - All seven products are wgmma.mma_async m64nNk16 (bf16 -> float32),
//     started by whole warpgroups, accumulators in registers.
//     K4 (one block per key tile, loop over query tiles) computes the
//     transposed scores S^T = K Q^T and dP^T = V dO^T with the keys as M, so
//     P^T and dS^T come out in the accumulator layout, are rounded to bf16
//     in registers and feed dV += P^T dO and dK += dS^T Q as the A operand
//     from registers. K5 (one block per query tile, loop over key tiles)
//     computes S and dP with the queries as M and feeds dQ += dS K the same
//     way. P and dS never touch shared memory. lse and Delta are one value
//     per accumulator row (K5: registers) or column (K4: a small shared
//     array per query tile). exp2 with log2(e) folded into scale and lse.
//   - The inner-axis tiles (Q, dO, lse, Delta in K4; K, V in K5) go through
//     a ring of two stages filled by 16-byte cp.async into the swizzled
//     layout (zero fill past the last row and past d): the copies of tile
//     t + 1 are started before the products of tile t. The outer tiles are
//     loaded once.
//   - Within a tile step the two score products are committed as two groups:
//     P is formed while dP's product is still in flight, and dS of the second
//     half of the tile while the first half's accumulations run. The two
//     warpgroups of a block meet at two __syncthreads a tile (before the
//     products, and before the stage is refilled).
//   - Registers: a 64 x N float32 accumulator is N/2 registers a thread.
//     Head dim 64: K4 128 keys a block (64 a warpgroup), 128-query tiles;
//     K5 128 queries a block, 128-key tiles. Head dim 128: 64-query /
//     64-key tiles. Head dim 256: K4 takes 64 keys a block and splits the
//     columns of dK/dV over its two warpgroups (each forms the scores
//     itself); K5 runs one warpgroup of 64 queries with dQ as two 128-column
//     halves.
#include "sm90_common.cuh"

namespace {

using namespace lvg_sm90;

struct Params {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse, *delta;
  __nv_bfloat16 *g0, *g1;        // K4: dK, dV; K5: dQ
  int n_bh, heads, s_q, s_k, d;   // n_bh = batch * heads
  long long st[18];              // (batch, head, row) strides of q, k, v, dO, g0, g1
  float scale;
  int causal;
};


// K4, s <- P^T over a 64-key x BQ-query tile of transposed scores: element
// 4j + e of s is key key0 + 8 (e / 2), query r0 + 8j + 2 (lane % 4) + e % 2.
// MASK: pairs past s_q or s_k and causally hidden pairs get 0; rows that
// see no key get 1/s_k at the real keys.
template <bool MASK, int BQ>
__device__ __forceinline__ void dkv_probs(float (&s)[BQ / 2], const float* lse_s, float scale2,
                                          float inv_sk, int key0, int r0, int lane, int off,
                                          int s_q, int s_k, int causal) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const float pv = ex2(fmaf(s[i], scale2, -((e & 1) ? l2.y : l2.x) * kLog2e));
      if (MASK) {
        const int key = key0 + 8 * (e >> 1), row = r0 + c + (e & 1);
        const bool real = key < s_k && row < s_q;
        const bool vis = real && !(causal && key > row + off);
        const bool blind = causal && row + off < 0;   // the row sees no key
        s[i] = vis ? pv : (real && blind ? inv_sk : 0.f);
      } else {
        s[i] = pv;
      }
    }
  }
}

// K4, dp <- dS^T over half H of the tile's queries, and P^T and dS^T of that
// half rounded to bf16 as the next products' A fragments. Masked pairs
// have P = 0, so dS = 0; rows that see no key (MASK) have P = 1/s_k, dS = 0.
template <bool MASK, int H, int BQ>
__device__ __forceinline__ void dkv_grads(const float (&s)[BQ / 2], float (&dp)[BQ / 2],
                                          const float* delta_s, float scale, int r0, int lane,
                                          int off, int causal, uint32_t (&pa)[BQ / 8],
                                          uint32_t (&da)[BQ / 8]) {
#pragma unroll
  for (int jj = 0; jj < BQ / 16; ++jj) {
    const int j = H * (BQ / 16) + jj, c = 8 * j + 2 * (lane & 3);
    const float2 d2 = *reinterpret_cast<const float2*>(delta_s + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const float dsv = s[i] * (dp[i] - ((e & 1) ? d2.y : d2.x)) * scale;
      dp[i] = MASK && causal && r0 + c + (e & 1) + off < 0 ? 0.f : dsv;
    }
    pa[2 * jj] = pack_bf16(s[4 * j], s[4 * j + 1]);
    pa[2 * jj + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    da[2 * jj] = pack_bf16(dp[4 * j], dp[4 * j + 1]);
    da[2 * jj + 1] = pack_bf16(dp[4 * j + 2], dp[4 * j + 3]);
  }
}

// K5, dS over half H of a 64-query x BK-key tile, rounded to bf16 as the
// next product's A fragments: element i is query row0 + 8 (i / 2 % 2), key
// j0 + 8 (i / 4) + 2 (lane % 4) + i % 2. MASK: hidden pairs get 0.
template <bool MASK, int H, int BK>
__device__ __forceinline__ void dq_grads(const float (&s)[BK / 2], float (&dp)[BK / 2],
                                         const float (&dsc)[2], float scale, int j0, int row0,
                                         int lane, int off, int s_q, int s_k, int causal,
                                         uint32_t (&da)[BK / 8]) {
  constexpr int I0 = H * (BK / 4);
#pragma unroll
  for (int ii = 0; ii < BK / 4; ++ii) {
    const int i = I0 + ii, hi = (i >> 1) & 1;
    const float dsv = s[i] * fmaf(dp[i], scale, -dsc[hi]);
    if (MASK) {
      const int key = j0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1), row = row0 + 8 * hi;
      const bool vis = key < s_k && row < s_q && !(causal && key > row + off);
      dp[i] = vis ? dsv : 0.f;
    } else {
      dp[i] = dsv;
    }
  }
#pragma unroll
  for (int ii = 0; ii < BK / 8; ++ii) da[ii] = pack_bf16(dp[I0 + 2 * ii], dp[I0 + 2 * ii + 1]);
}

// K5, dQ (64 x DP) += dS K over rows [16 KK0, 16 KK0 + BK / 2) of the K tile
// at st, NI columns a product.
template <int DP, int NI, int BK, int KK0>
__device__ __forceinline__ void dq_accumulate(float (&dq)[DP / 2], const uint32_t (&da)[BK / 8],
                                              uint32_t st) {
#pragma unroll
  for (int n = 0; n < DP / NI; ++n)
    product_rs<BK, NI, KK0, BK / 32>(reinterpret_cast<float (&)[NI / 2]>(dq[n * (NI / 2)]), da,
                                     st + n * (NI / 64) * (BK * 128));
}

// ---------------------------------------------------------------- K4: dK, dV

template <int DP> struct DkvCfg {
  static constexpr int NSPLIT = DP == 256 ? 2 : 1;   // warpgroups sharing the keys
  static constexpr int KEYS = 128 / NSPLIT;          // keys per block
  static constexpr int BQ = DP == 64 ? 128 : 64;     // query rows per tile
  static constexpr int CW = DP / NSPLIT;             // dK/dV columns per warpgroup
  static constexpr int kv_bytes = KEYS * DP * 2;
  static constexpr int q_bytes = BQ * DP * 2;
  static constexpr int stage_bytes = 2 * q_bytes + 1024;   // Q, dO, lse and Delta
  static constexpr int smem_bytes = 2 * kv_bytes + 2 * stage_bytes + 1024;
};

template <int DP>
__global__ void __launch_bounds__(256, 1) flash_bwd_dkv_sm90_kernel(Params p) {
  using C = DkvCfg<DP>;
  constexpr int BQ = C::BQ, KEYS = C::KEYS, CW = C::CW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - raw);
  const uint32_t ks = base, vs = ks + C::kv_bytes, stage0 = vs + C::kv_bytes;

  const int bh = head_of_block();
  if (bh >= p.n_bh) return;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const __nv_bfloat16* qb = p.q + b * p.st[0] + h * p.st[1];
  const __nv_bfloat16* kb = p.k + b * p.st[3] + h * p.st[4];
  const __nv_bfloat16* vb = p.v + b * p.st[6] + h * p.st[7];
  const __nv_bfloat16* dob = p.dout + b * p.st[9] + h * p.st[10];
  const float* lse = p.lse + static_cast<long long>(bh) * p.s_q;
  const float* delta = p.delta + static_cast<long long>(bh) * p.s_q;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int kg = C::NSPLIT == 1 ? wg : 0;   // which 64 keys of the block
  const int ch = C::NSPLIT == 1 ? 0 : wg;   // which CW columns of dK/dV
  const int j0 = blockIdx.x * KEYS;
  const int key0 = j0 + kg * 64 + 16 * warp + (lane >> 2);   // and key0 + 8
  const int off = p.s_k - p.s_q;
  const float scale2 = p.scale * kLog2e;
  const float inv_sk = 1.f / static_cast<float>(p.s_k);

  // Query tiles this block walks: all of them, or, causal, the leading ones
  // that hold a row seeing no key (its P reaches every key) and then those
  // from the first that sees one of the block's keys.
  const int n_tiles = (p.s_q + BQ - 1) / BQ;
  int n_blind = 0, t_first = 0;
  if (p.causal) {
    if (off < 0) n_blind = min(n_tiles, (-off + BQ - 1) / BQ);
    t_first = min(n_tiles, max(n_blind, j0 - off <= 0 ? 0 : (j0 - off) / BQ));
  }
  const int n_iter = n_blind + n_tiles - t_first;
  auto tile_of = [&](int it) { return it < n_blind ? it : it - n_blind + t_first; };

  auto load_stage = [&](int it) {
    const int r0 = tile_of(it) * BQ;
    const uint32_t st = stage0 + (it & 1) * C::stage_bytes;
    load_rows<BQ, DP, 256>(st, qb, p.st[2], r0, p.s_q, p.d, tid);
    load_rows<BQ, DP, 256>(st + C::q_bytes, dob, p.st[11], r0, p.s_q, p.d, tid);
    if (tid < 2 * BQ) {
      const int r = tid < BQ ? tid : tid - BQ;
      const bool in = r0 + r < p.s_q;
      const float* src = (tid < BQ ? lse : delta) + (in ? r0 + r : 0);
      cp_async4(st + 2 * C::q_bytes + 4 * tid, src, in ? 4 : 0);
    }
  };

  load_rows<KEYS, DP, 256>(ks, kb, p.st[5], j0, p.s_k, p.d, tid);
  load_rows<KEYS, DP, 256>(vs, vb, p.st[8], j0, p.s_k, p.d, tid);
  if (n_iter > 0) load_stage(0);
  cp_async_commit();

  float dk[CW / 2], dv[CW / 2];
#pragma unroll
  for (int i = 0; i < CW / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    if (it + 1 < n_iter) {
      load_stage(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_proxy();
    __syncthreads();

    const int r0 = tile_of(it) * BQ;
    const uint32_t st = stage0 + (it & 1) * C::stage_bytes;
    const float* lse_s =
        reinterpret_cast<const float*>(base_ptr + (st - base) + 2 * C::q_bytes);
    const float* delta_s = lse_s + BQ;

    // S^T = K Q^T, then dP^T = V dO^T: 64 keys x BQ queries
    float s[BQ / 2], dp[BQ / 2];
    wgmma_fence();
    product_ss<DP, KEYS, BQ>(s, ks + kg * 8192, st);
    wgmma_commit();
    product_ss<DP, KEYS, BQ>(dp, vs + kg * 8192, st + C::q_bytes);
    wgmma_commit();

    const bool full = r0 + BQ <= p.s_q && j0 + KEYS <= p.s_k &&
                      (!p.causal || j0 + KEYS - 1 <= r0 + off);
    const uint32_t dos_b = st + C::q_bytes + ch * (CW / 64) * (BQ * 128);
    const uint32_t qs_b = st + ch * (CW / 64) * (BQ * 128);
    constexpr int NKK = BQ / 32;   // k-steps per half of the queries

    // s <- P^T, while dP^T is still being formed
    wgmma_wait<1>();
    fence_acc(s);
    if (full)
      dkv_probs<false, BQ>(s, lse_s, scale2, inv_sk, key0, r0, lane, off, p.s_q, p.s_k, p.causal);
    else
      dkv_probs<true, BQ>(s, lse_s, scale2, inv_sk, key0, r0, lane, off, p.s_q, p.s_k, p.causal);
    fence_acc(s);   // P^T is formed before the wait for dP^T
    wgmma_wait<0>();
    fence_acc(dp);

    // dV += P^T dO, dK += dS^T Q over this warpgroup's CW columns: the first
    // half of the queries, then the second, whose dS^T is formed while the
    // first half's products run
    uint32_t pa0[BQ / 8], da0[BQ / 8], pa1[BQ / 8], da1[BQ / 8];
    if (full)
      dkv_grads<false, 0, BQ>(s, dp, delta_s, p.scale, r0, lane, off, p.causal, pa0, da0);
    else
      dkv_grads<true, 0, BQ>(s, dp, delta_s, p.scale, r0, lane, off, p.causal, pa0, da0);
    fence_acc(dk);
    fence_acc(dv);
    wgmma_fence();
    product_rs<BQ, CW, 0, NKK>(dv, pa0, dos_b);
    product_rs<BQ, CW, 0, NKK>(dk, da0, qs_b);
    wgmma_commit();
    fence_acc(s);   // the second half is formed after the first half's products are started
    fence_acc(dp);
    if (full)
      dkv_grads<false, 1, BQ>(s, dp, delta_s, p.scale, r0, lane, off, p.causal, pa1, da1);
    else
      dkv_grads<true, 1, BQ>(s, dp, delta_s, p.scale, r0, lane, off, p.causal, pa1, da1);
    wgmma_fence();
    product_rs<BQ, CW, NKK, NKK>(dv, pa1, dos_b);
    product_rs<BQ, CW, NKK, NKK>(dk, da1, qs_b);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dk);
    fence_acc(dv);
    __syncthreads();   // the stage may be refilled
  }
  cp_async_wait<0>();

  __nv_bfloat16* dkb = p.g0 + b * p.st[12] + h * p.st[13];
  __nv_bfloat16* dvb = p.g1 + b * p.st[15] + h * p.st[16];
#pragma unroll
  for (int i = 0; i < CW / 2; i += 2) {
    const int key = key0 + 8 * ((i >> 1) & 1);
    const int c = ch * CW + 8 * (i >> 2) + 2 * (lane & 3);
    if (key < p.s_k && c < p.d) {
      *reinterpret_cast<uint32_t*>(dkb + key * p.st[14] + c) = pack_bf16(dk[i], dk[i + 1]);
      *reinterpret_cast<uint32_t*>(dvb + key * p.st[17] + c) = pack_bf16(dv[i], dv[i + 1]);
    }
  }
}

// -------------------------------------------------------------------- K5: dQ

template <int DP> struct DqCfg {
  static constexpr int NWG = DP == 256 ? 1 : 2;      // warpgroups, 64 queries each
  static constexpr int BQ = 64 * NWG;                // query rows per block
  static constexpr int BK = DP == 64 ? 128 : 64;     // keys per tile
  static constexpr int NI = DP == 64 ? 64 : 128;     // columns of dQ per product
  static constexpr int threads = 128 * NWG;
  static constexpr int q_bytes = BQ * DP * 2;
  static constexpr int kv_bytes = BK * DP * 2;
  static constexpr int smem_bytes = 2 * q_bytes + 4 * kv_bytes + 1024;
};

template <int DP>
__global__ void __launch_bounds__(DqCfg<DP>::threads, 1) flash_bwd_dq_sm90_kernel(Params p) {
  using C = DqCfg<DP>;
  constexpr int BQ = C::BQ, BK = C::BK, NI = C::NI, NT = C::threads;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t qs = base, dos = qs + C::q_bytes, stage0 = dos + C::q_bytes;

  const int bh = head_of_block();
  if (bh >= p.n_bh) return;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const __nv_bfloat16* qb = p.q + b * p.st[0] + h * p.st[1];
  const __nv_bfloat16* kb = p.k + b * p.st[3] + h * p.st[4];
  const __nv_bfloat16* vb = p.v + b * p.st[6] + h * p.st[7];
  const __nv_bfloat16* dob = p.dout + b * p.st[9] + h * p.st[10];
  const float* lse = p.lse + static_cast<long long>(bh) * p.s_q;
  const float* delta = p.delta + static_cast<long long>(bh) * p.s_q;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = blockIdx.x * BQ;
  const int row0 = r0 + wg * 64 + 16 * warp + (lane >> 2);   // and row0 + 8
  const int off = p.s_k - p.s_q;
  const float scale2 = p.scale * kLog2e;

  // Causal: key tiles past the block's last visible key add nothing (rows
  // that see no key get dQ = 0).
  int n_iter = (p.s_k + BK - 1) / BK;
  if (p.causal) {
    const int last = min(p.s_k - 1, r0 + BQ - 1 + off);
    n_iter = last < 0 ? 0 : last / BK + 1;
  }

  auto load_stage = [&](int it) {
    const uint32_t st = stage0 + (it & 1) * (2 * C::kv_bytes);
    load_rows<BK, DP, NT>(st, kb, p.st[5], it * BK, p.s_k, p.d, tid);
    load_rows<BK, DP, NT>(st + C::kv_bytes, vb, p.st[8], it * BK, p.s_k, p.d, tid);
  };

  load_rows<BQ, DP, NT>(qs, qb, p.st[2], r0, p.s_q, p.d, tid);
  load_rows<BQ, DP, NT>(dos, dob, p.st[11], r0, p.s_q, p.d, tid);
  if (n_iter > 0) load_stage(0);
  cp_async_commit();

  float lse2[2], dsc[2];   // lse log2(e) and Delta scale of rows row0, row0 + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row0 + 8 * i < p.s_q;
    lse2[i] = in ? lse[row0 + 8 * i] * kLog2e : 0.f;
    dsc[i] = in ? delta[row0 + 8 * i] * p.scale : 0.f;
  }

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    if (it + 1 < n_iter) {
      load_stage(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_proxy();
    __syncthreads();

    const int j0 = it * BK;
    const uint32_t st = stage0 + (it & 1) * (2 * C::kv_bytes);

    // S = Q K^T, then dP = dO V^T: 64 queries x BK keys
    float s[BK / 2], dp[BK / 2];
    wgmma_fence();
    product_ss<DP, BQ, BK>(s, qs + wg * 8192, st);
    wgmma_commit();
    product_ss<DP, BQ, BK>(dp, dos + wg * 8192, st + C::kv_bytes);
    wgmma_commit();

    const bool full = r0 + BQ <= p.s_q && j0 + BK <= p.s_k &&
                      (!p.causal || j0 + BK - 1 <= r0 + off);

    // s <- P, while dP is still being formed
    wgmma_wait<1>();
    fence_acc(s);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = ex2(fmaf(s[i], scale2, -lse2[(i >> 1) & 1]));
    fence_acc(s);   // P is formed before the wait for dP
    wgmma_wait<0>();
    fence_acc(dp);

    // the first half of the keys, then the second, whose dS is formed while
    // the first half's products run
    uint32_t da0[BK / 8], da1[BK / 8];
    if (full)
      dq_grads<false, 0, BK>(s, dp, dsc, p.scale, j0, row0, lane, off, p.s_q, p.s_k, p.causal, da0);
    else
      dq_grads<true, 0, BK>(s, dp, dsc, p.scale, j0, row0, lane, off, p.s_q, p.s_k, p.causal, da0);
    fence_acc(dq);
    wgmma_fence();
    dq_accumulate<DP, NI, BK, 0>(dq, da0, st);
    wgmma_commit();
    fence_acc(s);   // the second half is formed after the first half's products are started
    fence_acc(dp);
    if (full)
      dq_grads<false, 1, BK>(s, dp, dsc, p.scale, j0, row0, lane, off, p.s_q, p.s_k, p.causal, da1);
    else
      dq_grads<true, 1, BK>(s, dp, dsc, p.scale, j0, row0, lane, off, p.s_q, p.s_k, p.causal, da1);
    wgmma_fence();
    dq_accumulate<DP, NI, BK, BK / 32>(dq, da1, st);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dq);
    __syncthreads();   // the stage may be refilled
  }
  cp_async_wait<0>();

  __nv_bfloat16* dqb = p.g0 + b * p.st[12] + h * p.st[13];
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int row = row0 + 8 * ((i >> 1) & 1);
    const int c = 8 * (i >> 2) + 2 * (lane & 3);
    if (row < p.s_q && c < p.d)
      *reinterpret_cast<uint32_t*>(dqb + row * p.st[14] + c) = pack_bf16(dq[i], dq[i + 1]);
  }
}

template <int DP> int launch_dp(bool dkv, const Params& p, cudaStream_t stream) {
  const int smem = dkv ? DkvCfg<DP>::smem_bytes : DqCfg<DP>::smem_bytes;
  auto kernel = dkv ? flash_bwd_dkv_sm90_kernel<DP> : flash_bwd_dq_sm90_kernel<DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = dkv ? p.s_k : p.s_q;
  const int tile = dkv ? DkvCfg<DP>::KEYS : DqCfg<DP>::BQ;
  kernel<<<tile_head_grid((rows + tile - 1) / tile, p.n_bh), dkv ? 256 : DqCfg<DP>::threads, smem,
           stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch(bool dkv, const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* g0, void* g1, int batch, int heads,
           int s_q, int s_k, int d, const long long* strides, float scale, int causal,
           void* stream) {
  if (batch <= 0 || heads <= 0 || s_q <= 0 || s_k <= 0 || d <= 0 || d > 256 || d % 8 ||
      static_cast<long long>(batch) * heads > kMaxHeads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) && aligned16(g0) &&
        (g1 == nullptr || aligned16(g1))))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.g0 = static_cast<__nv_bfloat16*>(g0);
  p.g1 = static_cast<__nv_bfloat16*>(g1);
  p.n_bh = batch * heads; p.heads = heads; p.s_q = s_q; p.s_k = s_k; p.d = d;
  for (int i = 0; i < (dkv ? 18 : 15); ++i) {
    if (strides[i] % 8) return static_cast<int>(cudaErrorMisalignedAddress);
    p.st[i] = strides[i];
  }
  p.scale = scale;
  p.causal = causal;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_dp<64>(dkv, p, cs);
  if (d <= 128) return launch_dp<128>(dkv, p, cs);
  return launch_dp<256>(dkv, p, cs);
}

}  // namespace

// The interface of flash_bwd.cu's entry points, for bf16 q, k, v, dout whose
// base addresses are multiples of 16 bytes and whose strides and d are
// multiples of 8 elements (anything else returns an error and launches
// nothing). Each returns cudaGetLastError() after the launch.
extern "C" int lvg_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, int batch, int heads, int s_q,
                                      int s_k, int d, const long long* strides, float scale,
                                      int causal, void* stream) {
  return launch(true, q, k, v, dout, lse, delta, dk, dv, batch, heads, s_q, s_k, d, strides,
                scale, causal, stream);
}

extern "C" int lvg_flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, int batch, int heads, int s_q, int s_k, int d,
                                     const long long* strides, float scale, int causal,
                                     void* stream) {
  return launch(false, q, k, v, dout, lse, delta, dq, nullptr, batch, heads, s_q, s_k, d,
                strides, scale, causal, stream);
}
