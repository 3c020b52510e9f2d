// K2 on the tensor cores: small-sequence multi-head self-attention forward
// for bf16 q, k, v whose base addresses and (batch, row) strides are multiples
// of 16 bytes, with S <= 128 tokens and a head dim that is a multiple of 8 up
// to 128. One block per head at a time, one warp per strip of 16 query rows.
//
// Replaces lipreading_video_generation_tpu/ops/attention.py::
// _small_mha_kernel for those inputs; float32 (tensor cores would mean TF32),
// longer sequences, other head dims and unaligned views keep the CUDA-core
// kernel of small_mha.cu. Same function as there and as the plain version:
// float32 scores at 1/sqrt(d) (causal: keys j <= row only), the row softmax,
// P normalised and then rounded to bf16, P.V summed in float32, O in bf16.
//
// Bound: bytes. At the ViViT shape (S = 80, d = 32, 8 heads, batch 384) a
// head moves 20 KB for 1.6 MFLOP, so the kernel has to stream q, k, v once at
// the memory's rate with few instructions a byte. What the design does:
//   - mma.sync m16n8k16 (bf16 -> float32), not wgmma: the products are 80 x
//     80 x 32 and smaller, wgmma's 64-row instruction would pad five strips of
//     16 rows to two of 64, and its operands would need the swizzled layout.
//   - A block has one warp per strip of 16 query rows (five at S = 80) and
//     walks heads b, b + grid, b + 2 grid, ... (a head is a (batch element,
//     head) pair). Its threads copy the head's Q, K and V slices (row stride
//     given, so the column slices of a fused qkv projection need no copy) into
//     shared memory by 16-byte cp.async, as bf16, into one of two buffers:
//     the copies of the next head are in flight while this head is computed.
//     (One warp a head with one buffer took the sum of its copies' and its
//     arithmetic's time: warps that start together stay in step.) Two
//     __syncthreads a head. Several blocks share an SM; the grid is what the
//     SMs hold at once.
//   - Per strip of 16 query rows the whole score strip (16 x S_pad) stays in
//     registers: Q fragments by ldmatrix, K as the "col" operand by ldmatrix,
//     the mask (keys past S, and causally hidden ones, to -inf; key 0 is
//     visible to every row, so the row max is finite), row max, exp2 and row
//     sum among the four lanes that share a row (two shuffles each), P
//     normalised, rounded and packed in the accumulator layout, which is the
//     A fragment layout of P.V: no shared-memory round trip. V comes through
//     ldmatrix.trans. The strip is straight-line code: every tile is
//     multiplied, also those a causal mask hides, and only the tiles that can
//     hold a key past S are tested for it (a first version that skipped
//     hidden tiles spent most of its instructions on the branches around the
//     warp-wide loads and products).
//   - Shared rows are d_pad * 2 + 16 bytes apart, which spreads the eight
//     rows of an ldmatrix over all banks for every head dim.
//   - The O strip is rounded to bf16 into the strip's own (now dead) Q rows
//     and written from there as 16-byte vectors, whole head rows at a time.
// Compiled for S_pad in steps of 16 up to 128 and d_pad 32, 64, 128 (columns
// past d are zeros in shared memory).
#include <cmath>
#include <cstdint>

#include "sm90_common.cuh"

namespace {

using namespace lvg_sm90;

constexpr unsigned kFullMask = 0xffffffffu;

struct Params {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* o;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs;   // batch and row strides, elements
  int n_bh, heads, s, d;
  float scale2;      // softmax scale times log2(e)
  int causal;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of a block: two buffers of Q, K and V of a head, SP rows each.
template <int SP, int DP> struct Layout {
  static constexpr int threads = 2 * SP;           // a warp per 16 rows
  static constexpr int pitch = DP * 2 + 16;        // bytes between rows
  static constexpr int head_bytes = 3 * SP * pitch;
  static constexpr int smem_bytes = 2 * head_bytes;
};

// Rows [0, SP) x DP columns of one head's (row, column) slice at g (row
// stride rs elements) into shared memory at dst; zeros past s and past d.
// Thread tid copies 16-byte chunk tid % (DP / 8) of DP / 16 rows.
template <int SP, int DP>
__device__ __forceinline__ void load_slice(uint32_t dst, const __nv_bfloat16* g, long long rs,
                                           int s, int d, int tid) {
  constexpr int CPR = DP / 8;                              // chunks a row
  constexpr int STEP = Layout<SP, DP>::threads / CPR;      // rows between two copies of a thread
  static_assert(Layout<SP, DP>::threads % CPR == 0 && SP % STEP == 0, "rows do not divide");
  const int c = tid % CPR, r0 = tid / CPR;
  const bool col_in = c * 8 < d;
  const __nv_bfloat16* src = g + r0 * rs + c * 8;
  const uint32_t to = dst + r0 * Layout<SP, DP>::pitch + c * 16;
#pragma unroll
  for (int i = 0; i < SP / STEP; ++i) {
    const bool in = col_in && r0 + i * STEP < s;
    cp_async16(to + i * STEP * Layout<SP, DP>::pitch, in ? src + i * STEP * rs : g, in ? 16 : 0);
  }
}

// One strip of 16 query rows (r0 ..) of the head whose Q, K and V rows lie at
// q_rows: scores, softmax, P.V, and the strip of O written to ob (the head's
// (row, column) slice of the output, row stride e). Straight-line code: every
// tile of the strip is multiplied, also those a causal mask hides (the
// products are cheap, a branch around a warp-wide instruction is not).
template <int SP, int DP>
__device__ __forceinline__ void attend_strip(const Params& p, uint8_t* q_rows,
                                             __nv_bfloat16* ob, int e, int r0, int lane) {
  constexpr int P = Layout<SP, DP>::pitch;
  const uint32_t qs = smem_u32(q_rows), ks = qs + SP * P, vs = ks + SP * P;
  const int g = lane >> 2, t = lane & 3;

  // Q fragments of the strip: 16 rows x DP
  uint32_t qa[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    ldmatrix_x4(qa[kk], qs + (r0 + (lane & 15)) * P + kk * 32 + (lane >> 4) * 16);

  // scores: sc[nt][i] is row g + 8 (i / 2), key 8 nt + 2 t + i % 2
  float sc[SP / 8][4];
  const uint32_t k_lane = ks + (lane & 7) * P + (lane >> 3) * 16;
#pragma unroll
  for (int nt = 0; nt < SP / 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[nt][i] = 0.f;
#pragma unroll
    for (int kq = 0; kq < DP / 32; ++kq) {
      uint32_t kb[4];
      ldmatrix_x4(kb, k_lane + nt * 8 * P + kq * 64);
      mma_bf16(sc[nt], qa[2 * kq], kb[0], kb[1]);
      mma_bf16(sc[nt], qa[2 * kq + 1], kb[2], kb[3]);
    }
  }

  // keys past s (they can only be in the last two tiles: SP - s < 16) and,
  // causal, keys past the row get -inf
  if (p.causal) {
#pragma unroll
    for (int nt = 0; nt < SP / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = nt * 8 + 2 * t + (i & 1), row = r0 + g + 8 * (i >> 1);
        if (key >= p.s || key > row) sc[nt][i] = -INFINITY;
      }
  } else {
#pragma unroll
    for (int nt = SP / 8 - 2; nt < SP / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (nt * 8 + 2 * t + (i & 1) >= p.s) sc[nt][i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < SP / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], sc[nt][i]);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(kFullMask, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(kFullMask, mx[hh], 2));
    mx[hh] *= p.scale2;   // finite: key 0 is real and visible to every row
  }
#pragma unroll
  for (int nt = 0; nt < SP / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sc[nt][i] = ex2(fmaf(sc[nt][i], p.scale2, -mx[i >> 1]));
      sum[i >> 1] += sc[nt][i];
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    sum[hh] += __shfl_xor_sync(kFullMask, sum[hh], 1);
    sum[hh] += __shfl_xor_sync(kFullMask, sum[hh], 2);
    sum[hh] = 1.f / sum[hh];
  }

  // P normalised, rounded to bf16, as the A fragments of P.V
  uint32_t pa[SP / 16][4];
#pragma unroll
  for (int kk = 0; kk < SP / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[2 * kk][0] * sum[0], sc[2 * kk][1] * sum[0]);
    pa[kk][1] = pack_bf16(sc[2 * kk][2] * sum[1], sc[2 * kk][3] * sum[1]);
    pa[kk][2] = pack_bf16(sc[2 * kk + 1][0] * sum[0], sc[2 * kk + 1][1] * sum[0]);
    pa[kk][3] = pack_bf16(sc[2 * kk + 1][2] * sum[1], sc[2 * kk + 1][3] * sum[1]);
  }

  // O strip: o[dn][i] is row g + 8 (i / 2), column 8 dn + 2 t + i % 2
  float o[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dn][i] = 0.f;
  const uint32_t v_lane = vs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * P + (lane >> 4) * 16;
#pragma unroll
  for (int kk = 0; kk < SP / 16; ++kk) {
#pragma unroll
    for (int dq = 0; dq < DP / 16; ++dq) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, v_lane + kk * 16 * P + dq * 32);
      mma_bf16(o[2 * dq], pa[kk], vb[0], vb[1]);
      mma_bf16(o[2 * dq + 1], pa[kk], vb[2], vb[3]);
    }
  }

  // through the strip's Q rows (every lane has read its Q fragments), out
  // as 16-byte vectors: lane l writes chunk l % (DP / 8) of rows l / (DP / 8) ...
  __syncwarp();
  uint8_t* row_g = q_rows + (r0 + g) * P + t * 4;
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) {
    *reinterpret_cast<uint32_t*>(row_g + dn * 16) = pack_bf16(o[dn][0], o[dn][1]);
    *reinterpret_cast<uint32_t*>(row_g + dn * 16 + 8 * P) = pack_bf16(o[dn][2], o[dn][3]);
  }
  __syncwarp();
  constexpr int CPR = DP / 8, ROWS = 32 / CPR;   // chunks a row; rows a pass of the warp
  const int c = lane % CPR, rl = lane / CPR;
  if (c * 8 < p.d) {
#pragma unroll
    for (int i = 0; i < 16 / ROWS; ++i) {
      const int r = r0 + rl + i * ROWS;
      if (r < p.s)
        *reinterpret_cast<uint4*>(ob + static_cast<long long>(r) * e + c * 8) =
            *reinterpret_cast<const uint4*>(q_rows + r * P + c * 16);
    }
  }
}

template <int SP, int DP>
__global__ void __launch_bounds__(Layout<SP, DP>::threads)
small_mha_sm90_kernel(Params p) {
  using L = Layout<SP, DP>;
  constexpr int P = L::pitch;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int e = p.heads * p.d;

  auto load_head = [&](int b, int h, int buf) {
    const uint32_t dst = smem_u32(smem_raw) + buf * L::head_bytes;
    load_slice<SP, DP>(dst, p.q + b * p.q_bs + h * p.d, p.q_rs, p.s, p.d, tid);
    load_slice<SP, DP>(dst + SP * P, p.k + b * p.k_bs + h * p.d, p.k_rs, p.s, p.d, tid);
    load_slice<SP, DP>(dst + 2 * SP * P, p.v + b * p.v_bs + h * p.d, p.v_rs, p.s, p.d, tid);
  };

  int task = blockIdx.x;           // the grid is no larger than n_bh
  int b = task / p.heads, h = task - b * p.heads;
  load_head(b, h, 0);
  cp_async_commit();
  for (int it = 0; task < p.n_bh; ++it) {
    const int next = task + gridDim.x;
    const int nb = next / p.heads, nh = next - nb * p.heads;
    if (next < p.n_bh) load_head(nb, nh, (it + 1) & 1);   // free since the barrier that ended it - 1
    cp_async_commit();
    cp_async_wait<1>();   // this thread's copies of this head
    __syncthreads();      // every thread's

    uint8_t* q_rows = smem_raw + (it & 1) * L::head_bytes;
    __nv_bfloat16* ob = p.o + (static_cast<long long>(b) * p.s) * e + h * p.d;
    attend_strip<SP, DP>(p, q_rows, ob, e, 16 * warp, lane);
    __syncthreads();   // every warp is done with this buffer: the next head but one may land
    task = next;
    b = nb;
    h = nh;
  }
  cp_async_wait<0>();
}

template <int SP, int DP> int launch_sd(const Params& p, cudaStream_t stream) {
  using L = Layout<SP, DP>;
  static bool sized = false;   // per instantiation; the attribute stays with the function
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(small_mha_sm90_kernel<SP, DP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           L::smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  // as many blocks as the SMs hold at once (registers, shared memory, threads): a block
  // that had to wait for a place would start its walk late
  static int per_sm = 0;
  if (per_sm == 0) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, small_mha_sm90_kernel<SP, DP>,
                                                      L::threads, L::smem_bytes) != cudaSuccess ||
        per_sm < 1)
      per_sm = 1;
  }
  const long long slots = static_cast<long long>(sm_count()) * per_sm;
  const unsigned grid = static_cast<unsigned>(p.n_bh < slots ? p.n_bh : slots);
  small_mha_sm90_kernel<SP, DP><<<grid, L::threads, L::smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DP> int launch_d(const Params& p, cudaStream_t stream) {
  switch ((p.s + 15) / 16) {
    case 1: return launch_sd<16, DP>(p, stream);
    case 2: return launch_sd<32, DP>(p, stream);
    case 3: return launch_sd<48, DP>(p, stream);
    case 4: return launch_sd<64, DP>(p, stream);
    case 5: return launch_sd<80, DP>(p, stream);
    case 6: return launch_sd<96, DP>(p, stream);
    case 7: return launch_sd<112, DP>(p, stream);
    default: return launch_sd<128, DP>(p, stream);
  }
}

}  // namespace

// q, k, v: (batch, s, heads*d) bf16 with unit column stride and the given
// batch and row strides (elements, multiples of 8), base addresses multiples
// of 16 bytes, 1 <= s <= 128, d a multiple of 8 up to 128; o: contiguous
// (batch, s, heads*d) bf16. scale is the softmax scale (1/sqrt(d), > 0).
// Anything else returns an error and launches nothing. Returns
// cudaGetLastError() after the launch.
extern "C" int lvg_small_mha_sm90(const void* q, const void* k, const void* v, void* o,
                                  int batch, long long q_bs, long long q_rs, long long k_bs,
                                  long long k_rs, long long v_bs, long long v_rs, int s,
                                  int heads, int d, float scale, int causal, void* stream) {
  if (batch <= 0 || heads <= 0 || s <= 0 || s > 128 || d <= 0 || d > 128 || d % 8 ||
      !(scale > 0.f) || static_cast<long long>(batch) * heads > 0x7fff0000LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o)) || q_bs % 8 || q_rs % 8 ||
      k_bs % 8 || k_rs % 8 || v_bs % 8 || v_rs % 8)
    return static_cast<int>(cudaErrorMisalignedAddress);
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.q_bs = q_bs; p.q_rs = q_rs; p.k_bs = k_bs; p.k_rs = k_rs; p.v_bs = v_bs; p.v_rs = v_rs;
  p.n_bh = batch * heads; p.heads = heads; p.s = s; p.d = d;
  p.scale2 = scale * kLog2e;
  p.causal = causal;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (d <= 32) return launch_d<32>(p, cs);
  if (d <= 64) return launch_d<64>(p, cs);
  return launch_d<128>(p, cs);
}
