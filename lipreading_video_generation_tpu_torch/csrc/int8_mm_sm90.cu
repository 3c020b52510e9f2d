// K6 on Hopper's tensor cores: C(M,N) = A(M,K) . B(K,N), int8 x int8 -> int32
// (exact) and bf16 x bf16 -> float32 (the unrounded accumulator), for
// operands whose rows start on 16-byte boundaries: A with K contiguous, B with
// K contiguous (the (N,K) weight of int8 serving taken as its transpose) or,
// bf16 only, with N contiguous (a row-major (K,N) matrix).
//
// Replaces scripts/microbench_int8_pallas.py::mm_kernel (make_mm), for
// every layout: any other (element strides, odd row strides, unaligned or
// broadcast views, the TPU kernel's own row-major int8 B, since integer wgmma
// takes K-major operands only) is first copied to K-major rows by the pack of
// int8_mm.cu (ops/matmul_cuda.py's "packed" route). No shape needs padding;
// the sums are int32 / float32 and are formed in one fixed order, so two
// launches give the same bits.
//
// Bound: operations at the microbench's 4096^3; bytes at the serving shapes
// (M up to 1.2e6 rows against N <= 64 columns, or K of 16-32 bytes against an
// output of 128 bytes a row: A is read once and C written once). What the
// design does about each:
//   - Products are wgmma.mma_async m64nNk16 (bf16) / m64nNk32 (int8) on
//     128-byte-swizzled tiles in shared memory, read through descriptors. A
//     swizzled row holds 128 bytes of K: 64 bf16 or 128 int8 values, four
//     instructions either way, so one body serves both type pairs: it counts
//     K in bytes and the tensor maps describe both operands as bytes. A
//     row-major bf16 B is the MN-major operand of the same tile layout
//     (transpose bit; LBO = the distance between 64-column blocks, SBO =
//     1024).
//   - Loads are TMA (cp.async.bulk.tensor with the 128-byte swizzle): a
//     producer warpgroup, of which one thread works, keeps a ring of four
//     stages of (A tile, B tile) full; two consumer warpgroups, 64 rows of a
//     128-row tile of C each, both reading one B tile, multiply what has
//     arrived. A stage has a "full" mbarrier (the copies' bytes) and an
//     "empty" one (one arrival a consumer warp, once the products that read
//     the stage have been waited for), so no thread meets another at a
//     __syncthreads and the products of steps t and t - 1 are in flight
//     while the copies of the steps after them land. Rows, columns and depth
//     past the matrices are zeros: the tensor map fills what lies outside. A
//     first version filled the same ring with 16-byte cp.async from all
//     threads; at 4096^3 its copies alone took as long as its products alone
//     and the two did not overlap (0.34 ms against 0.19 ms with TMA).
//   - setmaxnreg moves registers from the producer to the consumers at the
//     wide tiles (128 accumulator registers a thread at N = 256).
//   - The tile's width is chosen by the launcher from N: 8, 16, 32 or 64
//     columns where N is at most that (no product is spent on columns that do
//     not exist; two blocks an SM), else 256, 128 or 64, the widest that
//     still gives every SM a tile.
//   - A block is persistent: it walks tiles b, b + grid, b + 2 grid, ... and
//     the ring runs on across tile borders, so the copies of the next tile are
//     in flight while this one's accumulators are stored, and at small K (one
//     step a tile) the loads, not the start of blocks, set the pace. Tiles are
//     numbered in groups of 8 row tiles, row tile fastest, so that the blocks
//     running at one time share B columns and a few A rows in L2.
//   - Every wait on an mbarrier is bounded: a fault in the ring traps and
//     the launch returns an error instead of hanging the card.
//   - Where tiles are fewer than SMs and K is long (128 x 4608 x 512: eight
//     tiles of 64 columns) nothing more is done: no split of K; PERF.md has
//     its time. Multicast of the B tile over a cluster is not used either.
#include <cstdint>

#include <cuda.h>   // CUtensorMap and its enums; the encoder is looked up at run time

#include "sm90_common.cuh"
#include "sm90_wgmma_ss.cuh"

namespace {

using namespace lvg_sm90;

constexpr int kThreads = 384;     // a producer warpgroup and two consumer warpgroups
constexpr int kBM = 128;          // rows of C per tile
constexpr int kStages = 4;
constexpr int kGroupM = 8;        // row tiles per group of the tile order
constexpr int kMaxSpins = 1 << 22;   // tries of one mbarrier wait before the kernel traps
constexpr unsigned kFullMask = 0xffffffffu;

template <typename T> struct AccOf;
template <> struct AccOf<int8_t> { using type = int; };
template <> struct AccOf<__nv_bfloat16> { using type = float; };

struct Params {
  void* c;              // contiguous (m, n) of the accumulator type
  int m, n, kb;         // kb: bytes of K in a row of A (k or 2 k)
  int tiles_m, tiles_n, k_tiles;   // k_tiles = ceil(kb / 128)
};

template <int BN, int TB> struct Cfg {
  static constexpr int a_bytes = kBM * 128;
  // K-major: BN rows of 128 bytes; MN-major: 64 depths of BN columns as
  // BN / 64 blocks of 64 x 128 bytes (one block where BN < 64)
  static constexpr int b_boxes = TB ? (BN < 64 ? 1 : BN / 64) : 1;
  static constexpr int b_bytes = TB ? b_boxes * 8192 : BN * 128;
  static constexpr int stage_bytes = a_bytes + b_bytes;
  // stages (1024-byte aligned), then a full and an empty mbarrier a stage
  static constexpr int smem_bytes = kStages * stage_bytes + 1024 + 16 * kStages;
  // narrow tiles need few registers and little shared memory: two blocks an SM
  static constexpr int blocks_per_sm = BN <= 64 ? 2 : 1;
  static constexpr bool move_registers = BN > 64;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// One arrival, and `bytes` more that the copies into the stage will report.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Returns once the barrier has left the phase of the given parity; traps
// after kMaxSpins tries, so that a fault in the ring cannot hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (int spin = 0; spin < kMaxSpins; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}
// The box of `map` at (c0 along a row in bytes, row c1) into shared memory at
// dst; its bytes are reported to `bar`. What lies outside the matrix is zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

template <typename T, int BN, int TB>
__global__ void __launch_bounds__(kThreads, Cfg<BN, TB>::blocks_per_sm)
mm_sm90_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
               Params p) {
  using C = Cfg<BN, TB>;
  using Acc = typename AccOf<T>::type;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = base + kStages * C::stage_bytes, empty0 = full0 + 8 * kStages;

  const int tid = threadIdx.x;
  // through a shuffle: the same in every lane, so descriptors stay uniform
  const int wg = __shfl_sync(kFullMask, tid >> 7, 0), warp = (tid >> 5) & 3, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);    // the producer's arrival; the copies report bytes
      mbar_init(empty0 + 8 * s, 8);   // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();   // the only one: the roles part here and do not meet again

  const int n_tiles = p.tiles_m * p.tiles_n;
  const int my_tiles = (n_tiles - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                       static_cast<int>(gridDim.x);
  const int KT = p.k_tiles;
  const int n_items = my_tiles * KT;   // (tile, step) pairs, in the order they are multiplied

  // this block's j-th tile -> its first row and column
  auto origin = [&](int j, int& m0, int& n0) {
    const int t = blockIdx.x + j * gridDim.x;
    const int per_group = kGroupM * p.tiles_n;
    const int first = (t / per_group) * kGroupM;
    const int gm = min(kGroupM, p.tiles_m - first);
    const int local = t % per_group;
    m0 = (first + local % gm) * kBM;
    n0 = (local / gm) * BN;
  };

  if (wg == 0) {
    // producer: item i goes into stage i % kStages once the consumers have
    // released what was there (the empty barrier's phase i / kStages - 1; the
    // first round finds the stages free)
    if constexpr (C::move_registers) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int item = 0;
      for (int j = 0; j < my_tiles; ++j) {
        int m0, n0;
        origin(j, m0, n0);
        for (int kt = 0; kt < KT; ++kt, ++item) {
          const int s = item % kStages;
          mbar_wait(empty0 + 8 * s, ((item / kStages) & 1) ^ 1);
          const uint32_t st = base + s * C::stage_bytes, full = full0 + 8 * s;
          mbar_expect_tx(full, C::stage_bytes);
          tma_load(st, &map_a, full, kt * 128, m0);
          if constexpr (TB != 0) {
#pragma unroll
            for (int b = 0; b < C::b_boxes; ++b)
              tma_load(st + C::a_bytes + b * 8192, &map_b, full, (n0 + 64 * b) * 2, kt * 64);
          } else {
            tma_load(st + C::a_bytes, &map_b, full, kt * 128, n0);
          }
        }
      }
    }
    return;
  }

  // consumers
  if constexpr (C::move_registers) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;   // rows [64 cw, 64 cw + 64) of the tile
  Acc acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  int kt = 0, j = 0, m0, n0, released = 0;
  origin(0, m0, n0);
  // the products of the items below `upto` have been waited for: their stages are free
  auto release = [&](int upto) {
    for (; released < upto; ++released)
      if (lane == 0) mbar_arrive(empty0 + 8 * (released % kStages));
  };
  for (int it = 0; it < n_items; ++it) {
    mbar_wait(full0 + 8 * (it % kStages), (it / kStages) & 1);
    const uint32_t st = base + (it % kStages) * C::stage_bytes;
    const uint64_t da = make_desc(st + cw * (64 * 128), 16, 1024);
    const uint64_t db = TB ? make_desc(st + C::a_bytes, 64 * 128, 1024)
                           : make_desc(st + C::a_bytes, 16, 1024);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // depth past K is zeros in the tiles
      wgmma_tile<TB>(acc, desc_at(da, kk * 32), desc_at(db, TB ? kk * 2048 : kk * 32),
                     kt > 0 || kk > 0);
    wgmma_commit();
    if (kt < KT - 1) {
      wgmma_wait<1>();   // the products of item it - 1
      release(it);
      ++kt;
      continue;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    release(it + 1);

    // element i of acc: row 8 (i / 2 % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2
    Acc* cb = static_cast<Acc*>(p.c);
    const int row0 = m0 + cw * 64 + warp * 16 + (lane >> 2);
    const bool pairs = (p.n & 1) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= p.m) continue;
      Acc* out = cb + static_cast<long long>(row) * p.n + n0 + 2 * (lane & 3);
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
        const int col = n0 + 8 * jj + 2 * (lane & 3);
        const Acc x = acc[4 * jj + 2 * h], y = acc[4 * jj + 2 * h + 1];
        if (pairs) {
          if (col < p.n) {
            uint2 v;
            v.x = *reinterpret_cast<const uint32_t*>(&x);
            v.y = *reinterpret_cast<const uint32_t*>(&y);
            *reinterpret_cast<uint2*>(out + 8 * jj) = v;
          }
        } else {
          if (col < p.n) out[8 * jj] = x;
          if (col + 1 < p.n) out[8 * jj + 1] = y;
        }
      }
    }
    kt = 0;
    if (++j < my_tiles) origin(j, m0, n0);
  }
}

// cuTensorMapEncodeTiled of the installed libcuda, looked up through the
// runtime (the library is not linked against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The tensor map of a (rows, inner_bytes) matrix of bytes at ptr, `stride`
// bytes between rows, read in boxes of box_rows x 128 bytes with the 128-byte
// swizzle; what a box holds outside the matrix is zeros. 0, or a CUDA error.
int encode_map(CUtensorMap* map, const void* ptr, long long inner_bytes, long long rows,
               long long stride, int box_rows) {
  EncodeTiled encode = tensor_map_encoder();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner_bytes), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t box[2] = {128u, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1u, 1u};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
                             strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

struct Operands {
  const void *a, *b;
  long long sa, sb;   // bytes between rows of A; between columns (K-major) or depths of B
  int k;
};

template <typename T, int BN, int TB>
int launch_bn(Params p, const Operands& op, cudaStream_t stream) {
  using C = Cfg<BN, TB>;
  const long long tiles_n = (static_cast<long long>(p.n) + BN - 1) / BN;
  const long long tiles = p.tiles_m * tiles_n;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.tiles_n = static_cast<int>(tiles_n);
  CUtensorMap map_a, map_b;
  int rc = encode_map(&map_a, op.a, p.kb, p.m, op.sa, kBM);
  if (rc == 0)
    rc = TB ? encode_map(&map_b, op.b, 2LL * p.n, op.k, op.sb, 64)
            : encode_map(&map_b, op.b, p.kb, p.n, op.sb, BN);
  if (rc != 0) return rc;
  static bool sized = false;   // per instantiation; the attribute stays with the function
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(mm_sm90_kernel<T, BN, TB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           C::smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const long long slots = static_cast<long long>(sm_count()) * C::blocks_per_sm;
  const int grid = static_cast<int>(tiles < slots ? tiles : slots);
  mm_sm90_kernel<T, BN, TB><<<grid, kThreads, C::smem_bytes, stream>>>(map_a, map_b, p);
  return static_cast<int>(cudaGetLastError());
}

// The tile width: N itself rounded up to 8, 16, 32 or 64 where that covers
// it; else the widest of 256, 128, 64 that still gives every SM a tile (wider
// tiles read A and B fewer times), 64 where none does.
template <typename T, int TB>
int launch_tb(const Params& p, const Operands& op, cudaStream_t stream) {
  if constexpr (!TB) {
    if (p.n <= 8) return launch_bn<T, 8, TB>(p, op, stream);
    if (p.n <= 16) return launch_bn<T, 16, TB>(p, op, stream);
    if (p.n <= 32) return launch_bn<T, 32, TB>(p, op, stream);
  }
  if (p.n <= 64) return launch_bn<T, 64, TB>(p, op, stream);
  const long long sms = sm_count();
  auto tiles = [&](int bn) { return static_cast<long long>(p.tiles_m) * ((p.n + bn - 1) / bn); };
  if (p.n > 128 && tiles(256) >= sms) return launch_bn<T, 256, TB>(p, op, stream);
  if (tiles(128) >= sms) return launch_bn<T, 128, TB>(p, op, stream);
  return launch_bn<T, 64, TB>(p, op, stream);
}

template <typename T>
int launch(const void* a, const void* b, void* c, int m, int n, int k, long long sam,
           long long sbk, long long sbn, void* stream) {
  constexpr long long size = sizeof(T);
  if (m <= 0 || n <= 0 || k <= 0 || k > 0x7fffffff / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool k_major = sbk == 1;
  if (!k_major && !(sbn == 1 && size == 2)) return static_cast<int>(cudaErrorInvalidValue);
  Operands op{a, b, sam * size, (k_major ? sbn : sbk) * size, k};
  // a single row has no stride to speak of: give the tensor map a valid one
  const long long a_row = (k * size + 15) / 16 * 16;
  const long long b_row = k_major ? a_row : (n * size + 15) / 16 * 16;
  if (m == 1) op.sa = a_row;
  if ((k_major ? n : k) == 1) op.sb = b_row;
  if (!aligned16(a) || !aligned16(b) || op.sa % 16 || op.sb % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (op.sa < k * size || op.sb < (k_major ? k : n) * size)   // broadcast or overlapping rows
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.c = c;
  p.m = m;
  p.n = n;
  p.kb = static_cast<int>(k * size);
  p.tiles_m = (m + kBM - 1) / kBM;
  p.k_tiles = (p.kb + 127) / 128;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (k_major) return launch_tb<T, 0>(p, op, cs);
  if constexpr (size == 2) return launch_tb<T, 1>(p, op, cs);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// a: (m, k) int8, row stride sam elements, K contiguous; b: (k, n) int8 with
// element strides (sbk, sbn), sbk == 1 (K contiguous); every row start a
// multiple of 16 bytes, rows not overlapping; c: contiguous (m, n) int32; m,
// n, k >= 1. Anything
// else returns an error and launches nothing. Returns cudaGetLastError() after
// the launch.
extern "C" int lvg_mm_sm90_int8(const void* a, const void* b, void* c, int m, int n, int k,
                                long long sam, long long sbk, long long sbn, void* stream) {
  return launch<int8_t>(a, b, c, m, n, k, sam, sbk, sbn, stream);
}

// The same for bf16 operands and a contiguous float32 c; b may also have
// sbn == 1 (a row-major (k, n) matrix, N contiguous).
extern "C" int lvg_mm_sm90_bf16(const void* a, const void* b, void* c, int m, int n, int k,
                                long long sam, long long sbk, long long sbn, void* stream) {
  return launch<__nv_bfloat16>(a, b, c, m, n, k, sam, sbk, sbn, stream);
}
