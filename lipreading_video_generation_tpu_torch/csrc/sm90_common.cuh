// What the tensor-core kernels of flash_fwd_sm90.cu (K3) and
// flash_bwd_sm90.cu (K4, K5) share: 16-byte asynchronous copies into
// 128-byte-swizzled shared-memory tiles, the shared-memory matrix descriptor,
// wgmma.mma_async m64n64k16 / m64n128k16 (bf16 -> float32) with A from shared
// memory or from registers, its fences, and the tile-level products built
// from them.
//
// A tile of ROWS rows and DP columns of bf16 lies in shared memory as DP / 64
// blocks of 64 columns; in a block each row is 128 bytes and 16-byte chunk c
// of row r sits at chunk c ^ (r & 7): the 128-byte swizzle that wgmma
// descriptors read without bank conflicts. A tile starts at a multiple of
// 1024 bytes. One such tile serves as a K-major operand (its columns are
// contracted) and as an MN-major B operand (its rows are contracted).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lvg_sm90 {
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; the bytes past src_bytes
// are written as zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Shared-memory writes of this thread become visible to the async proxy,
// through which wgmma reads its operands.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Returns once at most N of the committed groups are still in flight.
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving uses of an accumulator across the
// asynchronous products' start or wait.
template <int N> __device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. K-major operand: rows
// of 128 bytes, sbo = 1024 between 8-row groups (lbo unused). MN-major B
// operand: the same tile with its rows as K; sbo = 1024 between 8-row
// groups, lbo = the distance between 64-column blocks.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// The descriptor of the matrix `bytes` past the one desc describes, in the
// same shared-memory window (the address field cannot carry out of its 14
// bits there).
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, uint32_t bytes) {
  return (desc & 0xFFFFFFFF00000000ull) | (static_cast<uint32_t>(desc) + (bytes >> 4));
}

#define LVG_R32                                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define LVG_R64                                                                         \
  LVG_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "    \
          "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "      \
          "%60, %61, %62, %63"
#define LVG_ACC8(d, o)                                                                  \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),           \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define LVG_ACC32(d, o) LVG_ACC8(d, o), LVG_ACC8(d, o + 8), LVG_ACC8(d, o + 16), LVG_ACC8(d, o + 24)

// D (64 x N, float32) = A B + (acc ? D : 0), A (64 x 16) and B (N x 16) both
// K-major bf16 tiles in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" LVG_R32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : LVG_ACC32(d, 0)
      : "l"(a), "l"(b), "r"(acc));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" LVG_R64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : LVG_ACC32(d, 0), LVG_ACC32(d, 32)
      : "l"(a), "l"(b), "r"(acc));
}
// D (64 x N) += A B, A (64 x 16) from registers in the accumulator's
// fragment layout, B (16 x N) an MN-major bf16 tile in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" LVG_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : LVG_ACC32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" LVG_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : LVG_ACC32(d, 0), LVG_ACC32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Rows [r0, r0 + ROWS) of a (row, column) bf16 matrix at g (row stride ss
// elements, d columns, d % 8 == 0) into a swizzled tile of DP / 64 column
// blocks at dst; zeros past n_rows and past d. Thread tid of NT copies the
// same 16-byte chunk of every (NT / chunks per row)-th row.
template <int ROWS, int DP, int NT>
__device__ __forceinline__ void load_rows(uint32_t dst, const __nv_bfloat16* g, long long ss,
                                          int r0, int n_rows, int d, int tid) {
  constexpr int CPR = DP / 8;      // 16-byte chunks per row
  constexpr int STEP = NT / CPR;   // rows between two copies of a thread
  static_assert(NT % CPR == 0 && ROWS % STEP == 0, "tile does not divide over the threads");
  const int cf = tid % CPR, rb = tid / CPR;
  const bool col_in = cf * 8 < d;
  const __nv_bfloat16* src = g + (r0 + rb) * ss + cf * 8;
  const uint32_t dst_col = dst + (cf >> 3) * (ROWS * 128);
#pragma unroll
  for (int i = 0; i < ROWS / STEP; ++i) {
    const int r = rb + i * STEP;
    const bool in = col_in && r0 + r < n_rows;
    cp_async16(dst_col + r * 128 + (((cf & 7) ^ (r & 7)) << 4), in ? src + i * STEP * ss : g,
               in ? 16 : 0);
  }
}

// load_rows for a thread that walks a matrix tile after tile (tile t is rows
// [t ROWS, (t + 1) ROWS)), in the order it is asked: the thread's addresses
// are formed once and advanced by additions, and a thread whose rows of the
// tile all exist copies them without a test, so that a tile costs a few
// instructions beside its copies.
template <int ROWS, int DP, int NT> struct RowLoader {
  static constexpr int CPR = DP / 8, STEP = NT / CPR, N = ROWS / STEP;
  // STEP % 4 == 0: row r + i STEP then has the swizzle of row r with bit 2
  // flipped for odd i STEP / 4
  static_assert(NT % CPR == 0 && ROWS % STEP == 0 && STEP % 4 == 0,
                "tile does not divide over the threads");
  const __nv_bfloat16* g;     // a valid address for the copies of no byte
  const __nv_bfloat16* src;   // this thread's chunk of its first row of the next tile
  long long row_step, tile_step;   // STEP and ROWS rows, in elements
  uint32_t off;               // of that chunk in a tile
  int row, n_rows;            // that row; rows of the matrix
  bool col_in;

  __device__ __forceinline__ RowLoader(const __nv_bfloat16* base, long long ss, int rows, int d,
                                       int tid) {
    const int cf = tid % CPR, rb = tid / CPR;
    g = base;
    src = base + rb * ss + cf * 8;
    row_step = STEP * ss;
    tile_step = ROWS * ss;
    off = (cf >> 3) * (ROWS * 128) + rb * 128 + (((cf & 7) ^ (rb & 7)) << 4);
    row = rb;
    n_rows = rows;
    col_in = cf * 8 < d;
  }

  // Starts the copies of the next tile into the swizzled tile at dst.
  __device__ __forceinline__ void next(uint32_t dst) {
    const uint32_t a = dst + off;
    if (col_in && row + (N - 1) * STEP < n_rows) {
      const __nv_bfloat16* p = src;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        cp_async16((a + i * STEP * 128) ^ (((i * STEP) & 7) << 4), p, 16);
        p += row_step;
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const bool in = col_in && row + i * STEP < n_rows;
        cp_async16((a + i * STEP * 128) ^ (((i * STEP) & 7) << 4), in ? src + i * row_step : g,
                   in ? 16 : 0);
      }
    }
    src += tile_step;
    row += ROWS;
  }
};

// D = A B^T over the DP columns of two K-major tiles: A 64 rows at a (tile
// of ROWS_A rows), B N rows at b.
template <int DP, int ROWS_A, int N>
__device__ __forceinline__ void product_ss(float (&d)[N / 2], uint32_t a, uint32_t b) {
  const uint64_t da = make_desc(a, 16, 1024), db = make_desc(b, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t step = (kk & 3) * 32;
    wgmma_ss(d, desc_at(da, (kk >> 2) * (ROWS_A * 128) + step),
             desc_at(db, (kk >> 2) * (N * 128) + step), kk > 0);
  }
}

// D (64 x N) += A B over rows [16 KK0, 16 (KK0 + NKK)) of a swizzled tile of
// ROWS rows starting at b (its ROWS x N part): A (64 x 16 NKK) packed bf16
// fragments.
template <int ROWS, int N, int KK0, int NKK>
__device__ __forceinline__ void product_rs(float (&d)[N / 2], const uint32_t (&a)[4 * NKK],
                                           uint32_t b) {
  const uint64_t db = make_desc(b, ROWS * 128, 1024);
#pragma unroll
  for (int kk = 0; kk < NKK; ++kk) wgmma_rs(d, a + 4 * kk, desc_at(db, (KK0 + kk) * 2048));
}

// Keeps packed A fragments alive, and in their registers, until the products
// that read them asynchronously have been waited for.
template <int N> __device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// The grid of a kernel whose blocks are (tile, batch * head) pairs: the tile
// on x, batch * head split over y and z (65,535 each at most), y running
// faster, so that blocks start in the order of one folded index. The kernel
// reads its pair through head_of_block; in the last z slice that may pass
// n_bh, and such a block returns at once. (With both folded onto blockIdx.x
// the compiler's code for K4 and K5 takes more registers and more time.)
constexpr long long kMaxHeads = 0x7fffffffLL;
inline dim3 tile_head_grid(int tiles, long long n_bh) {
  const long long gz = (n_bh + 65534) / 65535, gy = (n_bh + gz - 1) / gz;
  return dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(gy), static_cast<unsigned>(gz));
}
__device__ __forceinline__ int head_of_block() { return blockIdx.z * gridDim.y + blockIdx.y; }

}  // namespace lvg_sm90
