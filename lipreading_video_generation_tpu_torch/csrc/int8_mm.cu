// K6: tiled matrix product C(M,N) = A(M,K) . B(K,N), int8 x int8 -> int32 and
// bf16 x bf16 -> float32, for any M, N, K and any element strides of A and B.
//
// Replaces scripts/microbench_int8_pallas.py::mm_kernel (make_mm). The TPU
// kernel walks a grid (M/512, N/512, K/512) in order and accumulates over the
// k axis through its output block; that is Mosaic's pipeline. Here blocks run
// in parallel, so a block owns one 128 x 64 tile of C, loops over K itself
// and keeps the int32 / float32 sums in registers until the end.
//
// Per block (256 threads, 8 warps as 4 x 2, a 32 x 32 warp tile): each step
// brings 64 bytes of K (64 int8 or 32 bf16 values) of 128 rows of A and of 64
// columns of B into shared memory, B stored column by column so that both
// operands have K contiguous, then every warp runs mma.sync on them
// (m16n8k32 s8 or m16n8k16 bf16; in bytes the two fragment layouts are the
// same, so one kernel body serves both types). Shared rows are 80 bytes
// apart, which spreads the eight rows a fragment load touches over all banks.
// Rows, columns and depth beyond the matrices are zero in shared memory and
// masked at the store, so no shape needs padding.
//
// Loads: an operand whose K stride is 1 and whose rows start on 16-byte
// boundaries (the im2col matrix and a quantised (N, K) weight taken as a
// strided B) comes in as 16-byte vectors; any other layout (a row-major B,
// odd K) goes element by element through its strides.
//
// Bound: bytes for the convolution shapes of the lip-sync generator (M up to
// 1.2e6 rows against N <= 64 columns: A is read once, at most 1.7 GB), and
// operations at 4096^3, where this kernel, with mma.sync, one tile in flight
// and no TMA or wgmma, stays far from the tensor-core peak; PERF.md has both.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;          // rows of C per block
constexpr int kBN = 64;           // columns of C per block
constexpr int kTileBytes = 64;    // bytes of K per step
constexpr int kLd = kTileBytes + 16;  // shared row stride in bytes

template <typename T> struct Traits;
template <> struct Traits<int8_t> {
  using Acc = int;
  using Raw = uint8_t;
};
template <> struct Traits<__nv_bfloat16> {
  using Acc = float;
  using Raw = uint16_t;
};

__device__ __forceinline__ void mma_tile(int (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tile(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ROWS x 64 bytes of a matrix whose element (r, k) lives at
// src[r * rs + k * ks], rows r0.. and depth k0.., into dst[r * kLd + k * size];
// what lies beyond `rows` or `depth` becomes zero. `vec`: ks == 1, every row
// 16-byte aligned and depth a whole number of 16-byte chunks.
template <typename Raw, int ROWS>
__device__ __forceinline__ void load_tile(unsigned char* dst, const Raw* src, long long rs,
                                          long long ks, int r0, int k0, int rows, int depth,
                                          int vec) {
  constexpr int kElems = kTileBytes / static_cast<int>(sizeof(Raw));   // K values a row
  if (vec) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(Raw));           // K values a chunk
    for (int c = threadIdx.x; c < ROWS * 4; c += kThreads) {
      const int r = c >> 2, part = c & 3;
      const int kk = k0 + part * kPer;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < rows && kk < depth)
        v = *reinterpret_cast<const uint4*>(src + static_cast<long long>(r0 + r) * rs + kk);
      *reinterpret_cast<uint4*>(dst + r * kLd + part * 16) = v;
    }
    return;
  }
  // neighbouring threads walk the axis with the smaller stride
  const bool rows_fastest = rs < ks;
  for (int i = threadIdx.x; i < ROWS * kElems; i += kThreads) {
    const int r = rows_fastest ? i % ROWS : i / kElems;
    const int kk = rows_fastest ? i / ROWS : i % kElems;
    Raw v = 0;
    if (r0 + r < rows && k0 + kk < depth)
      v = src[static_cast<long long>(r0 + r) * rs + static_cast<long long>(k0 + kk) * ks];
    *reinterpret_cast<Raw*>(dst + r * kLd + kk * static_cast<int>(sizeof(Raw))) = v;
  }
}

// Strides in elements: A(m, k) at a[m * sam + k * sak], B(k, n) at
// b[k * sbk + n * sbn]; C is contiguous (M, N).
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
mm_kernel(const T* __restrict__ a, const T* __restrict__ b,
          typename Traits<T>::Acc* __restrict__ c, int m, int n, int k, long long sam,
          long long sak, long long sbk, long long sbn, int a_vec, int b_vec) {
  using Acc = typename Traits<T>::Acc;
  using Raw = typename Traits<T>::Raw;
  constexpr int kElems = kTileBytes / static_cast<int>(sizeof(Raw));
  __shared__ __align__(16) unsigned char as[kBM * kLd];
  __shared__ __align__(16) unsigned char bs[kBN * kLd];

  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
  const int g = lane >> 2, t = lane & 3;

  Acc acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const Raw* ar = reinterpret_cast<const Raw*>(a);
  const Raw* br = reinterpret_cast<const Raw*>(b);
  for (int k0 = 0; k0 < k; k0 += kElems) {
    load_tile<Raw, kBM>(as, ar, sam, sak, m0, k0, m, k, a_vec);
    load_tile<Raw, kBN>(bs, br, sbn, sbk, n0, k0, n, k, b_vec);
    __syncthreads();
#pragma unroll
    for (int kb = 0; kb < kTileBytes; kb += 32) {
      uint32_t fa[2][4], fb[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const unsigned char* p = as + (wm + i * 16 + g) * kLd + kb + t * 4;
        fa[i][0] = *reinterpret_cast<const uint32_t*>(p);
        fa[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd);
        fa[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        fa[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned char* p = bs + (wn + j * 8 + g) * kLd + kb + t * 4;
        fb[j][0] = *reinterpret_cast<const uint32_t*>(p);
        fb[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tile(acc[i][j], fa[i], fb[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + j * 8 + t * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + h * 8;
        if (row < m) {
          Acc* out = c + static_cast<long long>(row) * n + col;
          if (col < n) out[0] = acc[i][j][2 * h];
          if (col + 1 < n) out[1] = acc[i][j][2 * h + 1];
        }
      }
    }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int m, int n, int k, long long sam,
           long long sak, long long sbk, long long sbn, void* stream) {
  const long long size = static_cast<long long>(sizeof(T));
  auto vec = [&](const void* p, long long row_stride, long long k_stride) {
    return k_stride == 1 && reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
           (row_stride * size) % 16 == 0 && (static_cast<long long>(k) * size) % 16 == 0;
  };
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  mm_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<typename Traits<T>::Acc*>(c), m, n, k, sam, sak, sbk, sbn,
      vec(a, sam, sak) ? 1 : 0, vec(b, sbn, sbk) ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: (m, k) int8 with element strides (sam, sak); b: (k, n) int8 with element
// strides (sbk, sbn); c: contiguous (m, n) int32; m, n, k >= 1 and
// ceil(n / 64) <= 65535. Returns cudaGetLastError() after the launch.
extern "C" int lvg_mm_int8(const void* a, const void* b, void* c, int m, int n, int k,
                           long long sam, long long sak, long long sbk, long long sbn,
                           void* stream) {
  return launch<int8_t>(a, b, c, m, n, k, sam, sak, sbk, sbn, stream);
}

// The same for bf16 operands and a contiguous float32 c.
extern "C" int lvg_mm_bf16(const void* a, const void* b, void* c, int m, int n, int k,
                           long long sam, long long sak, long long sbk, long long sbn,
                           void* stream) {
  return launch<__nv_bfloat16>(a, b, c, m, n, k, sam, sak, sbk, sbn, stream);
}
