// What the float32 "tiled" flash-attention kernels share: the forward K3
// (flash_fwd.cu) and the backward K4 and K5 (flash_bwd.cu). Their blocks are
// 128 threads; their tiles are rows of float in shared memory, filled by
// 16-byte cp.async with zeros past the rows and columns that exist.
#pragma once

#include <cuda_runtime.h>

namespace flash_tiled {

constexpr int kT = 128;        // threads a block (4 warps)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
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

}  // namespace flash_tiled
