// K6's packing pass: a copy of a (rows, K) int8 or bf16 operand with K
// contiguous and rows pad16(K * size) bytes apart, for the layouts that the
// tensor maps of int8_mm_sm90.cu cannot read.
//
// Replaces nothing of scripts/microbench_int8_pallas.py::mm_kernel on its
// own: it is the first half of K6's "packed" route (ops/matmul_cuda.py), of
// which int8_mm_sm90.cu's wgmma kernel is the second. Integer wgmma takes
// K-major operands only, and a tensor map wants 16-byte row starts and rows
// that do not overlap, so the TPU kernel's own row-major int8 B, int8_dense's
// (in, out) weight, odd depths, element strides, views that start inside a
// 16-byte word and broadcast rows come here first. Element (r, k) of the
// source lies at src[r * rs + k * ks] (strides in elements, any alignment);
// the copy holds it at dst[r * ld + k]. The bytes of a row past K are left as
// they fall: the product's tensor map has a K extent of K and fills what lies
// past it with zeros, so it never reads them.
//
// Bound: bytes, the operand read once and the copy written once (at 4096^2
// int8, 33.5 MB: 10.0 us at 3.35 TB/s). What the design does about it: every
// store is 16 bytes, and three paths, picked by the caller
// (ops/matmul_cuda.pack_path), read as wide as the layout allows:
//   - "rows" (K contiguous, any row start: odd K, views one element in,
//     broadcast or overlapping rows): a thread a 16-byte chunk of a row,
//     neighbouring threads on neighbouring chunks. It reads the one or two
//     aligned 16-byte words that hold the chunk and shifts the bytes into
//     place with funnel shifts.
//   - "transpose" (rows contiguous at 16-byte row starts: a row-major (K, N)
//     B read as (N, K)): a block moves a tile of 128 depths x 128 bytes of
//     rows through 16 KB of shared memory, loading 16 bytes along the rows,
//     then each thread reads a column strip of 16 bytes of K for 4 rows,
//     transposes it in registers with byte permutes (4 x 4 bytes for int8,
//     2 x 2 halves for bf16) and stores 16 bytes along K. The tile's 16-byte
//     chunks are XOR-swizzled by depth, so the loads' writes and the
//     strips' reads meet distinct banks.
//   - "gather" (anything else: element strides on both axes, unaligned rows
//     of a row-major B): the same tile, filled element by element with
//     neighbouring threads on the smaller stride.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileK = 128;        // depths (K) of a tile
constexpr int kTileBytes = 128;    // bytes of rows of a tile
constexpr int kRowBlocks = 1 << 16;   // blocks of the rows path; it strides past them

// ---- "rows": K contiguous ------------------------------------------------
// Chunk c of row r is bytes [16c, 16c + 16) of the row; the copy's rows are
// ld_bytes apart (a multiple of 16), so it is one aligned 16-byte store.
__global__ void __launch_bounds__(kThreads)
rows_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, long long rows,
            int row_bytes, long long src_row_bytes, long long ld_bytes) {
  const long long per_row = (row_bytes + 15) / 16;
  const long long total = rows * per_row;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += step) {
    const long long r = i / per_row;
    const int c = static_cast<int>(i - r * per_row);
    const uint8_t* p = src + r * src_row_bytes + 16 * c;
    const int off = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
    // the aligned words holding the chunk; the second only where it holds a
    // byte of the row (an aligned word with one byte of the row lies in the
    // row's page, so no read leaves the allocation's pages)
    const uint4* w = reinterpret_cast<const uint4*>(p - off);
    const uint4 lo = __ldg(w);
    uint4 hi = make_uint4(0u, 0u, 0u, 0u);
    if (off != 0 && 16 * c + 16 - off < row_bytes) hi = __ldg(w + 1);
    const uint32_t x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const int q = off >> 2;
    const uint32_t s = 8u * static_cast<uint32_t>(off & 3);
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // words j + q and j + q + 1 by selects: no indexing into local memory
      const uint32_t a = q == 0 ? x[j] : q == 1 ? x[j + 1] : q == 2 ? x[j + 2] : x[j + 3];
      const uint32_t b = q == 0 ? x[j + 1] : q == 1 ? x[j + 2] : q == 2 ? x[j + 3] : x[j + 4];
      o[j] = __funnelshift_r(a, b, s);
    }
    *reinterpret_cast<uint4*>(dst + r * ld_bytes + 16 * c) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// ---- "transpose" and "gather": a tile through shared memory ---------------
// The tile holds depths k0 .. k0 + 127 (its rows) x 128 bytes of operand rows
// (its columns). Chunk c of tile row d sits at chunk c ^ swizzle(d), where
// the swizzle changes with every group of 16 bytes of K (16 int8 or 8 bf16
// depths): the groups that one warp's strips read then fall on distinct
// banks, and the 8 chunks of one depth, which 8 neighbouring threads load,
// stay on distinct chunks.
template <int SIZE>
__device__ __forceinline__ int tile_offset(int d, int col_byte) {
  const int swz = (2 * (d / (16 / SIZE))) & 7;
  return d * kTileBytes + ((((col_byte >> 4) ^ swz)) << 4) + (col_byte & 15);
}

// Byte-wise 4 x 4 transpose: r[i] holds byte j of row (operand row) j at
// depth i; out[j] holds depths 0..3 of operand row j.
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4], uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

template <int SIZE, bool VEC>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, int rows, int depth,
            long long rs, long long ks, long long ld_bytes, int tiles_rows) {
  constexpr int kTileRows = kTileBytes / SIZE;   // operand rows of a tile
  __shared__ __align__(16) uint8_t tile[kTileK * kTileBytes];
  const int tr = static_cast<int>(blockIdx.x % tiles_rows);
  const int r0 = tr * kTileRows, k0 = static_cast<int>(blockIdx.x / tiles_rows) * kTileK;
  const int tid = threadIdx.x;

  if constexpr (VEC) {
    // rs == 1, 16-byte depth starts: 16 bytes along the rows a load
    const long long row_end = static_cast<long long>(rows) * SIZE;
#pragma unroll
    for (int it = 0; it < kTileK * 8 / kThreads; ++it) {
      const int idx = tid + it * kThreads, d = idx >> 3, c = idx & 7;
      const long long cb = static_cast<long long>(r0) * SIZE + 16 * c;
      if (k0 + d < depth && cb < row_end) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(
            src + static_cast<long long>(k0 + d) * ks * SIZE + cb));
        *reinterpret_cast<uint4*>(tile + tile_offset<SIZE>(d, 16 * c)) = v;
      }
    }
  } else {
    // element loads, neighbouring threads along the smaller stride, kBatch
    // of them in flight a thread before their stores (one at a time, a
    // tile's 64 or 32 loads a thread ran one latency each)
    using Raw = typename std::conditional<SIZE == 1, uint8_t, uint16_t>::type;
    constexpr int kElems = kTileK * kTileRows, kBatch = 16;
    const Raw* in = reinterpret_cast<const Raw*>(src);
    const bool rows_fastest = rs <= ks;
    for (int base = tid; base < kElems; base += kThreads * kBatch) {
      Raw v[kBatch];
      int at[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int idx = base + j * kThreads;
        const int r = rows_fastest ? idx % kTileRows : idx / kTileK;
        const int d = rows_fastest ? idx / kTileRows : idx % kTileK;
        at[j] = -1;
        if (idx < kElems && k0 + d < depth && r0 + r < rows) {
          v[j] = in[static_cast<long long>(r0 + r) * rs + static_cast<long long>(k0 + d) * ks];
          at[j] = tile_offset<SIZE>(d, r * SIZE);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (at[j] >= 0) *reinterpret_cast<Raw*>(tile + at[j]) = v[j];
    }
  }
  __syncthreads();

  // each thread: 16 bytes of K (group g) for 4 operand rows; four
  // neighbouring lanes take the four groups of 64 bytes of K, so a store
  // instruction writes 64 contiguous bytes of 8 copy rows
  const int warp = tid >> 5, lane = tid & 31;
  uint32_t out[4][4];   // [operand row j][word q of its 16 bytes]
  int g, rw;            // group of 16 bytes of K; first operand row of the 4, tile-local
  if constexpr (SIZE == 1) {
    g = (lane & 3) + 4 * (warp & 1);                // 8 groups of 16 depths
    rw = 4 * ((lane >> 2) + 8 * (warp >> 1));      // 32 x 4 rows
    uint32_t r[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      r[i] = *reinterpret_cast<const uint32_t*>(tile + tile_offset<1>(16 * g + i, rw));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t in[4] = {r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]};
      uint32_t t[4];
      transpose4x4(in, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) out[j][q] = t[j];
    }
  } else {
    g = (lane & 3) + 4 * (warp & 3);                // 16 groups of 8 depths
    rw = 4 * ((lane >> 2) + 8 * (warp >> 2));      // 16 x 4 rows
    uint2 r[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      r[i] = *reinterpret_cast<const uint2*>(tile + tile_offset<2>(8 * g + i, 2 * rw));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      out[0][q] = __byte_perm(r[2 * q].x, r[2 * q + 1].x, 0x5410);
      out[1][q] = __byte_perm(r[2 * q].x, r[2 * q + 1].x, 0x7632);
      out[2][q] = __byte_perm(r[2 * q].y, r[2 * q + 1].y, 0x5410);
      out[3][q] = __byte_perm(r[2 * q].y, r[2 * q + 1].y, 0x7632);
    }
  }
  const long long kb = static_cast<long long>(k0) * SIZE + 16 * g;
  if (kb < static_cast<long long>(depth) * SIZE) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + rw + j;
      if (r < rows)
        *reinterpret_cast<uint4*>(dst + static_cast<long long>(r) * ld_bytes + kb) =
            make_uint4(out[j][0], out[j][1], out[j][2], out[j][3]);
    }
  }
}

template <int SIZE>
int launch(const void* src, void* dst, long long rows, int k, long long rs, long long ks,
           long long ld, int path, cudaStream_t stream) {
  const auto bad = static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || rows > 0x7fffffffLL || k <= 0 || ld < k || (ld * SIZE) % 16 ||
      reinterpret_cast<uintptr_t>(dst) % 16)
    return bad;
  const auto* s = static_cast<const uint8_t*>(src);
  auto* d = static_cast<uint8_t*>(dst);
  if (path == 0) {
    if (ks != 1) return bad;
    const long long blocks = (rows * ((k * SIZE + 15) / 16) + kThreads - 1) / kThreads;
    rows_kernel<<<static_cast<int>(blocks < kRowBlocks ? blocks : kRowBlocks), kThreads, 0,
                  stream>>>(s, d, rows, k * SIZE, rs * SIZE, ld * SIZE);
    return static_cast<int>(cudaGetLastError());
  }
  const long long tiles_rows = (rows * SIZE + kTileBytes - 1) / kTileBytes;
  const long long tiles = tiles_rows * ((k + kTileK - 1) / kTileK);
  if (tiles > 0x7fffffffLL) return bad;
  const dim3 grid(static_cast<unsigned>(tiles));
  if (path == 1) {
    if (rs != 1 || reinterpret_cast<uintptr_t>(src) % 16 || (ks * SIZE) % 16) return bad;
    tile_kernel<SIZE, true><<<grid, kThreads, 0, stream>>>(
        s, d, static_cast<int>(rows), k, rs, ks, ld * SIZE, static_cast<int>(tiles_rows));
  } else if (path == 2) {
    tile_kernel<SIZE, false><<<grid, kThreads, 0, stream>>>(
        s, d, static_cast<int>(rows), k, rs, ks, ld * SIZE, static_cast<int>(tiles_rows));
  } else {
    return bad;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: (rows, k) int8, element (r, c) at src[r * rs + c * ks]; dst: rows of
// ld elements (ld >= k, ld a multiple of 16) at a 16-byte boundary; path: 0
// "rows" (ks == 1), 1 "transpose" (rs == 1, src and ks multiples of 16
// bytes), 2 "gather" (any strides). Copies element (r, c) to dst[r * ld + c].
// Anything else returns cudaErrorInvalidValue and launches nothing; else
// cudaGetLastError() after the launch.
extern "C" int lvg_pack_int8(const void* src, void* dst, long long rows, int k, long long rs,
                             long long ks, long long ld, int path, void* stream) {
  return launch<1>(src, dst, rows, k, rs, ks, ld, path, static_cast<cudaStream_t>(stream));
}

// The same for bf16 (ld a multiple of 8; for path 1, ks a multiple of 8).
extern "C" int lvg_pack_bf16(const void* src, void* dst, long long rows, int k, long long rs,
                             long long ks, long long ld, int path, void* stream) {
  return launch<2>(src, dst, rows, k, rs, ks, ld, path, static_cast<cudaStream_t>(stream));
}
