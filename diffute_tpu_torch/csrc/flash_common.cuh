// Device helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): cp.async tile loads into padded shared memory, ldmatrix,
// the bf16 mma.sync.m16n8k16, and the 16x64 warp-tile products built on them.
//
// Conventions.  A block has 4 warps; each warp owns 16 rows of a 64-row tile.
// Within a warp, g = lane / 4 and tig = lane % 4: an fp32 accumulator
// acc[n][0..3] holds rows (g, g, g+8, g+8) and columns n*8 + tig*2 + (0, 1,
// 0, 1) of the warp's 16 x 64 tile.  A "frags" array a[4][4] holds the bf16
// A operand of the same 16 x 64 shape, one m16k16 fragment per k-step; an
// accumulator re-packs into it without leaving registers (pack_frags).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int kHeadDim = 64;
constexpr int kTile = 64;             // rows per shared-memory tile (4 warps x 16)
constexpr int kThreads = 128;
constexpr int kPad = 8;               // bf16 elements of row padding
constexpr int kRow = kHeadDim + kPad; // 72 elements = 144 bytes: ldmatrix rows
                                      // of one 8x8 load land in distinct banks
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  // src_bytes == 0 zero-fills the 16 destination bytes (ragged tail rows)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// D = A(16x16 bf16, row) * B(16x8 bf16, col) + D, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0+64) of one (rows, 64) bf16 matrix into a padded
// [64][72] shared tile; rows at or past `n_rows` are zero-filled.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int n_rows) {
  // 64 rows x 8 chunks of 16 bytes = 512 chunks, 4 per thread
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int chunk = threadIdx.x + i * kThreads;
    int r = chunk >> 3, c = (chunk & 7) * 8;
    int row = row0 + r;
    bool ok = row < n_rows;
    const __nv_bfloat16* g = src + (size_t)(ok ? row : 0) * kHeadDim + c;
    cp_async_16(smem_u32(dst + r * kRow + c), g, ok ? 16 : 0);
  }
}

// A fragments of rows [row0, row0+16) of a (rows, 64) bf16 matrix in global
// memory, read once; rows at or past `n_rows` are zero.
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[4][4],
                                             const __nv_bfloat16* src,
                                             int row0, int n_rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int r_lo = row0 + g, r_hi = row0 + g + 8;
  const uint32_t* lo = reinterpret_cast<const uint32_t*>(
      src + (size_t)min(r_lo, n_rows - 1) * kHeadDim);
  const uint32_t* hi = reinterpret_cast<const uint32_t*>(
      src + (size_t)min(r_hi, n_rows - 1) * kHeadDim);
  const bool ok_lo = r_lo < n_rows, ok_hi = r_hi < n_rows;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 8 + tig;  // in 32-bit words: (kk*16 + tig*2) / 2
    a[kk][0] = ok_lo ? lo[c] : 0u;
    a[kk][1] = ok_hi ? hi[c] : 0u;
    a[kk][2] = ok_lo ? lo[c + 4] : 0u;
    a[kk][3] = ok_hi ? hi[c + 4] : 0u;
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
}

// An fp32 accumulator tile, rounded to bf16, as the A operand of the next
// product: the accumulator layout is the A-fragment layout.
__device__ __forceinline__ void pack_frags(uint32_t (&a)[4][4],
                                           const float (&s)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// acc (16 x 64) += A (16 x 64) * tile^T, tile = [64 n][64 k] in shared memory
// (the contraction runs over each tile row's 64 elements).
__device__ __forceinline__ void mma_nt(float (&acc)[8][4],
                                       const uint32_t (&a)[4][4],
                                       const __nv_bfloat16* tile) {
  // ldmatrix row addresses: thread t feeds row (t & 7) of 8x8 matrix (t >> 3)
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      // matrices: (n0, k0), (n0, k0+8), (n0+8, k0), (n0+8, k0+8)
      const int row = p * 16 + (mi >> 1) * 8 + mr;
      const int col = kk * 16 + (mi & 1) * 8;
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4(b0, b1, b2, b3, smem_u32(tile + row * kRow + col));
      mma_bf16(acc[2 * p], a[kk], b0, b1);
      mma_bf16(acc[2 * p + 1], a[kk], b2, b3);
    }
  }
}

// acc (16 x 64) += A (16 x 64) * tile, tile = [64 k][64 n] in shared memory
// (the contraction runs over the tile's 64 rows).
__device__ __forceinline__ void mma_nn(float (&acc)[8][4],
                                       const uint32_t (&a)[4][4],
                                       const __nv_bfloat16* tile) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      // transposed matrices: (k0, n0), (k0+8, n0), (k0, n0+8), (k0+8, n0+8)
      const int row = kk * 16 + (mi & 1) * 8 + mr;
      const int col = p * 16 + (mi >> 1) * 8;
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(b0, b1, b2, b3, smem_u32(tile + row * kRow + col));
      mma_bf16(acc[2 * p], a[kk], b0, b1);
      mma_bf16(acc[2 * p + 1], a[kk], b2, b3);
    }
  }
}

// Write the warp's 16 x 64 accumulator, times f_lo / f_hi per row half, as
// bf16 rows [row0, row0+16) of a (rows, 64) matrix; rows past n_rows are
// dropped.
__device__ __forceinline__ void store_acc(__nv_bfloat16* dst,
                                          const float (&acc)[8][4], int row0,
                                          int n_rows, float f_lo, float f_hi) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int r_lo = row0 + g, r_hi = row0 + g + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + tig * 2;
    if (r_lo < n_rows)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r_lo * kHeadDim + c) =
          pack_bf16(acc[n][0] * f_lo, acc[n][1] * f_lo);
    if (r_hi < n_rows)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r_hi * kHeadDim + c) =
          pack_bf16(acc[n][2] * f_hi, acc[n][3] * f_hi);
  }
}

}  // namespace flash
