// int8-weight matmul for Hopper (sm_90a): y = (x @ q^T) * s, bf16 x and y,
// int8 q, fp32 accumulation.
//
// Replaces the Pallas TPU kernel `_w8_kernel` of diffute_tpu/ops/quant.py
// (`_pallas_matmul_w8`'s pl.pallas_call).  It computes the same function, not
// the same grid: the Pallas kernel holds a (256, K) x tile and a whole
// (K, 256) int8 weight panel in VMEM per grid step; here a block owns a
// 64 x 64 output tile and walks K in steps of 64 through shared memory.
//
//   x (M, K) bf16 row-major, q (N, K) int8 row-major (one output feature per
//   row, as nn.Linear keeps its weight), s (N) fp32 or bf16 -> y (M, N) bf16
//
// What bounds it on the H100: at M = 64 and 256 (the 8^2 and 16^2 levels of
// the UNet) the weight bytes: N*K int8 read once against 2*M*N*K operations
// is 2M = 128 to 512 FLOP/byte, around the card's 295 FLOP/byte line, and the
// int8 storage halves those bytes against bf16, which is the kernel's reason
// to exist.  At M = 4096 it is bound by the tensor cores.  What the design
// does about it:
//   - the weights cross device memory and L2 as int8, 16 bytes a thread, and
//     become bf16 only on their way into shared memory (the values -127..127
//     are exact in bf16), so no dequantised copy exists in device memory;
//   - the next tile's int8 loads are issued before the current tile's
//     products and converted after them, and x tiles are double-buffered
//     with cp.async, so the loads overlap the mma.sync stream;
//   - the per-column scale commutes with the contraction and is applied once
//     to the fp32 accumulator in the epilogue, then the result is rounded to
//     bf16: the order of roundings of the TPU kernel.  The bias is not fused:
//     the layer adds it to the rounded result, as the JAX layer does.
//   - at M = 64 and 256 a 64 x 64 tiling gives 20 to 80 blocks for 132 SMs,
//     each walking up to 80 K steps alone on its SM.  There K is split over
//     blockIdx.z: every block writes its fp32 partial tile to a workspace,
//     and the block that finishes last for an output tile (a ticket counter,
//     reset by that block) adds the partials in split order, so the sum does
//     not depend on which block came last; no float atomics, no second
//     launch.
// One 64 x 64 tiling serves all shapes for now; a taller tile for M = 4096
// is left for later work.

#include "flash_common.cuh"

namespace {

using flash::cp_async_16;
using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::ldmatrix_x4;
using flash::mma_bf16;
using flash::pack_bf16;
using flash::smem_u32;

constexpr int kThreads = 128;
constexpr int kBM = 64, kBN = 64, kBK = 64;
constexpr int kRow = kBK + 8;  // padded row: ldmatrix rows in distinct banks

// x rows [m0, m0+64) x columns [k0, k0+64) -> dst[64][kRow]; rows >= M and
// columns >= K are zero-filled.
__device__ __forceinline__ void load_x_tile(__nv_bfloat16* dst,
                                            const __nv_bfloat16* x, int m0,
                                            int k0, int M, int K) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int chunk = threadIdx.x + i * kThreads;
    const int r = chunk >> 3, c = (chunk & 7) * 8;
    const bool ok = (m0 + r < M) && (k0 + c < K);
    const __nv_bfloat16* g = x + (size_t)(ok ? m0 + r : 0) * K + (ok ? k0 + c : 0);
    cp_async_16(smem_u32(dst + r * kRow + c), g, ok ? 16 : 0);
  }
}

// Two 16-byte chunks of int8 weights per thread: rows [n0, n0+64) x columns
// [k0, k0+64) of q is 64 x 4 chunks.
__device__ __forceinline__ void load_q_regs(int4 (&r)[2], const int8_t* q,
                                            int n0, int k0, int N, int K) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = threadIdx.x + i * kThreads;
    const int n = n0 + (chunk >> 2), k = k0 + (chunk & 3) * 16;
    r[i] = (n < N && k < K)
               ? __ldg(reinterpret_cast<const int4*>(q + (size_t)n * K + k))
               : make_int4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ uint32_t cvt2(int word, int shift) {
  // two neighbouring int8 of `word` -> packed bf16 pair (exact)
  const float lo = (float)(int8_t)(word >> shift);
  const float hi = (float)(int8_t)(word >> (shift + 8));
  return pack_bf16(lo, hi);
}

__device__ __forceinline__ void store_q_tile(__nv_bfloat16* dst,
                                             const int4 (&r)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = threadIdx.x + i * kThreads;
    __nv_bfloat16* p = dst + (chunk >> 2) * kRow + (chunk & 3) * 16;
    const int w[4] = {r[i].x, r[i].y, r[i].z, r[i].w};
    uint4 lo, hi;
    lo.x = cvt2(w[0], 0); lo.y = cvt2(w[0], 16);
    lo.z = cvt2(w[1], 0); lo.w = cvt2(w[1], 16);
    hi.x = cvt2(w[2], 0); hi.y = cvt2(w[2], 16);
    hi.z = cvt2(w[3], 0); hi.w = cvt2(w[3], 16);
    reinterpret_cast<uint4*>(p)[0] = lo;
    reinterpret_cast<uint4*>(p)[1] = hi;
  }
}

// grid (N tiles, M tiles, splits).  With splits > 1: workspace holds
// (splits, M, N) fp32 and tickets one zeroed int per output tile.
__global__ void __launch_bounds__(kThreads)
w8_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ q, const void* __restrict__ scale,
                 int scale_bf16, __nv_bfloat16* __restrict__ y,
                 float* __restrict__ workspace, int* __restrict__ tickets,
                 int M, int N, int K, int tiles_per_split) {
  __shared__ __align__(128) __nv_bfloat16 x_s[2][kBM * kRow];
  __shared__ __align__(128) __nv_bfloat16 q_s[2][kBN * kRow];

  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3, mi = lane >> 3, mr = lane & 7;
  const int splits = gridDim.z;
  const int t0 = blockIdx.z * tiles_per_split;
  const int n_tiles = min(t0 + tiles_per_split, (K + kBK - 1) / kBK);

  int4 qr[2];
  load_x_tile(x_s[0], x, m0, t0 * kBK, M, K);
  cp_async_commit();
  load_q_regs(qr, q, n0, t0 * kBK, N, K);
  store_q_tile(q_s[0], qr);

  float acc[8][4];
  flash::zero_acc(acc);

  for (int t = t0; t < n_tiles; ++t) {
    const int buf = (t - t0) & 1;
    if (t + 1 < n_tiles) {
      load_x_tile(x_s[buf ^ 1], x, m0, (t + 1) * kBK, M, K);
      cp_async_commit();
      load_q_regs(qr, q, n0, (t + 1) * kBK, N, K);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const __nv_bfloat16* xs = x_s[buf] + warp * 16 * kRow;
    const __nv_bfloat16* qs = q_s[buf];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // A fragment of the warp's 16 rows: matrices (m, k), (m+8, k),
      // (m, k+8), (m+8, k+8)
      uint32_t a[4];
      ldmatrix_x4(a[0], a[1], a[2], a[3],
                  smem_u32(xs + ((mi & 1) * 8 + mr) * kRow + kk * 16 +
                           (mi >> 1) * 8));
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        // B from q_s[n][k]: matrices (n, k), (n, k+8), (n+8, k), (n+8, k+8)
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(b0, b1, b2, b3,
                    smem_u32(qs + (p * 16 + (mi >> 1) * 8 + mr) * kRow +
                             kk * 16 + (mi & 1) * 8));
        mma_bf16(acc[2 * p], a, b0, b1);
        mma_bf16(acc[2 * p + 1], a, b2, b3);
      }
    }
    // the other buffer was last read before the barrier that ended the
    // previous iteration
    if (t + 1 < n_tiles) store_q_tile(q_s[buf ^ 1], qr);
    __syncthreads();
  }

  const int r_lo = m0 + warp * 16 + g, r_hi = r_lo + 8;
  if (splits > 1) {
    // this split's partial tile to the workspace; the last block to arrive
    // for the tile re-reads all of them in split order
    __shared__ int is_last;
    float* mine = workspace + (size_t)blockIdx.z * M * N;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = n0 + n * 8 + tig * 2;
      if (c >= N) continue;
      if (r_lo < M)
        __stcg(reinterpret_cast<float2*>(mine + (size_t)r_lo * N + c),
               make_float2(acc[n][0], acc[n][1]));
      if (r_hi < M)
        __stcg(reinterpret_cast<float2*>(mine + (size_t)r_hi * N + c),
               make_float2(acc[n][2], acc[n][3]));
    }
    __threadfence();
    __syncthreads();
    const int tile_id = blockIdx.y * gridDim.x + blockIdx.x;
    if (threadIdx.x == 0)
      is_last = atomicAdd(&tickets[tile_id], 1) == splits - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    if (threadIdx.x == 0) tickets[tile_id] = 0;
    flash::zero_acc(acc);
    for (int z = 0; z < splits; ++z) {
      const float* part = workspace + (size_t)z * M * N;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = n0 + n * 8 + tig * 2;
        if (c >= N) continue;
        if (r_lo < M) {
          const float2 v = __ldcg(
              reinterpret_cast<const float2*>(part + (size_t)r_lo * N + c));
          acc[n][0] += v.x;
          acc[n][1] += v.y;
        }
        if (r_hi < M) {
          const float2 v = __ldcg(
              reinterpret_cast<const float2*>(part + (size_t)r_hi * N + c));
          acc[n][2] += v.x;
          acc[n][3] += v.y;
        }
      }
    }
  }

  // epilogue: scale per output column, round to bf16
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n0 + n * 8 + tig * 2;
    if (c >= N) continue;  // N is even: c + 1 < N too
    float s0, s1;
    if (scale_bf16) {
      const __nv_bfloat16* s = static_cast<const __nv_bfloat16*>(scale);
      s0 = __bfloat162float(s[c]);
      s1 = __bfloat162float(s[c + 1]);
    } else {
      const float* s = static_cast<const float*>(scale);
      s0 = s[c];
      s1 = s[c + 1];
    }
    if (r_lo < M)
      *reinterpret_cast<uint32_t*>(y + (size_t)r_lo * N + c) =
          pack_bf16(acc[n][0] * s0, acc[n][1] * s1);
    if (r_hi < M)
      *reinterpret_cast<uint32_t*>(y + (size_t)r_hi * N + c) =
          pack_bf16(acc[n][2] * s0, acc[n][3] * s1);
  }
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream`, allocates nothing,
// and returns cudaGetLastError() (0 = launched).  K % 16 == 0 (16-byte int8
// chunks), N % 2 == 0 (paired stores).  splits > 1 splits K's 64-wide steps
// over `splits` grid planes: workspace then holds splits*M*N floats and
// tickets one zeroed int per 64 x 64 output tile (left zeroed).
extern "C" int w8_matmul_bf16(const void* x, const void* q, const void* scale,
                              int scale_bf16, void* y, void* workspace,
                              void* tickets, int M, int N, int K, int splits,
                              void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || N % 2 || splits <= 0 ||
      (splits > 1 && (workspace == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int per = (k_tiles + splits - 1) / splits;
  if ((long long)per * (splits - 1) >= k_tiles)  // an empty last split
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  w8_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      scale, scale_bf16, static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(workspace), static_cast<int*>(tickets), M, N, K,
      per);
  return (int)cudaGetLastError();
}
