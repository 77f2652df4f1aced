// int8-weight matmul on fp32 activations for Hopper (sm_90a):
// y = ((x @ q^T) * s) + bias, fp32 x and y, int8 q, fp32 scale and bias.
//
// Replaces the Pallas TPU kernel `_w8_kernel` of diffute_tpu/ops/quant.py
// (`_pallas_matmul_w8`'s pl.pallas_call) on fp32 inputs, and the bias add of
// the JAX layer `QuantDense` (diffute_tpu/models/layers.py): the product in
// fp32, times the per-feature scale, rounded, then the bias added and the
// sum rounded, all in fp32.  The bf16 kernel (quant.cu) stays as it is.
//
//   x (M, K) fp32 row-major; q (N, K) int8 as the layer keeps it (no
//   repacked copy: the fp32 kernel adds no bytes to serving memory);
//   s (N) fp32 or bf16; bias (N) fp32 or none -> y (M, N) fp32
//
// Precision.  The port's fp32 paths turn TF32 off, so the kernel is accurate
// to fp32, not to TF32 (held to relative L2 1e-5 of the plain fp32 version,
// chip_smoke.py phase 3g):
//   * every int8 value is exact in TF32 (|q| <= 127 has 7 significant bits
//     of TF32's 11), so only x is split: hi = tf32(x) (cvt.rna), lo =
//     tf32(x - hi), and x q = lo q + hi q, two products on
//     mma.sync.m16n8k8.tf32 where fp32 operands take three (flash_fp32.cu);
//     the dropped part of x is 2^-22 of it.  TF32 alone (hi q) reads about
//     3e-4 from fp32 and fails the bound;
//   * the tensor cores' fp32 accumulation rounds toward zero, so no
//     accumulator in them spans more than one 32-wide k tile (8 products
//     from zero); each tile's sum is added to the running fp32 sum by an
//     ordinary (round-to-nearest) add.
//
// What bounds it on the H100: operations at the UNet's M = 1024 and 4096
// (2 M N K over the TF32 rate halved by the two products, 247 TFLOP/s),
// the bytes of x and y (4 bytes each) elsewhere: at M = 64 and 256 the
// int8 weight is the largest operand.  This first cut is simple:
//   - a block of 4 warps owns a 64 x 64 tile of y, each warp 32 x 32 (2 x 4
//     mma tiles of 16 x 8), and walks K in tiles of 32 through a
//     three-stage cp.async ring (8 KB of x and 2 KB of q a stage); rows past
//     M or N and columns past K are zero-filled;
//   - a tile's contraction runs in a permuted k order: step s of a lane with
//     t = lane % 4 takes k = 8t + 2s and 8t + 2s + 1 for the fragment's k =
//     t and t + 4, on A and B alike.  So a lane reads its 8 k values of an x
//     row as two 16-byte loads and of a q row as one 8-byte load; x's
//     16-byte chunks are stored at chunk ^ (row & 1), which keeps both
//     conflict-free;
//   - int8 -> fp32 by a byte permute and an fp32 subtraction (2^23 + b - 2^23
//     - 128, on b = q + 128), no int-to-float conversion;
//   - no K split, so every output element is one fixed sum: two runs give
//     the same bits.  wgmma (tf32 takes K-major operands, which both are
//     here), TMA and a producer warp are left to a redesign (ROADMAP.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_sm90.cuh"

namespace {

using namespace tf32_sm90;

constexpr int kBM = 64, kBN = 64, kBK = 32;  // block tile, k tile
constexpr int kStages = 3;
constexpr int kThreads = 128;  // 4 warps: 2 along M x 2 along N
constexpr int kXStage = kBM * kBK;  // floats of x a stage
constexpr int kQStage = kBN * kBK;  // bytes of q a stage

struct Smem {
  float x[kStages][kXStage];     // [row][32], 16-byte chunk c at c ^ (row & 1)
  uint8_t q[kStages][kQStage];   // [feature][32]
};

// x tile kt and q tile kt into stage st: 512 16-byte chunks of x (4 a
// thread) and 128 of q (1 a thread)
__device__ __forceinline__ void load_stage(Smem& sm, int st, int kt,
                                           const float* __restrict__ x,
                                           const int8_t* __restrict__ q,
                                           int m0, int n0, int m, int n,
                                           int k) {
  const int k0 = kt * kBK;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 3, c = idx & 7;
    const bool ok = m0 + r < m && k0 + 4 * c < k;
    const float* src = ok ? x + (size_t)(m0 + r) * k + k0 + 4 * c : x;
    cp_async_16(smem_u32(&sm.x[st][r * kBK + 4 * (c ^ (r & 1))]), src,
                ok ? 16 : 0);
  }
  {
    const int r = threadIdx.x >> 1, c = threadIdx.x & 1;
    const bool ok = n0 + r < n && k0 + 16 * c < k;
    const int8_t* src = ok ? q + (size_t)(n0 + r) * k + k0 + 16 * c : q;
    cp_async_16(smem_u32(&sm.q[st][r * kBK + 16 * c]), src, ok ? 16 : 0);
  }
}

// four int8 values (a 32-bit word) -> their exact fp32 values: bytes biased
// by 128 (xor 0x80) sit in the mantissa of 2^23; subtracting 2^23 + 128
// leaves q
__device__ __forceinline__ void int8x4_to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t b = w ^ 0x80808080u, m = 0x4B000000u;
  f[0] = __uint_as_float(__byte_perm(b, m, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(b, m, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(b, m, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(b, m, 0x7653)) - 8388736.f;
}

__device__ __forceinline__ float4 lds_f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The block's 64 x 64 tile of y.  grid (ceil(N / 64), ceil(M / 64)).
__global__ void __launch_bounds__(kThreads)
    w8_fp32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                   const void* __restrict__ scale, int scale_bf16,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int m, int n, int k) {
  __shared__ __align__(16) Smem sm;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;  // the warp's 32 x 32 of the tile
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kt_n = (k + kBK - 1) / kBK;

  float acc[2][4][4];  // [m tile][n tile][fragment]: the running fp32 sum
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_n) load_stage(sm, s, s, x, q, m0, n0, m, n, k);
    cp_async_commit();
  }

  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed; stage (kt - 1) % kStages is free
    if (kt + kStages - 1 < kt_n)
      load_stage(sm, (kt + kStages - 1) % kStages, kt + kStages - 1, x, q, m0,
                 n0, m, n, k);
    cp_async_commit();

    const int st = kt % kStages;
    // this lane's 8 k values (8t .. 8t + 7) of its x rows and q rows
    float xa[2][2][8];  // [m tile][row g, g + 8][k]
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + i * 16 + h * 8 + g;
        const float* row = &sm.x[st][r * kBK];
        const float4 u = lds_f4(row + 4 * ((2 * t) ^ (r & 1)));
        const float4 v = lds_f4(row + 4 * ((2 * t + 1) ^ (r & 1)));
        xa[i][h][0] = u.x, xa[i][h][1] = u.y, xa[i][h][2] = u.z;
        xa[i][h][3] = u.w, xa[i][h][4] = v.x, xa[i][h][5] = v.y;
        xa[i][h][6] = v.z, xa[i][h][7] = v.w;
      }
    float qb[4][8];  // [n tile][k]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint2 w = *reinterpret_cast<const uint2*>(
          &sm.q[st][(wn * 32 + j * 8 + g) * kBK + 8 * t]);
      float lo4[4], hi4[4];
      int8x4_to_f32(w.x, lo4);
      int8x4_to_f32(w.y, hi4);
#pragma unroll
      for (int e = 0; e < 4; ++e) qb[j][e] = lo4[e], qb[j][4 + e] = hi4[e];
    }

    float part[2][4][4];  // this tile's sum, from zero
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      // fragment k = t -> 8t + 2s, k = t + 4 -> 8t + 2s + 1
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        split(xa[i][0][2 * s], ahi[i][0], alo[i][0]);
        split(xa[i][1][2 * s], ahi[i][1], alo[i][1]);
        split(xa[i][0][2 * s + 1], ahi[i][2], alo[i][2]);
        split(xa[i][1][2 * s + 1], ahi[i][3], alo[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t b0 = __float_as_uint(qb[j][2 * s]);
        const uint32_t b1 = __float_as_uint(qb[j][2 * s + 1]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_tf32(part[i][j], alo[i], b0, b1);  // the small term first
          mma_tf32(part[i][j], ahi[i], b0, b1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  cp_async_wait<0>();

  // epilogue: y = acc * s, rounded, + bias, rounded (no fused multiply-add)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn * 32 + j * 8 + 2 * t;
    float sc[2], bi[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = min(col + e, n - 1);
      sc[e] = scale_bf16
                  ? __bfloat162float(static_cast<const __nv_bfloat16*>(scale)[c])
                  : static_cast<const float*>(scale)[c];
      bi[e] = bias ? bias[c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + i * 16 + h * 8 + g;
        if (row >= m || col >= n) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = __fmul_rn(acc[i][j][2 * h + e], sc[e]);
          if (bias) v[e] = __fadd_rn(v[e], bi[e]);
        }
        float* dst = y + (size_t)row * n + col;
        if ((n & 1) == 0) {
          *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
        } else {
          dst[0] = v[0];
          if (col + 1 < n) dst[1] = v[1];
        }
      }
  }
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream`, allocates nothing,
// and returns a CUDA error code (0 = launched).
//   x (M, K) fp32 row-major, q (N, K) int8 row-major, both 16-byte aligned,
//   K % 16 == 0; scale (N) fp32 or bf16; bias (N) fp32 or nullptr; y (M, N)
//   fp32, 8-byte aligned.
extern "C" int w8_matmul_fp32(const void* x, const void* q, const void* scale,
                              int scale_bf16, const void* bias, void* y, int M,
                              int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 ||
      (M + kBM - 1) / kBM > 65535 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 8)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  w8_fp32_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(q), scale,
      scale_bf16, static_cast<const float*>(bias), static_cast<float*>(y), M,
      N, K);
  return (int)cudaGetLastError();
}
