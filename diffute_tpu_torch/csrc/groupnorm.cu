// GroupNorm statistics and the fused GroupNorm + SiLU apply for Hopper
// (sm_90a), NCHW bf16.
//
// Replaces the Pallas TPU kernel `_gn_silu_kernel` of
// diffute_tpu/ops/groupnorm.py (`_pallas_gn_silu_fwd_impl`'s pl.pallas_call).
// It computes the same function, not the same grid.  The Pallas kernel keeps
// one sample's whole (H*W, C) slab in VMEM, one grid step per sample, and
// reduces channels to groups with one-hot matmuls (a Mosaic workaround).  In
// NCHW a group of one sample is one contiguous run of (C/G)*H*W elements, so
// here the reduction is a plain sum over that run, in two launches:
//
//   gn_stats_bf16      x (B, C, H, W) -> mean, rstd (B, G) fp32
//   gn_silu_apply_bf16 y = silu(x * a_c + d_c),  a_c = gamma_c * rstd_g,
//                      d_c = beta_c - mean_g * a_c, rounded to bf16
//
// The statistics are shared with the fused conv kernel (conv_fused.cu).
//
// What bounds them on the H100: bytes.  Both passes do a few fp32 operations
// per element, far below the card's 295 FLOP/byte line; the least time is x
// read once (stats) and x read once + y written once (apply) over 3.35 TB/s.
// The tensors of the UNet are 80 KB to 7.9 MB, so they sit in the 50 MB L2
// between the two launches.  What the design does about it:
//   - 16-byte loads and stores, 8 bf16 per thread per step;
//   - at batch 1 a (sample, group) pair per block would put 32 blocks on 132
//     SMs, so a group's run is split over several blocks.  Each block reduces
//     its piece to (mean, M2) with two passes over data it has just read
//     (the second pass hits L1/L2), which is exact where E[x^2] - mean^2
//     cancels (|mean| >> std); the block that finishes last for a group
//     (a ticket counter, reset by that block) merges the pieces in index
//     order with Chan's formula, so the result does not depend on the order
//     in which blocks ran;
//   - the apply recomputes a_c, d_c per 8-element vector from four cached
//     loads instead of a third launch that would tabulate them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStatThreads = 256;

__device__ __forceinline__ float ld_affine(const void* p, int i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Sum of `v` over the block, returned to every thread.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kStatThreads / 32; ++w) t += red[w];
  return t;
}

// grid (splits, B*G).  Block (s, bg) reduces vectors [s*per, (s+1)*per) of
// the group's n_vec 8-element vectors.  partial: (B*G, splits, 2) fp32
// (mean, M2); tickets: (B*G) int32, all zero before and after the launch.
__global__ void __launch_bounds__(kStatThreads)
gn_stats_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ mean,
                float* __restrict__ rstd, float* __restrict__ partial,
                int* __restrict__ tickets, int n_vec, int per, float eps) {
  __shared__ float red[kStatThreads / 32];
  __shared__ int is_last;
  const int bg = blockIdx.y, split = blockIdx.x, splits = gridDim.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x) + (size_t)bg * n_vec;
  const int v0 = split * per, v1 = min(v0 + per, n_vec);
  const float cnt = 8.f * (float)(v1 - v0);

  float s = 0.f;
  for (int i = v0 + threadIdx.x; i < v1; i += kStatThreads) {
    float f[8];
    unpack8(xv[i], f);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += f[j];
  }
  const float mu = block_sum(s, red) / cnt;
  float m2 = 0.f;
  for (int i = v0 + threadIdx.x; i < v1; i += kStatThreads) {
    float f[8];
    unpack8(xv[i], f);
#pragma unroll
    for (int j = 0; j < 8; ++j) m2 += (f[j] - mu) * (f[j] - mu);
  }
  m2 = block_sum(m2, red);

  if (splits == 1) {
    if (threadIdx.x == 0) {
      mean[bg] = mu;
      rstd[bg] = rsqrtf(m2 / cnt + eps);
    }
    return;
  }
  if (threadIdx.x == 0) {
    volatile float* mine = partial + ((size_t)bg * splits + split) * 2;
    mine[0] = mu;
    mine[1] = m2;
    __threadfence();
    is_last = atomicAdd(&tickets[bg], 1) == splits - 1;
  }
  __syncthreads();
  if (!is_last || threadIdx.x != 0) return;
  __threadfence();
  // merge the pieces in index order: n_ab = n_a + n_b,
  // mean_ab = mean_a + d * n_b / n_ab, M2_ab = M2_a + M2_b + d^2 n_a n_b / n_ab
  const volatile float* p = partial + (size_t)bg * splits * 2;
  float n_a = 0.f, mean_a = 0.f, m2_a = 0.f;
  for (int i = 0; i < splits; ++i) {
    const float n_b = 8.f * (float)(min((i + 1) * per, n_vec) - i * per);
    const float d = p[2 * i] - mean_a, n_ab = n_a + n_b;
    mean_a += d * (n_b / n_ab);
    m2_a += p[2 * i + 1] + d * d * (n_a * n_b / n_ab);
    n_a = n_ab;
  }
  mean[bg] = mean_a;
  rstd[bg] = rsqrtf(m2_a / n_a + eps);
  tickets[bg] = 0;
}

// One thread per 8 contiguous elements (H*W is a multiple of 8, so a vector
// lies in one channel).
__global__ void __launch_bounds__(256)
gn_silu_apply_kernel(const __nv_bfloat16* __restrict__ x,
                     const void* __restrict__ gamma,
                     const void* __restrict__ beta, int affine_bf16,
                     const float* __restrict__ mean,
                     const float* __restrict__ rstd,
                     __nv_bfloat16* __restrict__ y, long long total_vec,
                     int hw_vec, int channels, int cpg) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total_vec) return;
  const long long bc = i / hw_vec;  // b * C + c
  const int c = (int)(bc % channels);
  const int bg = (int)(bc / channels) * (channels / cpg) + c / cpg;
  const float a = ld_affine(gamma, c, affine_bf16) * rstd[bg];
  const float d = ld_affine(beta, c, affine_bf16) - mean[bg] * a;
  float f[8];
  unpack8(reinterpret_cast<const uint4*>(x)[i], f);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float u = fmaf(f[2 * j], a, d), w = fmaf(f[2 * j + 1], a, d);
    o[j] = __floats2bfloat162_rn(u / (1.f + __expf(-u)), w / (1.f + __expf(-w)));
  }
  reinterpret_cast<uint4*>(y)[i] = out;
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream`, allocates
// nothing, and returns cudaGetLastError() (0 = launched).

// x (B*G groups of n_elem contiguous bf16, n_elem % 8 == 0) -> mean, rstd
// (B*G) fp32.  With splits > 1: partial holds B*G*splits*2 floats and tickets
// B*G zeroed ints (left zeroed).
extern "C" int gn_stats_bf16(const void* x, void* mean, void* rstd,
                             void* partial, void* tickets, int n_groups,
                             int n_elem, int splits, float eps, void* stream) {
  if (n_groups <= 0 || n_elem <= 0 || n_elem % 8 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_vec = n_elem / 8;
  const int per = (n_vec + splits - 1) / splits;
  if ((long long)per * (splits - 1) >= n_vec)  // an empty last piece
    return (int)cudaErrorInvalidValue;
  gn_stats_kernel<<<dim3(splits, n_groups), kStatThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(mean),
      static_cast<float*>(rstd), static_cast<float*>(partial),
      static_cast<int*>(tickets), n_vec, per, eps);
  return (int)cudaGetLastError();
}

// x, y (B, C, HW) bf16 with HW % 8 == 0; gamma, beta (C) bf16 or fp32.
extern "C" int gn_silu_apply_bf16(const void* x, const void* gamma,
                                  const void* beta, int affine_bf16,
                                  const void* mean, const void* rstd, void* y,
                                  int batch, int channels, int hw, int groups,
                                  void* stream) {
  if (batch <= 0 || channels <= 0 || hw <= 0 || hw % 8 || groups <= 0 ||
      channels % groups)
    return (int)cudaErrorInvalidValue;
  const long long total_vec = (long long)batch * channels * (hw / 8);
  const int threads = 256;
  const long long blocks = (total_vec + threads - 1) / threads;
  gn_silu_apply_kernel<<<(unsigned)blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), gamma, beta, affine_bf16,
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<__nv_bfloat16*>(y), total_vec, hw / 8, channels,
      channels / groups);
  return (int)cudaGetLastError();
}
