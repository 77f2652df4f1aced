// Fused GroupNorm + SiLU + 3x3 convolution (padding 1) on fp32 inputs for
// Hopper (sm_90a): NCHW fp32 x and out, OIHW fp32 weights, fp32 sums.
//
// Replaces the Pallas TPU kernel `_kernel` of diffute_tpu/ops/conv_fused.py
// (`_fwd_impl`'s pl.pallas_call) on fp32 inputs.  The bf16 kernel
// (conv_fused.cu) stays as it is.  It computes the same function:
//
//   out[b, co, p] = bias[co] + sum_{ci, tap} w[co, ci, tap] * n[b, ci, p + tap]
//   n = silu((x - mean_g) * (rstd_g * gamma_c) + beta_c) inside the image,
//       0 outside it
//
// held in fp32 (the TPU kernel keeps its normalised slab in x's dtype).  The
// zero padding is of the NORMALISED tensor: an out-of-image tap adds 0, not
// silu(d_c).  The statistics come from gn_stats_fp32 (groupnorm.cu), launched
// before this kernel; the apply is centred on the mean, as gn_silu_fp32's
// is: folding the mean into d_c = beta_c - mean * a_c costs an ulp of mean *
// a_c, which an fp32 output held to relative L2 1e-5 would show.
//
// GEMM view: an implicit GEMM with M = Cout (64 a block), N = output pixels
// (an 8 x 8 tile a block), K = 9 * Cin walked in chunks of 8 input channels.
// A chunk's weights for one output channel are w[co, 8c .. 8c + 7, :, :], 72
// contiguous floats of the OIHW tensor as the layer keeps it (16-byte
// aligned when Cin % 8 == 0), so the kernel adds no repacked copy to the
// resident bytes.  Inside a chunk the products run tap by tap, each tap one
// k step of 8 channels.
//
// Precision.  The port's fp32 paths turn TF32 off, so the kernel is accurate
// to fp32, not to TF32 (held to relative L2 1e-5 of the plain fp32 version,
// chip_smoke.py phase 3h):
//   * 3xTF32 on mma.sync.m16n8k8.tf32: n = n_hi + n_lo and w = w_hi + w_lo
//     (hi = tf32(v) by cvt.rna, lo = tf32(v - hi)), and n w as n_lo w_hi +
//     n_hi w_lo + n_hi w_hi, the small terms first.  TF32 alone (n_hi w_hi)
//     reads about 3e-4 from fp32 and fails the bound;
//   * the tensor cores' fp32 accumulation rounds toward zero, so no
//     accumulator in them spans more than one kernel row of a chunk
//     (kTapsPerSum = 3 taps, 9 products from zero); each row's sum is added
//     to the running fp32 sum by an ordinary add.  Measured on an H100
//     (tools/conv_fp32_accuracy.py): sums of the chunk's 9 taps read
//     4.8e-7 to 5.7e-7 from fp64, of 3 taps 2.5e-7 to 5.1e-7 in the same
//     time, of 1 tap 2.4e-7 to 8.3e-7 and 12-22% slower; cuDNN's fp32
//     convolution (the plain version) reads 9.8e-7 to 2.6e-6.
//
// What bounds it on the H100: operations, 18 * Cin * Cout per output pixel
// at the 3xTF32 rate (a third of the 494.7 TFLOP/s TF32 peak); the bytes of
// x, w and out are 10 to 100 times below that at the UNet's shapes.  This
// first cut is simple:
//   - a block of 4 warps owns 64 output channels x 8 x 8 pixels, each warp
//     32 channels x 4 pixel rows (2 x 4 mma tiles of 16 x 8), and walks its
//     chunks through a three-stage cp.async ring: the chunk's 64 x 72 weights
//     (16-byte copies, rows of 76 floats, so the fragments' loads are free of
//     bank conflicts) and the raw 8 x 10 x 10 halo patch of x (16-byte copies
//     of each row's 8 inner pixels, 4-byte copies of its two halo pixels);
//   - per chunk the block normalises the patch once into two shared tiles,
//     n_hi and n_lo (planes of 104 floats: the four channels a fragment
//     reads fall in distinct banks), then every warp reads its B fragments
//     there, already split, and splits its A fragments in registers;
//   - where the grid would leave the card's SMs empty (20 blocks at 8^2 and
//     Cout 1280) Cin's chunks are split over blockIdx.z into fp32 partial
//     sums, added in index order by a second kernel: no float atomics, so
//     two launches give the same bits.
// TMA, wgmma (tf32 takes only K-major operands in shared memory; the patch's
// taps are not) and a producer warp are left to a redesign (ROADMAP.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_sm90.cuh"

namespace {

using namespace tf32_sm90;

constexpr int kCo = 64;              // output channels a block
constexpr int kTile = 8;             // output pixels: kTile x kTile a block
constexpr int kCk = 8;               // input channels a chunk
constexpr int kTaps = 9;
constexpr int kPatch = kTile + 2;    // the halo patch's rows and columns
constexpr int kAStride = 76;         // floats a weight row: 72 + 4
constexpr int kRawStride = 16;       // floats a raw patch row: halo at 3, 12
constexpr int kPlane = 104;          // floats a normalised channel plane
constexpr int kStages = 3;
// taps whose products one tensor-core accumulator sums from zero before the
// sum is added to the running fp32 sum (the chunk's 9 at most)
constexpr int kTapsPerSum = 3;
constexpr int kThreads = 128;        // 4 warps: 2 along Cout x 2 along rows
constexpr int kPatchElems = kCk * kPatch * kPatch;  // 800

struct Stage {
  float a[kCo * kAStride];                  // [co][c * 9 + tap]
  float raw[kCk * kPatch * kRawStride];     // [c][patch row][3 + patch col]
  float4 par[kCk];                          // (mean, rstd * gamma, beta)
};

struct Smem {
  Stage st[kStages];
  uint32_t n_hi[kCk * kPlane];              // [c][patch row * 10 + col]
  uint32_t n_lo[kCk * kPlane];
};

struct Params {
  const float* x;
  const float* w;
  const float* mean;
  const float* rstd;
  const void* gamma;
  const void* beta;
  const void* bias;
  float* out;
  float* partial;
  int gn_bf16, bias_bf16;
  int batch, cin, cout, h, w_, groups, cpg;
  int tiles_x, tiles_y, chunks_per_split;
};

__device__ __forceinline__ float ld_param(const void* p, int i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// Chunk `chunk`'s weights, raw patch and GroupNorm parameters into stage s.
__device__ __forceinline__ void load_stage(const Params& p, Stage& s,
                                           int chunk, int b, int row0,
                                           int col0, int co0) {
  const int tid = threadIdx.x;
  // weights: 64 rows of 18 16-byte pieces, zero past Cout
  for (int idx = tid; idx < kCo * 18; idx += kThreads) {
    const int r = idx / 18, q = idx - r * 18;
    const bool ok = co0 + r < p.cout;
    const float* src =
        ok ? p.w + ((size_t)(co0 + r) * p.cin + chunk * kCk) * kTaps + 4 * q
           : p.w;
    cp_async_16(smem_u32(&s.a[r * kAStride + 4 * q]), src, ok ? 16 : 0);
  }
  // raw x: 8 channels x 10 patch rows, each its left halo pixel, two 16-byte
  // runs of the 8 inner pixels and its right halo pixel; zero outside the
  // image (the normalisation writes 0 there whatever it reads)
  for (int idx = tid; idx < kCk * kPatch * 4; idx += kThreads) {
    const int piece = idx & 3, row = idx >> 2;
    const int c = row / kPatch, pr = row - c * kPatch;
    const int y = row0 - 1 + pr;
    const bool y_ok = (unsigned)y < (unsigned)p.h;
    const float* line = p.x + (((size_t)b * p.cin + chunk * kCk + c) * p.h +
                               (y_ok ? y : 0)) * p.w_;
    float* dst = &s.raw[row * kRawStride];
    if (piece == 0) {
      const bool ok = y_ok && col0 > 0;
      cp_async_4(smem_u32(dst + 3), ok ? line + col0 - 1 : p.x, ok ? 4 : 0);
    } else if (piece == 3) {
      const bool ok = y_ok && col0 + kTile < p.w_;
      cp_async_4(smem_u32(dst + 4 + kTile), ok ? line + col0 + kTile : p.x,
                 ok ? 4 : 0);
    } else {
      const int half = piece - 1;
      cp_async_16(smem_u32(dst + 4 + 4 * half),
                  y_ok ? line + col0 + 4 * half : p.x, y_ok ? 16 : 0);
    }
  }
  if (tid < kCk) {
    const int ch = chunk * kCk + tid;
    const int g = b * p.groups + ch / p.cpg;
    s.par[tid] = make_float4(p.mean[g],
                             p.rstd[g] * ld_param(p.gamma, ch, p.gn_bf16),
                             ld_param(p.beta, ch, p.gn_bf16), 0.f);
  }
}

// The block's 64 output channels x 8 x 8 pixels over its split of Cin's
// chunks.  grid (B * tiles_y * tiles_x, ceil(Cout / 64), splits).
__global__ void __launch_bounds__(kThreads, 2)
    gn_silu_conv3x3_fp32_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;  // 32 channels, 4 pixel rows
  int tile = blockIdx.x;
  const int tx = tile % p.tiles_x;
  tile /= p.tiles_x;
  const int ty = tile % p.tiles_y, b = tile / p.tiles_y;
  const int row0 = ty * kTile, col0 = tx * kTile;
  const int co0 = blockIdx.y * kCo;
  const int n_all = p.cin / kCk;
  const int chunk0 = blockIdx.z * p.chunks_per_split;
  const int n_chunks = min(p.chunks_per_split, n_all - chunk0);

  float acc[2][4][4];  // [m tile][n tile][fragment]: the running fp32 sum
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks)
      load_stage(p, sm.st[s], chunk0 + s, b, row0, col0, co0);
    cp_async_commit();
  }

  for (int i = 0; i < n_chunks; ++i) {
    cp_async_wait<kStages - 2>();
    // chunk i has landed; every warp is done with the previous chunk's
    // normalised tiles and with stage (i - 1) % kStages
    __syncthreads();
    if (i + kStages - 1 < n_chunks)
      load_stage(p, sm.st[(i + kStages - 1) % kStages], chunk0 + i + kStages - 1,
                 b, row0, col0, co0);
    cp_async_commit();

    const Stage& s = sm.st[i % kStages];
    // normalise the halo patch once, split into TF32 hi and lo
    for (int e = tid; e < kPatchElems; e += kThreads) {
      const int c = e / (kPatch * kPatch), rem = e - c * kPatch * kPatch;
      const int pr = rem / kPatch, pc = rem - pr * kPatch;
      const int y = row0 - 1 + pr, xc = col0 - 1 + pc;
      float n = 0.f;
      if ((unsigned)y < (unsigned)p.h && (unsigned)xc < (unsigned)p.w_) {
        const float4 q = s.par[c];
        const float u = fmaf(s.raw[(c * kPatch + pr) * kRawStride + 3 + pc] -
                                 q.x,
                             q.y, q.z);
        n = __fdividef(u, 1.f + __expf(-u));
      }
      uint32_t hi, lo;
      split(n, hi, lo);
      sm.n_hi[c * kPlane + rem] = hi;
      sm.n_lo[c * kPlane + rem] = lo;
    }
    __syncthreads();

    float part[2][4][4];  // kTapsPerSum taps' sum, from zero
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      if (tap % kTapsPerSum == 0) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mi][j][e] = 0.f;
      }
      // B: channel t (k = t) and t + 4 (k = t + 4) at pixel (row, g) shifted
      // by the tap
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int off = (wn * 4 + j + ky) * kPatch + g + kx;
        bh[j][0] = sm.n_hi[t * kPlane + off];
        bh[j][1] = sm.n_hi[(t + 4) * kPlane + off];
        bl[j][0] = sm.n_lo[t * kPlane + off];
        bl[j][1] = sm.n_lo[(t + 4) * kPlane + off];
      }
      // A: output channels g and g + 8 of the m tile, the same channels
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* r0 = &s.a[(wm * 32 + mi * 16 + g) * kAStride + tap];
        const float* r1 = r0 + 8 * kAStride;
        split(r0[t * kTaps], ah[mi][0], al[mi][0]);
        split(r1[t * kTaps], ah[mi][1], al[mi][1]);
        split(r0[(t + 4) * kTaps], ah[mi][2], al[mi][2]);
        split(r1[(t + 4) * kTaps], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32(part[mi][j], al[mi], bh[j][0], bh[j][1]);
          mma_tf32(part[mi][j], ah[mi], bl[j][0], bl[j][1]);
          mma_tf32(part[mi][j], ah[mi], bh[j][0], bh[j][1]);
        }
      if (tap % kTapsPerSum == kTapsPerSum - 1 || tap == kTaps - 1) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][j][e] += part[mi][j][e];
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: fragment (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
  // of each tile; with a split the partial sum, else the sum plus the bias
  const size_t plane = (size_t)p.h * p.w_;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int co = co0 + wm * 32 + mi * 16 + g + 8 * hf;
      if (co >= p.cout) continue;
      const float bv = p.partial ? 0.f : ld_param(p.bias, co, p.bias_bf16);
      const size_t base = ((size_t)b * p.cout + co) * plane;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int y = row0 + wn * 4 + j;
        if (y >= p.h) continue;
        const size_t off = base + (size_t)y * p.w_ + col0 + 2 * t;
        const float2 v = make_float2(acc[mi][j][2 * hf] + bv,
                                     acc[mi][j][2 * hf + 1] + bv);
        if (p.partial) {
          const size_t z = (size_t)blockIdx.z * p.batch * p.cout * plane;
          *reinterpret_cast<float2*>(p.partial + z + off) = v;
        } else {
          *reinterpret_cast<float2*>(p.out + off) = v;
        }
      }
    }
}

// out = sum_z partial[z] + bias, the splits added in index order.
__global__ void __launch_bounds__(256)
    splitk_reduce_fp32_kernel(const float4* __restrict__ partial,
                              const void* __restrict__ bias, int bias_bf16,
                              float4* __restrict__ out, long long n4,
                              long long split_stride4, int splits, int plane,
                              int cout) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 s = partial[i];
  for (int z = 1; z < splits; ++z) {
    const float4 v = partial[(size_t)z * split_stride4 + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const float bv = ld_param(bias, (int)((4 * i / plane) % cout), bias_bf16);
  out[i] = make_float4(s.x + bv, s.y + bv, s.z + bv, s.w + bv);
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream`, allocates nothing,
// and returns a CUDA error code (0 = launched).
//   x (B, Cin, H, W) fp32, 16-byte aligned; mean, rstd (B, groups) fp32
//   (gn_stats_fp32); gamma, beta (Cin) and bias (Cout) bf16 or fp32; w
//   (Cout, Cin, 3, 3) fp32, 16-byte aligned, as the layer keeps it; out
//   (B, Cout, H, W) fp32.  Cin % 8 == 0, W % 8 == 0.
//   splits > 1: Cin's chunks of 8 are split over `splits` grid planes into
//   partial (splits, B, Cout, H, W) fp32 (16-byte aligned), then reduced
//   into out; no split may be empty.
extern "C" int gn_silu_conv3x3_fp32(const void* x, const void* mean,
                                    const void* rstd, const void* gamma,
                                    const void* beta, int gn_bf16,
                                    const void* w, const void* bias,
                                    int bias_bf16, void* out, void* partial,
                                    int batch, int cin, int cout, int h, int w_,
                                    int groups, int splits, void* stream) {
  if (batch <= 0 || cin <= 0 || cout <= 0 || h <= 0 || w_ <= 0 ||
      cin % kCk || w_ % kTile || groups <= 0 || cin % groups || splits <= 0 ||
      (cout + kCo - 1) / kCo > 65535 || splits > 65535 ||
      (splits > 1 && partial == nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(partial) % 16)
    return (int)cudaErrorInvalidValue;
  Params p;
  const int n_chunks = cin / kCk;
  p.chunks_per_split = (n_chunks + splits - 1) / splits;
  if ((long long)p.chunks_per_split * (splits - 1) >= n_chunks)
    return (int)cudaErrorInvalidValue;  // an empty last split
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.mean = static_cast<const float*>(mean);
  p.rstd = static_cast<const float*>(rstd);
  p.gamma = gamma;
  p.beta = beta;
  p.bias = bias;
  p.out = static_cast<float*>(out);
  p.partial = splits > 1 ? static_cast<float*>(partial) : nullptr;
  p.gn_bf16 = gn_bf16;
  p.bias_bf16 = bias_bf16;
  p.batch = batch; p.cin = cin; p.cout = cout; p.h = h; p.w_ = w_;
  p.groups = groups;
  p.cpg = cin / groups;
  p.tiles_x = w_ / kTile;
  p.tiles_y = (h + kTile - 1) / kTile;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gn_silu_conv3x3_fp32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(batch * p.tiles_y * p.tiles_x, (cout + kCo - 1) / kCo,
                  splits);
  gn_silu_conv3x3_fp32_kernel<<<grid, kThreads, sizeof(Smem), st>>>(p);
  int err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  const long long n4 = (long long)batch * cout * h * w_ / 4;  // w_ % 8 == 0
  splitk_reduce_fp32_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, st>>>(
      static_cast<const float4*>(partial), bias, bias_bf16,
      static_cast<float4*>(out), n4, n4, splits, h * w_, cout);
  return (int)cudaGetLastError();
}
