// Fused GroupNorm + SiLU + 3x3 convolution (padding 1) for Hopper (sm_90a),
// NCHW bf16 in and out, fp32 accumulation.
//
// Replaces the Pallas TPU kernel `_kernel` of diffute_tpu/ops/conv_fused.py
// (`_fwd_impl`'s pl.pallas_call).  It computes the same function, not the
// same grid.  The Pallas kernel keeps one sample's zero-padded normalised
// slab (H+2, W+2, C) in VMEM, recomputes the GroupNorm statistics in every
// Cout tile and runs nine shifted whole-slab matmuls; a thread block has
// 227 KB, so here the statistics come once from gn_stats_bf16 (groupnorm.cu)
// and the convolution is an implicit GEMM over small tiles:
//
//   out[b, co, p] = bias[co] + sum_{tap, ci} w[co, tap, ci] * n[b, ci, p + tap]
//   n = bf16(silu(x * a_c + d_c)) inside the image and 0 outside it
//
// (the zero padding is of the NORMALISED tensor: an out-of-image tap adds 0,
// not silu(d_c)).  GEMM view: pixels x Cout x 9*Cin.  It is fed transposed,
// D[co][pixel] = W[co][k] * N[k][pixel]: in NCHW a channel's pixels are
// contiguous, so the activations are the operand that is contiguous along
// the non-contracted axis (read with ldmatrix.trans, as flash_fwd.cu reads
// V), the repacked weights (one row of 9 x 16 values per output channel and
// chunk of 16 input channels) are the row-major A operand, and an
// accumulator row is one output channel whose pixels are neighbours in
// memory.  The normalised tensor never reaches device memory.
//
// What bounds it on the H100: operations, 18*Cin*Cout per pixel on the tensor
// cores (the byte bound is 4 to 100 times lower at the UNet's shapes), and in
// this cut the SiLU of the staging pass beside them: every block of output
// channels re-normalises its input patch, so each normalised element feeds
// only 128 * 18 tensor FLOPs.  What the design does about it:
//   - a block owns 128 output channels (4 warps x 32) x 64 pixels (4 rows x
//     16 columns; 8 x 8 when W is not a multiple of 16) and walks Cin in
//     chunks of 16.  Per chunk it normalises the (rows+2) x (cols+2) halo
//     patch ONCE and stores it three times, shifted by dx = -1, 0, +1
//     columns, so that every one of the nine taps is an aligned
//     ldmatrix.trans read of the same data;
//   - a 4 x 16 tile re-normalises 1.9 elements per output pixel and channel,
//     a 1 x 64 row tile would 3.75;
//   - a thread's share of the patch (at most two 8-pixel runs) is the same
//     in every chunk, so its addresses are computed once, and the next
//     chunk's x is loaded into registers before this chunk's products, which
//     hide the loads' latency;
//   - every pixel tile reads its Cout tile's weights again from L2, so they
//     are packed once as (Cout tile, chunk, 128, 9, 16): a block's weights
//     for one chunk are one contiguous 36,864-byte run that arrives by
//     cp.async in whole 128-byte lines while the block normalises (read from
//     a (Cout, 9, Cin) layout they would be 1,152 separate 32-byte pieces);
//   - 48 KB of shared memory let four blocks share an SM, so one block's
//     mma.sync stream overlaps another's staging;
//   - where the grid would leave the card empty (8^2: 10 blocks) Cin is split
//     over blockIdx.z into fp32 partial sums, added in a fixed order by a
//     second kernel (no float atomics: the result is deterministic).
// wgmma and a staging pass shared between Cout tiles are left for later work.

#include "flash_common.cuh"

namespace {

using flash::cp_async_16;
using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::ldmatrix_x4;
using flash::ldmatrix_x4_trans;
using flash::mma_bf16;
using flash::pack_bf16;
using flash::smem_u32;

constexpr int kThreads = 128;
constexpr int kCo = 128;     // output channels per block (4 warps x 32)
constexpr int kPix = 64;     // output pixels per block
constexpr int kCk = 16;      // input channels per chunk (one mma k-step a tap)
constexpr int kWRow = 9 * kCk + 8;  // padded weight row (152 el = 19 chunks)
constexpr int kMaxChStride = 104;   // (4+2)*16 + 8 and (8+2)*8 + 8 fit
constexpr int kItems = 2;    // 8-pixel runs of the patch per thread and chunk

struct Geom {
  int batch, cin, cout, h, w;
  int tw_shift;   // tile width 16 or 8 columns = 1 << tw_shift
  int tiles_x, tiles_y;
  int ch_stride;  // elements per channel of one shifted copy, odd in 16 B
  int cpg, groups;
  int chunks_per_split;
};

__device__ __forceinline__ float ld_param(const void* p, int i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ uint32_t norm_silu_bits(float x, float a, float d) {
  const float u = fmaf(x, a, d);
  return (uint32_t)__bfloat16_as_ushort(
      __float2bfloat16_rn(__fdividef(u, 1.f + __expf(-u))));
}

// One 8-pixel run of the halo patch: where it comes from in a channel
// plane of x, where it goes in a shifted copy, and what lies outside.
struct Item {
  int cl;        // channel within the chunk, -1: no item
  int x_off;     // offset of the run's first pixel in the channel plane
  int s_off;     // offset in one shifted copy of the patch
  bool row_ok, left_ok, right_ok;
};

// The raw x of one item: the run and its two neighbours.
struct Raw {
  uint4 v;
  __nv_bfloat16 left, right;
};

__global__ void __launch_bounds__(kThreads)
gn_silu_conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ mean,
                       const float* __restrict__ rstd,
                       const void* __restrict__ gamma,
                       const void* __restrict__ beta, int gn_bf16,
                       const __nv_bfloat16* __restrict__ wp,
                       const void* __restrict__ bias, int bias_bf16,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ partial, Geom gm) {
  // three column-shifted copies of the normalised halo patch: [dx][ci][r][c]
  __shared__ __align__(128) __nv_bfloat16 n_s[3 * kCk * kMaxChStride];
  __shared__ __align__(128) __nv_bfloat16 w_s[kCo * kWRow];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3, mi = lane >> 3, mr = lane & 7;
  const int tw = 1 << gm.tw_shift, tr = kPix >> gm.tw_shift;
  const int r2 = tr + 2, g8 = tw >> 3;

  int tile = blockIdx.x;
  const int tx = tile % gm.tiles_x;
  tile /= gm.tiles_x;
  const int ty = tile % gm.tiles_y, b = tile / gm.tiles_y;
  const int row0 = ty * tr, col0 = tx * tw;
  const int co0 = blockIdx.y * kCo;
  const int n_chunks = gm.cin / kCk;
  const int chunk0 = blockIdx.z * gm.chunks_per_split;
  const int chunk1 = min(chunk0 + gm.chunks_per_split, n_chunks);
  const size_t plane = (size_t)gm.h * gm.w;

  // ---- this thread's runs of the patch, the same in every chunk
  Item items[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int id = threadIdx.x + i * kThreads;
    Item& it = items[i];
    it.cl = -1;
    if (id < kCk * r2 * g8) {
      const int cg = id % g8, rr = (id / g8) % r2;
      const int row = row0 + rr - 1, col = col0 + cg * 8;
      it.cl = id / (g8 * r2);
      it.row_ok = row >= 0 && row < gm.h;
      it.left_ok = it.row_ok && col > 0;
      it.right_ok = it.row_ok && col + 8 < gm.w;
      it.x_off = it.cl * (int)plane + row * gm.w + col;
      it.s_off = it.cl * gm.ch_stride + rr * tw + cg * 8;
    }
  }

  auto load_raw = [&](Raw (&raw)[kItems], int chunk) {
    const __nv_bfloat16* xb = x + ((size_t)b * gm.cin + chunk * kCk) * plane;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const Item& it = items[i];
      if (it.cl < 0 || !it.row_ok) continue;
      const __nv_bfloat16* src = xb + it.x_off;
      raw[i].v = *reinterpret_cast<const uint4*>(src);
      if (it.left_ok) raw[i].left = src[-1];
      if (it.right_ok) raw[i].right = src[8];
    }
  };

  float acc[2][8][4];
  flash::zero_acc(acc[0]);
  flash::zero_acc(acc[1]);

  Raw raw[kItems];
  if (chunk0 < chunk1) load_raw(raw, chunk0);

  for (int chunk = chunk0; chunk < chunk1; ++chunk) {
    const int ci0 = chunk * kCk;

    // ---- weights of this chunk: w_s[co][tap*16 + ci], 2 x 16 B per (co, tap)
    // (one contiguous 36,864-byte run of the packed weights)
    const __nv_bfloat16* wc =
        wp + ((size_t)blockIdx.y * n_chunks + chunk) * (kCo * 9 * kCk);
    for (int i = threadIdx.x; i < kCo * 18; i += kThreads) {
      const int co_l = i / 18, j = i % 18;
      cp_async_16(smem_u32(w_s + co_l * kWRow + j * 8), wc + i * 8, 16);
    }
    cp_async_commit();

    // ---- normalise the halo patch once, store it shifted by dx = 0, 1, 2:
    // copy dx holds, at (r, c), the normalised pixel (row0 + r - 1,
    // col0 + c + dx - 1), zero outside the image
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const Item& it = items[i];
      if (it.cl < 0) continue;
      uint32_t e[10];  // bf16 bits of columns col-1 .. col+8
#pragma unroll
      for (int j = 0; j < 10; ++j) e[j] = 0u;
      if (it.row_ok) {
        const int ci = ci0 + it.cl, bg = b * gm.groups + ci / gm.cpg;
        const float a = ld_param(gamma, ci, gn_bf16) * rstd[bg];
        const float d = ld_param(beta, ci, gn_bf16) - mean[bg] * a;
        const __nv_bfloat162* h2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw[i].v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h2[j]);
          e[1 + 2 * j] = norm_silu_bits(f.x, a, d);
          e[2 + 2 * j] = norm_silu_bits(f.y, a, d);
        }
        if (it.left_ok)
          e[0] = norm_silu_bits(__bfloat162float(raw[i].left), a, d);
        if (it.right_ok)
          e[9] = norm_silu_bits(__bfloat162float(raw[i].right), a, d);
      }
      __nv_bfloat16* dst = n_s + it.s_off;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        uint4 o;
        o.x = e[dx] | (e[dx + 1] << 16);
        o.y = e[dx + 2] | (e[dx + 3] << 16);
        o.z = e[dx + 4] | (e[dx + 5] << 16);
        o.w = e[dx + 6] | (e[dx + 7] << 16);
        *reinterpret_cast<uint4*>(dst + dx * kCk * gm.ch_stride) = o;
      }
    }
    // the next chunk's x, in flight while this chunk's products run
    if (chunk + 1 < chunk1) load_raw(raw, chunk + 1);
    cp_async_wait<0>();
    __syncthreads();

    // ---- nine taps, one k-step of 16 input channels each
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      uint32_t a[2][4];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
        ldmatrix_x4(a[mf][0], a[mf][1], a[mf][2], a[mf][3],
                    smem_u32(w_s + (warp * 32 + mf * 16 + (mi & 1) * 8 + mr) *
                                       kWRow + tap * kCk + (mi >> 1) * 8));
      const __nv_bfloat16* ns =
          n_s + (dx * kCk + (mi & 1) * 8 + mr) * gm.ch_stride + dy * tw;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        // transposed 8x8 matrices (k, n), (k+8, n), (k, n+8), (k+8, n+8);
        // n is 8 neighbouring pixels of one tile row
        const int pn = p * 16 + (mi >> 1) * 8;
        const int r = pn >> gm.tw_shift, c = pn & (tw - 1);
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3, smem_u32(ns + r * tw + c));
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) {
          mma_bf16(acc[mf][2 * p], a[mf], b0, b1);
          mma_bf16(acc[mf][2 * p + 1], a[mf], b2, b3);
        }
      }
    }
    __syncthreads();  // the next chunk overwrites both tiles
  }

  // ---- epilogue: rows of acc are output channels, columns pixels
#pragma unroll
  for (int mh = 0; mh < 4; ++mh) {
    const int mf = mh >> 1, hi = mh & 1;
    const int co = co0 + warp * 32 + mf * 16 + g + hi * 8;
    if (co >= gm.cout) continue;
    const float bv = partial ? 0.f : ld_param(bias, co, bias_bf16);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int pn = n * 8 + tig * 2;
      const int row = row0 + (pn >> gm.tw_shift), col = col0 + (pn & (tw - 1));
      if (row >= gm.h) continue;
      const size_t off = ((size_t)b * gm.cout + co) * plane + (size_t)row * gm.w + col;
      const float v0 = acc[mf][n][2 * hi] + bv, v1 = acc[mf][n][2 * hi + 1] + bv;
      if (partial) {
        const size_t z_off = (size_t)blockIdx.z * gm.batch * gm.cout * plane;
        *reinterpret_cast<float2*>(partial + z_off + off) = make_float2(v0, v1);
      } else {
        *reinterpret_cast<uint32_t*>(out + off) = pack_bf16(v0, v1);
      }
    }
  }
}

// out = bf16(sum_z partial[z] + bias), the splits added in index order.
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ partial,
                     const void* __restrict__ bias, int bias_bf16,
                     __nv_bfloat16* __restrict__ out, long long total_pairs,
                     long long split_stride, int splits, int plane, int cout) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total_pairs) return;
  const float2* p = reinterpret_cast<const float2*>(partial) + i;
  float2 s = p[0];
  for (int z = 1; z < splits; ++z) {
    const float2 t = p[(size_t)z * (split_stride / 2)];
    s.x += t.x;
    s.y += t.y;
  }
  const float bv = ld_param(bias, (int)((2 * i / plane) % cout), bias_bf16);
  reinterpret_cast<uint32_t*>(out)[i] = pack_bf16(s.x + bv, s.y + bv);
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream`, allocates nothing,
// and returns cudaGetLastError() (0 = launched).
//   x (B, Cin, H, W) bf16; mean, rstd (B, groups) fp32; gamma, beta (Cin) and
//   bias (Cout) bf16 or fp32; wp (ceil(Cout/128), Cin/16, 128, 9, 16) bf16:
//   [t][c][o][3*ky + kx][i] = w[128*t + o][16*c + i][ky][kx], 0 past Cout;
//   out (B, Cout, H, W) bf16.  Cin % 16 == 0, W % 8 == 0.
//   splits > 1: Cin's chunks are split over `splits` grid planes into
//   partial (splits, B, Cout, H, W) fp32, then reduced into out.
extern "C" int gn_silu_conv3x3_bf16(const void* x, const void* mean,
                                    const void* rstd, const void* gamma,
                                    const void* beta, int gn_bf16,
                                    const void* wp, const void* bias,
                                    int bias_bf16, void* out, void* partial,
                                    int batch, int cin, int cout, int h, int w,
                                    int groups, int splits, void* stream) {
  if (batch <= 0 || cin <= 0 || cout <= 0 || h <= 0 || w <= 0 || cin % kCk ||
      w % 8 || groups <= 0 || cin % groups || splits <= 0 ||
      (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  Geom gm;
  gm.batch = batch; gm.cin = cin; gm.cout = cout; gm.h = h; gm.w = w;
  gm.tw_shift = (w % 16 == 0) ? 4 : 3;
  const int tw = 1 << gm.tw_shift, tr = kPix / tw;
  gm.tiles_x = w / tw;
  gm.tiles_y = (h + tr - 1) / tr;
  gm.ch_stride = (((tr + 2) * tw / 8) | 1) * 8;
  gm.cpg = cin / groups;
  gm.groups = groups;
  const int n_chunks = cin / kCk;
  gm.chunks_per_split = (n_chunks + splits - 1) / splits;
  if (gm.ch_stride > kMaxChStride ||
      (long long)gm.chunks_per_split * (splits - 1) >= n_chunks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(batch * gm.tiles_y * gm.tiles_x, (cout + kCo - 1) / kCo, splits);
  gn_silu_conv3x3_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), gamma, beta, gn_bf16,
      static_cast<const __nv_bfloat16*>(wp), bias, bias_bf16,
      static_cast<__nv_bfloat16*>(out),
      splits > 1 ? static_cast<float*>(partial) : nullptr, gm);
  int err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  const long long total = (long long)batch * cout * h * w;  // even: w % 8 == 0
  const long long pairs = total / 2;
  splitk_reduce_kernel<<<(unsigned)((pairs + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(partial), bias, bias_bf16,
      static_cast<__nv_bfloat16*>(out), pairs, total, splits, h * w, cout);
  return (int)cudaGetLastError();
}
