// Flash attention on fp32 inputs for Hopper (sm_90a): the forward, the
// deferred-softmax forward, the dq kernel (which also writes delta) and the
// dk/dv kernel, fp32 in and out, fp32 LSE and delta.  One source, templated
// on the width (`Fp32<D, R>`), instantiated at head_dim 64 (the UNet's
// heads), 256 (the small VAE's mid-block, `small_config`) and 512 (the SD2
// VAE's mid-block).  The bf16 kernels (flash_fwd.cu, flash_fwd_pipelined.cu,
// flash_bwd.cu, flash_wide.cu) stay as they are.
//
// Replaces the Pallas TPU kernels of diffute_tpu/ops/flash_attention.py on
// fp32 inputs: `_fwd_kernel` (pl.pallas_call in `_flash_fwd_3d`),
// `_fwd_kernel_pipelined` (in `_flash_fwd_3d_pipelined`), `_bwd_dq_kernel`
// and `_bwd_dkv_kernel` (both in `_flash_bwd_3d`).
//
// Precision contract.  The port's fp32 paths turn TF32 off, so that an fp32
// model computes what the JAX one computes on the CPU; these kernels are
// accurate to fp32, not to TF32:
//
//   * every product is 3xTF32 on mma.sync.m16n8k8.tf32: each operand x is
//     split into hi = tf32(x) (cvt.rna) and lo = tf32(x - hi), and
//     a b = lo_a hi_b + hi_a lo_b, then + hi_a hi_b, accumulated in fp32
//     (the dropped lo_a lo_b is 2^-22 of the product);
//   * the tensor cores' fp32 accumulation rounds toward zero, so no
//     accumulator in them spans more than 32 rows of one tile: each such
//     part of p v, ds k, p^T dO or ds^T q is summed from zero (12 products
//     at most) and added to o, dq, dv or dk by an fp32 add.  Carried
//     across all the keys in one accumulator, that bias alone broke the
//     bound below at 4,096 keys (python -m
//     diffute_tpu_torch.tools.flash_fp32_accuracy reads each kernel's and
//     each plain version's distance from fp64);
//   * p and ds stay fp32 and are never rounded to a narrower type, as in
//     the JAX package's fp32 kernels (`p.astype(v.dtype)` is fp32 there);
//   * the standard forward and both backward kernels work in the natural
//     domain with the exact scale after the product, as JAX's
//     `log2_domain=False` (base 2 is for non-fp32 inputs only, :352, :491):
//     s = q k^T * scale, p = exp(s - m), lse = m + log(l);
//     p = exp(s - lse), ds = p (dO v^T - delta), dq = ds k * scale,
//     dv = p^T dO, dk = ds^T q * scale;
//   * the deferred forward prescales q by fp32(scale * log2 e), rounded to
//     fp32 as `_flash_fwd_3d_pipelined` does, and works in base 2:
//     s = q' k^T, p = exp2(s - m), lse = (m + log2(l)) * ln 2.
//
// Held on the card (chip_smoke.py phase 3f) against the plain fp32 versions
// of diffute_tpu_torch/ops/flash_attention.py at the same domain: o, dq,
// dk and dv within relative L2 1e-5, the LSE within 1e-5 absolute, the same
// bits twice; the plain version with its operands rounded to TF32 (about
// 1e-3) must fail that bound.
//
//   q (B, S, H, D), k/v (B, T, H, D)  fp32, any strides that are multiples
//     of 4 elements with the last one 1 (16-byte cp.async)
//   o, dq (B, S, H, D), dk, dv (B, T, H, D) fp32 through their strides
//   lse, delta (B*H, S) fp32 contiguous; lse natural log
//
// What bounds them on the H100: operations.  fp32 accuracy takes three
// TF32 products for one, so the tensor cores' 494.7 TF32 TFLOP/s give
// 164.9 fp32 TFLOP/s at best; an exp costs a few instructions of the
// special-function unit per score against 2 D FLOPs a product.  On-chip
// room is scarce: an fp32 row takes twice a bf16 one.
//
// Layout.  Every tile of one kernel has R rows: the resident tile (q; q and
// dO; k and v) and the streamed ones (k, v; or q, dO), two stages deep
// through cp.async.  head_dim is cut into D / 64 slices of 64 columns and
// the resident tile into R / 16 groups of 16 rows; a block is one warp per
// (group, slice), and a warp keeps its 16 x 64 slice of each accumulator in
// registers (32 fp32 a thread; 64 for dk and dv).  The contraction over
// head_dim in s = q k^T (and dp = dO v^T) is split between the slices: each
// warp writes its 16 x R fp32 partial scores to shared memory and, after a
// barrier, every warp of a row group sums the D / 64 partials in slice
// order, so the slices see bit-identical scores and p (flash_wide.cu's
// scheme).  At D = 64 there is one slice and no exchange.  Shared memory
// (227 KB, 232,448 bytes, a block):
//
//   D = 64,  R = 64: 4 warps, a 16 KB tile; forward 80 KB (deferred 80 KB),
//     dq 96.5 KB, dk/dv 97 KB: two blocks an SM;
//   D = 256, R = 32: 8 warps, a 32 KB tile, 16 KB of partials; forward
//     176 KB (deferred 192 KB), dq 224.25 KB, dk/dv 224.5 KB;
//   D = 512, R = 16: 8 warps, a 32 KB tile, 8 KB of partials; forward
//     168 KB (deferred 176 KB), dq 208.1 KB, dk/dv 208.25 KB.
//
// A 32-row tile at 512 would be 64 KB: five of them (the forward) or six
// (the backward) do not fit, hence 16 rows there.
//
// Fragments.  ldmatrix moves b16 elements and cannot transpose 32-bit ones,
// so every fragment is read with 32-bit shared loads.  The tf32 m16n8k8
// A fragment holds (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
// and B (k t, n g), (k t + 4, n g), for g = lane / 4, t = lane % 4; the
// accumulator holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).  So
// that p (an accumulator) is the A operand of p v as it lies, the products
// over the streamed rows run the contraction in the order k' = 2t, 2t + 1
// for k = t, t + 4: A = (c0, c2, c1, c3), and B reads rows 2t and 2t + 1.
// A tile is [R][D] fp32 with column c of row r stored at c ^ ((r & 7) << 2):
// 16-byte chunks stay whole (cp.async), the fragments of q k^T (rows g,
// columns k0 + t) and those of p v (rows 2t + e, columns n0 + g) each hit
// 32 distinct banks.
//
// This first cut uses mma.sync and a cp.async ring; wgmma (which takes tf32
// with both operands K-major only), TMA and a producer warp are left to a
// redesign (ROADMAP.md).
//
// Ragged edges.  Rows past the end of a tile are zero-filled by cp.async.
// The forward and dq mask the kv columns past T in the last kv tile (p = 0).
// dk/dv: q rows past S are zero (so dO = 0), and their lse and delta are
// zero-filled too, which gives p = exp(0) = 1 and ds = 1 * (0 - 0) = 0:
// they contribute nothing.  Rows past the end of an output are not written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_sm90.cuh"

namespace {

using namespace tf32_sm90;

constexpr int kSlice = 64;  // head_dim columns a warp owns
constexpr float kLn2 = 0.6931471805599453f;

// The tiling of one instantiation: head_dim D, R rows a tile.
template <int D, int R>
struct Fp32 {
  static constexpr int kD = D;
  static constexpr int kRows = R;
  static constexpr int kGroups = R / 16;         // 16-row groups a tile
  static constexpr int kSlices = D / kSlice;     // 64-column slices
  static constexpr int kThreads = kGroups * kSlices * 32;
  static constexpr int kNT = R / 8;              // 8-column score tiles
  static constexpr int kChunks = D / 4;          // 16-byte chunks a row
  static constexpr int kTile = R * D * 4;        // bytes of fp32
  // partial scores of one product: float4 [slice][group][n-tile][lane]
  static constexpr int kPart = kSlices > 1 ? kSlices * kGroups * kNT * 32 * 16
                                           : 0;
  // q | k[2] | v[2] | partials (the deferred forward: partials[2])
  static constexpr int kFwdSmem = 5 * kTile + kPart;
  static constexpr int kFwdDeferredSmem = 5 * kTile + 2 * kPart;
  // q | dO | k[2] | v[2] | partials of s | of dp | lse | delta
  static constexpr int kDqSmem = 6 * kTile + 2 * kPart + 2 * R * 4;
  // k | v | q[2] | dO[2] | partials of s^T | of dp^T | lse[2] | delta[2]
  static constexpr int kDkvSmem = 6 * kTile + 2 * kPart + 4 * R * 4;
  static_assert(D % kSlice == 0 && R % 16 == 0, "whole slices and groups");
  static_assert((R * kChunks) % kThreads == 0, "whole chunks a thread");
  static_assert(R % (kThreads / 32) == 0, "delta's rows");
  static_assert(kThreads >= 2 * R, "load_row_stats' threads");
  static_assert(kDqSmem <= 232448 && kDkvSmem <= 232448 &&
                    kFwdDeferredSmem <= 232448,
                "227 KB a block");
};

using F64 = Fp32<64, 64>;
using F256 = Fp32<256, 32>;
using F512 = Fp32<512, 16>;

// float offset of element (row, col) in a swizzled [rows][D] fp32 tile
template <class W>
__device__ __forceinline__ int sw(int row, int col) {
  return row * W::kD + (col ^ ((row & 7) << 2));
}

// An A fragment split into its TF32 halves.
struct FragA {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void split_a(FragA& f, float a0, float a1, float a2,
                                        float a3) {
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
}

// d += a b in 3xTF32: the small terms first, then hi hi
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma_tf32(d, a.lo, h0, h1);
  mma_tf32(d, a.hi, l0, l1);
  mma_tf32(d, a.hi, h0, h1);
}

// A (B, L, H, D) operand of one (batch, head): its first row and the
// element stride between rows.
struct Rows {
  const float* p;
  long long stride;
};

__device__ __forceinline__ Rows rows_of(const void* base, const long long* st,
                                        int b, int h) {
  return {static_cast<const float*>(base) + b * st[0] + h * st[2], st[1]};
}

// Copy rows [row0, row0 + R) of `src` into the swizzled tile at `dst`; rows
// at or past `n_rows` are zero-filled.  R * D / 4 / threads chunks of 16
// bytes a thread, neighbouring threads on neighbouring chunks of one row.
template <class W>
__device__ __forceinline__ void load_tile(uint32_t dst, Rows src, int row0,
                                          int n_rows) {
#pragma unroll
  for (int i = 0; i < W::kRows * W::kChunks / W::kThreads; ++i) {
    const int id = threadIdx.x + i * W::kThreads;
    const int r = id / W::kChunks, c = id % W::kChunks;
    const bool ok = row0 + r < n_rows;
    const float* g = src.p + (ok ? (row0 + r) * src.stride : 0) + c * 4;
    cp_async_16(dst + 4 * sw<W>(r, c * 4), g, ok ? 16 : 0);
  }
}

// acc (16 x R) = rows [a0, a0 + 16) of tile `a` times rows [0, R) of tile
// `b`, transposed, over the 64 columns of `slice`: this warp's share of the
// contraction over head_dim.
template <class W>
__device__ __forceinline__ void mma_slice_nt(float (&acc)[W::kNT][4],
                                             const float* a, int a0,
                                             const float* b, int slice) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < W::kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kSlice / 8; ++kk) {
    const int c = slice * kSlice + kk * 8 + t;
    FragA fa;
    split_a(fa, a[sw<W>(a0 + g, c)], a[sw<W>(a0 + g + 8, c)],
            a[sw<W>(a0 + g, c + 4)], a[sw<W>(a0 + g + 8, c + 4)]);
#pragma unroll
    for (int n = 0; n < W::kNT; ++n)
      mma3(acc[n], fa, b[sw<W>(n * 8 + g, c)], b[sw<W>(n * 8 + g, c + 4)]);
  }
}

// acc (16 x 64) += s (16 x R fp32 accumulator) times rows [0, R) of tile `b`
// (the contraction runs over the tile's rows, in the order 2t, 2t + 1 of
// each 8), columns of `slice`.  Each 16 x 8 block of the product over 32
// rows at most is summed from zero in the tensor cores and then added to
// `acc` in fp32: their accumulation rounds toward zero, and carried across
// every tile of the other axis (hundreds of products into one accumulator)
// that bias broke the precision contract at 4,096 keys; here a sum is 12
// products at most.  32 rows at a time also bound the split A fragments
// held at once (32 registers).
template <class W>
__device__ __forceinline__ void mma_slice_nn(float (&acc)[8][4],
                                             const float (&s)[W::kNT][4],
                                             const float* b, int slice) {
  constexpr int kChunk = W::kNT < 4 ? W::kNT : 4;  // 8-row steps a sum
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n0 = 0; n0 < W::kNT; n0 += kChunk) {
    FragA fa[kChunk];
#pragma unroll
    for (int n = 0; n < kChunk; ++n)
      split_a(fa[n], s[n0 + n][0], s[n0 + n][2], s[n0 + n][1], s[n0 + n][3]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = slice * kSlice + j * 8 + g;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < kChunk; ++n) {
        const int r = (n0 + n) * 8 + 2 * t;
        mma3(part, fa[n], b[sw<W>(r, c)], b[sw<W>(r + 1, c)]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += part[i];
    }
  }
}

// Partial scores: float4 [slice][group][n-tile][lane], each thread's four
// values of one n-tile in one float4, lanes contiguous (no bank conflict).
template <class W>
__device__ __forceinline__ void put_part(float4* part,
                                         const float (&s)[W::kNT][4],
                                         int group, int slice) {
  float4* p = part + (slice * W::kGroups + group) * W::kNT * 32 +
              (threadIdx.x & 31);
#pragma unroll
  for (int n = 0; n < W::kNT; ++n)
    p[n * 32] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
}

// s = the slices' partials of this thread's scores, summed in slice order:
// every warp of a row group gets the same bits.
template <class W>
__device__ __forceinline__ void sum_parts(float (&s)[W::kNT][4],
                                          const float4* part, int group) {
  const float4* p = part + group * W::kNT * 32 + (threadIdx.x & 31);
#pragma unroll
  for (int n = 0; n < W::kNT; ++n) {
    float4 x = p[n * 32];
#pragma unroll
    for (int sl = 1; sl < W::kSlices; ++sl) {
      const float4 y = p[(sl * W::kGroups * W::kNT + n) * 32];
      x.x += y.x;
      x.y += y.y;
      x.z += y.z;
      x.w += y.w;
    }
    s[n][0] = x.x;
    s[n][1] = x.y;
    s[n][2] = x.z;
    s[n][3] = x.w;
  }
}

// The scores of one product, summed over head_dim: this warp's slice of
// the contraction, then (D > 64) the exchange through `part`.  Returns
// with a barrier passed when there is an exchange.
template <class W>
__device__ __forceinline__ void scores(float (&s)[W::kNT][4], const float* a,
                                       int a0, const float* b, float4* part,
                                       int group, int slice) {
  mma_slice_nt<W>(s, a, a0, b, slice);
  if constexpr (W::kSlices > 1) {
    put_part<W>(part, s, group, slice);
    __syncthreads();
    sum_parts<W>(s, part, group);
  }
}

// The kv columns at or past t_len of a tile starting at col0: -inf.
template <class W>
__device__ __forceinline__ void mask_cols(float (&s)[W::kNT][4], int col0,
                                          int t_len) {
  if (col0 + W::kRows <= t_len) return;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < W::kNT; ++n) {
    const int c = col0 + n * 8 + t * 2;
    if (c >= t_len) s[n][0] = s[n][2] = -INFINITY;
    if (c + 1 >= t_len) s[n][1] = s[n][3] = -INFINITY;
  }
}

template <class W>
__device__ __forceinline__ void scale_scores(float (&s)[W::kNT][4], float f) {
#pragma unroll
  for (int n = 0; n < W::kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] *= f;
}

__device__ __forceinline__ void zero8(float (&acc)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
}

// Write this warp's 16 x 64 accumulator slice, times f (or divided by
// l_lo / l_hi per row half with `divide`), as fp32 rows [row0, row0 + 16)
// of `dst` (rows past n_rows dropped).
__device__ __forceinline__ void store_slice(float* dst, long long stride,
                                            const float (&acc)[8][4],
                                            int row0, int n_rows, int slice,
                                            float f_lo, float f_hi,
                                            bool divide) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r_lo = row0 + g, r_hi = row0 + g + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = slice * kSlice + n * 8 + t * 2;
    if (r_lo < n_rows)
      *reinterpret_cast<float2*>(dst + r_lo * stride + c) =
          divide ? make_float2(acc[n][0] / f_lo, acc[n][1] / f_lo)
                 : make_float2(acc[n][0] * f_lo, acc[n][1] * f_lo);
    if (r_hi < n_rows)
      *reinterpret_cast<float2*>(dst + r_hi * stride + c) =
          divide ? make_float2(acc[n][2] / f_hi, acc[n][3] / f_hi)
                 : make_float2(acc[n][2] * f_hi, acc[n][3] * f_hi);
  }
}

struct Params {
  const void *q, *k, *v, *o, *dout;
  void *out0, *out1;  // o | dq | dk, and dv
  float* lse;    // written by the forward, read by the backward
  float* delta;  // written by the dq kernel, read by the dk/dv kernel
  long long st[18];   // (sb, sl, sh) per tensor, in the entry's order
  int heads, s_len, t_len;
  float scale, scale_log2;
};

// ---------------------------------------------------------------------------
// forward: strides of q, k, v, o
// ---------------------------------------------------------------------------

// The online softmax of one thread's two rows (g and g + 8 of its warp's
// 16): the running max and this thread's share of the sum.
struct RowStats {
  float m_lo, m_hi, l_lo, l_hi;
};

// Tile j's online softmax on its scores `s` (natural domain: exp; base 2:
// exp2), then o += p v_j over this slice's columns.
template <class W, bool kBase2>
__device__ __forceinline__ void consume_tile(float (&s)[W::kNT][4],
                                             float (&o)[8][4], RowStats& r,
                                             const float* v_tile, int slice) {
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int n = 0; n < W::kNT; ++n) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  const float mn_lo = fmaxf(r.m_lo, mx_lo), mn_hi = fmaxf(r.m_hi, mx_hi);
  const float alpha_lo = kBase2 ? exp2f(r.m_lo - mn_lo) : expf(r.m_lo - mn_lo);
  const float alpha_hi = kBase2 ? exp2f(r.m_hi - mn_hi) : expf(r.m_hi - mn_hi);
  r.m_lo = mn_lo;
  r.m_hi = mn_hi;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int n = 0; n < W::kNT; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m = i < 2 ? mn_lo : mn_hi;
      s[n][i] = kBase2 ? exp2f(s[n][i] - m) : expf(s[n][i] - m);
    }
    sum_lo += s[n][0] + s[n][1];
    sum_hi += s[n][2] + s[n][3];
  }
  r.l_lo = r.l_lo * alpha_lo + sum_lo;
  r.l_hi = r.l_hi * alpha_hi + sum_hi;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    o[n][0] *= alpha_lo;
    o[n][1] *= alpha_lo;
    o[n][2] *= alpha_hi;
    o[n][3] *= alpha_hi;
  }
  mma_slice_nn<W>(o, s, v_tile, slice);
}

// o = acc / l through o's strides, and the natural-log LSE of the block's
// rows [q0, q0 + R).
template <class W, bool kBase2>
__device__ __forceinline__ void store_fwd(const Params& p, float (&o)[8][4],
                                          RowStats r, int q0, int group,
                                          int slice) {
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    r.l_lo += __shfl_xor_sync(0xffffffffu, r.l_lo, off);
    r.l_hi += __shfl_xor_sync(0xffffffffu, r.l_hi, off);
  }
  const long long* os = p.st + 9;
  float* ob = static_cast<float*>(p.out0) + b * os[0] + h * os[2];
  const int row0 = q0 + group * 16;
  store_slice(ob, os[1], o, row0, p.s_len, slice, r.l_lo, r.l_hi, true);
  if (slice == 0 && t == 0) {
    float* lb = p.lse + (long long)bh * p.s_len;
    const float lse_lo = kBase2 ? (r.m_lo + log2f(r.l_lo)) * kLn2
                                : r.m_lo + logf(r.l_lo);
    const float lse_hi = kBase2 ? (r.m_hi + log2f(r.l_hi)) * kLn2
                                : r.m_hi + logf(r.l_hi);
    if (row0 + g < p.s_len) lb[row0 + g] = lse_lo;
    if (row0 + g + 8 < p.s_len) lb[row0 + g + 8] = lse_hi;
  }
}

template <class W>
__global__ void __launch_bounds__(W::kThreads, 1) fwd_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + W::kTile / 4;
  float* v_s = k_s + 2 * (W::kTile / 4);
  float4* part = reinterpret_cast<float4*>(smem + 5 * W::kTile);

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int warp = threadIdx.x >> 5;
  const int group = warp % W::kGroups, slice = warp / W::kGroups;
  const int q0 = blockIdx.x * W::kRows;
  const Rows q = rows_of(p.q, p.st, b, h), k = rows_of(p.k, p.st + 3, b, h),
             v = rows_of(p.v, p.st + 6, b, h);

  const int n_tiles = (p.t_len + W::kRows - 1) / W::kRows;
  load_tile<W>(smem_u32(q_s), q, q0, p.s_len);
  load_tile<W>(smem_u32(k_s), k, 0, p.t_len);
  load_tile<W>(smem_u32(v_s), v, 0, p.t_len);
  cp_async_commit();

  float o[8][4];
  zero8(o);
  RowStats r = {-INFINITY, -INFINITY, 0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<W>(smem_u32(k_s + (buf ^ 1) * (W::kTile / 4)), k,
                   (j + 1) * W::kRows, p.t_len);
      load_tile<W>(smem_u32(v_s + (buf ^ 1) * (W::kTile / 4)), v,
                   (j + 1) * W::kRows, p.t_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // ---- s = q k^T * scale, the kv columns past T masked
    float s[W::kNT][4];
    scores<W>(s, q_s, group * 16, k_s + buf * (W::kTile / 4), part, group,
              slice);
    scale_scores<W>(s, p.scale);
    mask_cols<W>(s, j * W::kRows, p.t_len);

    // ---- online softmax, o += p v
    consume_tile<W, false>(s, o, r, v_s + buf * (W::kTile / 4), slice);
    __syncthreads();  // the partials and this stage are written next
  }
  store_fwd<W, false>(p, o, r, q0, group, slice);
}

// ---------------------------------------------------------------------------
// deferred-softmax forward: strides of q, k, v, o
// ---------------------------------------------------------------------------
//
// Replaces `_fwd_kernel_pipelined` on fp32: q prescaled by
// fp32(scale * log2 e) in shared memory once, the softmax in base 2, and
// tile j + 1's scores issued ahead of tile j's softmax, as flash_wide.cu's
// fwd_deferred_kernel does: body j sums S_j's partials (written by the
// previous body; at D = 64 S_j is held in registers), issues S_{j+1}'s
// product and writes its partials to the buffer of the other parity, and
// runs tile j's softmax and o += p v_j.  The k stream runs one tile ahead of
// the v stream, each two stages deep; one __syncthreads a kv tile.  T is a
// multiple of R with at least two tiles (the dispatch rule), so no column
// is masked.

template <class W>
__global__ void __launch_bounds__(W::kThreads, 1)
    fwd_deferred_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kTileF = W::kTile / 4;      // floats of one tile
  constexpr int kPartVecs = W::kPart / 16;  // float4s of one partial buffer
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + kTileF;
  float* v_s = k_s + 2 * kTileF;
  float4* part = reinterpret_cast<float4*>(smem + 5 * W::kTile);

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int warp = threadIdx.x >> 5;
  const int group = warp % W::kGroups, slice = warp / W::kGroups;
  const int q0 = blockIdx.x * W::kRows;
  const Rows q = rows_of(p.q, p.st, b, h), k = rows_of(p.k, p.st + 3, b, h),
             v = rows_of(p.v, p.st + 6, b, h);

  const int n_tiles = p.t_len / W::kRows;
  load_tile<W>(smem_u32(q_s), q, q0, p.s_len);
  load_tile<W>(smem_u32(k_s), k, 0, p.t_len);
  cp_async_commit();
  load_tile<W>(smem_u32(k_s + kTileF), k, W::kRows, p.t_len);
  load_tile<W>(smem_u32(v_s), v, 0, p.t_len);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  // ---- q' = q * fp32(scale * log2 e), in place
  for (int i = threadIdx.x; i < kTileF; i += W::kThreads)
    q_s[i] *= p.scale_log2;
  __syncthreads();

  float s[W::kNT][4];
  mma_slice_nt<W>(s, q_s, group * 16, k_s, slice);
  if constexpr (W::kSlices > 1) put_part<W>(part, s, group, slice);

  float o[8][4];
  zero8(o);
  RowStats r = {-INFINITY, -INFINITY, 0.f, 0.f};

  int j = 0;
  for (; j < n_tiles - 1; ++j) {
    const int cur = j & 1, nxt = cur ^ 1;
    cp_async_wait<0>();
    __syncthreads();
    if (j + 2 < n_tiles)
      load_tile<W>(smem_u32(k_s + cur * kTileF), k, (j + 2) * W::kRows,
                   p.t_len);
    load_tile<W>(smem_u32(v_s + nxt * kTileF), v, (j + 1) * W::kRows,
                 p.t_len);
    cp_async_commit();

    if constexpr (W::kSlices > 1) sum_parts<W>(s, part + cur * kPartVecs,
                                               group);
    // ---- produce S_{j+1}: this slice's share, summed by the next body
    float sn[W::kNT][4];
    mma_slice_nt<W>(sn, q_s, group * 16, k_s + nxt * kTileF, slice);
    if constexpr (W::kSlices > 1)
      put_part<W>(part + nxt * kPartVecs, sn, group, slice);
    // ---- consume tile j
    consume_tile<W, true>(s, o, r, v_s + cur * kTileF, slice);
    if constexpr (W::kSlices == 1) {
#pragma unroll
      for (int n = 0; n < W::kNT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = sn[n][i];
    }
  }
  // ---- the last body: consume only
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (W::kSlices > 1)
    sum_parts<W>(s, part + (j & 1) * kPartVecs, group);
  consume_tile<W, true>(s, o, r, v_s + (j & 1) * kTileF, slice);
  store_fwd<W, true>(p, o, r, q0, group, slice);
}

// ---------------------------------------------------------------------------
// dq and delta: strides of q, k, v, o, dO, dq
// ---------------------------------------------------------------------------

template <class W>
__global__ void __launch_bounds__(W::kThreads, 1) dq_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kTileF = W::kTile / 4;
  float* q_s = reinterpret_cast<float*>(smem);
  float* do_s = q_s + kTileF;
  float* k_s = do_s + kTileF;
  float* v_s = k_s + 2 * kTileF;
  unsigned char* rest = smem + 6 * W::kTile;
  float4* part_s = reinterpret_cast<float4*>(rest);
  float4* part_dp = part_s + W::kPart / 16;
  float* lse_s = reinterpret_cast<float*>(rest + 2 * W::kPart);
  float* delta_s = lse_s + W::kRows;

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp % W::kGroups, slice = warp / W::kGroups;
  const int g = lane >> 2;
  const int q0 = blockIdx.x * W::kRows;
  const Rows q = rows_of(p.q, p.st, b, h), k = rows_of(p.k, p.st + 3, b, h),
             v = rows_of(p.v, p.st + 6, b, h), o = rows_of(p.o, p.st + 9, b, h),
             dout = rows_of(p.dout, p.st + 12, b, h);

  const int n_tiles = (p.t_len + W::kRows - 1) / W::kRows;
  load_tile<W>(smem_u32(q_s), q, q0, p.s_len);
  load_tile<W>(smem_u32(do_s), dout, q0, p.s_len);
  load_tile<W>(smem_u32(k_s), k, 0, p.t_len);
  load_tile<W>(smem_u32(v_s), v, 0, p.t_len);
  cp_async_commit();

  // ---- delta = rowsum(dO * O) in fp32, R / warps rows a warp, column
  // c * 32 + lane summed by each lane in order, then across the warp by a
  // fixed tree.  Rows past S get 0 and are not written.
  constexpr int kRowsAWarp = W::kRows / (W::kThreads / 32);
#pragma unroll
  for (int i = 0; i < kRowsAWarp; ++i) {
    const int rr = warp * kRowsAWarp + i, row = q0 + rr;
    float acc = 0.f;
    if (row < p.s_len) {
      const float* orow = o.p + row * o.stride;
      const float* drow = dout.p + row * dout.stride;
#pragma unroll
      for (int c = 0; c < W::kD / 32; ++c)
        acc = fmaf(orow[c * 32 + lane], drow[c * 32 + lane], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      delta_s[rr] = acc;
      lse_s[rr] = row < p.s_len ? p.lse[(long long)bh * p.s_len + row] : 0.f;
      if (row < p.s_len) p.delta[(long long)bh * p.s_len + row] = acc;
    }
  }

  float dq[8][4];
  zero8(dq);
  float lse_lo = 0.f, lse_hi = 0.f, delta_lo = 0.f, delta_hi = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<W>(smem_u32(k_s + (buf ^ 1) * kTileF), k, (j + 1) * W::kRows,
                   p.t_len);
      load_tile<W>(smem_u32(v_s + (buf ^ 1) * kTileF), v, (j + 1) * W::kRows,
                   p.t_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
      lse_lo = lse_s[group * 16 + g];
      lse_hi = lse_s[group * 16 + g + 8];
      delta_lo = delta_s[group * 16 + g];
      delta_hi = delta_s[group * 16 + g + 8];
    }

    // ---- s = q k^T and dp = dO v^T, each summed over the slices
    float s[W::kNT][4], dp[W::kNT][4];
    mma_slice_nt<W>(s, q_s, group * 16, k_s + buf * kTileF, slice);
    mma_slice_nt<W>(dp, do_s, group * 16, v_s + buf * kTileF, slice);
    if constexpr (W::kSlices > 1) {
      put_part<W>(part_s, s, group, slice);
      put_part<W>(part_dp, dp, group, slice);
      __syncthreads();
      sum_parts<W>(s, part_s, group);
      sum_parts<W>(dp, part_dp, group);
    }
    scale_scores<W>(s, p.scale);
    mask_cols<W>(s, j * W::kRows, p.t_len);

    // ---- ds = p * (dp - delta), p = exp(s * scale - lse)
#pragma unroll
    for (int n = 0; n < W::kNT; ++n) {
      s[n][0] = expf(s[n][0] - lse_lo) * (dp[n][0] - delta_lo);
      s[n][1] = expf(s[n][1] - lse_lo) * (dp[n][1] - delta_lo);
      s[n][2] = expf(s[n][2] - lse_hi) * (dp[n][2] - delta_hi);
      s[n][3] = expf(s[n][3] - lse_hi) * (dp[n][3] - delta_hi);
    }

    // ---- dq += ds k over this slice's columns
    mma_slice_nn<W>(dq, s, k_s + buf * kTileF, slice);
    __syncthreads();
  }

  const long long* ds = p.st + 15;
  float* dqb = static_cast<float*>(p.out0) + b * ds[0] + h * ds[2];
  store_slice(dqb, ds[1], dq, q0 + group * 16, p.s_len, slice, p.scale,
              p.scale, false);
}

// ---------------------------------------------------------------------------
// dk and dv: strides of q, k, v, dO, dk, dv
// ---------------------------------------------------------------------------

// lse and delta of q rows [row0, row0 + R) into shared memory (threads
// 0..R-1 copy lse, R..2R-1 delta); rows at or past s_len are zero-filled.
template <class W>
__device__ __forceinline__ void load_row_stats(float* lse_dst, float* delta_dst,
                                               const float* lse,
                                               const float* delta, int row0,
                                               int s_len) {
  if (threadIdx.x >= 2 * W::kRows) return;
  const int r = threadIdx.x % W::kRows;
  const bool ok = row0 + r < s_len;
  const float* src =
      (threadIdx.x < W::kRows ? lse : delta) + (ok ? row0 + r : 0);
  float* dst = (threadIdx.x < W::kRows ? lse_dst : delta_dst) + r;
  cp_async_4(smem_u32(dst), src, ok ? 4 : 0);
}

template <class W>
__global__ void __launch_bounds__(W::kThreads, 1) dkv_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kTileF = W::kTile / 4;
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + kTileF;
  float* q_s = v_s + kTileF;
  float* do_s = q_s + 2 * kTileF;
  unsigned char* rest = smem + 6 * W::kTile;
  float4* part_s = reinterpret_cast<float4*>(rest);
  float4* part_dp = part_s + W::kPart / 16;
  float* lse_s = reinterpret_cast<float*>(rest + 2 * W::kPart);
  float* delta_s = lse_s + 2 * W::kRows;

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp % W::kGroups, slice = warp / W::kGroups;
  const int t = lane & 3;
  const int kv0 = blockIdx.x * W::kRows;
  const Rows q = rows_of(p.q, p.st, b, h), k = rows_of(p.k, p.st + 3, b, h),
             v = rows_of(p.v, p.st + 6, b, h),
             dout = rows_of(p.dout, p.st + 9, b, h);
  const float* lb = p.lse + (long long)bh * p.s_len;
  const float* db = p.delta + (long long)bh * p.s_len;

  const int n_tiles = (p.s_len + W::kRows - 1) / W::kRows;
  load_tile<W>(smem_u32(k_s), k, kv0, p.t_len);
  load_tile<W>(smem_u32(v_s), v, kv0, p.t_len);
  load_tile<W>(smem_u32(q_s), q, 0, p.s_len);
  load_tile<W>(smem_u32(do_s), dout, 0, p.s_len);
  load_row_stats<W>(lse_s, delta_s, lb, db, 0, p.s_len);
  cp_async_commit();

  float dk[8][4], dv[8][4];
  zero8(dk);
  zero8(dv);

  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < n_tiles) {
      load_tile<W>(smem_u32(q_s + (buf ^ 1) * kTileF), q, (i + 1) * W::kRows,
                   p.s_len);
      load_tile<W>(smem_u32(do_s + (buf ^ 1) * kTileF), dout,
                   (i + 1) * W::kRows, p.s_len);
      load_row_stats<W>(lse_s + (buf ^ 1) * W::kRows,
                        delta_s + (buf ^ 1) * W::kRows, lb, db,
                        (i + 1) * W::kRows, p.s_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // ---- s^T = k q^T and dp^T = v dO^T (16 kv rows x R q columns), each
    // summed over the slices; lse and delta index the columns
    float st[W::kNT][4], dpt[W::kNT][4];
    mma_slice_nt<W>(st, k_s, group * 16, q_s + buf * kTileF, slice);
    mma_slice_nt<W>(dpt, v_s, group * 16, do_s + buf * kTileF, slice);
    if constexpr (W::kSlices > 1) {
      put_part<W>(part_s, st, group, slice);
      put_part<W>(part_dp, dpt, group, slice);
      __syncthreads();
      sum_parts<W>(st, part_s, group);
      sum_parts<W>(dpt, part_dp, group);
    }

    const float* ls = lse_s + buf * W::kRows;
    const float* dl = delta_s + buf * W::kRows;
#pragma unroll
    for (int n = 0; n < W::kNT; ++n) {
      const int c = n * 8 + t * 2;
      st[n][0] = expf(st[n][0] * p.scale - ls[c]);
      st[n][1] = expf(st[n][1] * p.scale - ls[c + 1]);
      st[n][2] = expf(st[n][2] * p.scale - ls[c]);
      st[n][3] = expf(st[n][3] * p.scale - ls[c + 1]);
    }

    // ---- ds^T = p^T * (dp^T - delta), in dpt; dv += p^T dO; dk += ds^T q
#pragma unroll
    for (int n = 0; n < W::kNT; ++n) {
      const int c = n * 8 + t * 2;
      dpt[n][0] = st[n][0] * (dpt[n][0] - dl[c]);
      dpt[n][1] = st[n][1] * (dpt[n][1] - dl[c + 1]);
      dpt[n][2] = st[n][2] * (dpt[n][2] - dl[c]);
      dpt[n][3] = st[n][3] * (dpt[n][3] - dl[c + 1]);
    }
    mma_slice_nn<W>(dv, st, do_s + buf * kTileF, slice);
    mma_slice_nn<W>(dk, dpt, q_s + buf * kTileF, slice);
    __syncthreads();
  }

  const long long* ks = p.st + 12;
  const long long* vs = p.st + 15;
  const int row0 = kv0 + group * 16;
  store_slice(static_cast<float*>(p.out0) + b * ks[0] + h * ks[2], ks[1], dk,
              row0, p.t_len, slice, p.scale, p.scale, false);
  store_slice(static_cast<float*>(p.out1) + b * vs[0] + h * vs[2], vs[1], dv,
              row0, p.t_len, slice, 1.f, 1.f, false);
}

// Launch `kernel` over ceil(rows / R) tiles of the resident axis times B*H.
template <class W>
int launch(void (*kernel)(Params), int smem_bytes, int rows, Params& p,
           int b, int h, int s_len, int t_len, const long long* strides,
           int n_strides, float scale, void* stream) {
  if (b <= 0 || h <= 0 || s_len <= 0 || t_len <= 0 || b * h > 65535)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_strides; ++i) p.st[i] = strides[i];
  p.heads = h;
  p.s_len = s_len;
  p.t_len = t_len;
  p.scale = scale;
  // rounded to fp32 once, as the JAX package's `q * (scale * _LOG2E)` is
  p.scale_log2 = (float)((double)scale * 1.4426950408889634);
  dim3 grid((rows + W::kRows - 1) / W::kRows, b * h);
  kernel<<<grid, W::kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}

cudaError_t allow_smem(void (*kernel)(Params), int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// o and lse; strides of q, k, v, o.
template <class W>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int b, int h, int s_len, int t_len, const long long* strides,
        float scale, void* stream) {
  static const cudaError_t attr = allow_smem(fwd_kernel<W>, W::kFwdSmem);
  if (attr != cudaSuccess) return (int)attr;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out0 = o;
  p.lse = static_cast<float*>(lse);
  return launch<W>(fwd_kernel<W>, W::kFwdSmem, s_len, p, b, h, s_len, t_len,
                   strides, 12, scale, stream);
}

// The deferred-softmax forward: o and lse as fwd; t_len a multiple of R of
// at least 2 R (cudaErrorInvalidValue otherwise).
template <class W>
int fwd_deferred(const void* q, const void* k, const void* v, void* o,
                 void* lse, int b, int h, int s_len, int t_len,
                 const long long* strides, float scale, void* stream) {
  if (t_len % W::kRows || t_len < 2 * W::kRows)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr =
      allow_smem(fwd_deferred_kernel<W>, W::kFwdDeferredSmem);
  if (attr != cudaSuccess) return (int)attr;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out0 = o;
  p.lse = static_cast<float*>(lse);
  return launch<W>(fwd_deferred_kernel<W>, W::kFwdDeferredSmem, s_len, p, b,
                   h, s_len, t_len, strides, 12, scale, stream);
}

// dq and delta; strides of q, k, v, o, dO, dq.
template <class W>
int bwd_dq(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq, int b,
           int h, int s_len, int t_len, const long long* strides, float scale,
           void* stream) {
  static const cudaError_t attr = allow_smem(dq_kernel<W>, W::kDqSmem);
  if (attr != cudaSuccess) return (int)attr;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.out0 = dq;
  p.lse = static_cast<float*>(const_cast<void*>(lse));
  p.delta = static_cast<float*>(delta);
  return launch<W>(dq_kernel<W>, W::kDqSmem, s_len, p, b, h, s_len, t_len,
                   strides, 18, scale, stream);
}

// dk and dv from the dq kernel's delta; strides of q, k, v, dO, dk, dv.
template <class W>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int b,
            int h, int s_len, int t_len, const long long* strides, float scale,
            void* stream) {
  static const cudaError_t attr = allow_smem(dkv_kernel<W>, W::kDkvSmem);
  if (attr != cudaSuccess) return (int)attr;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.out0 = dk;
  p.out1 = dv;
  p.lse = static_cast<float*>(const_cast<void*>(lse));
  p.delta = static_cast<float*>(const_cast<void*>(delta));
  return launch<W>(dkv_kernel<W>, W::kDkvSmem, t_len, p, b, h, s_len, t_len,
                   strides, 18, scale, stream);
}

}  // namespace

// Plain C entry points for ctypes, with the bf16 entries' argument lists
// (flash_fwd_pipelined_*_fp32 refuses a t_len that is not a whole number,
// at least two, of its tiles).  Tensors (B, len, H, D) fp32, D = 64, 256 or
// 512 as the name says, with the element strides in `strides` (sb, sl, sh
// each; head_dim stride 1), lse and delta (B*H, S) fp32 contiguous.  Each
// launches on `stream`, allocates nothing, and returns a CUDA error code
// (0 = launched).

#define FLASH_FP32_ENTRIES(W, d)                                              \
  extern "C" int flash_fwd##d##_fp32(                                         \
      const void* q, const void* k, const void* v, void* o, void* lse, int b, \
      int h, int s_len, int t_len, const long long* strides, float scale,     \
      void* stream) {                                                         \
    return fwd<W>(q, k, v, o, lse, b, h, s_len, t_len, strides, scale,        \
                  stream);                                                    \
  }                                                                           \
  extern "C" int flash_fwd_pipelined##d##_fp32(                               \
      const void* q, const void* k, const void* v, void* o, void* lse, int b, \
      int h, int s_len, int t_len, const long long* strides, float scale,     \
      void* stream) {                                                         \
    return fwd_deferred<W>(q, k, v, o, lse, b, h, s_len, t_len, strides,      \
                           scale, stream);                                    \
  }                                                                           \
  extern "C" int flash_bwd_dq##d##_fp32(                                      \
      const void* q, const void* k, const void* v, const void* o,             \
      const void* dout, const void* lse, void* delta, void* dq, int b, int h, \
      int s_len, int t_len, const long long* strides, float scale,            \
      void* stream) {                                                         \
    return bwd_dq<W>(q, k, v, o, dout, lse, delta, dq, b, h, s_len, t_len,    \
                     strides, scale, stream);                                 \
  }                                                                           \
  extern "C" int flash_bwd_dkv##d##_fp32(                                     \
      const void* q, const void* k, const void* v, const void* dout,          \
      const void* lse, const void* delta, void* dk, void* dv, int b, int h,   \
      int s_len, int t_len, const long long* strides, float scale,            \
      void* stream) {                                                         \
    return bwd_dkv<W>(q, k, v, dout, lse, delta, dk, dv, b, h, s_len, t_len,  \
                      strides, scale, stream);                                \
  }

FLASH_FP32_ENTRIES(F64, )
FLASH_FP32_ENTRIES(F256, _d256)
FLASH_FP32_ENTRIES(F512, _d512)
