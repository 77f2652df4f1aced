// Flash attention on fp32 inputs for Hopper (sm_90a): the forward and the
// deferred-softmax forward at head_dim 64 (the UNet's heads), fp32 in and
// out, fp32 LSE (`Fp32<64, 64>`).  The other fp32 flash kernels are their
// own sources, on the same precision contract: the backward pair at 64
// flash_fp32_d64_bwd_sm90.cu (tf32 wgmma over split planes); at 256 (the
// small VAE's mid-block, `small_config`) the two forwards
// flash_fp32_d256_sm90.cu and the backward pair flash_fp32_d256_bwd_sm90.cu
// (tf32 wgmma on a cluster of four blocks over head_dim,
// flash_fp32_d256_sm90.cuh); at 512 (the SD2 VAE's mid-block) the two
// forwards flash_fp32_d512_sm90.cu and the backward pair
// flash_fp32_d512_bwd_sm90.cu (mma.sync on a cluster of four blocks over
// head_dim).  The bf16 kernels (flash_fwd.cu, flash_fwd_pipelined.cu,
// flash_bwd.cu, flash_wide.cu) stay as they are.
//
// Replaces the Pallas TPU kernels of diffute_tpu/ops/flash_attention.py on
// fp32 inputs: `_fwd_kernel` (pl.pallas_call in `_flash_fwd_3d`) and
// `_fwd_kernel_pipelined` (in `_flash_fwd_3d_pipelined`).
//
// Precision contract.  The port's fp32 paths turn TF32 off, so that an fp32
// model computes what the JAX one computes on the CPU; these kernels and
// the fp32 backward pairs are accurate to fp32, not to TF32:
//
//   * every product is 3xTF32 on mma.sync.m16n8k8.tf32: each operand x is
//     split into hi = tf32(x) (cvt.rna) and lo = tf32(x - hi), and
//     a b = lo_a hi_b + hi_a lo_b, then + hi_a hi_b, accumulated in fp32
//     (the dropped lo_a lo_b is 2^-22 of the product);
//   * the tensor cores' fp32 accumulation rounds toward zero, so no
//     accumulator in them spans more than 32 rows of one tile: each such
//     part of p v (of ds k, p^T dO or ds^T q in the backward pairs) is
//     summed from zero (12 products at most) and added to o (dq, dv or dk)
//     by an fp32 add.  Carried across all the keys in one accumulator, that
//     bias alone broke the bound below at 4,096 keys (python -m
//     diffute_tpu_torch.tools.flash_fp32_accuracy reads each kernel's and
//     each plain version's distance from fp64);
//   * p (and ds) stay fp32 and are never rounded to a narrower type, as in
//     the JAX package's fp32 kernels (`p.astype(v.dtype)` is fp32 there);
//   * the standard forward (and the backward pairs) work in the natural
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
//   o (B, S, H, D) fp32 through its strides
//   lse (B*H, S) fp32 contiguous, natural log
//
// What bounds them on the H100: operations.  fp32 accuracy takes three
// TF32 products for one, so the tensor cores' 494.7 TF32 TFLOP/s give
// 164.9 fp32 TFLOP/s at best; an exp costs a few instructions of the
// special-function unit per score against 2 D FLOPs a product.  On-chip
// room is scarce: an fp32 row takes twice a bf16 one.
//
// Layout.  Every tile of one kernel has R rows: the resident q tile and the
// streamed k and v tiles, two stages deep through cp.async.  The resident
// tile is cut into R / 16 groups of 16 rows, one warp each, and a warp
// keeps its 16 x 64 slice of the output accumulator in registers (32 fp32
// a thread).  At D = 64, R = 64: 4 warps, a 16 KB tile; forward 80 KB
// (deferred 80 KB): two blocks an SM.  (The first cut also ran D = 256
// here, head_dim cut into four 64-column warp slices whose partial scores
// were summed through shared memory; the kernels at 256 and 512 split
// head_dim over a cluster of four blocks instead.)
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
// with both operands K-major only), TMA and a producer warpgroup are left
// to a redesign (ROADMAP.md), as the backward pair at 64 and both 256
// sources had.
//
// Ragged edges.  Rows past the end of a tile are zero-filled by cp.async.
// Both forwards mask the kv columns past T in the last kv tile (p = 0).
// Rows past the end of an output are not written.

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
  // q | k[2] | v[2]
  static constexpr int kFwdSmem = 5 * kTile;
  static constexpr int kFwdDeferredSmem = 5 * kTile;
  // one slice: no exchange of partial scores between warps
  static_assert(D == kSlice && R % 16 == 0, "one slice, whole groups");
  static_assert((R * kChunks) % kThreads == 0, "whole chunks a thread");
  static_assert(kFwdDeferredSmem <= 232448, "227 KB a block");
};

using F64 = Fp32<64, 64>;

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

// Write this warp's 16 x 64 accumulator slice divided by l_lo / l_hi per
// row half as fp32 rows [row0, row0 + 16) of `dst` (rows past n_rows
// dropped).
__device__ __forceinline__ void store_slice(float* dst, long long stride,
                                            const float (&acc)[8][4],
                                            int row0, int n_rows, int slice,
                                            float l_lo, float l_hi) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r_lo = row0 + g, r_hi = row0 + g + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = slice * kSlice + n * 8 + t * 2;
    if (r_lo < n_rows)
      *reinterpret_cast<float2*>(dst + r_lo * stride + c) =
          make_float2(acc[n][0] / l_lo, acc[n][1] / l_lo);
    if (r_hi < n_rows)
      *reinterpret_cast<float2*>(dst + r_hi * stride + c) =
          make_float2(acc[n][2] / l_hi, acc[n][3] / l_hi);
  }
}

struct Params {
  const void *q, *k, *v;
  void* out0;  // o
  float* lse;
  long long st[12];   // (sb, sl, sh) per tensor: q, k, v, o
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
  store_slice(ob, os[1], o, row0, p.s_len, slice, r.l_lo, r.l_hi);
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
    mma_slice_nt<W>(s, q_s, group * 16, k_s + buf * (W::kTile / 4), slice);
    scale_scores<W>(s, p.scale);
    mask_cols<W>(s, j * W::kRows, p.t_len);

    // ---- online softmax, o += p v
    consume_tile<W, false>(s, o, r, v_s + buf * (W::kTile / 4), slice);
    __syncthreads();  // this stage is written next
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
// fwd_deferred_kernel does: body j issues S_{j+1}'s product into registers
// beside S_j's and runs tile j's softmax and o += p v_j.  The k stream runs
// one tile ahead of
// the v stream, each two stages deep; one __syncthreads a kv tile.  T is a
// multiple of R with at least two tiles (the dispatch rule), so no column
// is masked.

template <class W>
__global__ void __launch_bounds__(W::kThreads, 1)
    fwd_deferred_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kTileF = W::kTile / 4;      // floats of one tile
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + kTileF;
  float* v_s = k_s + 2 * kTileF;

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

    // ---- produce S_{j+1}
    float sn[W::kNT][4];
    mma_slice_nt<W>(sn, q_s, group * 16, k_s + nxt * kTileF, slice);
    // ---- consume tile j
    consume_tile<W, true>(s, o, r, v_s + cur * kTileF, slice);
#pragma unroll
    for (int n = 0; n < W::kNT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = sn[n][i];
  }
  // ---- the last body: consume only
  cp_async_wait<0>();
  __syncthreads();
  consume_tile<W, true>(s, o, r, v_s + (j & 1) * kTileF, slice);
  store_fwd<W, true>(p, o, r, q0, group, slice);
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

}  // namespace

// Plain C entry points for ctypes, with the bf16 entries' argument lists
// (flash_fwd_pipelined_fp32 refuses a t_len that is not a whole number, at
// least two, of its tiles).  Tensors (B, len, H, 64) fp32 with the element
// strides in `strides` (sb, sl, sh each; head_dim stride 1), lse (B*H, S)
// fp32 contiguous.  Each launches on `stream`, allocates nothing, and
// returns a CUDA error code (0 = launched).  The other fp32 flash entries:
// the backward pair at 64 flash_fp32_d64_bwd_sm90.cu; at 256 and 512 the
// forwards flash_fp32_d{256,512}_sm90.cu and the backward pairs
// flash_fp32_d{256,512}_bwd_sm90.cu.
extern "C" int flash_fwd_fp32(const void* q, const void* k, const void* v,
                              void* o, void* lse, int b, int h, int s_len,
                              int t_len, const long long* strides,
                              float scale, void* stream) {
  return fwd<F64>(q, k, v, o, lse, b, h, s_len, t_len, strides, scale,
                  stream);
}

extern "C" int flash_fwd_pipelined_fp32(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int b, int h, int s_len, int t_len,
                                        const long long* strides, float scale,
                                        void* stream) {
  return fwd_deferred<F64>(q, k, v, o, lse, b, h, s_len, t_len, strides,
                           scale, stream);
}
