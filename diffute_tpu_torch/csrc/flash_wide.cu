// Flash attention at the wide head_dims, 256 and 512, for Hopper (sm_90a):
// the forward, the deferred-softmax forward, the dq kernel (which also
// writes delta) and the dk/dv kernel, bf16 in and out, fp32 LSE and delta.
// One source, templated on the width (`Wide<D>`), instantiated at head_dim
// 512 (the SD2 VAE mid-block's single head) and 256 (the small VAE's,
// `small_config`).
//
// Replaces the Pallas TPU kernels of diffute_tpu/ops/flash_attention.py at
// those widths: `_fwd_kernel` (pl.pallas_call in `_flash_fwd_3d`),
// `_fwd_kernel_pipelined` (in `_flash_fwd_3d_pipelined`), `_bwd_dq_kernel`
// and `_bwd_dkv_kernel` (both in `_flash_bwd_3d`).  The
// Pallas kernels take any head_dim; their BlockSpecs put whole rows in VMEM
// and carry (m, l, acc), dq or dk/dv in VMEM scratch across a sequential
// grid axis.  Here one block owns a tile of rows of one (batch, head) and
// loops over the other axis itself, as the head_dim-64 kernels
// (flash_fwd.cu, flash_bwd.cu) do; those stay as they are, with their tiles
// fixed for 64 columns (flash_sm90.cuh).
//
//   q (B, S, H, D), k/v (B, T, H, D)  bf16, any strides that are multiples
//     of 8 elements with the last one 1 (16-byte cp.async)
//   o, dq (B, S, H, D), dk, dv (B, T, H, D) bf16 through their strides
//   lse, delta (B*H, S) fp32 contiguous; lse natural log
//
//   forward:  s = q k^T, online softmax in base 2 (scale*log2 e folded into
//             one FMA), p rounded to bf16 against the running max, o += p v;
//             the deferred one computes the same, in another order
//   dq:       delta = rowsum(dO * O); p = exp2(s*scale*log2 e - lse*log2 e),
//             ds = p * (dO v^T - delta), dq = bf16(ds) k * scale
//   dk/dv:    dv = bf16(p)^T dO, dk = bf16(ds)^T q * scale
//
// What bounds them on the H100: operations.  At these widths a score costs
// 2*D FLOPs in each product against one exp2, so the exp2 that competes
// with the products at head_dim 64 is a quarter (256) or an eighth (512) as
// heavy here; the inputs are a few MB to tens of MB, read once per tile of
// the other axis (from L2).  What is scarce is on-chip room.  One 512-wide
// bf16 row is 1 KB, and a 32 x 512 fp32 accumulator is 64 KB: an o (or dq)
// tile of 32 rows takes a quarter of an SM's registers, dk plus dv half.
//
// Layout: every tile is 32 rows.  head_dim is cut into D / 128 slices of
// 128 columns and the resident tile (q; q and dO; k and v) into two groups
// of 16 rows; a block is one warp per (group, slice).  A warp keeps its
// 16 x 128 slice of each accumulator in registers (64 fp32 a thread; 128
// for dk and dv), so the columns are split between warps.  The contraction over head_dim in
// s = q k^T (and dp = dO v^T) is then split too: each warp multiplies its
// 128 columns and writes its 16 x 32 fp32 partial scores to shared memory,
// and after a barrier every warp of a row group sums the D / 128 partials in
// the same (slice) order, so the slices see bit-identical scores and p.
// That costs a barrier and the partials' shared-memory traffic a product and
// tile, against no redundant product (splitting head_dim across blocks
// instead would recompute s in every block).  The streamed operands (k, v;
// or q, dO) come in 32-row tiles, two stages deep.  Shared memory, 227 KB a
// block, holds the resident tiles, the two stages and the partials:
//
//   D = 512: 8 warps (2 groups x 4 slices); 176 KB forward (192 KB the
//     deferred one), 224 KB each backward kernel, so one block an SM;
//   D = 256: 4 warps (2 groups x 2 slices); 88 KB forward (96 KB), 112 KB
//     each backward kernel, so two blocks an SM.
//
// At 256 a 64-row resident tile (8 warps, one block an SM) would halve the
// L2 traffic of the streamed axis; timed on an H100 it was slower at every
// shape of the small VAE's paths (PERF.md, section 6), so the 32-row tile
// stays.  At 512 a 64-row tile does not fit (16 warps of 166 to 253
// registers, and 320 KB of shared memory for the backward).
//
// Tiles are XOR-swizzled by 16-byte chunk (chunk ^ (row & 7)) so that
// ldmatrix reads 8 rows of one column chunk without bank conflicts (a row is
// 512 or 1,024 bytes, a multiple of the 128 bytes the XOR spans).
//
// This first cut uses mma.sync m16n8k16 and a double-buffered cp.async ring;
// TMA (a 512-wide row is 8 boxes of 64 columns under a 128-byte swizzle),
// wgmma and a producer warp are left to a redesign.
//
// Ragged edges.  Rows past the end of a tile are zero-filled by cp.async.
// The forward and dq mask the kv columns past T in the last kv tile (p = 0).
// dk/dv: q rows past S are zero (so dO = 0), and their lse and delta are
// zero-filled too, which gives p = exp2(0) = 1 and ds = 1 * (0 - 0) = 0:
// they contribute nothing.  Rows past the end of an output are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;            // rows of every tile
constexpr int kGroups = kRows / 16;  // 16-row groups a tile
constexpr int kSlice = 128;          // head_dim columns a warp owns
constexpr float kLog2e = 1.4426950408889634f;

constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n / 2); }

// The tiling of one instantiation at head_dim D.
template <int D>
struct Wide {
  static constexpr int kD = D;
  static constexpr int kSlices = D / kSlice;     // 128-column slices
  static constexpr int kThreads = kGroups * kSlices * 32;
  static constexpr int kChunks = D / 8;          // 16-byte chunks a row
  static constexpr int kChunkLog = log2_of(kChunks);
  static constexpr int kTile = kRows * D * 2;    // bytes of bf16
  static constexpr int kPart = kSlices * kGroups * 4 * 32 * 16;  // partials
  // q | k[2] | v[2] | partials (the deferred forward: partials[2])
  static constexpr int kFwdSmem = 5 * kTile + kPart;
  static constexpr int kFwdDeferredSmem = 5 * kTile + 2 * kPart;
  // q | dO | k[2] | v[2] | partials of s | of dp | lse*log2e | delta
  static constexpr int kDqSmem = 6 * kTile + 2 * kPart + 2 * kRows * 4;
  // k | v | q[2] | dO[2] | partials of s^T | of dp^T | lse[2] | delta[2]
  static constexpr int kDkvSmem = 6 * kTile + 2 * kPart + 4 * kRows * 4;
  static_assert(D % 256 == 0, "whole slices, and delta's rows");
  static_assert(kChunks == 1 << kChunkLog, "rows of a power of two chunks");
  static_assert((kRows * kChunks) % kThreads == 0, "whole chunks a thread");
  static_assert(kRows % (kThreads / 32) == 0, "delta's rows");
  static_assert(kThreads >= 2 * kRows, "load_row_stats' threads");
  static_assert(kDqSmem <= 232448 && kDkvSmem <= 232448 &&
                    kFwdDeferredSmem <= 232448,
                "227 KB a block");
};

using D512 = Wide<512>;
using D256 = Wide<256>;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` of row `row` in a swizzled [rows][D]
// bf16 tile
template <class W>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * (W::kD * 2) + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  // src_bytes == 0 zero-fills the 16 destination bytes
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// D = A(16x16 bf16, row) * B(16x8 bf16, col) + D, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
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

// A (B, L, H, D) operand of one (batch, head): its first row and the
// element stride between rows.
struct Rows {
  const __nv_bfloat16* p;
  long long stride;
};

__device__ __forceinline__ Rows rows_of(const void* base, const long long* st,
                                        int b, int h) {
  return {static_cast<const __nv_bfloat16*>(base) + b * st[0] + h * st[2],
          st[1]};
}

// Copy rows [row0, row0 + N) of `src` into the swizzled tile at `dst`;
// rows at or past `n_rows` are zero-filled.  N * D / 8 / threads chunks of
// 16 bytes a thread, neighbouring threads on neighbouring chunks of one row.
template <class W, int N>
__device__ __forceinline__ void load_tile(uint32_t dst, Rows src, int row0,
                                          int n_rows) {
#pragma unroll
  for (int i = 0; i < N * W::kChunks / W::kThreads; ++i) {
    const int id = threadIdx.x + i * W::kThreads;
    const int r = id >> W::kChunkLog, c = id & (W::kChunks - 1);
    const bool ok = row0 + r < n_rows;
    const __nv_bfloat16* g = src.p + (ok ? (row0 + r) * src.stride : 0) + c * 8;
    cp_async_16(dst + swz<W>(r, c), g, ok ? 16 : 0);
  }
}

// acc (16 x 32) = rows [a0, a0 + 16) of tile `a` times rows [0, 32) of tile
// `b`, transposed, over the 128 columns of `slice`: this warp's share of the
// contraction over head_dim.
template <class W>
__device__ __forceinline__ void mma_slice_nt(float (&acc)[4][4], uint32_t a,
                                             int a0, uint32_t b, int slice) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kSlice / 16; ++kk) {
    const int chunk = (slice * kSlice + kk * 16) >> 3;
    // A matrices: (rows 0-7, k lo), (8-15, k lo), (0-7, k hi), (8-15, k hi)
    uint32_t fa[4];
    ldmatrix_x4(fa, a + swz<W>(a0 + (mi & 1) * 8 + mr, chunk + (mi >> 1)));
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      // B matrices: (n0, k lo), (n0, k hi), (n0 + 8, k lo), (n0 + 8, k hi)
      uint32_t fb[4];
      ldmatrix_x4(fb,
                  b + swz<W>(p * 16 + (mi >> 1) * 8 + mr, chunk + (mi & 1)));
      mma_bf16(acc[2 * p], fa, fb[0], fb[1]);
      mma_bf16(acc[2 * p + 1], fa, fb[2], fb[3]);
    }
  }
}

// acc (16 x 128) += frags (16 x 32, bf16 A fragments) times rows [0, 32) of
// tile `b` (the contraction runs over the tile's rows), columns of `slice`.
template <class W>
__device__ __forceinline__ void mma_slice_nn(float (&acc)[16][4],
                                             const uint32_t (&fa)[2][4],
                                             uint32_t b, int slice) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int row = kk * 16 + (mi & 1) * 8 + mr;
#pragma unroll
    for (int p = 0; p < kSlice / 16; ++p) {
      // transposed: (k lo, n0), (k hi, n0), (k lo, n0 + 8), (k hi, n0 + 8)
      uint32_t fb[4];
      ldmatrix_x4_trans(
          fb, b + swz<W>(row, ((slice * kSlice + p * 16) >> 3) + (mi >> 1)));
      mma_bf16(acc[2 * p], fa[kk], fb[0], fb[1]);
      mma_bf16(acc[2 * p + 1], fa[kk], fb[2], fb[3]);
    }
  }
}

// A 16 x 32 fp32 accumulator, rounded to bf16, as the A operand of the next
// product (the accumulator layout is the A-fragment layout).
__device__ __forceinline__ void pack_frags(uint32_t (&a)[2][4],
                                           const float (&s)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    a[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// Partial scores: float4 [slice][group][n-tile][lane], each thread's four
// values of one n-tile in one float4, lanes contiguous (no bank conflict).
template <class W>
__device__ __forceinline__ void put_part(float4* part, const float (&s)[4][4],
                                         int group, int slice) {
  float4* p = part + (slice * kGroups + group) * 4 * 32 + (threadIdx.x & 31);
#pragma unroll
  for (int n = 0; n < 4; ++n)
    p[n * 32] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
}

// s = the slices' partials of this thread's scores, summed in slice order:
// every warp of a row group gets the same bits.
template <class W>
__device__ __forceinline__ void sum_parts(float (&s)[4][4], const float4* part,
                                          int group) {
  const float4* p = part + group * 4 * 32 + (threadIdx.x & 31);
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    float4 x = p[n * 32];
#pragma unroll
    for (int sl = 1; sl < W::kSlices; ++sl) {
      const float4 y = p[(sl * kGroups * 4 + n) * 32];
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

// The kv columns at or past t_len of a tile starting at col0: -inf.
__device__ __forceinline__ void mask_cols(float (&s)[4][4], int col0,
                                          int t_len) {
  if (col0 + kRows <= t_len) return;
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int c = col0 + n * 8 + tig * 2;
    if (c >= t_len) s[n][0] = s[n][2] = -INFINITY;
    if (c + 1 >= t_len) s[n][1] = s[n][3] = -INFINITY;
  }
}

// Write this warp's 16 x 128 accumulator slice, times f_lo / f_hi per row
// half, as bf16 rows [row0, row0 + 16) of `dst` (rows past n_rows dropped).
__device__ __forceinline__ void store_slice(__nv_bfloat16* dst,
                                            long long stride,
                                            const float (&acc)[16][4],
                                            int row0, int n_rows, int slice,
                                            float f_lo, float f_hi) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int r_lo = row0 + g, r_hi = row0 + g + 8;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int c = slice * kSlice + n * 8 + tig * 2;
    if (r_lo < n_rows)
      *reinterpret_cast<uint32_t*>(dst + r_lo * stride + c) =
          pack_bf16(acc[n][0] * f_lo, acc[n][1] * f_lo);
    if (r_hi < n_rows)
      *reinterpret_cast<uint32_t*>(dst + r_hi * stride + c) =
          pack_bf16(acc[n][2] * f_hi, acc[n][3] * f_hi);
  }
}

__device__ __forceinline__ void zero16(float (&acc)[16][4]) {
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
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
// 16): the running max in log2 units and this thread's share of the sum.
struct RowStats {
  float m_lo, m_hi, l_lo, l_hi;
};

// Tile j's online softmax in base 2 on its summed scores `s`, then
// o += p v_j over this slice's columns.  Both forwards run this same code
// on the same scores, so they give the same bits.
template <class W>
__device__ __forceinline__ void consume_tile(float (&s)[4][4],
                                             float (&o)[16][4], RowStats& r,
                                             float scale_log2, uint32_t v_tile,
                                             int slice) {
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  const float mn_lo = fmaxf(r.m_lo, mx_lo * scale_log2);
  const float mn_hi = fmaxf(r.m_hi, mx_hi * scale_log2);
  const float alpha_lo = exp2f(r.m_lo - mn_lo);
  const float alpha_hi = exp2f(r.m_hi - mn_hi);
  r.m_lo = mn_lo;
  r.m_hi = mn_hi;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    s[n][0] = exp2f(fmaf(s[n][0], scale_log2, -mn_lo));
    s[n][1] = exp2f(fmaf(s[n][1], scale_log2, -mn_lo));
    s[n][2] = exp2f(fmaf(s[n][2], scale_log2, -mn_hi));
    s[n][3] = exp2f(fmaf(s[n][3], scale_log2, -mn_hi));
    sum_lo += s[n][0] + s[n][1];
    sum_hi += s[n][2] + s[n][3];
  }
  r.l_lo = r.l_lo * alpha_lo + sum_lo;
  r.l_hi = r.l_hi * alpha_hi + sum_hi;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    o[n][0] *= alpha_lo;
    o[n][1] *= alpha_lo;
    o[n][2] *= alpha_hi;
    o[n][3] *= alpha_hi;
  }
  uint32_t pa[2][4];
  pack_frags(pa, s);
  mma_slice_nn<W>(o, pa, v_tile, slice);
}

// o = acc / l as bf16 through o's strides, and the natural-log LSE of the
// block's rows [q0, q0 + 32).
__device__ __forceinline__ void store_fwd(const Params& p, float (&o)[16][4],
                                          RowStats r, int q0, int group,
                                          int slice) {
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    r.l_lo += __shfl_xor_sync(0xffffffffu, r.l_lo, off);
    r.l_hi += __shfl_xor_sync(0xffffffffu, r.l_hi, off);
  }
  const long long* os = p.st + 9;
  __nv_bfloat16* ob =
      static_cast<__nv_bfloat16*>(p.out0) + b * os[0] + h * os[2];
  const int row0 = q0 + group * 16;
  store_slice(ob, os[1], o, row0, p.s_len, slice, 1.f / r.l_lo, 1.f / r.l_hi);
  if (slice == 0 && tig == 0) {
    const float ln2 = 0.6931471805599453f;
    float* lb = p.lse + (long long)bh * p.s_len;
    if (row0 + g < p.s_len) lb[row0 + g] = (r.m_lo + log2f(r.l_lo)) * ln2;
    if (row0 + g + 8 < p.s_len)
      lb[row0 + g + 8] = (r.m_hi + log2f(r.l_hi)) * ln2;
  }
}

template <class W>
__global__ void __launch_bounds__(W::kThreads, 1) fwd_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_s = smem_u32(smem), k_s = q_s + W::kTile,
                 v_s = k_s + 2 * W::kTile;
  float4* part = reinterpret_cast<float4*>(smem + 5 * W::kTile);

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int warp = threadIdx.x >> 5;
  const int group = warp % kGroups, slice = warp / kGroups;
  const int q0 = blockIdx.x * kRows;
  const Rows q = rows_of(p.q, p.st, b, h), k = rows_of(p.k, p.st + 3, b, h),
             v = rows_of(p.v, p.st + 6, b, h);

  const int n_tiles = (p.t_len + kRows - 1) / kRows;
  load_tile<W, kRows>(q_s, q, q0, p.s_len);
  load_tile<W, kRows>(k_s, k, 0, p.t_len);
  load_tile<W, kRows>(v_s, v, 0, p.t_len);
  cp_async_commit();

  float o[16][4];
  zero16(o);
  RowStats r = {-INFINITY, -INFINITY, 0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<W, kRows>(k_s + (buf ^ 1) * W::kTile, k, (j + 1) * kRows,
                        p.t_len);
      load_tile<W, kRows>(v_s + (buf ^ 1) * W::kTile, v, (j + 1) * kRows,
                        p.t_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // ---- s = q k^T: this slice's share, then the slices' sum
    float s[4][4];
    mma_slice_nt<W>(s, q_s, group * 16, k_s + buf * W::kTile, slice);
    put_part<W>(part, s, group, slice);
    __syncthreads();
    sum_parts<W>(s, part, group);
    mask_cols(s, j * kRows, p.t_len);

    // ---- online softmax, o += p v
    consume_tile<W>(s, o, r, p.scale_log2, v_s + buf * W::kTile, slice);
    __syncthreads();  // the partials and this stage are written next
  }
  store_fwd(p, o, r, q0, group, slice);
}

// ---------------------------------------------------------------------------
// deferred-softmax forward: strides of q, k, v, o
// ---------------------------------------------------------------------------
//
// Replaces `_fwd_kernel_pipelined` at these widths: the same function as
// fwd_kernel, with tile j + 1's scores issued ahead of tile j's softmax.
// The TPU kernel walks n_kv + 1 grid steps; step j writes S_j = q k_j^T
// into one of two VMEM score buffers by parity and runs tile j - 1's
// softmax and p v from the other, so that the matrix unit and the vector
// unit have independent work in one body.  Here body j sums S_j's partials
// (written by the previous body), issues S_{j+1}'s product and writes its
// partials, and runs tile j's softmax and o += p v_j: the products of
// S_{j+1} and tile j's exp2 have no dependence inside the body.  T is a
// multiple of 32 with at least two tiles (the dispatch rule), so no column
// is masked.
//
// The partial-score exchange.  S_{j+1}'s partials are written while other
// warps may still be summing S_j's, so they go to a second buffer: two by
// parity (part[j & 1] holds S_j's).  With the k and v refills issued after
// the barrier, that makes one __syncthreads a kv tile (fwd_kernel takes
// three):
//
//   prologue: q, k_0 | k_1, v_0 (two cp.async groups); wait for the first;
//             barrier; S_0's partials into part[0]
//   body j:   wait for every group; barrier (k_{j+1}, v_j and S_j's
//             partials are in, and every read of k_j, v_{j-1} and S_{j-1}'s
//             partials is done); refill k_{j+2} where k_j was and v_{j+1}
//             where v_{j-1} was, one group; S_j = sum of part[j & 1];
//             S_{j+1}'s partials into part[(j + 1) & 1]; tile j's softmax
//             and o += p v_j
//
// So the k stream runs one tile ahead of the v stream, each two stages
// deep, and each refill has the rest of its body to land.  The last body
// produces nothing: it is written out after the loop, so that no branch
// sits between a product and the softmax it overlaps.  Shared memory:
// fwd_kernel's plus one partial buffer (192 KB at 512, 96 KB at 256: still
// two blocks an SM there).

template <class W>
__global__ void __launch_bounds__(W::kThreads, 1)
    fwd_deferred_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_s = smem_u32(smem), k_s = q_s + W::kTile,
                 v_s = k_s + 2 * W::kTile;
  float4* part = reinterpret_cast<float4*>(smem + 5 * W::kTile);
  constexpr int kPartVecs = W::kPart / 16;  // float4s of one partial buffer

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int warp = threadIdx.x >> 5;
  const int group = warp % kGroups, slice = warp / kGroups;
  const int q0 = blockIdx.x * kRows;
  const Rows q = rows_of(p.q, p.st, b, h), k = rows_of(p.k, p.st + 3, b, h),
             v = rows_of(p.v, p.st + 6, b, h);

  const int n_tiles = p.t_len / kRows;
  load_tile<W, kRows>(q_s, q, q0, p.s_len);
  load_tile<W, kRows>(k_s, k, 0, p.t_len);
  cp_async_commit();
  load_tile<W, kRows>(k_s + W::kTile, k, kRows, p.t_len);
  load_tile<W, kRows>(v_s, v, 0, p.t_len);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  {
    float s0[4][4];
    mma_slice_nt<W>(s0, q_s, group * 16, k_s, slice);
    put_part<W>(part, s0, group, slice);
  }

  float o[16][4];
  zero16(o);
  RowStats r = {-INFINITY, -INFINITY, 0.f, 0.f};

  int j = 0;
  for (; j < n_tiles - 1; ++j) {
    const int cur = j & 1, nxt = cur ^ 1;
    cp_async_wait<0>();
    __syncthreads();
    if (j + 2 < n_tiles)
      load_tile<W, kRows>(k_s + cur * W::kTile, k, (j + 2) * kRows, p.t_len);
    load_tile<W, kRows>(v_s + nxt * W::kTile, v, (j + 1) * kRows, p.t_len);
    cp_async_commit();

    float s[4][4], sn[4][4];
    sum_parts<W>(s, part + cur * kPartVecs, group);
    // ---- produce S_{j+1}: this slice's share, summed by the next body
    mma_slice_nt<W>(sn, q_s, group * 16, k_s + nxt * W::kTile, slice);
    put_part<W>(part + nxt * kPartVecs, sn, group, slice);
    // ---- consume tile j
    consume_tile<W>(s, o, r, p.scale_log2, v_s + cur * W::kTile, slice);
  }
  // ---- the last body: consume only
  cp_async_wait<0>();
  __syncthreads();
  float s[4][4];
  sum_parts<W>(s, part + (j & 1) * kPartVecs, group);
  consume_tile<W>(s, o, r, p.scale_log2, v_s + (j & 1) * W::kTile, slice);
  store_fwd(p, o, r, q0, group, slice);
}

// ---------------------------------------------------------------------------
// dq and delta: strides of q, k, v, o, dO, dq
// ---------------------------------------------------------------------------

template <class W>
__global__ void __launch_bounds__(W::kThreads, 1) dq_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_s = smem_u32(smem), do_s = q_s + W::kTile,
                 k_s = do_s + W::kTile, v_s = k_s + 2 * W::kTile;
  unsigned char* rest = smem + 6 * W::kTile;
  float4* part_s = reinterpret_cast<float4*>(rest);
  float4* part_dp = part_s + W::kPart / 16;
  float* lse2_s = reinterpret_cast<float*>(rest + 2 * W::kPart);
  float* delta_s = lse2_s + kRows;

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp % kGroups, slice = warp / kGroups;
  const int g = lane >> 2;
  const int q0 = blockIdx.x * kRows;
  const Rows q = rows_of(p.q, p.st, b, h), k = rows_of(p.k, p.st + 3, b, h),
             v = rows_of(p.v, p.st + 6, b, h), o = rows_of(p.o, p.st + 9, b, h),
             dout = rows_of(p.dout, p.st + 12, b, h);

  const int n_tiles = (p.t_len + kRows - 1) / kRows;
  load_tile<W, kRows>(q_s, q, q0, p.s_len);
  load_tile<W, kRows>(do_s, dout, q0, p.s_len);
  load_tile<W, kRows>(k_s, k, 0, p.t_len);
  load_tile<W, kRows>(v_s, v, 0, p.t_len);
  cp_async_commit();

  // ---- delta = rowsum(dO * O) in fp32, R / warps rows a warp, D / 32
  // columns a lane summed in order, then across the warp by a fixed tree;
  // lse in log2 units.  Rows past S get 0 and are not written.
  constexpr int kRowsAWarp = kRows / (W::kThreads / 32);
  constexpr int kVecs = W::kD / 256;  // 16-byte vectors a lane
#pragma unroll
  for (int i = 0; i < kRowsAWarp; ++i) {
    const int r = warp * kRowsAWarp + i, row = q0 + r;
    float acc = 0.f;
    if (row < p.s_len) {
      const uint4* ov = reinterpret_cast<const uint4*>(o.p + row * o.stride);
      const uint4* dv =
          reinterpret_cast<const uint4*>(dout.p + row * dout.stride);
#pragma unroll
      for (int c = 0; c < kVecs; ++c) {
        const uint4 a = ov[lane * kVecs + c], d = dv[lane * kVecs + c];
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 af = __bfloat1622float2(a2[e]);
          const float2 df = __bfloat1622float2(d2[e]);
          acc = fmaf(af.x, df.x, acc);
          acc = fmaf(af.y, df.y, acc);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      delta_s[r] = acc;
      lse2_s[r] = row < p.s_len ? p.lse[(long long)bh * p.s_len + row] * kLog2e
                                : 0.f;
      if (row < p.s_len) p.delta[(long long)bh * p.s_len + row] = acc;
    }
  }

  float dq[16][4];
  zero16(dq);
  float lse2_lo = 0.f, lse2_hi = 0.f, delta_lo = 0.f, delta_hi = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<W, kRows>(k_s + (buf ^ 1) * W::kTile, k, (j + 1) * kRows,
                        p.t_len);
      load_tile<W, kRows>(v_s + (buf ^ 1) * W::kTile, v, (j + 1) * kRows,
                        p.t_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
      lse2_lo = lse2_s[group * 16 + g];
      lse2_hi = lse2_s[group * 16 + g + 8];
      delta_lo = delta_s[group * 16 + g];
      delta_hi = delta_s[group * 16 + g + 8];
    }

    // ---- s = q k^T and dp = dO v^T, each summed over the slices
    float s[4][4], dp[4][4];
    mma_slice_nt<W>(s, q_s, group * 16, k_s + buf * W::kTile, slice);
    mma_slice_nt<W>(dp, do_s, group * 16, v_s + buf * W::kTile, slice);
    put_part<W>(part_s, s, group, slice);
    put_part<W>(part_dp, dp, group, slice);
    __syncthreads();
    sum_parts<W>(s, part_s, group);
    sum_parts<W>(dp, part_dp, group);
    mask_cols(s, j * kRows, p.t_len);

    // ---- ds = p * (dp - delta), p = exp2(s*scale*log2e - lse*log2e)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      s[n][0] = exp2f(fmaf(s[n][0], p.scale_log2, -lse2_lo)) * (dp[n][0] - delta_lo);
      s[n][1] = exp2f(fmaf(s[n][1], p.scale_log2, -lse2_lo)) * (dp[n][1] - delta_lo);
      s[n][2] = exp2f(fmaf(s[n][2], p.scale_log2, -lse2_hi)) * (dp[n][2] - delta_hi);
      s[n][3] = exp2f(fmaf(s[n][3], p.scale_log2, -lse2_hi)) * (dp[n][3] - delta_hi);
    }

    // ---- dq += ds k over this slice's columns
    uint32_t dsa[2][4];
    pack_frags(dsa, s);
    mma_slice_nn<W>(dq, dsa, k_s + buf * W::kTile, slice);
    __syncthreads();
  }

  const long long* ds = p.st + 15;
  __nv_bfloat16* dqb =
      static_cast<__nv_bfloat16*>(p.out0) + b * ds[0] + h * ds[2];
  store_slice(dqb, ds[1], dq, q0 + group * 16, p.s_len, slice, p.scale,
              p.scale);
}

// ---------------------------------------------------------------------------
// dk and dv: strides of q, k, v, dO, dk, dv
// ---------------------------------------------------------------------------

// lse and delta of q rows [row0, row0 + 32) into shared memory (threads
// 0..31 copy lse, 32..63 delta); rows at or past s_len are zero-filled.
__device__ __forceinline__ void load_row_stats(float* lse_dst, float* delta_dst,
                                               const float* lse,
                                               const float* delta, int row0,
                                               int s_len) {
  if (threadIdx.x >= 2 * kRows) return;
  const int r = threadIdx.x % kRows;
  const bool ok = row0 + r < s_len;
  const float* src = (threadIdx.x < kRows ? lse : delta) + (ok ? row0 + r : 0);
  float* dst = (threadIdx.x < kRows ? lse_dst : delta_dst) + r;
  cp_async_4(smem_u32(dst), src, ok ? 4 : 0);
}

template <class W>
__global__ void __launch_bounds__(W::kThreads, 1) dkv_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t k_s = smem_u32(smem), v_s = k_s + W::kTile,
                 q_s = v_s + W::kTile, do_s = q_s + 2 * W::kTile;
  unsigned char* rest = smem + 6 * W::kTile;
  float4* part_s = reinterpret_cast<float4*>(rest);
  float4* part_dp = part_s + W::kPart / 16;
  float* lse_s = reinterpret_cast<float*>(rest + 2 * W::kPart);
  float* delta_s = lse_s + 2 * kRows;

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp % kGroups, slice = warp / kGroups;
  const int tig = lane & 3;
  const int kv0 = blockIdx.x * kRows;
  const Rows q = rows_of(p.q, p.st, b, h), k = rows_of(p.k, p.st + 3, b, h),
             v = rows_of(p.v, p.st + 6, b, h),
             dout = rows_of(p.dout, p.st + 9, b, h);
  const float* lb = p.lse + (long long)bh * p.s_len;
  const float* db = p.delta + (long long)bh * p.s_len;

  const int n_tiles = (p.s_len + kRows - 1) / kRows;
  load_tile<W, kRows>(k_s, k, kv0, p.t_len);
  load_tile<W, kRows>(v_s, v, kv0, p.t_len);
  load_tile<W, kRows>(q_s, q, 0, p.s_len);
  load_tile<W, kRows>(do_s, dout, 0, p.s_len);
  load_row_stats(lse_s, delta_s, lb, db, 0, p.s_len);
  cp_async_commit();

  float dk[16][4], dv[16][4];
  zero16(dk);
  zero16(dv);

  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < n_tiles) {
      load_tile<W, kRows>(q_s + (buf ^ 1) * W::kTile, q, (i + 1) * kRows,
                        p.s_len);
      load_tile<W, kRows>(do_s + (buf ^ 1) * W::kTile, dout, (i + 1) * kRows,
                        p.s_len);
      load_row_stats(lse_s + (buf ^ 1) * kRows, delta_s + (buf ^ 1) * kRows,
                     lb, db, (i + 1) * kRows, p.s_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // ---- s^T = k q^T and dp^T = v dO^T (16 kv rows x 32 q columns), each
    // summed over the slices; lse and delta index the columns
    float st[4][4], dpt[4][4];
    mma_slice_nt<W>(st, k_s, group * 16, q_s + buf * W::kTile, slice);
    mma_slice_nt<W>(dpt, v_s, group * 16, do_s + buf * W::kTile, slice);
    put_part<W>(part_s, st, group, slice);
    put_part<W>(part_dp, dpt, group, slice);
    __syncthreads();
    sum_parts<W>(st, part_s, group);
    sum_parts<W>(dpt, part_dp, group);

    const float* ls = lse_s + buf * kRows;
    const float* dl = delta_s + buf * kRows;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = n * 8 + tig * 2;
      const float l0 = ls[c] * kLog2e, l1 = ls[c + 1] * kLog2e;
      st[n][0] = exp2f(fmaf(st[n][0], p.scale_log2, -l0));
      st[n][1] = exp2f(fmaf(st[n][1], p.scale_log2, -l1));
      st[n][2] = exp2f(fmaf(st[n][2], p.scale_log2, -l0));
      st[n][3] = exp2f(fmaf(st[n][3], p.scale_log2, -l1));
    }

    // ---- dv += p^T dO
    uint32_t a[2][4];
    pack_frags(a, st);
    mma_slice_nn<W>(dv, a, do_s + buf * W::kTile, slice);

    // ---- ds^T = p^T * (dp^T - delta); dk += ds^T q
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = n * 8 + tig * 2;
      st[n][0] *= dpt[n][0] - dl[c];
      st[n][1] *= dpt[n][1] - dl[c + 1];
      st[n][2] *= dpt[n][2] - dl[c];
      st[n][3] *= dpt[n][3] - dl[c + 1];
    }
    pack_frags(a, st);
    mma_slice_nn<W>(dk, a, q_s + buf * W::kTile, slice);
    __syncthreads();
  }

  const long long* ks = p.st + 12;
  const long long* vs = p.st + 15;
  const int row0 = kv0 + group * 16;
  store_slice(static_cast<__nv_bfloat16*>(p.out0) + b * ks[0] + h * ks[2],
              ks[1], dk, row0, p.t_len, slice, p.scale, p.scale);
  store_slice(static_cast<__nv_bfloat16*>(p.out1) + b * vs[0] + h * vs[2],
              vs[1], dv, row0, p.t_len, slice, 1.f, 1.f);
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
  p.scale_log2 = scale * kLog2e;
  dim3 grid((rows + kRows - 1) / kRows, b * h);
  kernel<<<grid, W::kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}

// o and lse; strides of q, k, v, o.
template <class W>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int b, int h, int s_len, int t_len, const long long* strides,
        float scale, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      fwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, W::kFwdSmem);
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

// The deferred-softmax forward: o and lse as fwd; t_len a multiple of 32 of
// at least 64 (cudaErrorInvalidValue otherwise: the dispatch rule).
template <class W>
int fwd_deferred(const void* q, const void* k, const void* v, void* o,
                 void* lse, int b, int h, int s_len, int t_len,
                 const long long* strides, float scale, void* stream) {
  if (t_len % kRows || t_len < 2 * kRows) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fwd_deferred_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      W::kFwdDeferredSmem);
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
  static const cudaError_t attr = cudaFuncSetAttribute(
      dq_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, W::kDqSmem);
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
  static const cudaError_t attr = cudaFuncSetAttribute(
      dkv_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, W::kDkvSmem);
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

// Plain C entry points for ctypes, with the head_dim-64 entries' argument
// lists (flash_fwd_pipelined_* refuses a t_len the dispatch rule refuses).  Tensors (B, len, H, D) bf16, D = 512 or 256 as the name says, with
// the element strides in `strides` (sb, sl, sh each; head_dim stride 1), lse
// and delta (B*H, S) fp32 contiguous.  Each launches on `stream`, allocates
// nothing, and returns a CUDA error code (0 = launched).

#define FLASH_WIDE_ENTRIES(W, d)                                              \
  extern "C" int flash_fwd_##d##_bf16(                                        \
      const void* q, const void* k, const void* v, void* o, void* lse, int b, \
      int h, int s_len, int t_len, const long long* strides, float scale,     \
      void* stream) {                                                         \
    return fwd<W>(q, k, v, o, lse, b, h, s_len, t_len, strides, scale,        \
                  stream);                                                    \
  }                                                                           \
  extern "C" int flash_fwd_pipelined_##d##_bf16(                              \
      const void* q, const void* k, const void* v, void* o, void* lse, int b, \
      int h, int s_len, int t_len, const long long* strides, float scale,     \
      void* stream) {                                                         \
    return fwd_deferred<W>(q, k, v, o, lse, b, h, s_len, t_len, strides,      \
                           scale, stream);                                    \
  }                                                                           \
  extern "C" int flash_bwd_dq_##d##_bf16(                                     \
      const void* q, const void* k, const void* v, const void* o,             \
      const void* dout, const void* lse, void* delta, void* dq, int b, int h, \
      int s_len, int t_len, const long long* strides, float scale,            \
      void* stream) {                                                         \
    return bwd_dq<W>(q, k, v, o, dout, lse, delta, dq, b, h, s_len, t_len,    \
                     strides, scale, stream);                                 \
  }                                                                           \
  extern "C" int flash_bwd_dkv_##d##_bf16(                                    \
      const void* q, const void* k, const void* v, const void* dout,          \
      const void* lse, const void* delta, void* dk, void* dv, int b, int h,   \
      int s_len, int t_len, const long long* strides, float scale,            \
      void* stream) {                                                         \
    return bwd_dkv<W>(q, k, v, dout, lse, delta, dk, dv, b, h, s_len, t_len,  \
                      strides, scale, stream);                                \
  }

FLASH_WIDE_ENTRIES(D512, d512)
FLASH_WIDE_ENTRIES(D256, d256)
