// Flash attention at the narrow head_dims, every multiple of 8 up to 128
// but 64, for Hopper (sm_90a): the forward, the deferred-softmax forward,
// the dq kernel (which also writes delta) and the dk/dv kernel, on bf16 and
// on fp32 inputs, fp32 LSE and delta.  One source, templated on the element
// type and on a tile width W in {16, 32, 64, 128} (`Narrow<T, W>`); a call
// at head_dim D runs at the smallest W >= D.  All four bf16 kernels at
// W = 16 (both forwards and the backward pair) are flash_narrow_w16_sm90.cu's
// (redesigned for the tiny model's shapes); this source keeps the fp32
// kernels at 16 and every kernel at W = 32 to 128.  Head_dim 64
// itself stays with flash_fwd.cu, flash_fwd_pipelined.cu, flash_bwd.cu
// (bf16) and flash_fp32.cu (fp32); 256 and 512 with their own sources.
// The widths that reach these kernels: 8 (the tiny model's UNet heads) and
// 16 (its VAE mid-block's single head with VAEConfig.use_flash_attention);
// 40 and 80 are SD1.x's, 128 a common width elsewhere.
//
// Replaces the Pallas TPU kernels of diffute_tpu/ops/flash_attention.py at
// those widths: `_fwd_kernel` (pl.pallas_call in `_flash_fwd_3d`),
// `_fwd_kernel_pipelined` (in `_flash_fwd_3d_pipelined`), `_bwd_dq_kernel`
// and `_bwd_dkv_kernel` (both in `_flash_bwd_3d`).  Their BlockSpecs take
// whole rows of any width into VMEM and carry (m, l, acc), dq or dk/dv in
// VMEM scratch across a sequential grid axis; here one block owns a tile of
// rows of one (batch, head) and loops over the other axis itself.
//
//   q (B, S, H, D), k/v (B, T, H, D)  bf16 or fp32, any strides that are
//     whole 16-byte chunks with the last one 1 (16-byte cp.async)
//   o, dq (B, S, H, D), dk, dv (B, T, H, D) through their strides; only
//     the D real columns are read or written
//   lse, delta (B*H, S) fp32 contiguous; lse natural log
//
// The arithmetic is that of the other entries at the same dtype (the plain
// versions flash_fwd_tiled_reference / flash_bwd_tiled_reference of
// ops/flash_attention.py state it):
//   bf16: base 2 after the product (scale * log2 e folded into one FMA
//     inside the exp2), p rounded to bf16 against the running max before
//     p v, ds rounded to bf16 before ds k and ds^T q, bf16(p)^T dO; the
//     deferred forward runs the same code in another order (the same bits);
//   fp32: 3xTF32 products on mma.sync.m16n8k8.tf32 (each operand split
//     into hi + lo, lo_a hi_b + hi_a lo_b + hi_a hi_b accumulated in fp32),
//     p and ds kept fp32; the standard forward and the backward in the
//     natural domain with the exact scale after the product, the deferred
//     forward on q prescaled by fp32(scale * log2 e) in base 2.  The tensor
//     cores' fp32 accumulation truncates, so no tensor-core sum spans more
//     than 32 rows of one tile (flash_fp32.cu's rule).
// The scale is the caller's, never W^-0.5.
//
// What bounds them on the H100.  A score costs 2 D multiply-adds in each
// product against one exponential.  The special-function unit gives 16
// exponentials a clock an SM (about 3.9e12 a second at 1.83 GHz over 132
// SMs) against 1,024 bf16 tensor-core FLOPs a clock an SM, so at D <= 32
// the exponentials, not the products or the bytes, set the least time:
// at (B*H, S, T) = (2, 65536, 65536) and D = 8, 2.75e11 FLOPs take 0.28 ms
// at 989 TFLOP/s and the 8.6e9 exponentials about 2.2 ms.  (The bf16
// kernels at W = 16 are flash_narrow_w16_sm90.cu's, whose exponentials are
// each one MUFU.EX2: its forwards reach 69% of that bound, its pair 55-73%;
// here exp2f / expf without -ftz lower to a compare, two predicated
// multiplies and the MUFU, and this source's W = 16 bf16 kernels issued 14.4
// (forward) and 17.8 (dq, dk/dv) instructions a score.)  What the design
// does about it: each warp keeps a 16-row tile's scores, its softmax state
// and its whole W-column accumulator in registers (at W = 128, 64 fp32 a
// thread), so no score or partial sum leaves the SM and no barrier but the
// ring's is taken; the blocks are small (2 or 4 warps, 2 to 96 KB of shared
// memory), so many of them share an SM and one block's exponentials run
// while another's products and loads do.  Nothing else is tuned here.
//
// Layout.  Every tile has R rows: R = 64 at W <= 32, 32 at W = 64 and 128
// (dk plus dv at W = 128 is 128 fp32 a thread).  A block is R / 16 warps,
// one per 16 rows of the resident tile (q; q and dO; k and v), each owning
// all W columns; the streamed tiles (k, v; or q, dO) come two stages deep
// through cp.async.  A call loads D columns of each row and zero-fills the
// rest of the W in shared memory (cp.async's src-size 0): zero q and k
// columns add exactly 0 to every score, and the products skip the 8- or
// 16-column steps past D (bf16: a 16-column step that holds D may hold 8
// zero columns); columns past D of o, dq, dk and dv are never stored.
//
// Swizzle.  Tiles are stored by 16-byte chunks, chunk c of row r at
// c ^ x(r), x(r) = r & 7 for rows of 8 chunks or more and, for shorter
// rows, the index of the row's 128-byte line (mod its chunk count): the 8
// rows that one ldmatrix (bf16) or one 32-lane fragment load (fp32, 32-bit
// loads: ldmatrix cannot transpose 32-bit elements) reads fall on distinct
// banks, but for the fp32 p v operand at W = 16 (2-way).
//
// Ragged edges.  Rows past the end of a tile are zero-filled.  The forward
// and dq mask the kv columns past T in the last kv tile (p = 0).  dk/dv: q
// rows past S are zero (so dO = 0), and their lse and delta are zero-filled
// too, which gives p = 1 and ds = 1 * (0 - 0) = 0: they contribute nothing.
// Rows past the end of an output are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_mma_sync.cuh"
#include "tf32_sm90.cuh"

namespace {

using namespace bf16_mma;
using namespace tf32_sm90;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The tiling of one instantiation: element type T, tile width W.
template <typename T, int W>
struct Narrow {
  using Elem = T;
  static constexpr bool kFp32 = std::is_same<T, float>::value;
  static constexpr int kW = W;
  static constexpr int kRows = W <= 32 ? 64 : 32;
  static constexpr int kThreads = kRows / 16 * 32;  // a warp a 16-row group
  static constexpr int kVec = 16 / sizeof(T);       // elements a chunk
  static constexpr int kChunks = W / kVec;          // chunks a row
  static constexpr int kNT = kRows / 8;             // 8-column score tiles
  static constexpr int kWT = W / 8;                 // 8-column output tiles
  static constexpr int kTile = kRows * W * (int)sizeof(T);
  // q | k[2] | v[2] (both forwards)
  static constexpr int kFwdSmem = 5 * kTile;
  // q | dO | k[2] | v[2] | lse | delta
  static constexpr int kDqSmem = 6 * kTile + 2 * kRows * 4;
  // k | v | q[2] | dO[2] | lse[2] | delta[2]
  static constexpr int kDkvSmem = 6 * kTile + 4 * kRows * 4;
  static_assert(kChunks >= 2 && (kChunks & (kChunks - 1)) == 0,
                "a power of two chunks a row, at least two");
  static_assert((kRows * kChunks) % kThreads == 0, "whole chunks a thread");
  static_assert(kThreads == 2 * kRows, "load_row_stats' threads");
  static_assert(kDkvSmem <= 232448, "227 KB a block");
};

// The chunk XOR of row r (see Swizzle above).
template <class N>
__device__ __forceinline__ int xr(int r) {
  if constexpr (N::kChunks >= 8)
    return r & 7;
  else
    return (r / (8 / N::kChunks)) & (N::kChunks - 1);
}

// byte offset of chunk c of row r in a swizzled tile
template <class N>
__device__ __forceinline__ uint32_t chunk_off(int r, int c) {
  return r * (N::kW * (int)sizeof(typename N::Elem)) + ((c ^ xr<N>(r)) << 4);
}

// float index of element (r, col) in a swizzled fp32 tile
template <class N>
__device__ __forceinline__ int fidx(int r, int col) {
  return r * N::kW + (((col >> 2) ^ xr<N>(r)) << 2) + (col & 3);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// An A fragment of the tf32 product split into its TF32 halves.
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
template <typename T>
struct Rows {
  const T* p;
  long long stride;
};

template <typename T>
__device__ __forceinline__ Rows<T> rows_of(const void* base,
                                           const long long* st, int b, int h) {
  return {static_cast<const T*>(base) + b * st[0] + h * st[2], st[1]};
}

// Copy the first `n_chunks` chunks of rows [row0, row0 + R) of `src` into
// the swizzled tile at `dst`; rows at or past `n_rows`, and the chunks past
// `n_chunks`, are zero-filled.  Neighbouring threads on neighbouring chunks
// of one row.
template <class N>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          Rows<typename N::Elem> src, int row0,
                                          int n_rows, int n_chunks) {
#pragma unroll
  for (int i = 0; i < N::kRows * N::kChunks / N::kThreads; ++i) {
    const int id = threadIdx.x + i * N::kThreads;
    const int r = id / N::kChunks, c = id % N::kChunks;
    const bool ok = row0 + r < n_rows && c < n_chunks;
    const typename N::Elem* g =
        src.p + (ok ? (row0 + r) * src.stride + c * N::kVec : 0);
    cp_async_16(dst + chunk_off<N>(r, c), g, ok ? 16 : 0);
  }
}

// acc (16 x R) = rows [a0, a0 + 16) of the tile at byte `a` times rows
// [0, R) of the tile at byte `b`, transposed, over the first d columns
// (rounded up to the product's step; the rest are zero in the tiles).
template <class N>
__device__ __forceinline__ void scores(float (&acc)[N::kNT][4],
                                       unsigned char* smem, int a, int a0,
                                       int b, int d) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < N::kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  if constexpr (N::kFp32) {
    const float* fa_s = reinterpret_cast<const float*>(smem + a);
    const float* fb_s = reinterpret_cast<const float*>(smem + b);
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < N::kW / 8; ++kk) {
      if (kk * 8 < d) {
        const int c = kk * 8 + t;
        FragA fa;
        split_a(fa, fa_s[fidx<N>(a0 + g, c)], fa_s[fidx<N>(a0 + g + 8, c)],
                fa_s[fidx<N>(a0 + g, c + 4)],
                fa_s[fidx<N>(a0 + g + 8, c + 4)]);
#pragma unroll
        for (int n = 0; n < N::kNT; ++n)
          mma3(acc[n], fa, fb_s[fidx<N>(n * 8 + g, c)],
               fb_s[fidx<N>(n * 8 + g, c + 4)]);
      }
    }
  } else {
    const uint32_t sa = smem_u32(smem) + a, sb = smem_u32(smem) + b;
    const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
    for (int kk = 0; kk < N::kW / 16; ++kk) {
      if (kk * 16 < d) {
        // A: (rows 0-7, k lo), (8-15, k lo), (0-7, k hi), (8-15, k hi)
        uint32_t fa[4];
        ldmatrix_x4(fa, sa + chunk_off<N>(a0 + (mi & 1) * 8 + mr,
                                          kk * 2 + (mi >> 1)));
#pragma unroll
        for (int p = 0; p < N::kNT / 2; ++p) {
          // B: (n0, k lo), (n0, k hi), (n0 + 8, k lo), (n0 + 8, k hi)
          uint32_t fb[4];
          ldmatrix_x4(fb, sb + chunk_off<N>(p * 16 + (mi >> 1) * 8 + mr,
                                            kk * 2 + (mi & 1)));
          mma_bf16(acc[2 * p], fa, fb[0], fb[1]);
          mma_bf16(acc[2 * p + 1], fa, fb[2], fb[3]);
        }
      }
    }
  }
}

// acc (16 x W) += s (16 x R, an fp32 accumulator) times rows [0, R) of the
// tile at byte `b` (the contraction runs over the tile's rows), over the
// output columns below d.  bf16: s rounded to bf16 first (the accumulator
// layout is the A-fragment layout).  fp32: 3xTF32, the contraction in the
// order k' = 2t, 2t + 1 for k = t, t + 4 so that s is the A operand as it
// lies, each 16 x 8 block summed from zero over 32 rows at most and then
// added to acc in fp32.
template <class N>
__device__ __forceinline__ void accumulate(float (&acc)[N::kWT][4],
                                           const float (&s)[N::kNT][4],
                                           unsigned char* smem, int b, int d) {
  const int lane = threadIdx.x & 31;
  if constexpr (N::kFp32) {
    constexpr int kChunk = N::kNT < 4 ? N::kNT : 4;  // 8-row steps a sum
    const float* fb_s = reinterpret_cast<const float*>(smem + b);
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int n0 = 0; n0 < N::kNT; n0 += kChunk) {
      FragA fa[kChunk];
#pragma unroll
      for (int n = 0; n < kChunk; ++n)
        split_a(fa[n], s[n0 + n][0], s[n0 + n][2], s[n0 + n][1],
                s[n0 + n][3]);
#pragma unroll
      for (int j = 0; j < N::kWT; ++j) {
        if (j * 8 < d) {
          const int c = j * 8 + g;
          float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int n = 0; n < kChunk; ++n) {
            const int r = (n0 + n) * 8 + 2 * t;
            mma3(part, fa[n], fb_s[fidx<N>(r, c)], fb_s[fidx<N>(r + 1, c)]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] += part[i];
        }
      }
    }
  } else {
    uint32_t fa[N::kNT / 2][4];
#pragma unroll
    for (int kk = 0; kk < N::kNT / 2; ++kk) {
      fa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      fa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      fa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      fa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    const uint32_t sb = smem_u32(smem) + b;
    const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
    for (int kk = 0; kk < N::kNT / 2; ++kk) {
      const int row = kk * 16 + (mi & 1) * 8 + mr;
#pragma unroll
      for (int p = 0; p < N::kW / 16; ++p) {
        if (p * 16 < d) {
          // transposed: (k lo, n0), (k hi, n0), (k lo, n0 + 8), (k hi, n0 + 8)
          uint32_t fb[4];
          ldmatrix_x4_trans(fb, sb + chunk_off<N>(row, p * 2 + (mi >> 1)));
          mma_bf16(acc[2 * p], fa[kk], fb[0], fb[1]);
          mma_bf16(acc[2 * p + 1], fa[kk], fb[2], fb[3]);
        }
      }
    }
  }
}

// The kv columns at or past t_len of a tile starting at col0: -inf.
template <class N>
__device__ __forceinline__ void mask_cols(float (&s)[N::kNT][4], int col0,
                                          int t_len) {
  if (col0 + N::kRows <= t_len) return;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < N::kNT; ++n) {
    const int c = col0 + n * 8 + t * 2;
    if (c >= t_len) s[n][0] = s[n][2] = -INFINITY;
    if (c + 1 >= t_len) s[n][1] = s[n][3] = -INFINITY;
  }
}

template <class N>
__device__ __forceinline__ void scale_scores(float (&s)[N::kNT][4], float f) {
#pragma unroll
  for (int n = 0; n < N::kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] *= f;
}

template <class N>
__device__ __forceinline__ void zero_acc(float (&acc)[N::kWT][4]) {
#pragma unroll
  for (int n = 0; n < N::kWT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// Write this warp's 16 x W accumulator (its columns below d) as rows
// [row0, row0 + 16) of `dst` (rows past n_rows dropped): times f, or
// (`divide`) divided by l_lo / l_hi per row half.
template <class N>
__device__ __forceinline__ void store_rows(typename N::Elem* dst,
                                           long long stride,
                                           const float (&acc)[N::kWT][4],
                                           int row0, int n_rows, int d,
                                           float f_lo, float f_hi,
                                           bool divide) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r_lo = row0 + g, r_hi = row0 + g + 8;
#pragma unroll
  for (int n = 0; n < N::kWT; ++n) {
    if (n * 8 >= d) continue;
    const int c = n * 8 + t * 2;
    if (r_lo < n_rows)
      store2(dst + r_lo * stride + c,
             divide ? acc[n][0] / f_lo : acc[n][0] * f_lo,
             divide ? acc[n][1] / f_lo : acc[n][1] * f_lo);
    if (r_hi < n_rows)
      store2(dst + r_hi * stride + c,
             divide ? acc[n][2] / f_hi : acc[n][2] * f_hi,
             divide ? acc[n][3] / f_hi : acc[n][3] * f_hi);
  }
}

struct Params {
  const void *q, *k, *v, *o, *dout;
  void *out0, *out1;  // o | dq | dk, and dv
  float* lse;    // written by the forward, read by the backward
  float* delta;  // written by the dq kernel, read by the dk/dv kernel
  long long st[18];   // (sb, sl, sh) per tensor, in the entry's order
  int heads, s_len, t_len, d;
  float scale, scale_log2;
};

// ---------------------------------------------------------------------------
// forward: strides of q, k, v, o
// ---------------------------------------------------------------------------

// The softmax domain of a forward: kFma the bf16 kernels' (raw scores,
// exp2(s * scale log2 e - m) by one FMA, m in log2 units), kNatural the
// fp32 standard forward's (scores scaled first, exp), kBase2 the fp32
// deferred forward's (scores of prescaled q, already in log2 units, exp2).
enum Domain { kFma, kNatural, kBase2 };

// The online softmax of one thread's two rows (g and g + 8 of its warp's
// 16): the running max and this thread's share of the sum.
struct RowStats {
  float m_lo, m_hi, l_lo, l_hi;
};

template <Domain kDom>
__device__ __forceinline__ float soft_exp(float x) {
  return kDom == kNatural ? expf(x) : exp2f(x);
}

// Tile j's online softmax on its scores `s`, then o += p v_j.  Both
// forwards run this same code on the same scores.
template <class N, Domain kDom>
__device__ __forceinline__ void consume_tile(float (&s)[N::kNT][4],
                                             float (&o)[N::kWT][4],
                                             RowStats& r, unsigned char* smem,
                                             int v_tile, const Params& p) {
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int n = 0; n < N::kNT; ++n) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  const float c = kDom == kFma ? p.scale_log2 : 1.f;
  const float mn_lo = fmaxf(r.m_lo, mx_lo * c);
  const float mn_hi = fmaxf(r.m_hi, mx_hi * c);
  const float alpha_lo = soft_exp<kDom>(r.m_lo - mn_lo);
  const float alpha_hi = soft_exp<kDom>(r.m_hi - mn_hi);
  r.m_lo = mn_lo;
  r.m_hi = mn_hi;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int n = 0; n < N::kNT; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m = i < 2 ? mn_lo : mn_hi;
      s[n][i] = kDom == kFma ? exp2f(fmaf(s[n][i], c, -m))
                             : soft_exp<kDom>(s[n][i] - m);
    }
    sum_lo += s[n][0] + s[n][1];
    sum_hi += s[n][2] + s[n][3];
  }
  // one explicit FMA, so that both forwards round the sum alike (the
  // compiler's contraction of a * b + c may differ between kernels)
  r.l_lo = fmaf(r.l_lo, alpha_lo, sum_lo);
  r.l_hi = fmaf(r.l_hi, alpha_hi, sum_hi);
#pragma unroll
  for (int n = 0; n < N::kWT; ++n) {
    o[n][0] *= alpha_lo;
    o[n][1] *= alpha_lo;
    o[n][2] *= alpha_hi;
    o[n][3] *= alpha_hi;
  }
  accumulate<N>(o, s, smem, v_tile, p.d);
}

// o = acc / l through o's strides, and the natural-log LSE of this warp's
// 16 rows from row0.
template <class N, Domain kDom>
__device__ __forceinline__ void store_fwd(const Params& p,
                                          const float (&o)[N::kWT][4],
                                          RowStats r, int row0) {
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    r.l_lo += __shfl_xor_sync(0xffffffffu, r.l_lo, off);
    r.l_hi += __shfl_xor_sync(0xffffffffu, r.l_hi, off);
  }
  const long long* os = p.st + 9;
  typename N::Elem* ob =
      static_cast<typename N::Elem*>(p.out0) + b * os[0] + h * os[2];
  if constexpr (N::kFp32)
    store_rows<N>(ob, os[1], o, row0, p.s_len, p.d, r.l_lo, r.l_hi, true);
  else
    store_rows<N>(ob, os[1], o, row0, p.s_len, p.d, 1.f / r.l_lo,
                  1.f / r.l_hi, false);
  if (t == 0) {
    float* lb = p.lse + (long long)bh * p.s_len;
    const float lse_lo = kDom == kNatural ? r.m_lo + logf(r.l_lo)
                                          : (r.m_lo + log2f(r.l_lo)) * kLn2;
    const float lse_hi = kDom == kNatural ? r.m_hi + logf(r.l_hi)
                                          : (r.m_hi + log2f(r.l_hi)) * kLn2;
    if (row0 + g < p.s_len) lb[row0 + g] = lse_lo;
    if (row0 + g + 8 < p.s_len) lb[row0 + g + 8] = lse_hi;
  }
}

template <class N>
__global__ void __launch_bounds__(N::kThreads) fwd_kernel(Params p) {
  using T = typename N::Elem;
  constexpr Domain kDom = N::kFp32 ? kNatural : kFma;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  constexpr int kQ = 0, kK = N::kTile, kV = 3 * N::kTile;

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * N::kRows;
  const int n_chunks = p.d / N::kVec;
  const Rows<T> q = rows_of<T>(p.q, p.st, b, h),
                k = rows_of<T>(p.k, p.st + 3, b, h),
                v = rows_of<T>(p.v, p.st + 6, b, h);

  const int n_tiles = (p.t_len + N::kRows - 1) / N::kRows;
  load_tile<N>(base + kQ, q, q0, p.s_len, n_chunks);
  load_tile<N>(base + kK, k, 0, p.t_len, n_chunks);
  load_tile<N>(base + kV, v, 0, p.t_len, n_chunks);
  cp_async_commit();

  float o[N::kWT][4];
  zero_acc<N>(o);
  RowStats r = {-INFINITY, -INFINITY, 0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<N>(base + kK + (buf ^ 1) * N::kTile, k, (j + 1) * N::kRows,
                   p.t_len, n_chunks);
      load_tile<N>(base + kV + (buf ^ 1) * N::kTile, v, (j + 1) * N::kRows,
                   p.t_len, n_chunks);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // ---- s = q k^T (fp32: times the scale), the kv columns past T masked
    float s[N::kNT][4];
    scores<N>(s, smem, kQ, warp * 16, kK + buf * N::kTile, p.d);
    if constexpr (N::kFp32) scale_scores<N>(s, p.scale);
    mask_cols<N>(s, j * N::kRows, p.t_len);

    // ---- online softmax, o += p v
    consume_tile<N, kDom>(s, o, r, smem, kV + buf * N::kTile, p);
    __syncthreads();  // this stage is written next
  }
  store_fwd<N, kDom>(p, o, r, q0 + warp * 16);
}

// ---------------------------------------------------------------------------
// deferred-softmax forward: strides of q, k, v, o
// ---------------------------------------------------------------------------
//
// Replaces `_fwd_kernel_pipelined`: the function of fwd_kernel (bf16) or of
// the JAX package's deferred kernel (fp32: q prescaled by fp32(scale *
// log2 e) in shared memory once, base 2), with tile j + 1's scores issued
// ahead of tile j's softmax and held in registers: body j waits for every
// cp.async group and passes one barrier (k_{j+1} and v_j are in, every read
// of k_j and v_{j-1} is done), refills k_{j+2} where k_j was and v_{j+1}
// where v_{j-1} was, issues S_{j+1} = q k_{j+1}^T, and runs tile j's
// softmax and o += p v_j, which do not depend on it.  The k stream runs one
// tile ahead of the v stream; one __syncthreads a kv tile.  T is a multiple
// of R with at least two tiles (the dispatch rule), so no column is masked.

template <class N>
__global__ void __launch_bounds__(N::kThreads) fwd_deferred_kernel(Params p) {
  using T = typename N::Elem;
  constexpr Domain kDom = N::kFp32 ? kBase2 : kFma;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  constexpr int kQ = 0, kK = N::kTile, kV = 3 * N::kTile;

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * N::kRows;
  const int n_chunks = p.d / N::kVec;
  const Rows<T> q = rows_of<T>(p.q, p.st, b, h),
                k = rows_of<T>(p.k, p.st + 3, b, h),
                v = rows_of<T>(p.v, p.st + 6, b, h);

  const int n_tiles = p.t_len / N::kRows;
  load_tile<N>(base + kQ, q, q0, p.s_len, n_chunks);
  load_tile<N>(base + kK, k, 0, p.t_len, n_chunks);
  cp_async_commit();
  load_tile<N>(base + kK + N::kTile, k, N::kRows, p.t_len, n_chunks);
  load_tile<N>(base + kV, v, 0, p.t_len, n_chunks);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  if constexpr (N::kFp32) {
    // ---- q' = q * fp32(scale * log2 e), in place (the zero pad stays 0)
    float* q_s = reinterpret_cast<float*>(smem + kQ);
    for (int i = threadIdx.x; i < N::kTile / 4; i += N::kThreads)
      q_s[i] *= p.scale_log2;
    __syncthreads();
  }

  float s[N::kNT][4];
  scores<N>(s, smem, kQ, warp * 16, kK, p.d);

  float o[N::kWT][4];
  zero_acc<N>(o);
  RowStats r = {-INFINITY, -INFINITY, 0.f, 0.f};

  int j = 0;
  for (; j < n_tiles - 1; ++j) {
    const int cur = j & 1, nxt = cur ^ 1;
    cp_async_wait<0>();
    __syncthreads();
    if (j + 2 < n_tiles)
      load_tile<N>(base + kK + cur * N::kTile, k, (j + 2) * N::kRows,
                   p.t_len, n_chunks);
    load_tile<N>(base + kV + nxt * N::kTile, v, (j + 1) * N::kRows, p.t_len,
                 n_chunks);
    cp_async_commit();

    // ---- produce S_{j+1}, then consume tile j
    float sn[N::kNT][4];
    scores<N>(sn, smem, kQ, warp * 16, kK + nxt * N::kTile, p.d);
    consume_tile<N, kDom>(s, o, r, smem, kV + cur * N::kTile, p);
#pragma unroll
    for (int n = 0; n < N::kNT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = sn[n][i];
  }
  // ---- the last body: consume only
  cp_async_wait<0>();
  __syncthreads();
  consume_tile<N, kDom>(s, o, r, smem, kV + (j & 1) * N::kTile, p);
  store_fwd<N, kDom>(p, o, r, q0 + warp * 16);
}

// ---------------------------------------------------------------------------
// dq and delta: strides of q, k, v, o, dO, dq
// ---------------------------------------------------------------------------

template <class N>
__global__ void __launch_bounds__(N::kThreads) dq_kernel(Params p) {
  using T = typename N::Elem;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  constexpr int kQ = 0, kDO = N::kTile, kK = 2 * N::kTile,
                kV = 4 * N::kTile;
  float* lse_s = reinterpret_cast<float*>(smem + 6 * N::kTile);
  float* delta_s = lse_s + N::kRows;

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q0 = blockIdx.x * N::kRows;
  const int n_chunks = p.d / N::kVec;
  const Rows<T> q = rows_of<T>(p.q, p.st, b, h),
                k = rows_of<T>(p.k, p.st + 3, b, h),
                v = rows_of<T>(p.v, p.st + 6, b, h),
                o = rows_of<T>(p.o, p.st + 9, b, h),
                dout = rows_of<T>(p.dout, p.st + 12, b, h);

  const int n_tiles = (p.t_len + N::kRows - 1) / N::kRows;
  load_tile<N>(base + kQ, q, q0, p.s_len, n_chunks);
  load_tile<N>(base + kDO, dout, q0, p.s_len, n_chunks);
  load_tile<N>(base + kK, k, 0, p.t_len, n_chunks);
  load_tile<N>(base + kV, v, 0, p.t_len, n_chunks);
  cp_async_commit();

  // ---- delta = rowsum(dO * O) in fp32: the warp's 16 rows, column
  // c * 32 + lane summed by each lane in order, then across the warp by a
  // fixed tree; lse (bf16: in log2 units).  Rows past S get 0 and are not
  // written.
  for (int i = 0; i < 16; ++i) {
    const int rr = warp * 16 + i, row = q0 + rr;
    float acc = 0.f;
    if (row < p.s_len) {
      const T* orow = o.p + row * o.stride;
      const T* drow = dout.p + row * dout.stride;
      for (int c = lane; c < p.d; c += 32)
        acc = fmaf(to_float(orow[c]), to_float(drow[c]), acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      delta_s[rr] = acc;
      const float l =
          row < p.s_len ? p.lse[(long long)bh * p.s_len + row] : 0.f;
      lse_s[rr] = N::kFp32 ? l : l * kLog2e;
      if (row < p.s_len) p.delta[(long long)bh * p.s_len + row] = acc;
    }
  }

  float dq[N::kWT][4];
  zero_acc<N>(dq);
  float lse_lo = 0.f, lse_hi = 0.f, delta_lo = 0.f, delta_hi = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<N>(base + kK + (buf ^ 1) * N::kTile, k, (j + 1) * N::kRows,
                   p.t_len, n_chunks);
      load_tile<N>(base + kV + (buf ^ 1) * N::kTile, v, (j + 1) * N::kRows,
                   p.t_len, n_chunks);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
      lse_lo = lse_s[warp * 16 + g];
      lse_hi = lse_s[warp * 16 + g + 8];
      delta_lo = delta_s[warp * 16 + g];
      delta_hi = delta_s[warp * 16 + g + 8];
    }

    // ---- s = q k^T and dp = dO v^T
    float s[N::kNT][4], dp[N::kNT][4];
    scores<N>(s, smem, kQ, warp * 16, kK + buf * N::kTile, p.d);
    scores<N>(dp, smem, kDO, warp * 16, kV + buf * N::kTile, p.d);
    if constexpr (N::kFp32) scale_scores<N>(s, p.scale);
    mask_cols<N>(s, j * N::kRows, p.t_len);

    // ---- ds = p * (dp - delta); p = exp(s * scale - lse) (fp32) or
    // exp2(s * scale log2 e - lse log2 e) (bf16)
#pragma unroll
    for (int n = 0; n < N::kNT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float l = i < 2 ? lse_lo : lse_hi;
        const float pr = N::kFp32 ? expf(s[n][i] - l)
                                  : exp2f(fmaf(s[n][i], p.scale_log2, -l));
        s[n][i] = pr * (dp[n][i] - (i < 2 ? delta_lo : delta_hi));
      }
    }

    // ---- dq += ds k
    accumulate<N>(dq, s, smem, kK + buf * N::kTile, p.d);
    __syncthreads();
  }

  const long long* ds = p.st + 15;
  T* dqb = static_cast<T*>(p.out0) + b * ds[0] + h * ds[2];
  store_rows<N>(dqb, ds[1], dq, q0 + warp * 16, p.s_len, p.d, p.scale,
                p.scale, false);
}

// ---------------------------------------------------------------------------
// dk and dv: strides of q, k, v, dO, dk, dv
// ---------------------------------------------------------------------------

// lse and delta of q rows [row0, row0 + R) into shared memory (threads
// 0..R-1 copy lse, R..2R-1 delta); rows at or past s_len are zero-filled.
template <class N>
__device__ __forceinline__ void load_row_stats(float* lse_dst, float* delta_dst,
                                               const float* lse,
                                               const float* delta, int row0,
                                               int s_len) {
  const int r = threadIdx.x % N::kRows;
  const bool ok = row0 + r < s_len;
  const float* src =
      (threadIdx.x < N::kRows ? lse : delta) + (ok ? row0 + r : 0);
  float* dst = (threadIdx.x < N::kRows ? lse_dst : delta_dst) + r;
  cp_async_4(smem_u32(dst), src, ok ? 4 : 0);
}

template <class N>
__global__ void __launch_bounds__(N::kThreads) dkv_kernel(Params p) {
  using T = typename N::Elem;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  constexpr int kKt = 0, kVt = N::kTile, kQ = 2 * N::kTile,
                kDO = 4 * N::kTile;
  float* lse_s = reinterpret_cast<float*>(smem + 6 * N::kTile);
  float* delta_s = lse_s + 2 * N::kRows;

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int kv0 = blockIdx.x * N::kRows;
  const int n_chunks = p.d / N::kVec;
  const Rows<T> q = rows_of<T>(p.q, p.st, b, h),
                k = rows_of<T>(p.k, p.st + 3, b, h),
                v = rows_of<T>(p.v, p.st + 6, b, h),
                dout = rows_of<T>(p.dout, p.st + 9, b, h);
  const float* lb = p.lse + (long long)bh * p.s_len;
  const float* db = p.delta + (long long)bh * p.s_len;

  const int n_tiles = (p.s_len + N::kRows - 1) / N::kRows;
  load_tile<N>(base + kKt, k, kv0, p.t_len, n_chunks);
  load_tile<N>(base + kVt, v, kv0, p.t_len, n_chunks);
  load_tile<N>(base + kQ, q, 0, p.s_len, n_chunks);
  load_tile<N>(base + kDO, dout, 0, p.s_len, n_chunks);
  load_row_stats<N>(lse_s, delta_s, lb, db, 0, p.s_len);
  cp_async_commit();

  float dk[N::kWT][4], dv[N::kWT][4];
  zero_acc<N>(dk);
  zero_acc<N>(dv);

  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < n_tiles) {
      load_tile<N>(base + kQ + (buf ^ 1) * N::kTile, q, (i + 1) * N::kRows,
                   p.s_len, n_chunks);
      load_tile<N>(base + kDO + (buf ^ 1) * N::kTile, dout,
                   (i + 1) * N::kRows, p.s_len, n_chunks);
      load_row_stats<N>(lse_s + (buf ^ 1) * N::kRows,
                        delta_s + (buf ^ 1) * N::kRows, lb, db,
                        (i + 1) * N::kRows, p.s_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // ---- s^T = k q^T and dp^T = v dO^T (16 kv rows x R q columns); lse
    // and delta index the columns
    float st[N::kNT][4], dpt[N::kNT][4];
    scores<N>(st, smem, kKt, warp * 16, kQ + buf * N::kTile, p.d);
    scores<N>(dpt, smem, kVt, warp * 16, kDO + buf * N::kTile, p.d);

    const float* ls = lse_s + buf * N::kRows;
    const float* dl = delta_s + buf * N::kRows;
#pragma unroll
    for (int n = 0; n < N::kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l = ls[n * 8 + t * 2 + (e & 1)];
        st[n][e] = N::kFp32 ? expf(st[n][e] * p.scale - l)
                            : exp2f(fmaf(st[n][e], p.scale_log2, -l * kLog2e));
      }
    }

    // ---- dv += p^T dO
    accumulate<N>(dv, st, smem, kDO + buf * N::kTile, p.d);

    // ---- ds^T = p^T * (dp^T - delta); dk += ds^T q
#pragma unroll
    for (int n = 0; n < N::kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[n][e] *= dpt[n][e] - dl[n * 8 + t * 2 + (e & 1)];
    accumulate<N>(dk, st, smem, kQ + buf * N::kTile, p.d);
    __syncthreads();
  }

  const long long* ks = p.st + 12;
  const long long* vs = p.st + 15;
  const int row0 = kv0 + warp * 16;
  store_rows<N>(static_cast<T*>(p.out0) + b * ks[0] + h * ks[2], ks[1], dk,
                row0, p.t_len, p.d, p.scale, p.scale, false);
  store_rows<N>(static_cast<T*>(p.out1) + b * vs[0] + h * vs[2], vs[1], dv,
                row0, p.t_len, p.d, 1.f, 1.f, false);
}

// Launch `kernel` over ceil(rows / R) tiles of the resident axis times B*H.
template <class N>
int launch(void (*kernel)(Params), int smem_bytes, int rows, Params& p,
           int b, int h, int s_len, int t_len, int d,
           const long long* strides, int n_strides, float scale,
           void* stream) {
  if (b <= 0 || h <= 0 || s_len <= 0 || t_len <= 0 || b * h > 65535 ||
      d <= 0 || d > N::kW || d % 8)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_strides; ++i) p.st[i] = strides[i];
  p.heads = h;
  p.s_len = s_len;
  p.t_len = t_len;
  p.d = d;
  p.scale = scale;
  // rounded to fp32 once, as the JAX package's `q * (scale * _LOG2E)` is
  p.scale_log2 = (float)((double)scale * 1.4426950408889634);
  dim3 grid((rows + N::kRows - 1) / N::kRows, b * h);
  kernel<<<grid, N::kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}

cudaError_t allow_smem(void (*kernel)(Params), int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// o and lse; strides of q, k, v, o.
template <class N>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int b, int h, int s_len, int t_len, int d, const long long* strides,
        float scale, void* stream) {
  static const cudaError_t attr = allow_smem(fwd_kernel<N>, N::kFwdSmem);
  if (attr != cudaSuccess) return (int)attr;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out0 = o;
  p.lse = static_cast<float*>(lse);
  return launch<N>(fwd_kernel<N>, N::kFwdSmem, s_len, p, b, h, s_len, t_len,
                   d, strides, 12, scale, stream);
}

// The deferred-softmax forward: o and lse as fwd; t_len a multiple of R of
// at least 2 R (cudaErrorInvalidValue otherwise).
template <class N>
int fwd_deferred(const void* q, const void* k, const void* v, void* o,
                 void* lse, int b, int h, int s_len, int t_len, int d,
                 const long long* strides, float scale, void* stream) {
  if (t_len % N::kRows || t_len < 2 * N::kRows)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr =
      allow_smem(fwd_deferred_kernel<N>, N::kFwdSmem);
  if (attr != cudaSuccess) return (int)attr;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out0 = o;
  p.lse = static_cast<float*>(lse);
  return launch<N>(fwd_deferred_kernel<N>, N::kFwdSmem, s_len, p, b, h, s_len,
                   t_len, d, strides, 12, scale, stream);
}

// dq and delta; strides of q, k, v, o, dO, dq.
template <class N>
int bwd_dq(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq, int b,
           int h, int s_len, int t_len, int d, const long long* strides,
           float scale, void* stream) {
  static const cudaError_t attr = allow_smem(dq_kernel<N>, N::kDqSmem);
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
  return launch<N>(dq_kernel<N>, N::kDqSmem, s_len, p, b, h, s_len, t_len, d,
                   strides, 18, scale, stream);
}

// dk and dv from the dq kernel's delta; strides of q, k, v, dO, dk, dv.
template <class N>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int b,
            int h, int s_len, int t_len, int d, const long long* strides,
            float scale, void* stream) {
  static const cudaError_t attr = allow_smem(dkv_kernel<N>, N::kDkvSmem);
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
  return launch<N>(dkv_kernel<N>, N::kDkvSmem, t_len, p, b, h, s_len, t_len,
                   d, strides, 18, scale, stream);
}

using B32 = Narrow<__nv_bfloat16, 32>;
using B64 = Narrow<__nv_bfloat16, 64>;
using B128 = Narrow<__nv_bfloat16, 128>;
using F16 = Narrow<float, 16>;
using F32 = Narrow<float, 32>;
using F64 = Narrow<float, 64>;
using F128 = Narrow<float, 128>;

}  // namespace

// Plain C entry points for ctypes: the other flash entries' argument lists
// with the head_dim `d` after t_len (a multiple of 8 up to the entry's W;
// cudaErrorInvalidValue otherwise; flash_fwd_pipelined_* also refuses a
// t_len that is not a whole number, at least two, of its R-row tiles).
// Tensors (B, len, H, d) bf16 or fp32 as the name says, with the element
// strides in `strides` (sb, sl, sh each; head_dim stride 1), lse and delta
// (B*H, S) fp32 contiguous.  Each launches on `stream`, allocates nothing,
// and returns a CUDA error code (0 = launched).

#define FLASH_NARROW_ENTRIES(N, w, t)                                         \
  extern "C" int flash_fwd_##w##_##t(                                         \
      const void* q, const void* k, const void* v, void* o, void* lse, int b, \
      int h, int s_len, int t_len, int d, const long long* strides,           \
      float scale, void* stream) {                                            \
    return fwd<N>(q, k, v, o, lse, b, h, s_len, t_len, d, strides, scale,     \
                  stream);                                                    \
  }                                                                           \
  extern "C" int flash_fwd_pipelined_##w##_##t(                               \
      const void* q, const void* k, const void* v, void* o, void* lse, int b, \
      int h, int s_len, int t_len, int d, const long long* strides,           \
      float scale, void* stream) {                                            \
    return fwd_deferred<N>(q, k, v, o, lse, b, h, s_len, t_len, d, strides,   \
                           scale, stream);                                    \
  }                                                                           \
  extern "C" int flash_bwd_dq_##w##_##t(                                      \
      const void* q, const void* k, const void* v, const void* o,             \
      const void* dout, const void* lse, void* delta, void* dq, int b, int h, \
      int s_len, int t_len, int d, const long long* strides, float scale,     \
      void* stream) {                                                         \
    return bwd_dq<N>(q, k, v, o, dout, lse, delta, dq, b, h, s_len, t_len, d, \
                     strides, scale, stream);                                 \
  }                                                                           \
  extern "C" int flash_bwd_dkv_##w##_##t(                                     \
      const void* q, const void* k, const void* v, const void* dout,          \
      const void* lse, const void* delta, void* dk, void* dv, int b, int h,   \
      int s_len, int t_len, int d, const long long* strides, float scale,     \
      void* stream) {                                                         \
    return bwd_dkv<N>(q, k, v, dout, lse, delta, dk, dv, b, h, s_len, t_len,  \
                      d, strides, scale, stream);                             \
  }

// all four bf16 kernels at width 16 are flash_narrow_w16_sm90.cu's
FLASH_NARROW_ENTRIES(B32, w32, bf16)
FLASH_NARROW_ENTRIES(B64, w64, bf16)
FLASH_NARROW_ENTRIES(B128, w128, bf16)
FLASH_NARROW_ENTRIES(F16, w16, fp32)
FLASH_NARROW_ENTRIES(F32, w32, fp32)
FLASH_NARROW_ENTRIES(F64, w64, fp32)
FLASH_NARROW_ENTRIES(F128, w128, fp32)
