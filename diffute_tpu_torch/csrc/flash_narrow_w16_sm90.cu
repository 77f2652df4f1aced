// Flash attention's four bf16 kernels at tile width 16 (head_dims 8 and 16)
// for Hopper (sm_90a): the standard forward and the deferred-softmax
// forward, one kernel on a flag, and the backward pair, dq (which also
// writes delta) and dk/dv.  These are the tiny model's widths: its UNet's
// heads are 8 wide (three self-attentions of 65,536 tokens and one of
// 16,384 a 512^2 pass), its VAE mid-block's single head 16 wide with
// VAEConfig.use_flash_attention.  Every other narrow width, and fp32 at
// every narrow width, stays with flash_narrow.cu.
//
// Replaces the Pallas TPU kernels of diffute_tpu/ops/flash_attention.py at
// those widths: `_fwd_kernel` (pl.pallas_call in `_flash_fwd_3d`),
// `_fwd_kernel_pipelined` (in `_flash_fwd_3d_pipelined`), `_bwd_dq_kernel`
// and `_bwd_dkv_kernel` (both in `_flash_bwd_3d`).  Their BlockSpecs carry
// (m, l, acc), dq or dk/dv in VMEM scratch across a sequential grid axis;
// here one block owns rows of one (batch, head) and walks the other axis
// itself.
//
//   q (B, S, H, D), k/v (B, T, H, D) bf16, D = 8 or 16, any strides that
//     are whole 16-byte chunks with the last one 1 (16-byte cp.async)
//   o, dq (B, S, H, D), dk, dv (B, T, H, D) bf16 through their strides;
//     lse, delta (B*H, S) fp32 contiguous, lse natural log
//
// The arithmetic is flash_narrow.cu's bf16 forward's (the plain version
// flash_fwd_tiled_reference of ops/flash_attention.py at kv tile
// kBlockKV, domain "base2"): s = q k^T in fp32 on the tensor cores, the row
// max of each 64-column tile, p = exp2(s * scale log2 e - m) with the scale
// folded into one FMA, p rounded to bf16 against the running max before
// p v, l the fp32 sum of the fp32 p through one explicit fmaf a tile, o =
// acc * (1 / l), the LSE (m + log2 l) ln 2.  The deferred forward runs the
// same code on the same tiles in another order: the standard one's bits.
// The pair's is flash_narrow.cu's bf16 pair's (flash_bwd_tiled_reference
// on bf16): delta = rowsum(dO o) in fp32 by flash_narrow.cu's tree, p =
// exp2(s * scale log2 e - lse log2 e) by one FMA, ds = p (dp - delta),
// bf16(p)^T dO, bf16(ds) k and bf16(ds)^T q summed in fp32 a 16-row
// contraction step at a time in order, dq and dk times the scale at the
// end: flash_narrow.cu's pair's bits.
//
// What bounds it on the H100.  A score costs 2 D multiply-adds in each
// product (32 or 64 tensor-core FLOPs) against one exponential.  The
// special-function unit (MUFU) gives 16 exponentials a clock an SM, a warp
// instruction every 8 clocks on each of the 4 schedulers, against 1,024
// bf16 tensor-core FLOPs a clock an SM, so the exponentials set the least
// time: at (B*H, S, T) = (2, 65536, 65536) 8.6e9 of them take about 2.05 ms
// at 1.98 GHz.  The kernel reaches that only if each scheduler issues
// fewer than 8 instructions a score, the MUFU's included, and keeps the
// MUFU fed.  What the design does about it:
//   - every exponential is one MUFU.EX2 (ex2.approx.ftz.f32 by inline PTX;
//     exp2f without -ftz lowers to a compare, two predicated multiplies and
//     the MUFU): it flushes only results below 2^-126, which add nothing
//     to an fp32 l of at least 1 or to a bf16 o;
//   - the products are sized to D, not to the tile width: at D = 8 the
//     scores take m16n8k8 and p v one 8-column output tile, rows of K, V
//     and q are 16 bytes in shared memory, nothing is zero-filled but
//     ragged rows; only the last kv tile of a ragged T is masked, in a
//     copy of the tile's code of its own;
//   - the row max is a tree, not a chain; alpha, the scale and the
//     negated max are once a tile;
//   - a block is kWarps = 4 warps of 16 query rows (64 rows) and K and V
//     stream through a kStages-deep cp.async ring with one barrier a kv
//     tile.  Blocks of 8 warps (128 rows, half the L2 reads) ran 5-12%
//     slower: a scheduler's 8 warps then come from 4 blocks, not 8, and
//     more of them are in step.  A ring on full and empty mbarriers with
//     no barrier a tile gained 3-4% on 8-warp blocks at D = 8, lost 8% at
//     16 and lost on 4-warp blocks: its waits took the loop from 213 to
//     287 instructions a tile;
//   - __launch_bounds__(128, kMinBlocks8) keeps both forwards at D = 8 at
//     64 registers (the deferred one with a 16-byte spill, which cost
//     less than the 2 blocks an SM 80 registers lose), 8 blocks an SM:
//     1,056 slots, so (2, 65536^2) takes 1.94 waves of its 2,048 blocks
//     and (4, 16384^2) 0.97 of its 1,024; at D = 16 (o and q twice as
//     wide) the standard forward takes kMinBlocks16 = 5, 96 registers:
//     (1, 65536^2) takes 1.55 waves and ran 3% faster than at 6 blocks (80
//     registers) and 17-21% faster than at 8 (64 registers, a 72-byte
//     spill); the deferred one, with two score tiles live, takes
//     kMinBlocks16Deferred = 4, 128 registers (1.94 waves): 12% faster than
//     at 5 (96 registers, a 24-byte spill, 516 instructions a trip of two
//     tiles against 488) and within 1% of the standard forward.
// SASS count (tools/narrow_w16_probes.py --sass: the loop over a kv tile,
// 32 scores a thread; H100 build).  D = 8, standard: 211 instructions,
// 6.59 a score: 34 MUFU.EX2 (32 scores, 2 alphas), 36 FMNMX, 34 FFMA, 32
// FADD, 16 F2FP, 12 HMMA, 6 FMUL, 4 SHFL, and 37 of ring, addresses and
// loop.  The deferred forward 6.52 a score; at D = 16 7.22 and 7.63.
// flash_narrow.cu's width-16 forward issued 14.41 (78 FMUL, 34 FSETP
// around its 34 MUFU, 16 CS2R clearing accumulators).  So the loop issues
// 211 instructions a warp against the MUFU's 272 clocks: the exponentials
// bound it, and it reaches 69% of their bound at (2, 65536^2).
//
// The pair has the same bound: one exponential a score against 6 D (dq: s,
// dp, ds k) or 8 D (dk/dv: s^T, dp^T, p^T dO, ds^T q) multiply-adds, so
// 2.05 ms a kernel at (2, 65536^2, 8), and no row max or sum: the LSE is an
// input, so p needs no chain across lanes.  What its design does about it:
//   - every exponential is one MUFU.EX2 (ex2 above); dq keeps -lse log2 e
//     and delta of its rows in registers; dk/dv turns each q tile's lse
//     into -lse log2 e once, as it lands (the thread that copied it, before
//     the tile's barrier), and reads the (-lse log2 e, delta) pairs of a
//     column tile with one 16-byte load, never scaling the LSE a score;
//   - a warp owns 32 rows (two m16 tiles) and walks a streamed tile 16 rows
//     at a time, loading those rows' fragments once (as they lie for the
//     scores, transposed for the product over them) for both tiles: with
//     16 rows a warp, each warp reads every streamed tile twice for 16
//     rows, and at D = 16 dk/dv's ldmatrix bytes (8 KB a warp a tile, 128
//     bytes a clock an SM) match the MUFU's time;
//   - 128-row blocks of 4 warps on the forwards' 4-stage ring (K and V for
//     dq; q and dO, with each q tile's lse and delta, for dk/dv), through
//     the forwards' make_loader, which takes the pair's two streamed
//     tensors as a second kernel parameter, a Params with them in the
//     places of K and V (the forwards' code, so their SASS, untouched);
//     one barrier a tile; only a ragged last kv tile of dq masked;
//   - launch bounds by measurement (tools/narrow_w16_probes.py
//     --bwd-variants: 3 and 5 blocks an SM ran up to 7% and 21% slower):
//     4 blocks an SM (128 registers; dq spills 8 bytes at D = 8 and 12 at
//     16, outside the loop) but dk/dv at D = 16, 3 (146 registers): 1.94
//     waves at (2, 65536^2), 0.97 at (4, 16384^2) and 1.29 at (1, 65536^2,
//     16) for dk/dv.
// SASS count (tools/narrow_w16_probes.py --sass: the loop over a tile, 64
// scores a thread; H100 build): dq 5.84 a score at D = 8 (374
// instructions: 64 MUFU, FFMA, FADD and FMUL each, 32 F2FP, 40 HMMA, 12
// LDSM), dk/dv 6.98 (64 F2FP, 48 HMMA, 16 LDSM, 8 LDS.128 more); 6.11 and
// 7.28 at D = 16.  flash_narrow.cu's pair issued 17.8.  On an H100
// (chip_smoke.py --narrow-only) dq reaches 72-73% of the exponentials' bound
// at (2, 65536^2, 8) and dk/dv 65%; 65% and 55% at (1, 65536^2, 16).
//
// Layout (the forwards; the pair's warps own 32 rows, see above).  Warp w
// owns query rows [16 w, 16 w + 16) of the block's tile and
// all D columns: its 16 x 64 score tile is 32 fp32 a thread (rows g and
// g + 8, columns 8 n + 2 t, + 1 of each of the 8 column tiles), its o 4 or
// 8 fp32.  Rows of 32 bytes (D = 16) are stored by 16-byte chunks, chunk c
// of row r at c ^ ((r >> 2) & 1), so the 8 rows one ldmatrix reads fall
// on distinct banks; 16-byte rows need no swizzle.
//
// Ragged edges.  Query rows past S and kv rows past T are zero-filled
// (cp.async's src-size 0); the kv columns past T of the last tile are
// masked to -inf; rows past S are not stored.

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

// the kv tile (ops/flash_attention.py NARROW_BLOCK_KV[16]; the q tile dk/dv
// walks) and the query rows a block of the forwards (NARROW_W16_FWD_ROWS
// there, kRows = 16 kWarps); the ring's stages; the launch bounds' blocks an
// SM at D = 8 (both forwards) and at D = 16 (the standard forward, then the
// deferred one)
constexpr int kBlockKV = 64;
constexpr int kWarps = 4, kStages = 4, kMinBlocks8 = 8, kMinBlocks16 = 5,
              kMinBlocks16Deferred = 4;
// the backward pair's launch bounds: dq at D = 8 and 16, dk/dv at 8 and 16
constexpr int kDqMinBlocks8 = 4, kDqMinBlocks16 = 4, kDkvMinBlocks8 = 4,
              kDkvMinBlocks16 = 3;
constexpr int kRows = 16 * kWarps;
// the pair's rows a block (NARROW_W16_BWD_ROWS there): a warp owns 32 (two
// m16 tiles), so each fragment of a streamed tile is loaded once for both
constexpr int kBwdRows = 2 * kRows;
constexpr int kThreads = 32 * kWarps;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;
static_assert((kStages & (kStages - 1)) == 0 && kStages >= 3,
              "a power of two stages, at least three (the deferred forward "
              "waits a tile ahead)");
static_assert(kThreads == 2 * kBlockKV,
              "dk/dv copies a q tile's lse and delta a thread an element");

template <int kD>
struct Tile {
  static_assert(kD == 8 || kD == 16, "tile width 16: D = 8 or 16");
  static constexpr int kRowBytes = 2 * kD;
  static constexpr int kChunks = kD / 8;  // 16-byte chunks a row
  static constexpr int kQBytes = kRows * kRowBytes;    // the forwards' q
  static constexpr int kResBytes = kBwdRows * kRowBytes;  // the pair's
  static constexpr int kKVBytes = kBlockKV * kRowBytes;
  static constexpr int kRing = 2 * kStages * kKVBytes;  // two streamed
  // the forwards: q | k[kStages] | v[kStages]
  static constexpr int kSmem = kQBytes + kRing;
  // dq: q | dO | k[kStages] | v[kStages]
  static constexpr int kDqSmem = 2 * kResBytes + kRing;
  // dk/dv: k | v | q[kStages] | dO[kStages] | (lse, delta)[kStages], a
  // stage's lse and delta kBlockKV fp32 each
  static constexpr int kStatBytes = 2 * kBlockKV * 4;
  static constexpr int kDkvSmem = 2 * kResBytes + kRing + kStages * kStatBytes;
  // the 16-byte chunks of a streamed tile pair (K and V; q and dO) and the
  // threads that copy them, each kPer of them
  static constexpr int kTileChunks = 2 * kBlockKV * kChunks;
  static constexpr int kPer = (kTileChunks + kThreads - 1) / kThreads;
  static constexpr int kLoaders = kTileChunks / kPer;
  static_assert(kTileChunks % kPer == 0, "whole chunks a loader");
  static constexpr int kQRegs = kD / 4;  // an A fragment: m16k8 or m16k16
  static constexpr int kOT = kD / 8;     // 8-column output tiles
};

// byte offset of chunk c of row r in a tile
template <int kD>
__device__ __forceinline__ uint32_t chunk_off(int r, int c) {
  if constexpr (kD == 8)
    return r * 16;
  else
    return r * 32 + ((c ^ ((r >> 2) & 1)) << 4);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

struct Params {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* o;
  float* lse;
  long long st[12];  // (sb, sl, sh) of q, k, v, o
  int heads, s_len, t_len;
  float scale_log2;
};

// The backward pair's: the entries' tensors and strides, in their order.
struct BwdParams {
  const __nv_bfloat16 *q, *k, *v, *o, *dout;
  __nv_bfloat16 *out0, *out1;  // dq | dk, dv
  const float* lse;
  float* delta;  // written by dq, read by dk/dv
  long long st[18];  // (sb, sl, sh) of q, k, v, o, dO, dq | q, k, v, dO, dk, dv
  int heads, s_len, t_len;
  float scale, scale_log2;
};

// The online softmax state of one thread's two rows (g and g + 8 of its
// warp's 16): the running max in log2 units and this thread's share of l.
struct Stats {
  float m_lo, m_hi, l_lo, l_hi;
};

// Rows [row0, row0 + kBwdRows) of a (B, L, H, kD) tensor `x` of (batch b,
// head h) into the pair's resident tile at `dst` (rows at or past n_rows
// zero-filled), 16-byte chunks, neighbouring threads on neighbouring chunks.
template <int kD>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* x,
                                          const long long* st, int b, int h,
                                          int row0, int n_rows, int tid) {
  using TL = Tile<kD>;
  // (the chunk bound is always true here; without it ptxas gives dk/dv at
  // D = 8 four registers more and a loop 3% slower, chip_smoke.py
  // --narrow-only)
#pragma unroll
  for (int i = 0; i < (kBwdRows * TL::kChunks + kThreads - 1) / kThreads;
       ++i) {
    const int id = tid + i * kThreads;
    if (id < kBwdRows * TL::kChunks) {
      const int r = id / TL::kChunks, c = id % TL::kChunks;
      const bool ok = row0 + r < n_rows;
      const __nv_bfloat16* g =
          x + b * st[0] + h * st[2] +
          (ok ? (long long)(row0 + r) * st[1] + c * 8 : 0);
      cp_async_16(dst + chunk_off<kD>(r, c), g, ok ? 16 : 0);
    }
  }
}

// The A fragment of this warp's 16 rows of the resident tile at `qt`.
template <int kD>
__device__ __forceinline__ void load_q_frag(uint32_t (&qa)[Tile<kD>::kQRegs],
                                            uint32_t qt, int warp, int lane) {
  if constexpr (kD == 8) {
    ldmatrix_x2(qa, qt + chunk_off<8>(warp * 16 + (lane & 15), 0));
  } else {
    const int mi = lane >> 3, mr = lane & 7;
    ldmatrix_x4(qa, qt + chunk_off<16>(warp * 16 + (mi & 1) * 8 + mr,
                                       mi >> 1));
  }
}

// s (16 x 64, fp32) = this warp's q rows times the K tile at `kt`,
// transposed.
template <int kD>
__device__ __forceinline__ void scores(float (&s)[8][4],
                                       const uint32_t (&qa)[Tile<kD>::kQRegs],
                                       uint32_t kt, int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
  if constexpr (kD == 8) {
    // 4 column tiles an ldmatrix: kv rows 32 h + lane
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t b[4];
      ldmatrix_x4(b, kt + chunk_off<8>(32 * h + lane, 0));
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_bf16_k8(s[4 * h + i], qa, b[i]);
    }
  } else {
    // (n0, k lo), (n0, k hi), (n0 + 8, k lo), (n0 + 8, k hi)
    const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t b[4];
      ldmatrix_x4(b, kt + chunk_off<16>(16 * p + (mi >> 1) * 8 + mr, mi & 1));
      mma_bf16(s[2 * p], qa, b[0], b[1]);
      mma_bf16(s[2 * p + 1], qa, b[2], b[3]);
    }
  }
}

// The columns at or past t_len of s (8 kN columns from col0): -inf.
template <int kN>
__device__ __forceinline__ void mask_cols(float (&s)[kN][4], int col0,
                                          int t_len, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const int col = col0 + n * 8 + t * 2;
    if (col >= t_len) s[n][0] = s[n][2] = -INFINITY;
    if (col + 1 >= t_len) s[n][1] = s[n][3] = -INFINITY;
  }
}

// Write this warp's 16 x kD accumulator as rows r_lo and r_lo + 8 (this
// thread's; rows at or past n_rows dropped) of `dst` (its (batch, head) and
// this thread's first column), times f_lo / f_hi, in bf16.
template <int kD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           long long stride,
                                           const float (&o)[Tile<kD>::kOT][4],
                                           int r_lo, int n_rows, float f_lo,
                                           float f_hi) {
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int n = 0; n < Tile<kD>::kOT; ++n) {
    if (r_lo < n_rows)
      *reinterpret_cast<uint32_t*>(dst + r_lo * stride + n * 8) =
          pack_bf16(o[n][0] * f_lo, o[n][1] * f_lo);
    if (r_hi < n_rows)
      *reinterpret_cast<uint32_t*>(dst + r_hi * stride + n * 8) =
          pack_bf16(o[n][2] * f_hi, o[n][3] * f_hi);
  }
}

__device__ __forceinline__ float max_tree(float (&x)[8]) {
#pragma unroll
  for (int w = 4; w > 0; w >>= 1)
#pragma unroll
    for (int i = 0; i < w; ++i) x[i] = fmaxf(x[i], x[i + w]);
  return x[0];
}

// Tile j's online softmax on its raw scores `s` (kMask: the columns at or
// past t_len of a tile starting at col0 are -inf), then o += p v with the
// V tile at `vt`.  Both forwards run this code on the same scores.
template <int kD, bool kMask>
__device__ __forceinline__ void consume(float (&s)[8][4],
                                        float (&o)[Tile<kD>::kOT][4],
                                        Stats& st, uint32_t vt, float c,
                                        int col0, int t_len, int lane) {
  if constexpr (kMask) mask_cols<8>(s, col0, t_len, lane);
  float a[8], b[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    a[n] = fmaxf(s[n][0], s[n][1]);
    b[n] = fmaxf(s[n][2], s[n][3]);
  }
  float mx_lo = max_tree(a), mx_hi = max_tree(b);
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  const float mn_lo = fmaxf(st.m_lo, mx_lo * c);
  const float mn_hi = fmaxf(st.m_hi, mx_hi * c);
  const float alpha_lo = ex2(st.m_lo - mn_lo);
  const float alpha_hi = ex2(st.m_hi - mn_hi);
  st.m_lo = mn_lo;
  st.m_hi = mn_hi;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    s[n][0] = ex2(fmaf(s[n][0], c, -mn_lo));
    s[n][1] = ex2(fmaf(s[n][1], c, -mn_lo));
    s[n][2] = ex2(fmaf(s[n][2], c, -mn_hi));
    s[n][3] = ex2(fmaf(s[n][3], c, -mn_hi));
  }
  // the row sums column tile by column tile; starting from the first pair,
  // not from 0, gives the same bits with two adds fewer
  float sum_lo = s[0][0] + s[0][1], sum_hi = s[0][2] + s[0][3];
#pragma unroll
  for (int n = 1; n < 8; ++n) {
    sum_lo += s[n][0] + s[n][1];
    sum_hi += s[n][2] + s[n][3];
  }
  // one explicit FMA, so that both forwards round the sum alike
  st.l_lo = fmaf(st.l_lo, alpha_lo, sum_lo);
  st.l_hi = fmaf(st.l_hi, alpha_hi, sum_hi);
#pragma unroll
  for (int n = 0; n < Tile<kD>::kOT; ++n) {
    o[n][0] *= alpha_lo;
    o[n][1] *= alpha_lo;
    o[n][2] *= alpha_hi;
    o[n][3] *= alpha_hi;
  }
  // p as the A fragments of p v (the accumulator layout is the A layout)
  uint32_t pa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
  if constexpr (kD == 8) {
    // (kv 32 h + 0-7), (+ 8-15), (+ 16-23), (+ 24-31), transposed: b0, b1
    // of two 16-row contraction steps
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t v4[4];
      ldmatrix_x4_trans(v4, vt + chunk_off<8>(32 * h + lane, 0));
      mma_bf16(o[0], pa[2 * h], v4[0], v4[1]);
      mma_bf16(o[0], pa[2 * h + 1], v4[2], v4[3]);
    }
  } else {
    // transposed: (k lo, n0), (k hi, n0), (k lo, n0 + 8), (k hi, n0 + 8)
    const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t v4[4];
      ldmatrix_x4_trans(v4,
                        vt + chunk_off<16>(kk * 16 + (mi & 1) * 8 + mr, mi >> 1));
      mma_bf16(o[0], pa[kk], v4[0], v4[1]);
      mma_bf16(o[1], pa[kk], v4[2], v4[3]);
    }
  }
}

// One thread's share of every K and V tile (or the pair's streamed tiles,
// in their places): kPer chunks, chunk i being chunk `c` of row `row[i]`
// of K or V (or none: active false).
template <int kD>
struct Loader {
  const __nv_bfloat16* src[Tile<kD>::kPer];  // its chunks of the next tile
  long long step[Tile<kD>::kPer];            // kBlockKV rows, in elements
  uint32_t dst[Tile<kD>::kPer];  // its chunks' bytes in stage 0 of a ring
  int row[Tile<kD>::kPer];
  bool active;
};

template <int kD>
__device__ __forceinline__ Loader<kD> make_loader(const Params& p, int b,
                                                  int h, uint32_t base,
                                                  int tid) {
  using TL = Tile<kD>;
  Loader<kD> ld;
  ld.active = tid < TL::kLoaders;
#pragma unroll
  for (int i = 0; i < TL::kPer; ++i) {
    const int id = (tid + i * kThreads) % TL::kTileChunks;
    const int tensor = id / (kBlockKV * TL::kChunks);  // 0: K, 1: V
    const int rem = id % (kBlockKV * TL::kChunks);
    const int r = rem / TL::kChunks, c = rem % TL::kChunks;
    const long long* st = p.st + 3 * (1 + tensor);
    ld.src[i] = (tensor ? p.v : p.k) + b * st[0] + h * st[2] + r * st[1] +
                c * 8;
    ld.step[i] = kBlockKV * st[1];
    ld.dst[i] = base + TL::kQBytes + tensor * kStages * TL::kKVBytes +
                chunk_off<kD>(r, c);
    ld.row[i] = r;
  }
  return ld;
}

// A loader's share of tile j into ring stage j % kStages (rows at or past
// n_rows zero-filled: cp.async's src-size 0 reads nothing).
template <int kD>
__device__ __forceinline__ void load_kv(Loader<kD>& ld, int j, int n_rows) {
  if (!ld.active) return;
#pragma unroll
  for (int i = 0; i < Tile<kD>::kPer; ++i) {
    const bool ok = j * kBlockKV + ld.row[i] < n_rows;
    cp_async_16(ld.dst[i] + (j & (kStages - 1)) * Tile<kD>::kKVBytes,
                ld.src[i], ok ? 16 : 0);
    ld.src[i] += ld.step[i];
  }
}

template <int kD, bool kDeferred>
__global__ void __launch_bounds__(kThreads,
                                  kD == 8      ? kMinBlocks8
                                  : kDeferred ? kMinBlocks16Deferred
                                              : kMinBlocks16)
    fwd_kernel(Params p) {
  using TL = Tile<kD>;
  __shared__ __align__(128) unsigned char smem[TL::kSmem];
  const uint32_t base = smem_u32(smem);
  const uint32_t kring = base + TL::kQBytes;
  const uint32_t vring = kring + kStages * TL::kKVBytes;
  constexpr int kLead = kDeferred ? 1 : 0;  // S is a tile ahead

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kRows;
  const int t_len = p.t_len;
  const int n_tiles = (t_len + kBlockKV - 1) / kBlockKV;

  // ---- q (rows past S zero-filled) with tile 0, then tiles 1..kStages-2,
  // a cp.async group each
  if (tid < kRows * TL::kChunks) {
    const int r = tid / TL::kChunks, c = tid % TL::kChunks;
    const bool ok = q0 + r < p.s_len;
    const __nv_bfloat16* g =
        p.q + b * p.st[0] + h * p.st[2] +
        (ok ? (long long)(q0 + r) * p.st[1] + c * 8 : 0);
    cp_async_16(base + chunk_off<kD>(r, c), g, ok ? 16 : 0);
  }
  Loader<kD> ld = make_loader<kD>(p, b, h, base, tid);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_kv<kD>(ld, i, t_len);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2 - kLead>();
  __syncthreads();

  uint32_t qa[TL::kQRegs];
  load_q_frag<kD>(qa, base, warp, lane);
  const float c = p.scale_log2;
  float o[TL::kOT][4];
#pragma unroll
  for (int n = 0; n < TL::kOT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  Stats st = {-INFINITY, -INFINITY, 0.f, 0.f};

  // Body j's wait, barrier and refill: tile j + kLead is in, and every
  // warp is done with tile j - 1, whose stage takes tile j + kStages - 1
  // (an empty group past the end keeps the count).  Body 0's wait is the
  // prologue's.
  auto refill = [&](int j) {
    if (j > 0) {
      cp_async_wait<kStages - 2 - kLead>();
      __syncthreads();
    }
    if (j + kStages - 1 < n_tiles) load_kv<kD>(ld, j + kStages - 1, t_len);
    cp_async_commit();
  };
  auto kt = [&](int j) {
    return kring + (j & (kStages - 1)) * TL::kKVBytes;
  };
  auto vt = [&](int j) {
    return vring + (j & (kStages - 1)) * TL::kKVBytes;
  };

  if constexpr (!kDeferred) {
    // ---- the full tiles, then a ragged last one masked
    const int n_full = t_len / kBlockKV;
    for (int j = 0; j < n_full; ++j) {
      refill(j);
      float s[8][4];
      scores<kD>(s, qa, kt(j), lane);
      consume<kD, false>(s, o, st, vt(j), c, 0, t_len, lane);
    }
    if (n_full < n_tiles) {
      refill(n_full);
      float s[8][4];
      scores<kD>(s, qa, kt(n_full), lane);
      consume<kD, true>(s, o, st, vt(n_full), c, n_full * kBlockKV, t_len,
                        lane);
    }
  } else {
    // ---- S(j + 1) issued before tile j's softmax; t_len is a whole number
    // (at least two) of tiles.  Two bodies a trip, the score tiles taking
    // turns, so no tile is copied.
    float sa[8][4], sb[8][4];
    scores<kD>(sa, qa, kt(0), lane);
    int j = 0;
    for (; j + 2 < n_tiles; j += 2) {
      refill(j);
      scores<kD>(sb, qa, kt(j + 1), lane);
      consume<kD, false>(sa, o, st, vt(j), c, 0, t_len, lane);
      refill(j + 1);
      scores<kD>(sa, qa, kt(j + 2), lane);
      consume<kD, false>(sb, o, st, vt(j + 1), c, 0, t_len, lane);
    }
    if (j + 1 < n_tiles) {
      refill(j);
      scores<kD>(sb, qa, kt(j + 1), lane);
      consume<kD, false>(sa, o, st, vt(j), c, 0, t_len, lane);
      refill(j + 1);
      consume<kD, false>(sb, o, st, vt(j + 1), c, 0, t_len, lane);
    } else {
      refill(j);
      consume<kD, false>(sa, o, st, vt(j), c, 0, t_len, lane);
    }
  }
  cp_async_wait<0>();

  // ---- o = acc / l through o's strides, the natural-log LSE
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    st.l_lo += __shfl_xor_sync(0xffffffffu, st.l_lo, off);
    st.l_hi += __shfl_xor_sync(0xffffffffu, st.l_hi, off);
  }
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
  const float f_lo = 1.f / st.l_lo, f_hi = 1.f / st.l_hi;
  const long long* os = p.st + 9;
  __nv_bfloat16* ob = p.o + b * os[0] + h * os[2] + t * 2;
#pragma unroll
  for (int n = 0; n < TL::kOT; ++n) {
    if (r_lo < p.s_len)
      *reinterpret_cast<uint32_t*>(ob + r_lo * os[1] + n * 8) =
          pack_bf16(o[n][0] * f_lo, o[n][1] * f_lo);
    if (r_hi < p.s_len)
      *reinterpret_cast<uint32_t*>(ob + r_hi * os[1] + n * 8) =
          pack_bf16(o[n][2] * f_hi, o[n][3] * f_hi);
  }
  if (t == 0) {
    float* lb = p.lse + (long long)bh * p.s_len;
    if (r_lo < p.s_len) lb[r_lo] = (st.m_lo + log2f(st.l_lo)) * kLn2;
    if (r_hi < p.s_len) lb[r_hi] = (st.m_hi + log2f(st.l_hi)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// the backward pair's pieces
// ---------------------------------------------------------------------------
//
// A warp owns 32 rows of the block's resident tiles, two m16 tiles, and
// walks a streamed tile 16 rows (a contraction step) at a time: it loads
// the fragments of those 16 rows once, for the scores and for the product
// over them, and uses each for both m16 tiles.  So a warp reads each
// streamed tile twice (as it lies and transposed) for 32 rows, not for 16.

// The B fragments of rows [row0, row0 + 16) of a streamed tile for the
// scores: two 8-row column tiles, the kD columns the contraction.
template <int kD>
__device__ __forceinline__ void frag_rows(uint32_t (&b)[kD / 4], uint32_t tile,
                                          int lane, int row0) {
  if constexpr (kD == 8) {
    ldmatrix_x2(b, tile + chunk_off<8>(row0 + (lane & 15), 0));
  } else {
    // (n0, k lo), (n0, k hi), (n0 + 8, k lo), (n0 + 8, k hi)
    const int mi = lane >> 3, mr = lane & 7;
    ldmatrix_x4(b, tile + chunk_off<16>(row0 + (mi >> 1) * 8 + mr, mi & 1));
  }
}

// The B fragments of rows [row0, row0 + 16) of a streamed tile for a
// product over them: the rows the contraction, the kD columns its output.
template <int kD>
__device__ __forceinline__ void frag_cols(uint32_t (&b)[kD / 4], uint32_t tile,
                                          int lane, int row0) {
  if constexpr (kD == 8) {
    ldmatrix_x2_trans(b, tile + chunk_off<8>(row0 + (lane & 15), 0));
  } else {
    // transposed: (k lo, n0), (k hi, n0), (k lo, n0 + 8), (k hi, n0 + 8)
    const int mi = lane >> 3, mr = lane & 7;
    ldmatrix_x4_trans(b,
                      tile + chunk_off<16>(row0 + (mi & 1) * 8 + mr, mi >> 1));
  }
}

// s (16 x 16, fp32) = a warp's m16 tile (the A fragment `a`) times the 16
// rows of frag_rows, transposed.
template <int kD>
__device__ __forceinline__ void mma_rows(float (&s)[2][4],
                                         const uint32_t (&a)[kD / 4],
                                         const uint32_t (&b)[kD / 4]) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
  if constexpr (kD == 8) {
    mma_bf16_k8(s[0], a, b[0]);
    mma_bf16_k8(s[1], a, b[1]);
  } else {
    mma_bf16(s[0], a, b[0], b[1]);
    mma_bf16(s[1], a, b[2], b[3]);
  }
}

// o (16 x kD) += p (16 x 16, the A fragment `pa`) times the 16 rows of
// frag_cols: one contraction step.
template <int kD>
__device__ __forceinline__ void mma_cols(float (&o)[kD / 8][4],
                                         const uint32_t (&pa)[4],
                                         const uint32_t (&b)[kD / 4]) {
  mma_bf16(o[0], pa, b[0], b[1]);
  if constexpr (kD == 16) mma_bf16(o[1], pa, b[2], b[3]);
}

// p (16 x 16, fp32) rounded to bf16 as the A fragment of one contraction
// step (the accumulator layout is the A layout).
__device__ __forceinline__ void to_a_frag(uint32_t (&pa)[4],
                                          const float (&s)[2][4]) {
  pa[0] = pack_bf16(s[0][0], s[0][1]);
  pa[1] = pack_bf16(s[0][2], s[0][3]);
  pa[2] = pack_bf16(s[1][0], s[1][1]);
  pa[3] = pack_bf16(s[1][2], s[1][3]);
}

template <int kD>
__device__ __forceinline__ void zero_acc(float (&o)[2][kD / 8][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[m][n][i] = 0.f;
}

// ---------------------------------------------------------------------------
// dq and delta
// ---------------------------------------------------------------------------
//
// A block owns kBwdRows query rows of one (batch, head), q and dO
// resident; K and V stream through the forwards' ring.  Tile j, 16 columns
// at a time: s = q k^T and dp = dO v^T, p = exp2(s scale log2 e - lse
// log2 e) by one FMA and one MUFU.EX2, ds = p (dp - delta), dq += bf16(ds)
// k.  lse (in log2 units, negated) and delta of this thread's four rows
// stay in registers; only a ragged last kv tile is masked.

template <int kD>
__global__ void __launch_bounds__(kThreads,
                                  kD == 8 ? kDqMinBlocks8 : kDqMinBlocks16)
    dq_kernel(BwdParams p, Params ring) {
  using TL = Tile<kD>;
  __shared__ __align__(128) unsigned char smem[TL::kDqSmem];
  const uint32_t base = smem_u32(smem);
  const uint32_t dot = base + TL::kResBytes;  // dO
  const uint32_t kring = dot + TL::kResBytes;
  const uint32_t vring = kring + kStages * TL::kKVBytes;

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBwdRows;
  const int s_len = p.s_len, t_len = p.t_len;
  const int n_tiles = (t_len + kBlockKV - 1) / kBlockKV;

  // ---- q and dO (rows past S zero-filled) with tile 0, then tiles
  // 1..kStages-2
  load_rows<kD>(base, p.q, p.st, b, h, q0, s_len, tid);
  load_rows<kD>(dot, p.dout, p.st + 12, b, h, q0, s_len, tid);
  Loader<kD> ld = make_loader<kD>(ring, b, h, kring - TL::kQBytes, tid);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_kv<kD>(ld, i, t_len);
    cp_async_commit();
  }

  // ---- delta = rowsum(dO o) in fp32 of the warp's 32 rows while the
  // copies land: lane c < kD takes column c, then a fixed tree of 5
  // shuffles (flash_narrow.cu's order); each lane keeps its rows' values
  // (m16 tile i >> 4, row half (i >> 3) & 1).  lse of its rows in log2
  // units, negated.  Rows past S get 0.
  float dl[2][2], nl[2][2];
  {
    const long long *os = p.st + 9, *ds = p.st + 12;
    const __nv_bfloat16* ob = p.o + b * os[0] + h * os[2] + lane;
    const __nv_bfloat16* db = p.dout + b * ds[0] + h * ds[2] + lane;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = q0 + warp * 32 + i;
      float acc = 0.f;
      if (row < s_len && lane < kD)
        acc = fmaf(__bfloat162float(ob[row * os[1]]),
                   __bfloat162float(db[row * ds[1]]), acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (g == (i & 7)) dl[i >> 4][(i >> 3) & 1] = acc;
      if (lane == 0 && row < s_len)
        p.delta[(long long)bh * s_len + row] = acc;
    }
    const float* lb = p.lse + (long long)bh * s_len;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int row = q0 + warp * 32 + m * 16 + x * 8 + g;
        nl[m][x] = row < s_len ? lb[row] * -kLog2e : 0.f;
      }
  }

  cp_async_wait<kStages - 2>();
  __syncthreads();
  uint32_t qa[2][TL::kQRegs], da[2][TL::kQRegs];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    load_q_frag<kD>(qa[m], base, 2 * warp + m, lane);
    load_q_frag<kD>(da[m], dot, 2 * warp + m, lane);
  }
  const float c = p.scale_log2;
  float dq[2][TL::kOT][4];
  zero_acc<kD>(dq);

  auto refill = [&](int j) {
    if (j > 0) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
    }
    if (j + kStages - 1 < n_tiles) load_kv<kD>(ld, j + kStages - 1, t_len);
    cp_async_commit();
  };
  // tile j, 16 columns at a time (mask: those at or past t_len -inf)
  auto body = [&](int j, auto mask) {
    const uint32_t kt = kring + (j & (kStages - 1)) * TL::kKVBytes;
    const uint32_t vt = vring + (j & (kStages - 1)) * TL::kKVBytes;
#pragma unroll
    for (int k0 = 0; k0 < kBlockKV; k0 += 16) {
      uint32_t kb[kD / 4], vb[kD / 4], kc[kD / 4];
      frag_rows<kD>(kb, kt, lane, k0);
      frag_rows<kD>(vb, vt, lane, k0);
      frag_cols<kD>(kc, kt, lane, k0);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        float s[2][4], dp[2][4];
        mma_rows<kD>(s, qa[m], kb);
        mma_rows<kD>(dp, da[m], vb);
        if constexpr (decltype(mask)::value)
          mask_cols<2>(s, j * kBlockKV + k0, t_len, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          s[n][0] = ex2(fmaf(s[n][0], c, nl[m][0])) * (dp[n][0] - dl[m][0]);
          s[n][1] = ex2(fmaf(s[n][1], c, nl[m][0])) * (dp[n][1] - dl[m][0]);
          s[n][2] = ex2(fmaf(s[n][2], c, nl[m][1])) * (dp[n][2] - dl[m][1]);
          s[n][3] = ex2(fmaf(s[n][3], c, nl[m][1])) * (dp[n][3] - dl[m][1]);
        }
        uint32_t pa[4];
        to_a_frag(pa, s);
        mma_cols<kD>(dq[m], pa, kc);
      }
    }
  };

  // ---- the full tiles, then a ragged last one masked
  const int n_full = t_len / kBlockKV;
  for (int j = 0; j < n_full; ++j) {
    refill(j);
    body(j, std::false_type());
  }
  if (n_full < n_tiles) {
    refill(n_full);
    body(n_full, std::true_type());
  }
  cp_async_wait<0>();

  // ---- dq * scale through dq's strides
  const long long* qs = p.st + 15;
#pragma unroll
  for (int m = 0; m < 2; ++m)
    store_rows<kD>(p.out0 + b * qs[0] + h * qs[2] + t * 2, qs[1], dq[m],
                   q0 + warp * 32 + m * 16 + g, s_len, p.scale, p.scale);
}

// ---------------------------------------------------------------------------
// dk and dv
// ---------------------------------------------------------------------------
//
// A block owns kBwdRows kv rows of one (batch, head), k and v resident; q
// and dO stream through the ring, with each q tile's lse and delta beside
// them (a thread an element, cp.async).  When a tile lands, the thread
// that copied an lse turns it into -lse log2 e in place, before the tile's
// barrier, and every element sits where one 16-byte load gives a thread
// the (-lse log2 e, delta) pairs of its two columns of a column tile.
// Tile i, 16 q columns at a time: s^T = k q^T and dp^T = v dO^T, p^T =
// exp2(s^T scale log2 e - lse log2 e) by one FMA and one MUFU.EX2, dv +=
// bf16(p^T) dO, ds^T = p^T (dp^T - delta), dk += bf16(ds^T) q.  q rows
// past S are zero, as are their lse and delta: p = 1, dO = 0 and ds = 0,
// so no column is masked.

// The float index of column c's lse (e = 0) or delta (e = 1) in a stage:
// (c >> 3) * 16 + ((c & 7) >> 1) * 4 + 2 e + (c & 1).
__device__ __forceinline__ int stat_idx(int c, int e) {
  return (c >> 1) * 4 + 2 * e + (c & 1);
}

template <int kD>
__global__ void __launch_bounds__(kThreads,
                                  kD == 8 ? kDkvMinBlocks8 : kDkvMinBlocks16)
    dkv_kernel(BwdParams p, Params ring) {
  using TL = Tile<kD>;
  __shared__ __align__(128) unsigned char smem[TL::kDkvSmem];
  const uint32_t base = smem_u32(smem);
  const uint32_t vres = base + TL::kResBytes;
  const uint32_t qring = vres + TL::kResBytes;
  const uint32_t dring = qring + kStages * TL::kKVBytes;
  const int sring = 2 * TL::kResBytes + TL::kRing;  // the stats' byte offset

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kv0 = blockIdx.x * kBwdRows;
  const int s_len = p.s_len, t_len = p.t_len;
  const int n_tiles = (s_len + kBlockKV - 1) / kBlockKV;

  // ---- k and v (rows past T zero-filled) with q tile 0, then tiles
  // 1..kStages-2, each with its lse and delta
  load_rows<kD>(base, p.k, p.st + 3, b, h, kv0, t_len, tid);
  load_rows<kD>(vres, p.v, p.st + 6, b, h, kv0, t_len, tid);
  Loader<kD> ld = make_loader<kD>(ring, b, h, qring - TL::kQBytes, tid);
  // this thread's lse (tid < kBlockKV) or delta element of every q tile:
  // the next tile's and its row (past S zero-filled: cp.async's src-size 0
  // reads nothing)
  const int stat_e = tid / kBlockKV;
  int stat_row = tid % kBlockKV;
  const float* stat_src =
      (stat_e ? p.delta : p.lse) + (long long)bh * s_len + stat_row;
  const int stat_dst = sring + 4 * stat_idx(stat_row, stat_e);
  auto load_tile = [&](int i) {
    load_kv<kD>(ld, i, s_len);
    cp_async_4(base + stat_dst + (i & (kStages - 1)) * TL::kStatBytes,
               stat_src, stat_row < s_len ? 4 : 0);
    stat_src += kBlockKV;
    stat_row += kBlockKV;
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();
  uint32_t ka[2][TL::kQRegs], va[2][TL::kQRegs];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    load_q_frag<kD>(ka[m], base, 2 * warp + m, lane);
    load_q_frag<kD>(va[m], vres, 2 * warp + m, lane);
  }
  const float c = p.scale_log2;
  float dk[2][TL::kOT][4], dv[2][TL::kOT][4];
  zero_acc<kD>(dk);
  zero_acc<kD>(dv);

  // Body i's wait, lse conversion, barrier and refill (as the forwards')
  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i & (kStages - 1);
    cp_async_wait<kStages - 2>();
    if (stat_e == 0) {
      float* x = reinterpret_cast<float*>(smem + stat_dst +
                                          stage * TL::kStatBytes);
      *x *= -kLog2e;
    }
    __syncthreads();
    if (i + kStages - 1 < n_tiles) load_tile(i + kStages - 1);
    cp_async_commit();

    const uint32_t qt = qring + stage * TL::kKVBytes;
    const uint32_t dt = dring + stage * TL::kKVBytes;
    const float4* sd = reinterpret_cast<const float4*>(
        smem + sring + stage * TL::kStatBytes);
#pragma unroll
    for (int k0 = 0; k0 < kBlockKV; k0 += 16) {
      uint32_t qb[kD / 4], db[kD / 4], qc[kD / 4], dc[kD / 4];
      frag_rows<kD>(qb, qt, lane, k0);
      frag_rows<kD>(db, dt, lane, k0);
      frag_cols<kD>(qc, qt, lane, k0);
      frag_cols<kD>(dc, dt, lane, k0);
      // (-lse log2 e, delta) of columns k0 + 8 n + 2 t and + 1
      const float4 x[2] = {sd[(k0 / 8) * 4 + t], sd[(k0 / 8 + 1) * 4 + t]};
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        float s[2][4], dp[2][4];
        mma_rows<kD>(s, ka[m], qb);
        mma_rows<kD>(dp, va[m], db);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          s[n][0] = ex2(fmaf(s[n][0], c, x[n].x));
          s[n][1] = ex2(fmaf(s[n][1], c, x[n].y));
          s[n][2] = ex2(fmaf(s[n][2], c, x[n].x));
          s[n][3] = ex2(fmaf(s[n][3], c, x[n].y));
        }
        uint32_t pa[4];
        to_a_frag(pa, s);
        mma_cols<kD>(dv[m], pa, dc);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          s[n][0] *= dp[n][0] - x[n].z;
          s[n][1] *= dp[n][1] - x[n].w;
          s[n][2] *= dp[n][2] - x[n].z;
          s[n][3] *= dp[n][3] - x[n].w;
        }
        to_a_frag(pa, s);
        mma_cols<kD>(dk[m], pa, qc);
      }
    }
  }
  cp_async_wait<0>();

  // ---- dk * scale and dv through their strides
  const long long *ks = p.st + 12, *vs = p.st + 15;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int r_lo = kv0 + warp * 32 + m * 16 + g;
    store_rows<kD>(p.out0 + b * ks[0] + h * ks[2] + t * 2, ks[1], dk[m],
                   r_lo, t_len, p.scale, p.scale);
    store_rows<kD>(p.out1 + b * vs[0] + h * vs[2] + t * 2, vs[1], dv[m],
                   r_lo, t_len, 1.f, 1.f);
  }
}

template <int kD, bool kDeferred>
int launch(const Params& p, int bh, void* stream) {
  dim3 grid((p.s_len + kRows - 1) / kRows, bh);
  fwd_kernel<kD, kDeferred>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

int forward(bool deferred, const void* q, const void* k, const void* v,
            void* o, void* lse, int b, int h, int s_len, int t_len, int d,
            const long long* strides, float scale, void* stream) {
  if (b <= 0 || h <= 0 || s_len <= 0 || t_len <= 0 || b * h > 65535 ||
      (d != 8 && d != 16))
    return (int)cudaErrorInvalidValue;
  if (deferred && (t_len % kBlockKV || t_len < 2 * kBlockKV))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  for (int i = 0; i < 12; ++i) p.st[i] = strides[i];
  p.heads = h;
  p.s_len = s_len;
  p.t_len = t_len;
  // rounded to fp32 once, as the JAX package's `q * (scale * _LOG2E)` is
  p.scale_log2 = (float)((double)scale * 1.4426950408889634);
  if (d == 8)
    return deferred ? launch<8, true>(p, b * h, stream)
                    : launch<8, false>(p, b * h, stream);
  return deferred ? launch<16, true>(p, b * h, stream)
                  : launch<16, false>(p, b * h, stream);
}

// The pair: ceil(rows / kBwdRows) blocks a (batch, head), rows = S (dq) or
// T (dk/dv).  `ring` is the forwards' Params as make_loader takes it, the
// two streamed tensors in the places of K and V: x0 and x1, whose strides
// are the entry's slots s0 and s1.
using BwdKernel = void (*)(BwdParams, Params);

int backward(BwdKernel kernel, BwdParams p, const void* x0, int s0,
             const void* x1, int s1, int rows, int b, int h, int s_len,
             int t_len, int d, const long long* strides, float scale,
             void* stream) {
  if (b <= 0 || h <= 0 || s_len <= 0 || t_len <= 0 || b * h > 65535 ||
      (d != 8 && d != 16))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 18; ++i) p.st[i] = strides[i];
  p.heads = h;
  p.s_len = s_len;
  p.t_len = t_len;
  p.scale = scale;
  p.scale_log2 = (float)((double)scale * 1.4426950408889634);
  Params ring{};
  ring.k = static_cast<const __nv_bfloat16*>(x0);
  ring.v = static_cast<const __nv_bfloat16*>(x1);
  for (int i = 0; i < 3; ++i) {
    ring.st[3 + i] = strides[3 * s0 + i];
    ring.st[6 + i] = strides[3 * s1 + i];
  }
  dim3 grid((rows + kBwdRows - 1) / kBwdRows, b * h);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p, ring);
  return (int)cudaGetLastError();
}

// cudaOccupancyMaxActiveBlocksPerMultiprocessor of a kernel's blocks of
// kThreads threads (minus the CUDA error code if the query fails)
template <class K>
int blocks_per_sm(K kernel) {
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

// Plain C entry points for ctypes, flash_narrow.cu's argument lists: the
// head_dim `d` (8 or 16) after t_len; tensors (B, len, H, d) bf16 with the
// element strides in `strides` (sb, sl, sh of q, k, v, o for the forwards;
// of q, k, v, o, dO, dq for dq; of q, k, v, dO, dk, dv for dk/dv; head_dim
// stride 1), lse and delta (B*H, S) fp32 contiguous.
// flash_fwd_pipelined_w16_bf16 refuses a t_len that is not a whole number,
// at least two, of kBlockKV-row tiles.  Each launches on `stream`,
// allocates nothing, and returns a CUDA error code (0 = launched;
// cudaErrorInvalidValue for arguments it refuses).

extern "C" int flash_fwd_w16_bf16(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int b, int h, int s_len,
                                  int t_len, int d, const long long* strides,
                                  float scale, void* stream) {
  return forward(false, q, k, v, o, lse, b, h, s_len, t_len, d, strides,
                 scale, stream);
}

extern "C" int flash_fwd_pipelined_w16_bf16(const void* q, const void* k,
                                            const void* v, void* o, void* lse,
                                            int b, int h, int s_len,
                                            int t_len, int d,
                                            const long long* strides,
                                            float scale, void* stream) {
  return forward(true, q, k, v, o, lse, b, h, s_len, t_len, d, strides, scale,
                 stream);
}

// dq and delta = rowsum(dO o).
extern "C" int flash_bwd_dq_w16_bf16(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* dout, const void* lse,
                                     void* delta, void* dq, int b, int h,
                                     int s_len, int t_len, int d,
                                     const long long* strides, float scale,
                                     void* stream) {
  BwdParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.out0 = static_cast<__nv_bfloat16*>(dq);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  // K (slot 1) and V (slot 2) stream
  return backward(d == 8 ? dq_kernel<8> : dq_kernel<16>, p, k, 1, v, 2,
                  s_len, b, h, s_len, t_len, d, strides, scale, stream);
}

// dk and dv from dq's delta.
extern "C" int flash_bwd_dkv_w16_bf16(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv, int b, int h,
                                      int s_len, int t_len, int d,
                                      const long long* strides, float scale,
                                      void* stream) {
  BwdParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.out0 = static_cast<__nv_bfloat16*>(dk);
  p.out1 = static_cast<__nv_bfloat16*>(dv);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(const_cast<void*>(delta));
  // q (slot 0) and dO (slot 3) stream
  return backward(d == 8 ? dkv_kernel<8> : dkv_kernel<16>, p, q, 0, dout, 3,
                  t_len, b, h, s_len, t_len, d, strides, scale, stream);
}

// The blocks of kThreads threads an SM runs at once of the standard (0) or
// deferred (1) forward at head_dim d (8 or 16), by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor (minus a CUDA error code if
// the query fails, 0 for a d it does not take): the waves of a launch are
// its ceil(S / kRows) * B*H blocks over this times the SMs.
extern "C" int flash_fwd_w16_bf16_blocks_per_sm(int deferred, int d) {
  if (d == 8)
    return deferred ? blocks_per_sm(fwd_kernel<8, true>)
                    : blocks_per_sm(fwd_kernel<8, false>);
  if (d == 16)
    return deferred ? blocks_per_sm(fwd_kernel<16, true>)
                    : blocks_per_sm(fwd_kernel<16, false>);
  return 0;
}

// The same of dq (0) or dk/dv (1): ceil(S / kBwdRows) * B*H blocks (dq) or
// ceil(T / kBwdRows) * B*H (dk/dv).
extern "C" int flash_bwd_w16_bf16_blocks_per_sm(int dkv, int d) {
  if (d == 8)
    return dkv ? blocks_per_sm(dkv_kernel<8>) : blocks_per_sm(dq_kernel<8>);
  if (d == 16)
    return dkv ? blocks_per_sm(dkv_kernel<16>)
               : blocks_per_sm(dq_kernel<16>);
  return 0;
}
