// Flash-attention forwards on fp32 inputs at head_dim 256 for Hopper
// (sm_90a): the standard forward and the deferred-softmax forward, fp32 in
// and out, the LSE in fp32.  The small VAE's mid-block (small_config, one
// head of 256) runs them when an fp32 model encodes or decodes with
// VAEConfig.use_flash_attention: 2 standard forwards at (B*H, S, T) = (16,
// 4096, 4096) a stage-1 step at batch 16 (the step and its recompute), 1
// at (1, 4096, 4096) a 256^2 codec call; PIPELINE_FWD takes the deferred
// one.  The backward pair at 256 is flash_fp32_d256_bwd_sm90.cu, on the
// same cluster layout and the same score code (flash_fp32_d256_sm90.cuh).
//
// Replaces the Pallas TPU kernels `_fwd_kernel` (pl.pallas_call in
// `_flash_fwd_3d`) and `_fwd_kernel_pipelined` (in
// `_flash_fwd_3d_pipelined`) of diffute_tpu/ops/flash_attention.py on fp32
// inputs at that width, as JAX computes fp32:
//
//   standard: s = q k^T * scale (the exact scale after the product),
//     p = exp(s - m), lse = m + log(l), o = sum p v / l;
//   deferred: q' = q * fp32(scale * log2 e) (rounded to fp32 once, as
//     `_flash_fwd_3d_pipelined` does), s = q' k^T, p = exp2(s - m),
//     lse = (m + log2(l)) * ln 2;  p stays fp32 in both.
//
//   q (B, S, H, 256), k, v (B, T, H, 256)  fp32, any strides TMA takes
//     (multiples of 16 bytes, the last one 1)
//   o (B, S, H, 256) fp32 through its strides (the wrappers hand it
//     contiguous), lse (B*H, S) fp32 natural log
//
// The precision contract of flash_fp32.cu's head: every product 3xTF32
// (x = hi + lo, each a TF32 value; lo_a hi_b and hi_a lo_b first, then hi
// hi), no tensor-core sum longer than 32 columns of head_dim (a score
// chain) or 32 kv rows (a p v part) before an fp32 add, o within relative
// L2 1e-5 of the tiled plain fp32 forward at the kernel's kv tile and
// domain, the LSE within 1e-5; no float atomics, every sum in a fixed
// order, each output element written by one block: the same bits every
// run.
//
// What bounds them on the H100: operations.  3xTF32 takes three TF32
// products for one, so 494.7 TF32 TFLOP/s give 164.9; a forward issues 4 S
// T D FLOPs a head (S and P V).  tf32 wgmma takes both operands K-major
// only and reads an operand in shared memory as its TF32 truncation
// (tf32_wgmma_sm90.cuh), so both operands of S and the B of P V must be
// split planes already.  The first cut (flash_fp32.cu's Fp32<256, 32> on
// mma.sync) held 32-row q tiles, so each streamed byte served 32 rows, and
// summed S over four 64-column warp slices as one 64-column chain each:
// the backward pair at 256, which sums S as two 32-column chains, then
// recomputed p from other bits of S than the LSE it read.
//
// Layout (flash_fp32_d256_sm90.cuh), dq's of the backward pair with dP
// dropped and the online softmax in the reducer.  A cluster of four blocks
// splits head_dim: block r owns columns [64 r, 64 r + 64) of q, k, v and o
// and the cluster owns kRows = 64 resident q rows; kv streams in kBlockKV =
// 32-row tiles.  A block is a producer warpgroup and one consumer
// warpgroup.  The producer loads Q once, then each K and V tile, by TMA
// through the strides (boxes of 32 fp32 columns, 128-byte swizzle, rows
// past S or T read as zeros), and splits each once: Q into hi and lo planes
// (the deferred forward scales its 64 columns by fp32(scale * log2 e)
// first: elementwise, so four blocks scaled apart give the bits of each
// row scaled whole), K into its natural pair (hi in place of the raw tile),
// V from its landing buffer into the transposed pair, in the permuted order
// the output product's B takes (as the pair writes K^T).  K's natural
// planes and V's landing are one ring (kNatStages), a stage freed when its
// tile's score products retire; V^T is a second ring (kTrStages), a stage
// freed when its output product does.
//
// The consumer warpgroup holds the block's 64 rows x 64 columns of o (32
// fp32 registers a thread).  A tile's scores, in a fixed order: the
// block's partial S (64 x 32 over its 64 columns) is the pair's
// issue_scores (two 32-column chains, 12 products each, small terms first);
// each warp w adds its two chains with __fadd_rn and stores its 16 rows by
// st.async into the receive buffer of block w, which reduces rows [16 w,
// 16 w + 16) (a reduce-scatter: 2 KB from each rank a tile) and sums the
// ranks in order, 0 to 3 (sum_ranks); the standard forward then scales
// and sets columns at or past T to -inf, as dq does.  The reducer runs the
// online softmax of its 16 rows in consume_tile's order (flash_fp32.cu):
// the tile's row max (a quad's 8 columns by shuffles, then the four warps'
// n-tiles through shared memory behind one barrier of the warpgroup),
// m_new = max(m, max), alpha = exp(m - m_new), p = exp(s - m_new), l = l
// alpha + (p's share); each thread keeps its two rows' m and its share of
// l.  It stores p by st.async into every block's gather buffer in the
// accumulator layout the owning warp's register A takes, and warp 0 the
// rows' alpha (the last tile: l summed over the row, which every block
// divides its o columns by) beside it: warp w of every block holds the o
// rows [16 w, 16 w + 16) that block w reduced (the m64 accumulator's map:
// warp w, rows 16 w + g and 16 w + g + 8), so the float4 of alpha and l
// of rows g and g + 8 lands where those rows' threads read it.  Each block
// then rescales o by alpha and issues P V_j (a body later: below): p split
// in registers as A, the V^T planes as B (N = 64), 12 products from zero,
// added to o by an fp32 add when they retire: o = (o alpha) + part,
// consume_tile's two roundings.  The reducer writes the natural-log LSE of
// its rows.
//
// Schedule: the exchange's two remote trips a tile off the critical path.
// This layout's first cut ran dq's schedule (S_{j+1} issued ahead of tile
// j's reduce, P V_j right after it, one receive and one gather buffer):
// 6.37-6.48 ms at (16, 4096^2) on an H100 at 700 W, whatever the depth of
// its rings (two to four stages); this one runs 5.86-5.91 ms there.
// Here the receive and gather buffers are two each, by tile parity, and
// body j of the consumer runs:
//   1. tile j's reduce (its partials were sent one body earlier);
//   2. tile j - 2's part retired and added to o (its V^T stage released);
//   3. tile j - 1's gathered p and alpha (reduced one body earlier): o
//      rescaled, P V_{j-1} issued;
//   4. S_{j+1} retired (its K stage released) and sent;
//   5. S_{j+2} issued.
// So P V runs a tile behind the softmax, as `_fwd_kernel_pipelined` defers
// it on the TPU and flash_fp32_d512_sm90.cu does, and the deferred forward
// is the same kernel on prescaled q in base 2 (kBase2): the standard one
// issues S ahead too.  Two buffers of each suffice: a block sends tile j +
// 1's partials (into the parity of tile j - 1's) only after it has read
// tile j - 1's gathered p, which every reducer sent only after reading
// tile j - 1's partials; and a reducer writes tile j + 1's p (into the
// parity of tile j - 1's) only after every block's tile j + 1 partials,
// sent after that block read tile j - 1's p.  Each phase of an exchange
// mbarrier is armed by a thread that has waited on the phase before it of
// the same buffer, before that thread's own stores the new phase waits
// for.  One cluster barrier at the start, one at the end.  The producer
// runs ahead of the consumer by the rings: S_{j+2} needs K_{j+2} split in
// body j, while V^T_{j-1} is only then read, so the transposed ring holds
// kTrStages = 4 tiles (with three the producer's split of K_{j+2} waits on
// body j's step 2, with two it never comes); the natural ring's four
// stages let the producer load K and V three tiles ahead (three stages ran
// 1-2% slower, five of V^T 4% slower).
//
// What holds it, by count: shared-memory bandwidth, as it holds the pair.
// A block moves about 193 KB a tile through shared memory: S's operands 72
// KB (the resident Q planes are re-read every tile as the shared A of the
// pair's issue_scores), P V's B 24, the producer's TMA landing, reads and
// splits 64, the exchange 33: 0.86 us at 128 bytes a clock, against about
// 1.33 us measured a tile, the tensor cores' 36 products about 0.5 us.
//
// Shared memory: Q's planes 32 KB; four stages of K's planes and V's
// landing (24 KB each) and four of V^T's planes (16 KB each): 160 KB; two
// receive buffers of 8 KB; two gather buffers of 8 KB and 512 B of alpha
// and l; the row maxima and sums 768 B: 232,400 B with the mbarriers and
// the alignment, of the 232,448 a block may take.  So one block an SM (two
// would need 113 KB each; the first cut of this layout, single buffers and
// two stages a ring, took 133 KB and still one): the card runs 30 clusters
// at once (flash_fwd_d256_fp32_max_clusters, as the pair's), so (16,
// 4096^2)'s 1,024 clusters take 35 waves, (1, 4096^2)'s 64 three and (2,
// 1000, 1500)'s 32 two.
//
// Ragged edges.  TMA reads rows past S or T as zeros.  The standard
// forward sets the scores of kv columns at or past T to -inf before the
// max (a zero score would count); the deferred forward takes T a whole
// number, at least two, of tiles.  q rows past S are not stored.

#include "flash_fp32_d256_sm90.cuh"

namespace {

using namespace fp32_d256;
using cluster_sm90::cluster_arrive;
using cluster_sm90::cluster_rank;
using cluster_sm90::cluster_wait;
using cluster_sm90::mbar_wait_cluster;

// what a reducer receives a tile: float4 [rank][n-tile][lane] of S
constexpr int kRecvBytes = kRanks * kWarpPart;      // 8 KB
// beside a tile's gathered p: float4 [reducer rank][row g of its warp's
// 8] of (alpha of rows g and g + 8, then their l after the last tile)
constexpr int kStatsBytes = kRanks * 8 * 16;        // 512 B
constexpr int kGathTile = kGathBytes + kStatsBytes;  // what a block receives
// a consumer's row maxima by tile parity, then its row sums: float [16
// rows][4 warps] each
constexpr int kRowBytes = 16 * 4 * 4;
// the named barrier of the consumer warpgroup's row exchange
constexpr int kRowBar = 1;
constexpr int kFwdThreads = 256;
// stages of the natural ring (K's planes and V's landing: the producer
// loads tile i + kNatStages - 1 while it splits tile i) and of the
// transposed one (V^T); two receive and two gather buffers, by tile parity
constexpr int kNatStages = 4, kTrStages = 4;
using FwdBars = Barriers<kNatStages, kTrStages, 2>;

// One __grid_constant__ parameter for both forwards.  o's element strides
// (batch, row, head; head_dim stride 1).
struct FwdParams {
  CUtensorMap tm_q, tm_k, tm_v;
  float* o;
  long long o_sb, o_ss, o_sh;
  float* lse;  // (B*H, S), natural log
  int heads, s_len, t_len;
  float scale, scale_log2;
};

// Shared memory: Q's planes (hi, lo), the natural ring (K's planes, V's
// landing), the transposed ring (V^T's planes), the receive and gather
// buffers by tile parity, the row exchange, the mbarriers.
struct FwdSmem {
  static constexpr int q = 0;  // hi; lo kRes further
  static constexpr int nat = 2 * kRes;
  static constexpr int k = 0, v = 2 * kPlane;   // in a natural stage
  static constexpr int kNatStage = 3 * kPlane;  // 24 KB
  static constexpr int tr = nat + kNatStages * kNatStage;
  static constexpr int kTrStage = 2 * kPlane;   // 16 KB: V^T
  static constexpr int recv = tr + kTrStages * kTrStage;
  static constexpr int gath = recv + 2 * kRecvBytes;
  static constexpr int rows = gath + 2 * kGathTile;  // max by parity, then l
  static constexpr int bars = rows + 3 * kRowBytes;
  static constexpr int bytes = bars + FwdBars::kBytes + 1024;  // + alignment
  static_assert(bytes <= 232448, "227 KB a block");
};

template <bool kBase2>
__device__ __forceinline__ float ex(float x) {
  return kBase2 ? exp2f(x) : expf(x);
}

// K and V of kv tile i into its natural stage (K where its planes go, V in
// its landing), completing on full.
__device__ __forceinline__ void load_kv(const FwdParams& p, uint32_t smem,
                                        const FwdBars& bars, const Block& t,
                                        int i) {
  const int st = i % kNatStages;
  const uint32_t stage = smem + FwdSmem::nat + st * FwdSmem::kNatStage;
  mbar_expect_tx(bars.full(st), 2 * kPlane);
  load_plane(&p.tm_k, stage + FwdSmem::k, kStreamBox, bars.full(st),
             t.col0, i * kBlockKV, t.h, t.b);
  load_plane(&p.tm_v, stage + FwdSmem::v, kStreamBox, bars.full(st),
             t.col0, i * kBlockKV, t.h, t.b);
}

// The resident raw Q of the deferred forward scaled by f (fp32, rounded
// once) and split in place as split_plane splits it.
__device__ __forceinline__ void split_scaled(uint32_t hi, int bytes, float f,
                                             int tid) {
  for (int off = tid * 16; off < bytes; off += 128 * 16) {
    const uint4 x = ld_shared_u4(hi + off);
    split_chunk(hi + off, hi + bytes + off,
                make_uint4(__float_as_uint(__fmul_rn(__uint_as_float(x.x), f)),
                           __float_as_uint(__fmul_rn(__uint_as_float(x.y), f)),
                           __float_as_uint(__fmul_rn(__uint_as_float(x.z), f)),
                           __float_as_uint(__fmul_rn(__uint_as_float(x.w), f))));
  }
}

// The producer warpgroup: Q once; then each kv tile i, K split into its
// natural planes and V's landing read for its transposed ones (K's stage
// handed over then); thread 0 loads tile i + kNatStages - 1 into the stage
// tile i - 1's scores released, and the warpgroup writes tile i's V^T once
// tile i - kTrStages's output product released its stage.  No barrier of
// the warpgroup: K is split elementwise in place, and V's landing is not
// written.
template <bool kBase2>
__device__ __forceinline__ void produce(const FwdParams& p, uint32_t smem,
                                        const FwdBars& bars, const Block& t) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    prefetch_map(&p.tm_q);
    prefetch_map(&p.tm_k);
    prefetch_map(&p.tm_v);
    mbar_expect_tx(bars.res_full(), kRes);
    load_plane(&p.tm_q, smem + FwdSmem::q, kResBox, bars.res_full(), t.col0,
               t.row0, t.h, t.b);
    for (int i = 0; i < kNatStages - 1 && i < t.n_tiles; ++i)
      load_kv(p, smem, bars, t, i);
  }
  mbar_wait(bars.res_full(), 0);
  if (kBase2)
    split_scaled(smem + FwdSmem::q, kRes, p.scale_log2, tid);
  else
    split_plane(smem + FwdSmem::q, kRes, tid);
  fence_proxy_async();
  mbar_arrive(bars.res_ready());
  for (int i = 0; i < t.n_tiles; ++i) {
    const int st = i % kNatStages, sv = i % kTrStages;
    const uint32_t nat = smem + FwdSmem::nat + st * FwdSmem::kNatStage;
    const uint32_t tr = smem + FwdSmem::tr + sv * FwdSmem::kTrStage;
    StreamRaw<1, 1> raw;
    mbar_wait(bars.full(st), (i / kNatStages) & 1);
    read_transposed<1, 1>({nat + FwdSmem::v}, raw, tid);
    split_plane(nat + FwdSmem::k, kPlane, tid);
    fence_proxy_async();
    mbar_arrive(bars.nat_ready(st));
    const int ahead = i + kNatStages - 1;
    if (tid == 0 && ahead < t.n_tiles) {
      if (i >= 1) mbar_wait(bars.nat_empty(ahead % kNatStages),
                            ((i - 1) / kNatStages) & 1);
      load_kv(p, smem, bars, t, ahead);
    }
    if (i >= kTrStages)
      mbar_wait(bars.tr_empty(sv), ((i / kTrStages) & 1) ^ 1);
    write_transposed<1, 1>({tr}, raw, tid);
    fence_proxy_async();
    mbar_arrive(bars.tr_ready(sv));
  }
}

// Per thread: S's two chains (16 registers each), the output part and o
// (32 each), p's A fragments (hi and lo, 16 each); as a reducer its rows
// g and g + 8: their running max and its share of their sums; its
// float4 of alpha and l in every block's gather buffer.
struct FwdState {
  float sa[kS], sb[kS], part[32], o[32];
  uint32_t hi[kSteps][4], lo[kSteps][4];
  float m_lo, m_hi, l_lo, l_hi;
  uint32_t stats_at[kRanks];
};

// x over the four warps of the consumer warpgroup, two rows (g, g + 8) a
// quad, through `rows` (float [16][4]) behind one barrier of the
// warpgroup: returns the four in warp order (float4 of row g, of g + 8).
__device__ __forceinline__ void across_warps(uint32_t rows, float x_lo,
                                             float x_hi, float4& lo,
                                             float4& hi) {
  const int warp = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2;
  if ((threadIdx.x & 3) == 0) {
    st_shared_f32(rows + (g * 4 + warp) * 4, x_lo);
    st_shared_f32(rows + ((g + 8) * 4 + warp) * 4, x_hi);
  }
  warpgroup_sync(kRowBar);
  lo = ld_shared_f32x4(rows + g * 16);
  hi = ld_shared_f32x4(rows + (g + 8) * 16);
}

// Tile j's reduce on this block's 16 rows: S summed across the cluster
// (the standard forward: scaled, kv columns at or past T at -inf), the
// online softmax, p into every block's gather buffer of the tile's parity
// and, from warp 0, alpha (the last tile: with l, the rows' LSE written).  A reducer thread
// holds rows g and g + 8 of the block's 16 at the tile's columns 8 w + 2t,
// + 1 (w its warp): s.x, s.y of row g, s.z, s.w of row g + 8.
template <bool kBase2>
__device__ __forceinline__ void reduce(const FwdParams& p, uint32_t smem,
                                       const FwdBars& bars, const Exchange& x,
                                       const Block& t, FwdState& st, int j) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const bool last = j + 1 == t.n_tiles;
  const int par = j & 1;
  mbar_wait_cluster(bars.recv(par), (j >> 1) & 1);
  if ((threadIdx.x & 127) == 0 && j + 2 < t.n_tiles)
    mbar_expect_tx(bars.recv(par), kRecvBytes);
  float4 s = sum_ranks(smem + FwdSmem::recv + par * kRecvBytes, 0);
  if (!kBase2) {
    s.x *= p.scale;
    s.y *= p.scale;
    s.z *= p.scale;
    s.w *= p.scale;
    const int col = j * kBlockKV + warp * 8 + 2 * (lane & 3);
    if (col >= p.t_len) s.x = s.z = -INFINITY;
    if (col + 1 >= p.t_len) s.y = s.w = -INFINITY;
  }
  float mx_lo = fmaxf(s.x, s.y), mx_hi = fmaxf(s.z, s.w);
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  float4 a, b;
  across_warps(smem + FwdSmem::rows + (j & 1) * kRowBytes, mx_lo, mx_hi, a,
               b);
  const float mn_lo = fmaxf(st.m_lo, fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w)));
  const float mn_hi = fmaxf(st.m_hi, fmaxf(fmaxf(b.x, b.y), fmaxf(b.z, b.w)));
  const float alpha_lo = ex<kBase2>(st.m_lo - mn_lo);
  const float alpha_hi = ex<kBase2>(st.m_hi - mn_hi);
  st.m_lo = mn_lo;
  st.m_hi = mn_hi;
  const float4 pt = make_float4(ex<kBase2>(s.x - mn_lo),
                                ex<kBase2>(s.y - mn_lo),
                                ex<kBase2>(s.z - mn_hi),
                                ex<kBase2>(s.w - mn_hi));
  st.l_lo = st.l_lo * alpha_lo + (pt.x + pt.y);
  st.l_hi = st.l_hi * alpha_hi + (pt.z + pt.w);
  scatter(x, par * kGathTile, pt, 8 * par);
  float l_lo = 0.f, l_hi = 0.f;
  if (last) {
    // each row's sum: the quad's shares by a butterfly (every lane the
    // same bits), then the four warps' in order
    l_lo = st.l_lo;
    l_hi = st.l_hi;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    across_warps(smem + FwdSmem::rows + 2 * kRowBytes, l_lo, l_hi, a, b);
    l_lo = ((a.x + a.y) + a.z) + a.w;
    l_hi = ((b.x + b.y) + b.z) + b.w;
  }
  if (warp == 0 && (lane & 3) == 0) {
    const float4 v = make_float4(alpha_lo, alpha_hi, l_lo, l_hi);
#pragma unroll
    for (int q = 0; q < kRanks; ++q)
      st_async_f4(st.stats_at[q] + par * kGathTile, v,
                  x.gath_bar[q] + 8 * par);
    if (last) {
      const int row = t.row0 + 16 * t.rank + (lane >> 2);
      float* lb = p.lse + (size_t)blockIdx.y * p.s_len;
      if (row < p.s_len)
        lb[row] = kBase2 ? (mn_lo + log2f(l_lo)) * kLn2 : mn_lo + logf(l_lo);
      if (row + 8 < p.s_len)
        lb[row + 8] =
            kBase2 ? (mn_hi + log2f(l_hi)) * kLn2 : mn_hi + logf(l_hi);
    }
  }
}

// o / l as fp32 rows [row0, row0 + 64), the block's columns, through o's
// strides (l of rows g and g + 8 of this warp's 16); rows past S dropped.
__device__ __forceinline__ void store_o(const FwdParams& p, const Block& t,
                                        const float (&o)[32], float l_lo,
                                        float l_hi) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int r_lo = t.row0 + ((threadIdx.x >> 5) & 3) * 16 + g, r_hi = r_lo + 8;
  float* base = p.o + t.b * p.o_sb + t.h * p.o_sh + t.col0;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + tq * 2;
    if (r_lo < p.s_len)
      *reinterpret_cast<float2*>(base + r_lo * p.o_ss + col) =
          make_float2(o[4 * n] / l_lo, o[4 * n + 1] / l_lo);
    if (r_hi < p.s_len)
      *reinterpret_cast<float2*>(base + r_hi * p.o_ss + col) =
          make_float2(o[4 * n + 2] / l_hi, o[4 * n + 3] / l_hi);
  }
}

// The consumer warpgroup: the block's 64 q rows over its 64 columns, body
// j as the head says (j = n only finishes tile n - 1's P V).
template <bool kBase2>
__device__ __forceinline__ void consume(const FwdParams& p, uint32_t smem,
                                        const FwdBars& bars, const Block& t) {
  const int n = t.n_tiles, warp = (threadIdx.x >> 5) & 3;
  const int g = (threadIdx.x & 31) >> 2;
  const uint32_t gath = smem + FwdSmem::gath;
  const Exchange x = exchange(t, smem + FwdSmem::recv, gath, bars);
  FwdState st;
#pragma unroll
  for (int q = 0; q < kRanks; ++q)
    st.stats_at[q] = map_rank(gath + kGathBytes + (t.rank * 8 + g) * 16, q);
  st.m_lo = st.m_hi = -INFINITY;
  st.l_lo = st.l_hi = 0.f;
  zero(st.o);
  const uint32_t q_hi = smem + FwdSmem::q;
  // this thread's float4 of alpha and l: rows 16 w + g, + 8 (w its warp)
  const uint32_t stats = gath + kGathBytes + (warp * 8 + g) * 16;
  float4 al = make_float4(0.f, 0.f, 1.f, 1.f);
  mbar_wait(bars.res_ready(), 0);

  // S_j of the natural stage that holds tile j
  auto issue_s = [&](int j) {
    const int sn = j % kNatStages;
    const uint32_t nat = smem + FwdSmem::nat + sn * FwdSmem::kNatStage;
    mbar_wait(bars.nat_ready(sn), (j / kNatStages) & 1);
    issue_begin(st.sa, st.sb);
    issue_scores(st.sa, st.sb, q_hi, q_hi + kRes, nat + FwdSmem::k,
                 nat + FwdSmem::k + kPlane);
    issue_end(st.sa, st.sb);
  };
  // S_j retired: its K stage released, its partials sent
  auto send_s = [&](int j) {
    fence_regs(st.sa);
    fence_regs(st.sb);
    release_warp(bars.nat_empty(j % kNatStages));
    send_part(x.part_at + (j & 1) * kRecvBytes, x.part_bar + 8 * (j & 1),
              st.sa, st.sb);
  };

  // tile 0's scores, sent; tile 1's issued
  issue_s(0);
  wgmma_wait<0>();
  send_s(0);
  if (n > 1) issue_s(1);

  for (int j = 0; j <= n; ++j) {
    if (j < n) reduce<kBase2>(p, smem, bars, x, t, st, j);
    if (j >= 2) {
      // tile j - 2's part (S_{j+1} may be in flight behind it)
      if (j + 1 < n)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      fence_regs(st.part);
      fence_regs(st.hi);
      fence_regs(st.lo);
      add_part(st.o, st.part);
      release_warp(bars.tr_empty((j - 2) % kTrStages));
    }
    if (j >= 1) {
      // tile j - 1's p V
      const int i = j - 1, par = i & 1;
      mbar_wait_cluster(bars.gath(par), (i >> 1) & 1);
      if ((threadIdx.x & 127) == 0 && j + 1 < n)
        mbar_expect_tx(bars.gath(par), kGathTile);
      gathered_frags(gath + par * kGathTile, st.hi, st.lo);
      al = ld_shared_f32x4(stats + par * kGathTile);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        st.o[4 * c] = __fmul_rn(st.o[4 * c], al.x);
        st.o[4 * c + 1] = __fmul_rn(st.o[4 * c + 1], al.x);
        st.o[4 * c + 2] = __fmul_rn(st.o[4 * c + 2], al.y);
        st.o[4 * c + 3] = __fmul_rn(st.o[4 * c + 3], al.y);
      }
      const int sv = i % kTrStages;
      const uint32_t vt = smem + FwdSmem::tr + sv * FwdSmem::kTrStage;
      mbar_wait(bars.tr_ready(sv), (i / kTrStages) & 1);
      issue_begin(st.part, st.hi, st.lo);
      issue_out(st.part, st.hi, st.lo, vt, vt + kPlane);
      issue_end(st.part, st.hi, st.lo);
    }
    if (j + 1 < n) {
      // S_{j+1}, issued one body earlier, ahead of the part just issued
      if (j >= 1)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      send_s(j + 1);
    }
    if (j + 2 < n) issue_s(j + 2);
  }
  wgmma_wait<0>();
  fence_regs(st.part);
  fence_regs(st.hi);
  fence_regs(st.lo);
  add_part(st.o, st.part);
  store_o(p, t, st.o, al.z, al.w);
}

// grid (4 ceil(S / 64), B*H) in clusters of four: warpgroup 0 produces, 1
// consumes the cluster's 64 q rows over the block's 64 columns.
template <bool kBase2>
__global__ void __launch_bounds__(kFwdThreads, 1)
    fwd_kernel(const __grid_constant__ FwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int rank = cluster_rank();
  const Block t{rank,
                rank * kCols,
                (int)blockIdx.y / p.heads,
                (int)blockIdx.y % p.heads,
                (int)(blockIdx.x / kRanks) * kRows,
                (p.t_len + kBlockKV - 1) / kBlockKV};
  const FwdBars bars{smem + FwdSmem::bars};
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (threadIdx.x == 0) bars.init(4, kRecvBytes, kGathTile);
  __syncthreads();
  cluster_arrive();  // every block's mbarriers initialised and armed
  cluster_wait();
  if (wg == 0)
    produce<kBase2>(p, smem, bars, t);
  else
    consume<kBase2>(p, smem, bars, t);
  // no block leaves while another may still store into it
  cluster_arrive();
  cluster_wait();
}

// Encode the three input maps (q's boxes kRows rows, k's and v's
// kBlockKV), fill the scalars and launch over clusters of kRanks blocks.
// `s` holds the element strides (sb, sl, sh) of q, k, v and o.  The
// deferred forward takes t_len a multiple of kBlockKV of at least two
// tiles (cudaErrorInvalidValue otherwise).
template <bool kBase2>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int b, int h, int s_len, int t_len,
               const long long* s, float scale, void* stream) {
  if (b <= 0 || h <= 0 || s_len <= 0 || t_len <= 0 || (long long)b * h > 65535)
    return (int)cudaErrorInvalidValue;
  if (kBase2 && (t_len % kBlockKV || t_len < 2 * kBlockKV))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr =
      cluster_sm90::allow_smem(fwd_kernel<kBase2>, FwdSmem::bytes);
  if (attr != cudaSuccess) return (int)attr;
  if (const cudaError_t err = bind_context()) return (int)err;
  FwdParams p{};
  using fp32_tma::encode_fp32;
  if (!encode_fp32(&p.tm_q, q, kD, b, s_len, h, s[0], s[1], s[2], kRows) ||
      !encode_fp32(&p.tm_k, k, kD, b, t_len, h, s[3], s[4], s[5], kBlockKV) ||
      !encode_fp32(&p.tm_v, v, kD, b, t_len, h, s[6], s[7], s[8], kBlockKV))
    return (int)cudaErrorInvalidValue;
  p.o = static_cast<float*>(o);
  p.o_sb = s[9];
  p.o_ss = s[10];
  p.o_sh = s[11];
  p.lse = static_cast<float*>(lse);
  p.heads = h;
  p.s_len = s_len;
  p.t_len = t_len;
  p.scale = scale;
  // rounded to fp32 once, as the JAX package's `q * (scale * _LOG2E)` is
  p.scale_log2 = (float)((double)scale * 1.4426950408889634);
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = cluster_sm90::cluster_config(
      kRanks, kRows, kFwdThreads, s_len, b * h, FwdSmem::bytes,
      static_cast<cudaStream_t>(stream), &cluster);
  void (*kernel)(FwdParams) = fwd_kernel<kBase2>;
  void* args[] = {&p};
  const cudaError_t err =
      cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes, with the other forward entries'
// argument lists.  q, k, v, o (B, len, H, 256) fp32 with the element
// strides in `strides` (sb, sl, sh each of q, k, v, o; head_dim stride 1),
// lse (B*H, S) fp32 contiguous.  Each launches on `stream`, allocates
// nothing, and returns a CUDA error code (0 = launched).
extern "C" int flash_fwd_d256_fp32(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int b,
                                   int h, int s_len, int t_len,
                                   const long long* strides, float scale,
                                   void* stream) {
  return launch_fwd<false>(q, k, v, o, lse, b, h, s_len, t_len, strides,
                           scale, stream);
}

// The deferred-softmax forward: t_len a multiple of 32 of at least 64.
extern "C" int flash_fwd_pipelined_d256_fp32(const void* q, const void* k,
                                             const void* v, void* o,
                                             void* lse, int b, int h,
                                             int s_len, int t_len,
                                             const long long* strides,
                                             float scale, void* stream) {
  return launch_fwd<true>(q, k, v, o, lse, b, h, s_len, t_len, strides,
                          scale, stream);
}

// cudaOccupancyMaxActiveClusters of the standard (pipelined = 0) or the
// deferred forward (1): the clusters of four blocks the card runs at once;
// a negative CUDA error code if the query fails.
extern "C" int flash_fwd_d256_fp32_max_clusters(int pipelined) {
  return pipelined
             ? cluster_sm90::max_clusters(fwd_kernel<true>, kRanks, kRows,
                                          kFwdThreads, FwdSmem::bytes)
             : cluster_sm90::max_clusters(fwd_kernel<false>, kRanks, kRows,
                                          kFwdThreads, FwdSmem::bytes);
}
