// The cluster layout both fp32 head_dim-512 flash sources share
// (flash_fp32_d512_sm90.cu: the two forwards; flash_fp32_d512_bwd_sm90.cu:
// dq and dk/dv), sm_90a.  A cluster of four blocks (kRanks) splits
// head_dim: block r owns columns [128 r, 128 r + 128) of every tile and
// the cluster's kRows = 64 resident rows; the other axis streams in
// kBlockKV = 32-row tiles, loaded by TMA as boxes of 32 fp32 columns (128
// bytes) with the 128-byte swizzle.  Each block computes its share of a
// score tile over its columns, stores it through distributed shared memory
// into the receive buffer of the block that reduces those rows, and the
// reducing block hands the result back to every block's gather buffer.
//
// Here: the constants of that layout, the 3xTF32 products on
// mma.sync.m16n8k8.tf32 with each operand split by integer operations
// (cvt.rna's bits), a warp's 32 x 32 share of a score tile and of an output
// product, the slice loads and the cluster launch at this layout; the
// cluster's rank, mapa, remote stores and split barrier are
// cluster_sm90.cuh's, the tensor maps fp32_tma_sm90.cuh's.

#pragma once

#include "cluster_sm90.cuh"
#include "flash_sm90.cuh"
#include "fp32_tma_sm90.cuh"
#include "tf32_sm90.cuh"

namespace fp32_d512 {

using cluster_sm90::allow_smem;
using cluster_sm90::cluster_arrive;
using cluster_sm90::cluster_rank;
using cluster_sm90::cluster_wait;
using cluster_sm90::map_rank;
using cluster_sm90::st_cluster_f;
using cluster_sm90::st_cluster_f2;
using cluster_sm90::st_cluster_f4;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::prefetch_map;
using sm90::tma_load_at;
using tf32_sm90::mma_tf32;
using tf32_sm90::rna_tf32;

constexpr int kD = 512;
constexpr int kRanks = 4;              // blocks of a cluster
constexpr int kCols = kD / kRanks;     // 128 head_dim columns a block owns
constexpr int kBox = 32;               // fp32 columns of a TMA box: 128 bytes
// resident rows of a cluster: the q rows of the forwards and of dq, the kv
// rows of dk/dv (ops/flash_attention.py: FP32_D512_ROWS)
constexpr int kRows = 64;
// the rows of a streamed tile: the kv tile the forwards and dq walk and
// the q tile dk/dv walks (FP32_BLOCK_KV[512])
constexpr int kBlockKV = 32;
constexpr int kThreads = 256;  // 8 warps
// the m16 tiles (16-row groups of the 64) a warp's products span
constexpr int kM = 2;
constexpr int kResBytes = kRows * kCols * 4;         // 32 KB
constexpr int kStreamBytes = kBlockKV * kCols * 4;   // 16 KB
constexpr int kResBox = kRows * kBox * 4;            // 8 KB
constexpr int kStreamBox = kBlockKV * kBox * 4;      // 4 KB
// one gathered 64 x 32 fp32 operand, float4 [group][8-column step][lane]
constexpr int kGathBytes = kRows * kBlockKV * 4;      // 8 KB
static_assert(kRows == 64 && kBlockKV == 32,
              "four 16-row groups, four 8-column steps a tile");
static_assert(kCols == 4 * kBox, "four boxes a slice row");

// ---------------------------------------------------------------- products

// float offset of element (row, col) of a slice of R rows x 128 columns,
// stored as four boxes of [R][32] with the 128-byte swizzle
template <int R>
__device__ __forceinline__ int at(int row, int col) {
  return (col >> 5) * (R * kBox) + row * kBox +
         ((col & 31) ^ ((row & 7) << 2));
}

// x = hi + lo, each a TF32 value (lo the TF32 rounding of the rest), as
// tf32_sm90::split computes it
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
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

// A B fragment (b0, b1) split into its TF32 halves.
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split_b(FragB& f, float b0, float b1) {
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
}

// d[i] += a[i] b[i] for N independent accumulators in 3xTF32: every
// accumulator takes lo_a hi_b, then hi_a lo_b, then hi_a hi_b (the small
// terms first), and the N products of each term are issued together, so
// that no mma.sync waits on the one just before it.
template <int N>
__device__ __forceinline__ void mma3_n(float (&d)[N][4], const FragA (&a)[N],
                                       const FragB (&b)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], a[i].lo, b[i].hi[0], b[i].hi[1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], a[i].hi, b[i].lo[0], b[i].lo[1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], a[i].hi, b[i].hi[0], b[i].hi[1]);
}

// A warp's share of a product: 32 rows (kM m16 tiles) by 32 columns (four
// n8 tiles), acc[4 m + n].  Every split A fragment serves four products and
// every B fragment two: a warp splits 16 values a k-step for 24 mma.sync.
using Acc = float[4 * kM][4];

__device__ __forceinline__ void zero_acc(Acc& x) {
#pragma unroll
  for (int n = 0; n < 4 * kM; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) x[n][i] = 0.f;
}

// acc[4 m + n] += a[m] b[n] in 3xTF32
__device__ __forceinline__ void mma3_mx4(Acc& acc, const FragA (&a)[kM],
                                         const FragB (&b)[4]) {
  FragA fa[4 * kM];
  FragB fb[4 * kM];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      fa[4 * m + n] = a[m];
      fb[4 * m + n] = b[n];
    }
  mma3_n(acc, fa, fb);
}

// A warp's partial of a score tile: x (32 x 32) = rows [a0, a0 + 32) of
// the resident slice `a` times the 32 rows of the streamed slice `b`,
// transposed, over the 8 kSteps columns [c0, c0 + 8 kSteps) of the block's
// 128, in tensor-core chains of kChain k-steps (8 kChain columns) from
// zero, each added to x by an ordinary round-to-nearest fp32 add: the
// chains' accumulation rounds toward zero, and its bias grows with the
// partial sums it rounds (the forwards: one chain of 4 k-steps, 32 columns;
// the backward pair: 8 k-steps in chains of kScoreChain = 4 there).
template <int kSteps = 8, int kChain = kSteps>
__device__ __forceinline__ void scores_part(Acc& x, const float* a, int a0,
                                            const float* b, int c0) {
  static_assert(kSteps % kChain == 0, "whole chains");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  Acc c;
  zero_acc(x);
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int col = c0 + kk * 8 + t;
    FragA fa[kM];
    FragB fb[4];
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const int r = a0 + 16 * m + g;
      split_a(fa[m], a[at<kRows>(r, col)], a[at<kRows>(r + 8, col)],
              a[at<kRows>(r, col + 4)], a[at<kRows>(r + 8, col + 4)]);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
      split_b(fb[n], b[at<kBlockKV>(n * 8 + g, col)],
              b[at<kBlockKV>(n * 8 + g, col + 4)]);
    // the first chain runs in x itself (0 + chain is the chain)
    if (kk < kChain) {
      mma3_mx4(x, fa, fb);
      continue;
    }
    if (kk % kChain == 0) zero_acc(c);
    mma3_mx4(c, fa, fb);
    if (kk % kChain == kChain - 1) {
#pragma unroll
      for (int j = 0; j < 4 * kM; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) x[j][i] = __fadd_rn(x[j][i], c[j][i]);
    }
  }
}

// Store a warp's partial into the receive buffers of the blocks that
// reduce its rows, at dst[m] (the slot of its m16 tile m there: part_slots).
__device__ __forceinline__ void put_part(const uint32_t (&dst)[kM],
                                         const Acc& x) {
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
      st_cluster_f4(dst[m] + n * 32 * 16,
                    make_float4(x[4 * m + n][0], x[4 * m + n][1],
                                x[4 * m + n][2], x[4 * m + n][3]));
}

// part (32 x 32) = A (32 x 32: row groups 2 rp and 2 rp + 1 of the
// gathered operand `gath`) times the 32 rows of the streamed slice `b`,
// columns [c0, c0 + 32), summed from zero over the tile's 32 rows (12
// products, the eight 8-column blocks advancing together).  The
// contraction runs in the order 2t, 2t + 1 of each 8 rows, so that A is the
// accumulator layout as gathered (c0, c2, c1, c3) and B's rows 2t + e,
// columns c0 + 8n + g hit 32 distinct banks.
__device__ __forceinline__ void out_tile(Acc& part, const float4* gath,
                                         int rp, const float* b, int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  zero_acc(part);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int r = kk * 8 + 2 * t;
    FragA fa[kM];
    FragB fb[4];
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const float4 x = gath[((kM * rp + m) * 4 + kk) * 32 + lane];
      split_a(fa[m], x.x, x.z, x.y, x.w);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = c0 + n * 8 + g;
      split_b(fb[n], b[at<kBlockKV>(r, col)], b[at<kBlockKV>(r + 1, col)]);
    }
    mma3_mx4(part, fa, fb);
  }
}

// ------------------------------------------------------------------ loads

// The four box loads of this block's 128 columns from `col0` of rows
// `row`.. of `map` into the slice at `dst` (boxes `box` bytes apart),
// completing on `bar`.
__device__ __forceinline__ void load_slice(const CUtensorMap* map,
                                           uint32_t dst, uint32_t box,
                                           uint32_t bar, int col0, int row,
                                           int h, int b) {
#pragma unroll
  for (int c = 0; c < kCols / kBox; ++c)
    tma_load_at(dst + c * box, map, bar, col0 + c * kBox, h, row, b);
}

// What a block reads: its rank's first column, its (batch, head), the
// streamed tiles, and the addresses of its resident slices, ring, partial
// and gather buffers, mbarriers (`once` for the resident slices, then full
// per stage) and stage statistics (dk/dv).
struct Block {
  int rank, col0, bh, h, bb, n_tiles;
  uint32_t res0, res1, ring0, ring1, part, gath, bars, stats;
  __device__ uint32_t once() const { return bars; }
  __device__ uint32_t full(int s) const { return bars + 8 * (1 + s); }
};

__device__ __forceinline__ void init_bars(const Block& t, int ring,
                                          uint32_t full_count) {
  mbar_init(t.once(), 1);
  for (int s = 0; s < ring; ++s) mbar_init(t.full(s), full_count);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Where a warp's partial goes: the slots of its two m16 tiles (rows
// [32 rp, 32 rp + 32)) in the receive buffers of blocks 2 rp and 2 rp + 1
// (product `prod`, this block's rank, chain `ch` of kChains).
template <int kChains = 2>
__device__ __forceinline__ void part_slots(uint32_t (&dst)[kM], const Block& t,
                                           int prod, int rp, int ch) {
  const uint32_t slot =
      t.part + (((prod * kRanks + t.rank) * kChains + ch) * 4 * 32 +
                (threadIdx.x & 31)) *
                   16;
#pragma unroll
  for (int m = 0; m < kM; ++m) dst[m] = map_rank(slot, kM * rp + m);
}

// ------------------------------------------------------------------ host

// A launch of `kernel` over clusters of kRanks blocks, one cluster a
// kRows-row tile of `rows` rows and B*H.
inline cudaLaunchConfig_t cluster_config(int rows, int bh, int smem_bytes,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  return cluster_sm90::cluster_config(kRanks, kRows, kThreads, rows, bh,
                                      smem_bytes, stream, attr);
}

// cudaOccupancyMaxActiveClusters of `kernel` with `bytes` of shared memory
// a block: the clusters of kRanks blocks the card runs at once; a negative
// CUDA error code if the query fails.
template <class Params>
int max_clusters(void (*kernel)(Params), int bytes) {
  return cluster_sm90::max_clusters(kernel, kRanks, kRows, kThreads, bytes);
}

}  // namespace fp32_d512
