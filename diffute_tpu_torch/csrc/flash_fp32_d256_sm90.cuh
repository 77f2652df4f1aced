// The cluster layout both fp32 head_dim-256 flash sources share
// (flash_fp32_d256_sm90.cu: the two forwards; flash_fp32_d256_bwd_sm90.cu:
// dq and dk/dv), sm_90a.  A cluster of four blocks (kRanks) splits
// head_dim: block r owns columns [64 r, 64 r + 64) of every tile and the
// cluster's kRows = 64 resident rows (the q rows of the forwards and dq,
// the kv rows of dk/dv); the other axis streams in kBlockKV = 32-row tiles,
// loaded by TMA as boxes of 32 fp32 columns with the 128-byte swizzle and
// split once into hi and lo TF32 planes by a producer warpgroup
// (tf32_wgmma_sm90.cuh).
//
// Here: the constants of that layout; the score products (a block's 64
// columns of S, or of dP, as two 32-column tf32 wgmma chains, 12 products
// each from zero, the small terms first); the exchange of a score tile
// across the cluster without a cluster barrier (each warp's 16 rows of the
// block's partial, the two chains added in fp32, stored by st.async into
// the receive buffer of the block that reduces those rows; the ranks'
// partials summed there in order, 0 to 3; the reduced operand stored back
// the same way into every block's gather buffer, in the accumulator layout
// the owning warp's register A takes) and the mbarriers it completes on.
// So the forwards' scores and the backward pair's come from one piece of
// code: on the same Q and K they are the same bits.

#pragma once

#include "cluster_sm90.cuh"
#include "fp32_tma_sm90.cuh"
#include "tf32_wgmma_sm90.cuh"

namespace fp32_d256 {

using namespace sm90;
using cluster_sm90::map_rank;
using cluster_sm90::st_async_f4;

constexpr int kD = 256;
constexpr int kRanks = 4;              // blocks of a cluster
constexpr int kCols = kD / kRanks;     // 64 head_dim columns a block owns
constexpr int kBox = 32;               // fp32 columns of a TMA box
// resident rows of a cluster: the q rows of the forwards and dq, the kv
// rows of dk/dv (ops/flash_attention.py: FP32_D256_ROWS)
constexpr int kRows = 64;
// the streamed tile: the kv tile the forwards and dq walk and the q tile
// dk/dv walks (FP32_BLOCK_KV[256])
constexpr int kBlockKV = 32;
constexpr int kRing = 2;               // stages of each ring
constexpr int kS = kBlockKV / 2;       // score registers a thread
constexpr int kSteps = kBlockKV / 8;   // k-steps of an output product
constexpr int kStreamBox = kBlockKV * kBox * 4;   // 4 KB
constexpr int kPlane = 2 * kStreamBox;            // 8 KB: 32 rows x 64
constexpr int kResBox = kRows * kBox * 4;         // 8 KB
constexpr int kRes = 2 * kResBox;                 // 16 KB: 64 rows x 64
static_assert(kCols == 2 * kBox && kPlane == kCols * kBlockKV * 4,
              "a transposed plane (64 rows of 32) is a streamed plane's size");
static_assert(kSteps == 4, "issue_out's four k-steps");
static_assert(kStreamBox == kStreamTileBox && kPlane == kStreamTilePlane,
              "the streamed tile of tf32_wgmma_sm90.cuh's splits");
// one warp's 16 x 32 share of a score tile, float4 [n-tile][lane]
constexpr int kWarpPart = 4 * 32 * 16;                 // 2 KB
// one gathered 64 x 32 operand, float4 [warp][n-tile][lane]
constexpr int kGathBytes = 4 * kWarpPart;              // 8 KB

// mbarriers: the resident tiles' load and split; per stage the natural
// ring's load (full), split (nat_ready) and release (nat_empty), the
// transposed ring's split (tr_ready) and release (tr_empty); the exchange's
// receive and gather buffers (one arrival, the armed bytes).  kNat and kTr
// stages of the two rings, kEx receive and gather buffers: the backward
// pair's kRing, kRing and one.
template <int kNat, int kTr, int kEx = 1>
struct Barriers {
  static constexpr int kBytes = 8 * (2 + 3 * kNat + 2 * kTr + 2 * kEx);
  uint32_t base;
  __device__ uint32_t res_full() const { return base; }
  __device__ uint32_t res_ready() const { return base + 8; }
  __device__ uint32_t full(int s) const { return base + 8 * (2 + s); }
  __device__ uint32_t nat_ready(int s) const {
    return base + 8 * (2 + kNat + s);
  }
  __device__ uint32_t nat_empty(int s) const {
    return base + 8 * (2 + 2 * kNat + s);
  }
  __device__ uint32_t tr_ready(int s) const {
    return base + 8 * (2 + 3 * kNat + s);
  }
  __device__ uint32_t tr_empty(int s) const {
    return base + 8 * (2 + 3 * kNat + kTr + s);
  }
  __device__ uint32_t recv(int b = 0) const {
    return base + 8 * (2 + 3 * kNat + 2 * kTr + b);
  }
  __device__ uint32_t gath(int b = 0) const {
    return base + 8 * (2 + 3 * kNat + 2 * kTr + kEx + b);
  }
  // `warps` consumer warps release each stage; the exchange buffers' first
  // phases are armed here (`recv_bytes` and `gath_bytes` a tile), before
  // the start's cluster barrier lets any block store
  __device__ void init(uint32_t warps, uint32_t recv_bytes,
                       uint32_t gath_bytes) const {
    mbar_init(res_full(), 1);
    mbar_init(res_ready(), 128);
    for (int s = 0; s < (kNat > kTr ? kNat : kTr); ++s) {
      if (s < kNat) {
        mbar_init(full(s), 1);
        mbar_init(nat_ready(s), 128);
        mbar_init(nat_empty(s), warps);
      }
      if (s < kTr) {
        mbar_init(tr_ready(s), 128);
        mbar_init(tr_empty(s), warps);
      }
    }
    for (int b = 0; b < kEx; ++b) {
      mbar_init(recv(b), 1);
      mbar_init(gath(b), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int b = 0; b < kEx; ++b) {
      mbar_expect_tx(recv(b), recv_bytes);
      mbar_expect_tx(gath(b), gath_bytes);
    }
  }
};
using BarrierSet = Barriers<kRing, kRing>;
constexpr int kBarBytes = BarrierSet::kBytes;

// What a block is: its rank and first column, its (batch, head), its
// cluster's first resident row, the streamed tiles.
struct Block {
  int rank, col0, b, h, row0, n_tiles;
};

// ----------------------------------------------------------------- helpers

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The cluster's sum of one reducer's float4 of product `prod` in the
// receive buffer: the ranks' partials added in order, 0 to 3.
__device__ __forceinline__ float4 sum_ranks(uint32_t recv, int prod) {
  const int slot = (((threadIdx.x >> 5) & 3) * 32 + (threadIdx.x & 31)) * 16;
  float4 s = ld_shared_f32x4(recv + prod * kRanks * kWarpPart + slot);
#pragma unroll
  for (int q = 1; q < kRanks; ++q)
    s = add4(s, ld_shared_f32x4(recv + (prod * kRanks + q) * kWarpPart +
                                slot));
  return s;
}

// ----------------------------------------------------------------- wgmma

// S (or dP) of a block's 64 columns as two chains of 32 (acc_a: columns
// 0-31, acc_b: 32-63), each 12 products from zero, the small terms first:
// A's 64 rows in the resident planes, B's 32 streamed rows in the natural
// planes.  The operands step through their planes by adding 16-byte units
// to one descriptor in one asm statement (flash_fp32_d64_bwd_sm90.cu's
// way): k-step kk of a resident plane is (kk / 4) * 512 + (kk % 4) * 2
// units past its first, of a streamed plane (kk / 4) * 256 + (kk % 4) * 2;
// the two chains' products alternate.
#define D256_ACC_A \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define D256_ACC_B                                                        \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define D256_SS(ACC, A, B, OA, OB)                                       \
  " add.s64 da, " A ", " #OA ";\n add.s64 db, " B ", " #OB ";\n"         \
  " " TF32_WGMMA_N32 "{" ACC "}, da, db, p, 1, 1;\n"
// k-steps 1-3 of one term in both chains, and all four
#define D256_TERM3(A, B)                                                 \
  D256_SS(D256_ACC_A, A, B, 2, 2) D256_SS(D256_ACC_B, A, B, 514, 258)    \
  D256_SS(D256_ACC_A, A, B, 4, 4) D256_SS(D256_ACC_B, A, B, 516, 260)    \
  D256_SS(D256_ACC_A, A, B, 6, 6) D256_SS(D256_ACC_B, A, B, 518, 262)
#define D256_TERM4(A, B)                                                 \
  D256_SS(D256_ACC_A, A, B, 0, 0) D256_SS(D256_ACC_B, A, B, 512, 256)    \
  D256_TERM3(A, B)

__device__ __forceinline__ void issue_scores(float (&acc_a)[kS],
                                             float (&acc_b)[kS], uint32_t a_hi,
                                             uint32_t a_lo, uint32_t b_hi,
                                             uint32_t b_lo) {
  static_assert(kResBox == 512 * 16 && kStreamBox == 256 * 16,
                "the k-step offsets of D256_SS");
  asm volatile(
      "{\n .reg .b64 da, db;\n .reg .pred p;\n setp.ne.b32 p, %36, 0;\n"
      D256_SS(D256_ACC_A, "%32", "%35", 0, 0)
      D256_SS(D256_ACC_B, "%32", "%35", 512, 256)
      " setp.eq.b32 p, %36, 0;\n"
      D256_TERM3("%32", "%35") D256_TERM4("%33", "%34")
      D256_TERM4("%33", "%35")
      "}\n"
      : SM90_F16(acc_a), SM90_F16(acc_b)
      : "l"(desc_sw128(a_lo, 1)), "l"(desc_sw128(a_hi, 1)),
        "l"(desc_sw128(b_lo, 1)), "l"(desc_sw128(b_hi, 1)), "r"(0));
}

// A warp's 16 rows of the block's partial (chain a + chain b, in fp32) into
// the receive buffer of the block that reduces them (`at`: this rank's
// slot of the product there, `bar`: that block's receive mbarrier).
__device__ __forceinline__ void send_part(uint32_t at, uint32_t bar,
                                          const float (&a)[kS],
                                          const float (&b)[kS]) {
#pragma unroll
  for (int n = 0; n < kS / 4; ++n)
    st_async_f4(at + n * 32 * 16,
                make_float4(__fadd_rn(a[4 * n], b[4 * n]),
                            __fadd_rn(a[4 * n + 1], b[4 * n + 1]),
                            __fadd_rn(a[4 * n + 2], b[4 * n + 2]),
                            __fadd_rn(a[4 * n + 3], b[4 * n + 3])),
                bar);
}

// This warp's 16 rows of a gathered operand (the accumulator layout) as
// the output product's split A fragments.
__device__ __forceinline__ void gathered_frags(uint32_t gath,
                                               uint32_t (&hi)[kSteps][4],
                                               uint32_t (&lo)[kSteps][4]) {
  const uint32_t at =
      gath + (((threadIdx.x >> 5) & 3) * 4 * 32 + (threadIdx.x & 31)) * 16;
  float x[kS];
#pragma unroll
  for (int n = 0; n < kS / 4; ++n) {
    const float4 v = ld_shared_f32x4(at + n * 32 * 16);
    x[4 * n] = v.x;
    x[4 * n + 1] = v.y;
    x[4 * n + 2] = v.z;
    x[4 * n + 3] = v.w;
  }
  split_frags(x, hi, lo);
}

// The exchange's addresses of one consumer thread: its partials' slot
// (product 0; product 1 kWarpPart * kRanks further) in the receive buffer
// of block w (its warp), that block's receive mbarrier, and as a reducer
// its float4 in every block's gather buffer with their gather mbarriers.
struct Exchange {
  uint32_t part_at, part_bar;
  uint32_t gath_at[kRanks], gath_bar[kRanks];
};

template <class Bars>
__device__ __forceinline__ Exchange exchange(const Block& t, uint32_t recv,
                                             uint32_t gath, const Bars& bars) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  Exchange x;
  x.part_at =
      map_rank(recv + (t.rank * 4 * 32 + lane) * 16, warp);
  x.part_bar = map_rank(bars.recv(), warp);
  const uint32_t slot = gath + ((t.rank * 4 + warp) * 32 + lane) * 16;
#pragma unroll
  for (int q = 0; q < kRanks; ++q) {
    x.gath_at[q] = map_rank(slot, q);
    x.gath_bar[q] = map_rank(bars.gath(), q);
  }
  return x;
}

// v into every block's gather buffers, `off` bytes past the slot,
// completing on the gather mbarrier `bar_off` bytes past the first
__device__ __forceinline__ void scatter(const Exchange& x, uint32_t off,
                                        float4 v, uint32_t bar_off = 0) {
#pragma unroll
  for (int q = 0; q < kRanks; ++q)
    st_async_f4(x.gath_at[q] + off, v, x.gath_bar[q] + bar_off);
}

}  // namespace fp32_d256
