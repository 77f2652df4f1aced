// Flash-attention backward at head_dim 64 on fp32 inputs for Hopper
// (sm_90a): the dq kernel (which also writes delta) and the dk/dv kernel,
// fp32 in and out, fp32 LSE and delta.  The UNet's self-attention backward
// in an fp32 stage-2 step (train.run_unet --mixed_precision no) runs them:
// 5 pairs at (B*H, S, T) = (20, 4096, 4096) and 5 at (40, 1024, 1024) a
// step at batch 4.
//
// Replaces the Pallas TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel`
// (both pl.pallas_call in `_flash_bwd_3d`) of
// diffute_tpu/ops/flash_attention.py on fp32 inputs at that width, in the
// natural domain (JAX's `log2_domain=False` for fp32):
//
//   p = exp(s * scale - lse), ds = p (dO v^T - delta), dq = ds k * scale,
//   dv = p^T dO, dk = ds^T q * scale, delta = rowsum(dO * O)
//
// As every fp32 flash kernel (flash_fp32.cu's head), accurate to fp32, not
// TF32, by the same precision contract:
//   * every product is 3xTF32: each operand x split into hi = tf32(x) to
//     nearest and lo = tf32(x - hi), a b = lo_a hi_b + hi_a lo_b + hi_a
//     hi_b (the small terms first), accumulated in fp32;
//   * the tensor cores' fp32 accumulation rounds toward zero, so each
//     tensor-core sum is as short as the first cut's: S and dP one chain
//     over the 64 columns of head_dim (8 k-steps x 3); each part of ds k,
//     p^T dO and ds^T q one 32-row streamed tile (4 k-steps x 3 = 12
//     products) from zero, then added to dq, dv or dk by an fp32 add;
//   * p and ds stay fp32; delta is summed in the first cut's order (a lane
//     two columns by fmaf, then a butterfly over the warp), so it keeps
//     those bits.
//
//   q, o, dO (B, S, H, 64), k, v (B, T, H, 64) fp32, any strides TMA takes
//     (multiples of 16 bytes, the last one 1)
//   lse (B*H, S) fp32 natural log, as the forwards write it
//   delta (B*H, S) fp32: written by the dq kernel, read by the dk/dv kernel
//   dq (B, S, H, 64), dk, dv (B, T, H, 64) fp32 through their strides
//
// What bounds them on the H100: operations.  fp32 accuracy takes three
// TF32 products for one, so the tensor cores' 494.7 TF32 TFLOP/s give
// 164.9 at best; the kernels recompute S and dP, seven products where the
// function needs five.  tf32 wgmma takes both operands K-major only, and
// reads an operand in shared memory as its TF32 truncation
// (tf32_wgmma_sm90.cuh), so each operand needs hi and lo planes, and the
// second product of each kernel a transposed pair.  What the design does:
//   - a producer warpgroup (128 threads) keeps the copies and the splits
//     off the consumers: its thread 0 loads every tile by TMA through the
//     strides (boxes of 32 fp32 columns, 128-byte swizzle, rows past S or T
//     read as zeros), and the warpgroup splits each tile once, for every
//     consumer of the block: the natural hi plane in place of the raw tile,
//     the lo plane beside it, and for the streamed operand of the second
//     product the transposed pair (split_stream);
//   - the second product's A is the score itself, split in registers: the
//     accumulator holds columns 2t and 2t + 1 of each 8 where the register
//     fragment wants t and t + 4, so the contraction runs in the order k' =
//     2t, 2t + 1 (flash_fp32.cu's), and the transposed planes are written
//     in that order: no shuffle;
//   - the streamed axis moves in 32-row tiles through a ring of two stages,
//     each waited on by its ready barrier (the producer's 128 arrivals
//     after the split) and released by the consumers' warps (empty);
//   - each consumer issues its next tile's first score product before it
//     retires the current output product, which runs on into the next tile.
// A 384-thread block leaves ptxas 168 registers a thread, whatever
// setmaxnreg asks (flash_d256_sm90.cu says why), and the producer splits,
// so it keeps its registers: the consumers are laid out to fit in 168
// (32-row tiles keep a score tile at 16 registers).  What holds them on an
// H100 (PERF.md, counted from this layout): shared-memory bandwidth, which
// the score products with both operands there (N = 32: about 66% of the
// TF32 rate, tools/tf32_wgmma_probe.py) and the producer's planes share.
//
// dq kernel (dq_kernel): two consumer warpgroups of 64 q rows a block (128
// q rows: each K and V tile is loaded and split once for both); Q and dO
// resident as hi and lo planes (128 KB), K, V and K^T streamed (48 KB a
// stage).  Per kv tile: S = Q K^T issued (A and B both in shared memory,
// N = 32), the previous tile's dQ part retired (added, its stage
// released), dP = dO V^T issued, p = exp(s * scale - lse) while dP runs, ds
// = p (dP - delta), split into A fragments, and dQ's part = dS K (B = K^T's
// planes, N = 64) issued.  delta: each warp its 16 rows from O
// and dO in L2 before the first tile.  Registers: S 16, dP 16, the part
// 32, dq 32, dS's hi and lo 32.
//
// dk/dv kernel (dkv_kernel): two consumer warpgroups share a block's 64 kv
// rows by role (flash_d256_bwd_sm90.cu's split): A computes S^T = K Q^T,
// p^T = exp(S^T * scale - lse) in fp32 and dV += p^T dO; B computes dP^T
// = V dO^T, reads A's fp32 p^T from shared memory, forms dS^T = p^T (dP^T
// - delta) and dK += dS^T Q.  p^T goes through two buffers by tile parity
// under named barriers (A arrives at FULL, B syncs; B arrives at EMPTY, A
// syncs two tiles later).  K and V resident as planes (64 KB); Q, dO, Q^T
// and dO^T streamed (64 KB a stage), with the tile's 32 lse and 32 delta
// values, which the producer copies beside them (zeros past S).
//
// Shared memory: dq 225 KB, dk/dv 210 KB: one block an SM.
//
// Ragged edges.  TMA reads rows past S or T as zeros.  dq: the last kv tile
// sets its scores at or past T to -inf, so p = 0; q rows past S have lse =
// delta = 0 and dO = 0, so ds = 0.  dk/dv: q rows past S have dO = 0 and
// lse = delta = 0, so p = exp(0) = 1 and ds = 1 * (0 - 0) = 0: they add
// nothing.  Rows past the end of an output are not stored.

#include "fp32_tma_sm90.cuh"
#include "tf32_wgmma_sm90.cuh"

namespace {

using namespace sm90;
using fp32_tma::BwdParams;

constexpr int kD = 64;
constexpr int kBox = 32;                 // fp32 columns of a TMA box
constexpr int kRows = 64;                // rows of a consumer's resident tile
// the streamed tile: the kv tile the dq kernel walks and the q tile the
// dk/dv kernel walks (ops/flash_attention.py: FP32_D64_BWD_BLOCK_KV)
constexpr int kBlockKV = 32;
constexpr int kRing = 2;                 // stages of the streamed axis
constexpr int kThreads = 384;            // producer, two consumers
constexpr int kDqWgs = 2;                // dq's consumer warpgroups
constexpr int kS = kBlockKV / 2;         // score registers a thread
constexpr int kSteps = kBlockKV / 8;     // k-steps of an output product
constexpr int kStreamBox = kBlockKV * kBox * 4;   // 4 KB
constexpr int kPlane = 2 * kStreamBox;             // 8 KB: 32 rows x 64
// a consumer's resident tile: 64 rows x 64, a plane of two 8 KB boxes
constexpr int kResBox = kRows * kBox * 4;
constexpr int kRes = 2 * kResBox;                  // 16 KB
static_assert(kD == 2 * kBox && kPlane == kD * kBlockKV * 4,
              "a transposed plane (64 rows of 32) is a streamed plane's size");
static_assert(kStreamBox == kStreamTileBox && kPlane == kStreamTilePlane,
              "the streamed tile of tf32_wgmma_sm90.cuh's splits");
// the producer's named barrier (128 threads) and dk/dv's p^T exchange
// (256 threads: ids kPFull, kPFull + 1, kPEmpty, kPEmpty + 1)
constexpr int kSplitBar = 5;
constexpr int kPFull = 1, kPEmpty = 3;

// mbarriers: the resident tiles' load and split, then per stage the load
// (full), the split (ready) and the consumers' release (empty)
struct Bars {
  uint32_t base;
  __device__ uint32_t res_full() const { return base; }
  __device__ uint32_t res_ready() const { return base + 8; }
  __device__ uint32_t full(int s) const { return base + 8 * (2 + s); }
  __device__ uint32_t ready(int s) const {
    return base + 8 * (2 + kRing + s);
  }
  __device__ uint32_t empty(int s) const {
    return base + 8 * (2 + 2 * kRing + s);
  }
  __device__ void init() const {
    mbar_init(res_full(), 1);
    mbar_init(res_ready(), 128);
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full(s), 1);
      mbar_init(ready(s), 128);
      mbar_init(empty(s), 8);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};
constexpr int kBarBytes = 8 * (2 + 3 * kRing);

// ----------------------------------------------------------------- splits

// The raw 32-row streamed tiles x[a] into their planes: hi in place, lo
// kPlane further; and for the first kTrans of them the transposed pair at
// xt[a] (hi) and xt[a] + kPlane (lo), in the order the output products'
// register A takes (tf32_wgmma_sm90.cuh).  Every read comes first, then a
// barrier of the warpgroup, then every write.
template <int kTensors, int kTrans>
__device__ __forceinline__ void split_stream(const uint32_t (&x)[kTensors],
                                             const uint32_t (&xt)[kTrans],
                                             int tid) {
  StreamRaw<kTensors, kTrans> raw;
  read_stream<kTensors, kTrans>(x, raw, tid);
  warpgroup_sync(kSplitBar);
  write_natural<kTensors, kTrans>(x, raw, tid);
  write_transposed<kTensors, kTrans>(xt, raw, tid);
}

// ----------------------------------------------------------------- wgmma

// The products' operands step through their planes by adding 16-byte
// units to one descriptor, inside one asm statement, so that a few
// descriptors are live and not 24 (ptxas hoisted the loop-invariant ones
// and spilled): k-step kk of a 64-row resident plane is (kk / 4) * 512 +
// (kk % 4) * 2 units past its first (8 KB boxes), of a streamed plane (kk /
// 4) * 256 + (kk % 4) * 2 (4 KB boxes), of a transposed plane kk * 2.
#define D64_ACC16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
// one score product: A at descriptor A + OA, B at B + OB
#define D64_SS(A, B, OA, OB)                                             \
  " add.s64 da, " A ", " #OA ";\n add.s64 db, " B ", " #OB ";\n"         \
  " " TF32_WGMMA_N32 "{" D64_ACC16                                       \
  "}, da, db, p, 1, 1;\n"
// the last seven k-steps of one term, and all eight
#define D64_SS7(A, B)                                                    \
  D64_SS(A, B, 2, 2) D64_SS(A, B, 4, 4) D64_SS(A, B, 6, 6)               \
  D64_SS(A, B, 512, 256) D64_SS(A, B, 514, 258) D64_SS(A, B, 516, 260)   \
  D64_SS(A, B, 518, 262)
#define D64_SS8(A, B) D64_SS(A, B, 0, 0) D64_SS7(A, B)
// acc (64 x 32) = A B^T over head_dim in 3xTF32, one chain of 24 from
// zero, the small terms first: A's 64 rows in the resident planes a_hi /
// a_lo, B's 32 streamed rows in the natural planes b_hi / b_lo.
__device__ __forceinline__ void issue_scores(float (&acc)[kS], uint32_t a_hi,
                                             uint32_t a_lo, uint32_t b_hi,
                                             uint32_t b_lo) {
  static_assert(kResBox == 512 * 16 && kStreamBox == 256 * 16,
                "the k-step offsets of D64_SS");
  asm volatile(
      "{\n .reg .b64 da, db;\n .reg .pred p;\n setp.ne.b32 p, %20, 0;\n"
      " " TF32_WGMMA_N32 "{" D64_ACC16
      "}, %16, %19, p, 1, 1;\n"
      " setp.eq.b32 p, %20, 0;\n"
      D64_SS7("%16", "%19") D64_SS8("%17", "%18") D64_SS8("%17", "%19")
      "}\n"
      : SM90_F16(acc)
      : "l"(desc_sw128(a_lo, 1)), "l"(desc_sw128(a_hi, 1)),
        "l"(desc_sw128(b_lo, 1)), "l"(desc_sw128(b_hi, 1)), "r"(0));
}

// ------------------------------------------------------------------- dq

// Shared memory of the dq kernel: consumer c's Q and dO planes (hi, lo
// each) from c * kWg, then the stages (K, V natural, K^T; hi and lo each),
// the mbarriers.
struct DqSmem {
  static constexpr int kWg = 4 * kRes;  // a consumer's resident planes
  static constexpr int q = 0;           // hi; lo kRes further
  static constexpr int dout = 2 * kRes;
  static constexpr int ring = kDqWgs * kWg;
  // a stage: K (hi, lo), V (hi, lo), K^T (hi, lo)
  static constexpr int k = 0, v = 2 * kPlane, kt = 4 * kPlane;
  static constexpr int kStage = 6 * kPlane;  // 48 KB
  static constexpr int bars = ring + kRing * kStage;
  static constexpr int bytes = bars + kBarBytes + 1024;  // + alignment
  static_assert(bytes <= 232448, "227 KB a block");
};

// K and V of kv tile i into its stage, completing on full.
__device__ __forceinline__ void load_kv(const BwdParams& p, uint32_t smem,
                                        const Bars& bars, int i, int h,
                                        int b) {
  const int st = i % kRing;
  const uint32_t stage = smem + DqSmem::ring + st * DqSmem::kStage;
  mbar_expect_tx(bars.full(st), 2 * kPlane);
  load_plane(&p.tm_k, stage + DqSmem::k, kStreamBox, bars.full(st), 0,
             i * kBlockKV, h, b);
  load_plane(&p.tm_v, stage + DqSmem::v, kStreamBox, bars.full(st), 0,
             i * kBlockKV, h, b);
}

// The producer warpgroup of the dq kernel: Q and dO once, then every kv
// tile into its stage once the consumers released it (thread 0), each
// split for both consumers.
__device__ __forceinline__ void dq_produce(const BwdParams& p, uint32_t smem,
                                           const Bars& bars, int q0, int h,
                                           int b, int n_tiles) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    prefetch_map(&p.tm_q);
    prefetch_map(&p.tm_do);
    prefetch_map(&p.tm_k);
    prefetch_map(&p.tm_v);
    mbar_expect_tx(bars.res_full(), kDqWgs * 2 * kRes);
    for (int c = 0; c < kDqWgs; ++c) {
      const uint32_t res = smem + c * DqSmem::kWg;
      load_plane(&p.tm_q, res + DqSmem::q, kResBox, bars.res_full(), 0,
                 q0 + c * kRows, h, b);
      load_plane(&p.tm_do, res + DqSmem::dout, kResBox, bars.res_full(), 0,
                 q0 + c * kRows, h, b);
    }
    for (int i = 0; i < kRing && i < n_tiles; ++i)
      load_kv(p, smem, bars, i, h, b);
  }
  mbar_wait(bars.res_full(), 0);
  for (int c = 0; c < kDqWgs; ++c) {
    split_plane(smem + c * DqSmem::kWg + DqSmem::q, kRes, tid);
    split_plane(smem + c * DqSmem::kWg + DqSmem::dout, kRes, tid);
  }
  fence_proxy_async();
  mbar_arrive(bars.res_ready());
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kRing;
    if (tid == 0 && i >= kRing) {
      mbar_wait(bars.empty(st), ((i / kRing) & 1) ^ 1);
      load_kv(p, smem, bars, i, h, b);
    }
    mbar_wait(bars.full(st), (i / kRing) & 1);
    const uint32_t stage = smem + DqSmem::ring + st * DqSmem::kStage;
    split_stream<2, 1>({stage + DqSmem::k, stage + DqSmem::v},
                       {stage + DqSmem::kt}, tid);
    fence_proxy_async();
    mbar_arrive(bars.ready(st));
  }
}

// What a dq consumer reads: its rows' planes of Q and dO, the ring.
struct DqTiles {
  uint32_t q_hi, q_lo, do_hi, do_lo, ring;
};

// Per thread: S and dP (16 registers each), the dQ part and dq (32 each),
// dS's A fragments (hi and lo, 16 each), its two rows' lse and delta.
struct DqState {
  float s[kS], dp[kS], part[32], dq[32];
  uint32_t hi[kSteps][4], lo[kSteps][4];
  float lse_lo, lse_hi, delta_lo, delta_hi;
};

// Kv tile j: S_j issued, the previous tile's part retired (added to dq,
// its stage released), dP_j issued, p on S_j while dP_j runs, ds = p (dP_j
// - delta) split, dQ's part dS K_j issued to run on into the next tile.
// (dP_j issued with S_j, ahead of the retirement, kept 16 more registers
// live across it: ptxas spilled 72 bytes at the 168 a thread.)  The first
// tile and the last are separate instances (the last masks its columns
// past T), so no branch sits in the body while a product is in flight.
template <bool kFirst, bool kLast>
__device__ __forceinline__ void dq_step(const BwdParams& p, const DqTiles& t,
                                        const Bars& bars, int j,
                                        DqState& x) {
  const int st = j % kRing;
  const uint32_t stage = t.ring + st * DqSmem::kStage;
  mbar_wait(bars.ready(st), (j / kRing) & 1);
  issue_begin(x.s);
  issue_scores(x.s, t.q_hi, t.q_lo, stage + DqSmem::k,
               stage + DqSmem::k + kPlane);
  issue_end(x.s);
  if (!kFirst) {
    wgmma_wait<1>();
    fence_regs(x.part);
    fence_regs(x.hi);
    fence_regs(x.lo);
    add_part(x.dq, x.part);
    release_warp(bars.empty((j - 1) % kRing));
  }
  issue_begin(x.dp);
  issue_scores(x.dp, t.do_hi, t.do_lo, stage + DqSmem::v,
               stage + DqSmem::v + kPlane);
  issue_end(x.dp);
  wgmma_wait<1>();
  fence_regs(x.s);
#pragma unroll
  for (int i = 0; i < kS; ++i) x.s[i] *= p.scale;
  if (kLast) mask_tail(x.s, j * kBlockKV, p.t_len);
#pragma unroll
  for (int i = 0; i < kS; ++i)
    x.s[i] = expf(x.s[i] - ((i & 2) ? x.lse_hi : x.lse_lo));
  wgmma_wait<0>();
  fence_regs(x.dp);
#pragma unroll
  for (int i = 0; i < kS; ++i)
    x.s[i] *= x.dp[i] - ((i & 2) ? x.delta_hi : x.delta_lo);
  split_frags(x.s, x.hi, x.lo);
  issue_begin(x.part, x.hi, x.lo);
  issue_out(x.part, x.hi, x.lo, stage + DqSmem::kt,
            stage + DqSmem::kt + kPlane);
  issue_end(x.part, x.hi, x.lo);
}

// delta = rowsum(dO * O) in fp32 of this warp's 16 rows from `row0`, as
// the first cut sums it: lane l takes columns l and l + 32 by fmaf, then a
// butterfly over the warp (every lane the same sum); written out for the
// dk/dv kernel, and returned for this thread's rows lo and hi.  Rows past
// S: 0.
__device__ __forceinline__ float2 row_deltas(const BwdParams& p, int b, int h,
                                             int row0) {
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const float* ob = p.o + b * p.o_sb + h * p.o_sh + lane;
  const float* db = p.dout + b * p.do_sb + h * p.do_sh + lane;
  float* out = p.delta + (size_t)(b * p.heads + h) * p.s_len;
  float lo = 0.f, hi = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int row = row0 + i;
    float acc = 0.f;
    if (row < p.s_len) {
#pragma unroll
      for (int c = 0; c < kD / 32; ++c)
        acc = fmaf(ob[row * p.o_ss + c * 32], db[row * p.do_ss + c * 32],
                   acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (i == g) lo = acc;
    if (i == g + 8) hi = acc;
    if (lane == 0 && row < p.s_len) out[row] = acc;
  }
  return make_float2(lo, hi);
}

// grid (ceil(S / 128), B*H): warpgroup 0 produces, 1 and 2 consume 64 q
// rows each.
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * kDqWgs * kRows;
  const int n_tiles = (p.t_len + kBlockKV - 1) / kBlockKV;
  const Bars bars{smem + DqSmem::bars};
  // the warpgroup index, warp-uniform as the role split needs it
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (threadIdx.x == 0) bars.init();
  __syncthreads();
  if (wg == 0) {
    dq_produce(p, smem, bars, q0, h, b, n_tiles);
    return;
  }
  const int c = wg - 1, warp = (threadIdx.x >> 5) & 3;
  const int row0 = q0 + c * kRows;
  const int r_lo = row0 + warp * 16 + ((threadIdx.x & 31) >> 2);
  const int r_hi = r_lo + 8;
  const uint32_t res = smem + c * DqSmem::kWg;
  const DqTiles t{res + DqSmem::q, res + DqSmem::q + kRes,
                  res + DqSmem::dout, res + DqSmem::dout + kRes,
                  smem + DqSmem::ring};
  DqState x;
  // rows past S: lse = 0 (their dq is never stored)
  const float* lb = p.lse + (size_t)blockIdx.y * p.s_len;
  x.lse_lo = r_lo < p.s_len ? lb[r_lo] : 0.f;
  x.lse_hi = r_hi < p.s_len ? lb[r_hi] : 0.f;
  const float2 d = row_deltas(p, b, h, row0 + warp * 16);
  x.delta_lo = d.x;
  x.delta_hi = d.y;
  zero(x.dq);

  mbar_wait(bars.res_ready(), 0);
  if (n_tiles == 1) {
    dq_step<true, true>(p, t, bars, 0, x);
  } else {
    dq_step<true, false>(p, t, bars, 0, x);
    for (int j = 1; j < n_tiles - 1; ++j)
      dq_step<false, false>(p, t, bars, j, x);
    dq_step<false, true>(p, t, bars, n_tiles - 1, x);
  }
  wgmma_wait<0>();
  fence_regs(x.part);
  fence_regs(x.hi);
  fence_regs(x.lo);
  add_part(x.dq, x.part);
  store_rows(p.out0, p.o0_sb, p.o0_ss, p.o0_sh, b, h, 0, x.dq, p.scale,
             row0, p.s_len);
}

// ---------------------------------------------------------------- dk/dv

// Shared memory of the dk/dv kernel: K's and V's hi and lo planes for the
// block's 64 kv rows, the stages (Q, dO natural, Q^T, dO^T; hi and lo
// each), each stage's 32 lse and 32 delta values, p^T's two buffers, the
// mbarriers.
struct DkvSmem {
  static constexpr int k = 0;         // hi; lo kRes further
  static constexpr int v = 2 * kRes;
  static constexpr int ring = 4 * kRes;
  // a stage: Q, dO, Q^T, dO^T (hi, lo each)
  static constexpr int q = 0, dout = 2 * kPlane, qt = 4 * kPlane,
                       dot = 6 * kPlane;
  static constexpr int kStage = 8 * kPlane;          // 64 KB
  static constexpr int kStats = 2 * kBlockKV * 4;    // lse, delta
  static constexpr int stats = ring + kRing * kStage;
  static constexpr int kPBytes = kRows * kBlockKV * 4;  // 8 KB
  static constexpr int pt = stats + kRing * kStats;
  static constexpr int bars = pt + 2 * kPBytes;
  static constexpr int bytes = bars + kBarBytes + 1024;  // + alignment
  static_assert(bytes <= 232448, "227 KB a block");
};

// Q and dO of q tile i into its stage, completing on full.
__device__ __forceinline__ void load_q(const BwdParams& p, uint32_t smem,
                                       const Bars& bars, int i, int h,
                                       int b) {
  const int st = i % kRing;
  const uint32_t stage = smem + DkvSmem::ring + st * DkvSmem::kStage;
  mbar_expect_tx(bars.full(st), 2 * kPlane);
  load_plane(&p.tm_q, stage + DkvSmem::q, kStreamBox, bars.full(st), 0,
             i * kBlockKV, h, b);
  load_plane(&p.tm_do, stage + DkvSmem::dout, kStreamBox, bars.full(st), 0,
             i * kBlockKV, h, b);
}

// The producer warpgroup of the dk/dv kernel: K and V once, then every q
// tile into its stage once the consumers released it (thread 0), each
// split once, with its lse and delta (threads 0-63, zeros past S).
__device__ __forceinline__ void dkv_produce(const BwdParams& p, uint32_t smem,
                                            const Bars& bars, int kv0, int h,
                                            int b, int n_tiles) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    prefetch_map(&p.tm_q);
    prefetch_map(&p.tm_do);
    prefetch_map(&p.tm_k);
    prefetch_map(&p.tm_v);
    mbar_expect_tx(bars.res_full(), 2 * kRes);
    load_plane(&p.tm_k, smem + DkvSmem::k, kResBox, bars.res_full(), 0, kv0,
               h, b);
    load_plane(&p.tm_v, smem + DkvSmem::v, kResBox, bars.res_full(), 0, kv0,
               h, b);
    for (int i = 0; i < kRing && i < n_tiles; ++i)
      load_q(p, smem, bars, i, h, b);
  }
  mbar_wait(bars.res_full(), 0);
  split_plane(smem + DkvSmem::k, kRes, tid);
  split_plane(smem + DkvSmem::v, kRes, tid);
  fence_proxy_async();
  mbar_arrive(bars.res_ready());
  const size_t bh = (size_t)(b * p.heads + h) * p.s_len;
  const float* stat = (tid < kBlockKV ? p.lse : p.delta) + bh;
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kRing;
    if (tid == 0 && i >= kRing) {
      mbar_wait(bars.empty(st), ((i / kRing) & 1) ^ 1);
      load_q(p, smem, bars, i, h, b);
    }
    const int r = i * kBlockKV + (tid & (kBlockKV - 1));
    const float sv = tid < 2 * kBlockKV && r < p.s_len ? stat[r] : 0.f;
    mbar_wait(bars.full(st), (i / kRing) & 1);
    const uint32_t stage = smem + DkvSmem::ring + st * DkvSmem::kStage;
    if (tid < 2 * kBlockKV)
      st_shared_f32(smem + DkvSmem::stats + st * DkvSmem::kStats + tid * 4,
                    sv);
    split_stream<2, 2>({stage + DkvSmem::q, stage + DkvSmem::dout},
                       {stage + DkvSmem::qt, stage + DkvSmem::dot}, tid);
    fence_proxy_async();
    mbar_arrive(bars.ready(st));
  }
}

// Per thread: the first product of its role (S^T for A, dP^T for B; 16
// registers), its part and its accumulator (dV for A, dK for B; 32 each),
// the second product's A fragments (p^T or dS^T; hi and lo, 16 each).
struct DkvState {
  float s[kS], part[32], acc[32];
  uint32_t hi[kSteps][4], lo[kSteps][4];
};

// Q tile i.  A: S^T_i = K Q_i^T, p^T in fp32 handed to B through buffer i
// & 1, dV's part p^T dO_i.  B: dP^T_i = V dO_i^T, dS^T = p^T (dP^T -
// delta), dK's part dS^T Q_i.  Each issues its first product while its
// previous tile's part still runs, retires that (adds it, releases its
// stage), and issues this tile's part to run on into the next.  Only the
// first tile is a separate instance: no tile is masked (rows past S add
// zeros), and the branch between the roles runs with no product in
// flight.
template <bool kFirst>
__device__ __forceinline__ void dkv_step(const BwdParams& p, uint32_t smem,
                                         const Bars& bars, bool role_a,
                                         int i, int n_tiles, DkvState& x) {
  const int st = i % kRing;
  const uint32_t stage = smem + DkvSmem::ring + st * DkvSmem::kStage;
  // the role's resident A and streamed B of the scores, and the output
  // product's transposed B
  const uint32_t a_hi = smem + (role_a ? DkvSmem::k : DkvSmem::v);
  const uint32_t b_hi = stage + (role_a ? DkvSmem::q : DkvSmem::dout);
  const uint32_t bt_hi = stage + (role_a ? DkvSmem::dot : DkvSmem::qt);
  mbar_wait(bars.ready(st), (i / kRing) & 1);
  issue_begin(x.s);
  issue_scores(x.s, a_hi, a_hi + kRes, b_hi, b_hi + kPlane);
  issue_end(x.s);
  if (!kFirst) {
    wgmma_wait<1>();
    fence_regs(x.part);
    fence_regs(x.hi);
    fence_regs(x.lo);
    add_part(x.acc, x.part);
    release_warp(bars.empty((i - 1) % kRing));
  }
  wgmma_wait<0>();
  fence_regs(x.s);
  // columns 8 n + 2 t + {0, 1} are q rows of the tile: lse and delta by
  // column
  const int c = threadIdx.x & 3;
  const uint32_t sv = smem + DkvSmem::stats + st * DkvSmem::kStats;
  const uint32_t buf = smem + DkvSmem::pt + (i & 1) * DkvSmem::kPBytes +
                       (threadIdx.x & 127) * 16;
  if (role_a) {
#pragma unroll
    for (int n = 0; n < kS / 4; ++n) {
      const float2 l = ld_shared_f32x2(sv + 4 * (8 * n + 2 * c));
      x.s[4 * n] = expf(x.s[4 * n] * p.scale - l.x);
      x.s[4 * n + 1] = expf(x.s[4 * n + 1] * p.scale - l.y);
      x.s[4 * n + 2] = expf(x.s[4 * n + 2] * p.scale - l.x);
      x.s[4 * n + 3] = expf(x.s[4 * n + 3] * p.scale - l.y);
    }
    if (i >= 2) named_sync(kPEmpty + (i & 1));  // B has read tile i - 2's
#pragma unroll
    for (int n = 0; n < kS / 4; ++n)
      st_shared_f32x4(buf + n * 128 * 16, x.s[4 * n], x.s[4 * n + 1],
                      x.s[4 * n + 2], x.s[4 * n + 3]);
    named_arrive(kPFull + (i & 1));
  } else {
    named_sync(kPFull + (i & 1));
#pragma unroll
    for (int n = 0; n < kS / 4; ++n) {
      const float4 pv = ld_shared_f32x4(buf + n * 128 * 16);
      const float2 d =
          ld_shared_f32x2(sv + 4 * (kBlockKV + 8 * n + 2 * c));
      x.s[4 * n] = pv.x * (x.s[4 * n] - d.x);
      x.s[4 * n + 1] = pv.y * (x.s[4 * n + 1] - d.y);
      x.s[4 * n + 2] = pv.z * (x.s[4 * n + 2] - d.x);
      x.s[4 * n + 3] = pv.w * (x.s[4 * n + 3] - d.y);
    }
    if (i + 2 < n_tiles) named_arrive(kPEmpty + (i & 1));
  }
  split_frags(x.s, x.hi, x.lo);
  issue_begin(x.part, x.hi, x.lo);
  issue_out(x.part, x.hi, x.lo, bt_hi, bt_hi + kPlane);
  issue_end(x.part, x.hi, x.lo);
}

// grid (ceil(T / 64), B*H): warpgroup 0 produces, 1 (A) and 2 (B)
// consume by role.
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int kv0 = blockIdx.x * kRows;
  const int n_tiles = (p.s_len + kBlockKV - 1) / kBlockKV;
  const Bars bars{smem + DkvSmem::bars};
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (threadIdx.x == 0) bars.init();
  __syncthreads();
  if (wg == 0) {
    dkv_produce(p, smem, bars, kv0, h, b, n_tiles);
    return;
  }
  const bool role_a = wg == 1;
  DkvState x;
  zero(x.acc);
  mbar_wait(bars.res_ready(), 0);
  dkv_step<true>(p, smem, bars, role_a, 0, n_tiles, x);
  for (int i = 1; i < n_tiles; ++i)
    dkv_step<false>(p, smem, bars, role_a, i, n_tiles, x);
  wgmma_wait<0>();
  fence_regs(x.part);
  fence_regs(x.hi);
  fence_regs(x.lo);
  add_part(x.acc, x.part);
  if (role_a)
    store_rows(p.out1, p.o1_sb, p.o1_ss, p.o1_sh, b, h, 0, x.acc, 1.f, kv0,
               p.t_len);
  else
    store_rows(p.out0, p.o0_sb, p.o0_ss, p.o0_sh, b, h, 0, x.acc, p.scale,
               kv0, p.t_len);
}

// ------------------------------------------------------------------ host

// Fill the parameter (the resident tensors' boxes kRows rows, a consumer's,
// the streamed ones' kBlockKV) and launch `kernel` over ceil(len / rows) x
// B*H blocks, len S (dq, 128 rows a block) or T (dk/dv, 64).
int launch_bwd(void (*kernel)(BwdParams), int smem_bytes, bool dq,
               const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* delta, void* out0,
               void* out1, int b, int h, int s_len, int t_len,
               const long long* s, float scale, void* stream) {
  BwdParams p{};
  if (const cudaError_t err = fp32_tma::fill_params(
          p, kD, dq, dq ? kRows : kBlockKV, dq ? kBlockKV : kRows, q, k, v,
          o, dout, lse, delta, out0, out1, b, h, s_len, t_len, s, scale))
    return (int)err;
  const int res_rows = dq ? kDqWgs * kRows : kRows;  // a block's
  dim3 grid(((dq ? s_len : t_len) + res_rows - 1) / res_rows, b * h);
  kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes, with flash_fp32.cu's backward entries'
// argument lists (the names that source gave them at head_dim 64).
// Tensors (B, len, H, 64) fp32 with the element strides in `strides` (sb,
// sl, sh each; head_dim stride 1), lse and delta (B*H, S) fp32 contiguous.
// Each launches on `stream`, allocates nothing, and returns a CUDA error
// code (0 = launched).
//
// dq and delta; strides of q, k, v, o, dO, dq.
extern "C" int flash_bwd_dq_fp32(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq,
                                 int b, int h, int s_len, int t_len,
                                 const long long* strides, float scale,
                                 void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DqSmem::bytes);
  if (attr != cudaSuccess) return (int)attr;
  return launch_bwd(dq_kernel, DqSmem::bytes, true, q, k, v, o, dout, lse,
                    delta, dq, nullptr, b, h, s_len, t_len, strides, scale,
                    stream);
}

// dk and dv from the dq kernel's delta; strides of q, k, v, dO, dk, dv.
extern "C" int flash_bwd_dkv_fp32(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int b, int h, int s_len, int t_len,
                                  const long long* strides, float scale,
                                  void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DkvSmem::bytes);
  if (attr != cudaSuccess) return (int)attr;
  return launch_bwd(dkv_kernel, DkvSmem::bytes, false, q, k, v, nullptr, dout,
                    lse, const_cast<void*>(delta), dk, dv, b, h, s_len,
                    t_len, strides, scale, stream);
}
