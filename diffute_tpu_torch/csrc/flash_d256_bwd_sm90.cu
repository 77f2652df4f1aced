// Flash-attention backward at head_dim 256 for Hopper (sm_90a): the dq
// kernel (which also writes delta) and the dk/dv kernel, bf16 in and out,
// fp32 LSE and delta.  The small VAE's mid-block (`small_config`, one head
// of 256) runs them with VAEConfig.use_flash_attention when it trains.
//
// Replaces the Pallas TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel`
// (both pl.pallas_call in `_flash_bwd_3d`) of
// diffute_tpu/ops/flash_attention.py at that width.  As at head_dim 64
// (flash_bwd.cu), the dq kernel owns q rows of one (batch, head) and walks
// the kv tiles with dq in registers; the dk/dv kernel owns kv rows and
// walks the q tiles with dk and dv in registers: no atomics, each output
// element written by one block, the same bits every run.
//
//   q, o, dO (B, S, H, 256), k, v (B, T, H, 256)  bf16, any strides TMA
//     takes (multiples of 16 bytes, the last one 1)
//   lse (B*H, S) fp32 natural log, as the forwards write it
//   delta (B*H, S) fp32 = rowsum(dO * O): written by the dq kernel, read by
//     the dk/dv kernel
//   dq (B, S, H, 256), dk, dv (B, T, H, 256)       bf16 through their strides
//
//   p = exp2(s*scale*log2 e - lse*log2 e) (one FMA and one exp2 a score),
//   ds = p * (dO v^T - delta), dq = bf16(ds) k * scale,
//   dv = bf16(p)^T dO, dk = bf16(ds)^T q * scale
//
// What bounds them on the H100: operations.  A score costs 2*256 FLOPs in
// each of the four products a kernel issues (dq recomputes s and dp; dk/dv
// recomputes s and dp too) against one exp2; the inputs are a few MB, read
// from L2 once per 64-row block.  What the design has to give the tensor
// cores is wgmma on operands that arrive without the consumers' help, and
// every product over all 256 columns in one warpgroup, so that no partial
// score is exchanged (flash_wide.cu's first cut summed four warps'
// 128-column partials through shared memory behind two barriers a tile).
//
// Tiles.  A 256-wide bf16 row is 512 bytes: four TMA boxes of 64 columns,
// each loaded into its own 128-byte-swizzled block ([rows][64], 1024-byte
// aligned), which is the layout wgmma's descriptors read (as the forwards,
// flash_d256_sm90.cu, load them).  The products with both operands in
// shared memory step 32 bytes within a block and one block between blocks,
// as two sums of 128 columns added in fp32 (issue_ss says why); those with
// N = 256 take their A operand from registers (the accumulator
// layout of the product before, rounded to bf16) and read B MN-major, the
// leading offset the step between its four blocks.
//
// There is no producer warp: a 384-thread block, and a 288-thread one, leave
// ptxas 168 registers a thread whatever setmaxnreg asks (flash_d256_sm90.cu
// says why), and dq (or dk, or dv) alone is 128.  Thread 0 (the dk/dv
// kernel: warp 0) issues the first loads; after that the last warp to
// release a ring stage refills it (release_last: a shared count,
// acquire-release), with predicated instructions, so that no branch sits
// among products in flight (ptxas serializes wgmma across such branches).
//
// dq kernel (dq_kernel): one consumer warpgroup a block, 64 q rows by all
// 256 columns; Q and dO resident (32 KB each), K and V in 64-row kv tiles,
// two stages (128 KB).  Per kv tile: S = Q K^T issued behind the previous
// tile's dQ += dS K, that product retired (its stage released), dP = dO V^T
// issued, the exponentials on S while dP runs, then ds in registers and
// dQ += dS K_j (K MN-major, N = 256), which runs on into the next tile.
// delta is the rowsum of O and dO rows read from L2 before the first tile
// (each warp its 16 rows, a lane 8 columns).  Registers: dq 128 a thread, S,
// dP and a second half 32 each, dS 16.  (Two warpgroups a block on 32-row kv
// tiles, the other layout 192 KB allows, ran slower on an H100, most at the
// shapes with few blocks: PERF.md.)
//
// dk/dv kernel (dkv_kernel): two consumer warpgroups share a block's 64 kv
// rows by role, since one cannot hold dk and dv over 256 columns (256 fp32
// registers a thread).  Warpgroup A computes S^T = K Q^T, p^T in fp32 and
// dV += bf16(p^T) dO; warpgroup B computes dP^T = V dO^T, reads A's fp32
// p^T from shared memory, forms dS^T = p^T (dP^T - delta) and dK +=
// bf16(dS^T) Q.  The two run one instruction stream (the roles differ in
// the addresses they give the products and in a branch taken with no
// product in flight), each two of the four products, 128 + 80 registers.
// p^T (64 x 64 fp32, 16 KB) goes through two buffers by tile parity under
// named barriers (A arrives at FULL, B syncs; B arrives at EMPTY, A syncs
// two tiles later), so A can run a tile ahead.  K and V are resident
// (64 KB), Q and dO stream in 64-row q tiles, two stages (128 KB); lse and
// delta index the tile's columns, so the refilling warp copies each
// stage's 64 + 64 values by pointer with cp.async (a TMA map would need S
// * 4 bytes a multiple of 16), zero past S.  225 KB in all.
//
// Ragged edges.  TMA reads rows past S or T as zeros.  dq: the last kv tile
// sets its scores at or past T to -inf, so p = 0.  dk/dv: q rows past S have
// dO = 0 and lse = delta = 0, so p = exp2(0) = 1 and ds = 1 * (0 - 0) = 0:
// they add nothing.  Rows past the end of an output are not stored.

#include "flash_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kD = 256;
constexpr int kAtoms = kD / kHeadDim;          // 64-column boxes a row
constexpr int kRows = 64;                      // rows of a warpgroup's tile
constexpr int kAtom = kRows * kRowBytes;       // 8 KB: one box of 64 rows
constexpr int kTileBytes = kAtoms * kAtom;     // 32 KB: 64 rows x 256
constexpr int kRing = 2;                       // stages of the streamed axis
// the kv tile the dq kernel walks, and the q tile the dk/dv kernel walks
// (ops/flash_attention.py: D256_BWD_BLOCK_KV); the resident tiles are kRows
constexpr int kBlockKV = 64;
constexpr int kS = kBlockKV / 2;               // score registers a thread
constexpr int kSteps = kBlockKV / 16;          // k-steps, N = 256 products
static_assert(kBlockKV == kRows, "every tile 64 rows x 256");
// the named barriers of the p^T exchange (0 is __syncthreads)
constexpr int kPFull = 1, kPEmpty = 3;

// One __grid_constant__ parameter for both kernels (the dk/dv kernel
// leaves o unset).  out0/out1 are dq/- or dk/dv, with element strides
// (batch, row, head; head_dim stride 1).
struct BwdParams {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  const __nv_bfloat16* o;     // dq: delta's O rows
  const __nv_bfloat16* dout;  // dq: delta's dO rows
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  __nv_bfloat16* out0;
  __nv_bfloat16* out1;
  long long o0_sb, o0_ss, o0_sh, o1_sb, o1_ss, o1_sh;
  const float* lse;  // (B*H, S), natural log
  float* delta;      // (B*H, S)
  int heads, s_len, t_len;
  float scale, scale_log2;
};

// What a consumer warpgroup reads: its resident tiles (dq: Q and dO; dk/dv:
// K or V by role), the stream's ring and its mbarriers (`once` for the
// resident tiles, then full per stage) and release counts, its block's
// (batch, head) and streamed tiles.
struct Block {
  uint32_t a, b, ring0, ring1, bars, counts;
  int bh, h, bb, n_tiles;
  __device__ uint32_t once() const { return bars; }
  __device__ uint32_t full(int s) const { return bars + 8 * (1 + s); }
  __device__ uint32_t count(int s) const { return counts + 4 * s; }
};

// ----------------------------------------------------------------- loads

// The four box loads of rows `row`.. of a 256-wide tile into `dst`, one per
// 64-column block (`atom` bytes apart), completing on `full`; issued only
// where `go` holds, as predicated instructions.
__device__ __forceinline__ void load_rows_if(bool go, const CUtensorMap* map,
                                             uint32_t dst, uint32_t atom,
                                             uint32_t full, int row, int h,
                                             int b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %0, 0;\n"
      " @p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%1], [%5, {%9, %6, %7, %8}], [%13];\n"
      " @p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%2], [%5, {%10, %6, %7, %8}], [%13];\n"
      " @p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%3], [%5, {%11, %6, %7, %8}], [%13];\n"
      " @p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%4], [%5, {%12, %6, %7, %8}], [%13];\n}\n" ::"r"(
          (int)go),
      "r"(dst), "r"(dst + atom), "r"(dst + 2 * atom), "r"(dst + 3 * atom),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(h), "r"(row), "r"(b), "r"(0),
      "r"(kHeadDim), "r"(2 * kHeadDim), "r"(3 * kHeadDim), "r"(full)
      : "memory");
  static_assert(kAtoms == 4, "four boxes a row");
}

// One arrival on `full` expecting `bytes` more, where `go` holds.
__device__ __forceinline__ void expect_if(bool go, uint32_t full,
                                          uint32_t bytes) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %0, 0;\n"
      " @p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%1], %2;\n}\n" ::"r"(
          (int)go),
      "r"(full), "r"(bytes)
      : "memory");
}

// A warp is done with a stage in round `round` (its `round`-th use).  Lane
// 0 adds the warp to the stage's release count, acquire-release, so every
// warp's reads of the stage happen before what the last of them does next:
// refill it.  True on every lane of the last warp (`warps` release a round).
__device__ __forceinline__ bool release_last(uint32_t count, int round,
                                             int warps) {
  uint32_t before = 0;
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, %1, 0;\n"
      " @p atom.acq_rel.cta.shared::cta.add.u32 %0, [%2], 1;\n}\n"
      : "+r"(before)
      : "r"(threadIdx.x & 31), "r"(count)
      : "memory");
  before = __shfl_sync(0xffffffffu, before, 0);
  return before + 1 == (uint32_t)(warps * (round + 1));
}

__device__ __forceinline__ void init_ring(const Block& t, uint32_t full_count) {
  mbar_init(t.once(), 1);
  for (int s = 0; s < kRing; ++s) {
    mbar_init(t.full(s), full_count);
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(t.count(s)), "r"(0)
                 : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// ----------------------------------------------------------------- wgmma

#define D256_ACC32                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
// one k-step of issue_ss_half: both descriptors OFF (16-byte units) past
// its first
#define D256_SS_STEP(OFF)                                                   \
  " add.s64 da, %32, " #OFF ";\n add.s64 db, %33, " #OFF ";\n"             \
  " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" D256_ACC32     \
  "}, da, db, pacc, 1, 1, 0, 0;\n"

// acc (64 x 64, fp32) = A (64 x 128) B^T (64 x 128): columns 0-127 (or,
// kHigh, 128-255) of two tiles of four 64-row boxes in shared memory, 8
// wgmma k-steps of 16 columns, four in each box, 32 bytes apart in its
// swizzled rows (as the forwards' S = Q K^T).  One asm statement that forms
// the descriptors step by step from the first two (a k-step is 2 units of
// 16 bytes further, a box 512), so that two descriptors are live and not 16.
template <bool kHigh>
__device__ __forceinline__ void issue_ss_half(float (&acc)[kS], uint32_t a,
                                              uint32_t b) {
  static_assert(kAtom == 8192, "a box of 64 rows: 512 16-byte units");
  const uint64_t da = desc_sw128(a, 1) + (kHigh ? 1024 : 0);
  const uint64_t db = desc_sw128(b, 1) + (kHigh ? 1024 : 0);
  asm volatile(
      "{\n .reg .b64 da, db;\n .reg .pred pacc;\n"
      " setp.ne.b32 pacc, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" D256_ACC32
      "}, %32, %33, pacc, 1, 1, 0, 0;\n"
      " setp.eq.b32 pacc, %34, 0;\n"
      D256_SS_STEP(2) D256_SS_STEP(4) D256_SS_STEP(6)
      D256_SS_STEP(512) D256_SS_STEP(514) D256_SS_STEP(516) D256_SS_STEP(518)
      "}\n"
      : SM90_F32(acc)
      : "l"(da), "l"(db), "r"(0));
}

// A B^T over all 256 columns as two sums of 128, into acc (columns 0-127)
// and hi (128-255), which add_hi then adds in fp32.  The tensor cores'
// fp32 accumulation is not rounded to nearest: one 16-step chain put dq
// twelve times further from the tiled plain version than two 8-step ones
// on the small VAE's stage-1 inputs (scores up to 150 after the scale, dP
// close to delta); the two halves are the arithmetic of the first cut at
// this width, which summed two 128-column warp slices in fp32.
__device__ __forceinline__ void issue_ss(float (&acc)[kS], float (&hi)[kS],
                                         uint32_t a, uint32_t b) {
  issue_ss_half<false>(acc, a, b);
  issue_ss_half<true>(hi, a, b);
}

__device__ __forceinline__ void add_hi(float (&acc)[kS],
                                       const float (&hi)[kS]) {
#pragma unroll
  for (int i = 0; i < kS; ++i) acc[i] += hi[i];
}

// acc (64 x 256) += A (64 x 64, registers) B (64 x 256, a tile of four
// 64-row boxes in shared memory, read MN-major): 4 k-steps of 16 rows, each
// 16 rows (2048 bytes) further into every box; the leading offset is the
// step between boxes.  (As the forwards' O += P V.)
__device__ __forceinline__ void issue_rs(float (&acc)[kAtoms][32],
                                         const uint32_t (&a)[kSteps][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    wgmma_rs_n256(acc, a[kk], desc_sw128(b + kk * 16 * kRowBytes, kAtom >> 4));
}

// ----------------------------------------------------------------- misc

__device__ __forceinline__ float2 ld_shared_f32x2(uint32_t addr) {
  float2 x;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(x.x), "=f"(x.y)
               : "r"(addr)
               : "memory");
  return x;
}

__device__ __forceinline__ float4 ld_shared_f32x4(uint32_t addr) {
  float4 x;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(addr)
               : "memory");
  return x;
}

__device__ __forceinline__ void st_shared_f32x4(uint32_t addr, float a,
                                                float b, float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 xf = __bfloat1622float2(x[e]), yf = __bfloat1622float2(y[e]);
    acc = fmaf(xf.x, yf.x, acc);
    acc = fmaf(xf.y, yf.y, acc);
  }
  return acc;
}

// Write the warpgroup's 64 x 256 accumulator times f as bf16 rows
// [row0, row0 + 64) of (batch b, head h) through the strides; rows at or
// past n_rows are dropped.
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long sb,
                                           long long sl, long long sh, int b,
                                           int h,
                                           const float (&acc)[kAtoms][32],
                                           float f, int row0, int n_rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r_lo = row0 + ((threadIdx.x >> 5) & 3) * 16 + g, r_hi = r_lo + 8;
  __nv_bfloat16* base = out + b * sb + h * sh;
#pragma unroll
  for (int c = 0; c < kAtoms; ++c)
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n) {
      const int col = c * kHeadDim + n * 8 + t * 2;
      if (r_lo < n_rows)
        *reinterpret_cast<uint32_t*>(base + r_lo * sl + col) =
            pack_bf16(acc[c][4 * n] * f, acc[c][4 * n + 1] * f);
      if (r_hi < n_rows)
        *reinterpret_cast<uint32_t*>(base + r_hi * sl + col) =
            pack_bf16(acc[c][4 * n + 2] * f, acc[c][4 * n + 3] * f);
    }
}

__device__ __forceinline__ void zero(float (&acc)[kAtoms][32]) {
#pragma unroll
  for (int c = 0; c < kAtoms; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
}

// ------------------------------------------------------------------- dq

// Shared memory of the dq kernel: Q and dO (resident), then the K and V
// stages, the mbarriers (once, full per stage) and the release counts.
struct DqSmem {
  static constexpr int q = 0;
  static constexpr int dout = q + kTileBytes;
  static constexpr int k = dout + kTileBytes;
  static constexpr int v = k + kRing * kTileBytes;
  static constexpr int bars = v + kRing * kTileBytes;
  static constexpr int counts = bars + (1 + kRing) * 8;
  static constexpr int bytes = counts + kRing * 4 + 1024;  // + alignment
  static_assert(bytes <= 232448, "227 KB a block");
};

// K and V of kv tile j into stage j % kRing, where `go` holds.
__device__ __forceinline__ void load_kv_if(bool go, const BwdParams& p,
                                           const Block& t, int j) {
  const int st = j % kRing;
  expect_if(go, t.full(st), 2 * kTileBytes);
  load_rows_if(go, &p.tm_k, t.ring0 + st * kTileBytes, kAtom, t.full(st),
               j * kBlockKV, t.h, t.bb);
  load_rows_if(go, &p.tm_v, t.ring1 + st * kTileBytes, kAtom, t.full(st),
               j * kBlockKV, t.h, t.bb);
}

// Every warp releases kv tile j's stage once its dQ product has retired;
// the last refills it with tile j + kRing.
__device__ __forceinline__ void release_kv(const BwdParams& p, const Block& t,
                                           int j) {
  const bool last = release_last(t.count(j % kRing), j / kRing, 4);
  load_kv_if(last && (threadIdx.x & 31) == 0 && j + kRing < t.n_tiles, p, t,
             j + kRing);
}

// Per thread: S, dP and the second half of either (32 registers each), dQ
// (128), dS as the A operand (16) of the block's 64 q rows, and its two
// rows' lse * log2 e and delta.
struct DqState {
  float s[kS], dp[kS], hi[kS], dq[kAtoms][32];
  uint32_t ds[kSteps][4];
  float lse2_lo, lse2_hi, delta_lo, delta_hi;
};

// Tile j: S_j issued behind dQ += dS_{j-1} K_{j-1}, that product retired
// (its stage released), S_j's halves added, dP_j issued, p = exp2(...) on
// S_j while dP_j runs, then ds = p (dP_j - delta) and dQ += dS_j K_j, which
// runs on into the next tile.  The first tile and the last are separate
// instances, so no branch sits in the body while a product is in flight.
// (S_j and dP_j as one group, the exponentials after both, ran slower on an
// H100, and so did dP_j's first half issued behind S_j.)
template <bool kFirst, bool kLast>
__device__ __forceinline__ void dq_step(const BwdParams& p, const Block& t,
                                        int j, DqState& x) {
  const int st = j % kRing;
  const uint32_t k_tile = t.ring0 + st * kTileBytes;
  mbar_wait(t.full(st), (j / kRing) & 1);
  issue_begin(x.s, x.hi);
  issue_ss(x.s, x.hi, t.a, k_tile);
  issue_end(x.s, x.hi);
  if (!kFirst) {
    wgmma_wait<1>();
    fence_regs(x.dq);
    fence_regs(x.ds);
    release_kv(p, t, j - 1);
  }
  wgmma_wait<0>();
  fence_regs(x.s);
  fence_regs(x.hi);
  add_hi(x.s, x.hi);
  issue_begin(x.dp, x.hi);
  issue_ss(x.dp, x.hi, t.b, t.ring1 + st * kTileBytes);
  issue_end(x.dp, x.hi);
  if (kLast) mask_tail(x.s, j * kBlockKV, p.t_len);
#pragma unroll
  for (int n = 0; n < kS / 4; ++n) {
    x.s[4 * n] = exp2f(fmaf(x.s[4 * n], p.scale_log2, -x.lse2_lo));
    x.s[4 * n + 1] = exp2f(fmaf(x.s[4 * n + 1], p.scale_log2, -x.lse2_lo));
    x.s[4 * n + 2] = exp2f(fmaf(x.s[4 * n + 2], p.scale_log2, -x.lse2_hi));
    x.s[4 * n + 3] = exp2f(fmaf(x.s[4 * n + 3], p.scale_log2, -x.lse2_hi));
  }
  wgmma_wait<0>();
  fence_regs(x.dp);
  fence_regs(x.hi);
  add_hi(x.dp, x.hi);
#pragma unroll
  for (int n = 0; n < kS / 4; ++n) {
    x.s[4 * n] *= x.dp[4 * n] - x.delta_lo;
    x.s[4 * n + 1] *= x.dp[4 * n + 1] - x.delta_lo;
    x.s[4 * n + 2] *= x.dp[4 * n + 2] - x.delta_hi;
    x.s[4 * n + 3] *= x.dp[4 * n + 3] - x.delta_hi;
  }
  pack_p(x.ds, x.s);
  issue_begin(x.dq, x.ds);
  issue_rs(x.dq, x.ds, k_tile);
  issue_end(x.dq, x.ds);
}

// delta = rowsum(dO * O) in fp32 of this warp's 16 rows from `row0`, one
// row at a time across the warp (a lane 8 columns, then a butterfly, which
// leaves every lane the same sum); written out for the dk/dv kernel, and
// returned for this thread's rows lo and hi.  Rows past S: 0.
__device__ __forceinline__ float2 row_deltas(const BwdParams& p, int b, int h,
                                             int row0) {
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh + lane * 8;
  const __nv_bfloat16* db = p.dout + b * p.do_sb + h * p.do_sh + lane * 8;
  float* out = p.delta + (size_t)(b * p.heads + h) * p.s_len;
  float lo = 0.f, hi = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int row = row0 + i;
    float acc = 0.f;
    if (row < p.s_len)
      acc = dot8(*reinterpret_cast<const uint4*>(ob + row * p.o_ss),
                 *reinterpret_cast<const uint4*>(db + row * p.do_ss), 0.f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (i == g) lo = acc;
    if (i == g + 8) hi = acc;
    if (lane == 0 && row < p.s_len) out[row] = acc;
  }
  return make_float2(lo, hi);
}

// One consumer warpgroup and nothing else: up to 255 registers a thread
// for dq (128), the two score tiles and dS.
__global__ void __launch_bounds__(128, 1)
    dq_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int row0 = blockIdx.x * kRows;
  const Block t{smem + DqSmem::q, smem + DqSmem::dout, smem + DqSmem::k,
                smem + DqSmem::v, smem + DqSmem::bars, smem + DqSmem::counts,
                (int)blockIdx.y, h, b, (p.t_len + kBlockKV - 1) / kBlockKV};

  if (threadIdx.x == 0) {
    init_ring(t, 1);
    prefetch_map(&p.tm_q);
    prefetch_map(&p.tm_do);
    prefetch_map(&p.tm_k);
    prefetch_map(&p.tm_v);
    mbar_expect_tx(t.once(), 2 * kTileBytes);
    load_rows_if(true, &p.tm_q, t.a, kAtom, t.once(), row0, h, b);
    load_rows_if(true, &p.tm_do, t.b, kAtom, t.once(), row0, h, b);
    for (int j = 0; j < kRing && j < t.n_tiles; ++j) load_kv_if(true, p, t, j);
  }
  __syncthreads();

  const int warp_row0 = row0 + (threadIdx.x >> 5) * 16;
  const int r_lo = warp_row0 + ((threadIdx.x & 31) >> 2), r_hi = r_lo + 8;
  DqState x;
  // rows past S: lse = 0 (their dq is never stored)
  const float* lb = p.lse + (size_t)blockIdx.y * p.s_len;
  x.lse2_lo = r_lo < p.s_len ? lb[r_lo] * kLog2e : 0.f;
  x.lse2_hi = r_hi < p.s_len ? lb[r_hi] * kLog2e : 0.f;
  const float2 d = row_deltas(p, b, h, warp_row0);
  x.delta_lo = d.x;
  x.delta_hi = d.y;
  zero(x.dq);

  mbar_wait(t.once(), 0);
  const int n = t.n_tiles;
  if (n == 1) {
    dq_step<true, true>(p, t, 0, x);
  } else {
    dq_step<true, false>(p, t, 0, x);
    for (int j = 1; j < n - 1; ++j) dq_step<false, false>(p, t, j, x);
    dq_step<false, true>(p, t, n - 1, x);
  }
  wgmma_wait<0>();
  fence_regs(x.dq);
  fence_regs(x.ds);
  store_rows(p.out0, p.o0_sb, p.o0_ss, p.o0_sh, b, h, x.dq, p.scale, row0,
             p.s_len);
}

// ---------------------------------------------------------------- dk/dv

// Shared memory of the dk/dv kernel: K and V of the block's kv rows
// (resident), the Q and dO stages, p^T's two buffers, each stage's 64 lse
// and 64 delta values, the mbarriers and the release counts.
struct DkvSmem {
  static constexpr int k = 0;
  static constexpr int v = k + kTileBytes;
  static constexpr int q = v + kTileBytes;
  static constexpr int dout = q + kRing * kTileBytes;
  static constexpr int kPBytes = kRows * kBlockKV * 4;  // 16 KB
  static constexpr int pt = dout + kRing * kTileBytes;
  static constexpr int kStatsBytes = 2 * kBlockKV * 4;
  static constexpr int stats = pt + 2 * kPBytes;
  static constexpr int bars = stats + kRing * kStatsBytes;
  static constexpr int counts = bars + (1 + kRing) * 8;
  static constexpr int bytes = counts + kRing * 4 + 1024;  // + alignment
  static_assert(bytes <= 232448, "227 KB a block");
};

// Q, dO, lse and delta of q tile i into stage i % kRing, where `go` holds:
// every lane copies two rows' lse and delta by cp.async (0 past S) and
// arrives on the stage's full barrier when they land (32 arrivals), lane 0
// expects the tiles' bytes (one more) and issues their box loads.
__device__ __forceinline__ void load_q_if(bool go, const BwdParams& p,
                                          const Block& t, uint32_t stats,
                                          int i) {
  const int lane = threadIdx.x & 31, st = i % kRing;
  const float* lb = p.lse + (size_t)t.bh * p.s_len;
  const float* db = p.delta + (size_t)t.bh * p.s_len;
  const uint32_t dst = stats + st * DkvSmem::kStatsBytes + 4 * lane;
  const int r0 = i * kBlockKV + lane, r1 = r0 + 32;
  const int n0 = r0 < p.s_len ? 4 : 0, n1 = r1 < p.s_len ? 4 : 0;
  const int s0 = n0 ? r0 : 0, s1 = n1 ? r1 : 0;
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %0, 0;\n"
      " @p cp.async.ca.shared.global [%1], [%5], 4, %9;\n"
      " @p cp.async.ca.shared.global [%2], [%6], 4, %10;\n"
      " @p cp.async.ca.shared.global [%3], [%7], 4, %9;\n"
      " @p cp.async.ca.shared.global [%4], [%8], 4, %10;\n"
      " @p cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%11];\n}\n" ::"r"(
          (int)go),
      "r"(dst), "r"(dst + 128), "r"(dst + 4 * kBlockKV),
      "r"(dst + 4 * kBlockKV + 128), "l"(lb + s0), "l"(lb + s1),
      "l"(db + s0), "l"(db + s1), "r"(n0), "r"(n1), "r"(t.full(st))
      : "memory");
  const bool issue = go && lane == 0;
  expect_if(issue, t.full(st), 2 * kTileBytes);
  load_rows_if(issue, &p.tm_q, t.ring0 + st * kTileBytes, kAtom, t.full(st),
               i * kBlockKV, t.h, t.bb);
  load_rows_if(issue, &p.tm_do, t.ring1 + st * kTileBytes, kAtom,
               t.full(st), i * kBlockKV, t.h, t.bb);
}

// Per thread: the first product of its role (S^T for A, dP^T for B; 32
// registers), its accumulator (dV for A, dK for B; 128) and the second
// product's A operand (bf16 p^T or dS^T; 16).
struct DkvState {
  float s[kS], hi[kS];
  float acc[kAtoms][32];
  uint32_t a[kSteps][4];
};

// Q tile i.  A: S^T_i = K Q_i^T, p^T in fp32 handed to B through buffer i
// & 1, dV += bf16(p^T) dO_i.  B: dP^T_i = V dO_i^T, dS^T = p^T (dP^T -
// delta), dK += bf16(dS^T) Q_i.  Each issues its first product while its
// previous tile's second one still runs, retires that (releasing its
// stage), and issues this tile's second product to run on into the next.
// Only the first tile is a separate instance: no tile is masked (rows past
// S add zeros), and the branch between the roles runs with no product in
// flight.
template <bool kFirst>
__device__ __forceinline__ void dkv_step(const BwdParams& p, const Block& t,
                                         uint32_t stats, uint32_t pt,
                                         bool role_a, int i, DkvState& x) {
  const int st = i % kRing;
  const uint32_t q_tile = t.ring0 + st * kTileBytes;
  const uint32_t do_tile = t.ring1 + st * kTileBytes;
  mbar_wait(t.full(st), (i / kRing) & 1);
  issue_begin(x.s, x.hi);
  issue_ss(x.s, x.hi, t.a, role_a ? q_tile : do_tile);
  issue_end(x.s, x.hi);
  if (!kFirst) {
    wgmma_wait<1>();
    fence_regs(x.acc);
    fence_regs(x.a);
    const bool last = release_last(t.count((i - 1) % kRing), (i - 1) / kRing,
                                   8);
    load_q_if(last && i + 1 < t.n_tiles, p, t, stats, i + 1);
  }
  wgmma_wait<0>();
  fence_regs(x.s);
  fence_regs(x.hi);
  add_hi(x.s, x.hi);
  // columns 8n + 2c + {0, 1} are q rows of the tile: lse and delta by column
  const int c = threadIdx.x & 3;
  const uint32_t sv = stats + st * DkvSmem::kStatsBytes;
  const uint32_t buf =
      pt + (i & 1) * DkvSmem::kPBytes + (threadIdx.x & 127) * 16;
  if (role_a) {
#pragma unroll
    for (int n = 0; n < kS / 4; ++n) {
      const float2 l = ld_shared_f32x2(sv + 4 * (8 * n + 2 * c));
      const float l0 = l.x * kLog2e, l1 = l.y * kLog2e;
      x.s[4 * n] = exp2f(fmaf(x.s[4 * n], p.scale_log2, -l0));
      x.s[4 * n + 1] = exp2f(fmaf(x.s[4 * n + 1], p.scale_log2, -l1));
      x.s[4 * n + 2] = exp2f(fmaf(x.s[4 * n + 2], p.scale_log2, -l0));
      x.s[4 * n + 3] = exp2f(fmaf(x.s[4 * n + 3], p.scale_log2, -l1));
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
      const float2 d = ld_shared_f32x2(sv + 4 * (kBlockKV + 8 * n + 2 * c));
      x.s[4 * n] = pv.x * (x.s[4 * n] - d.x);
      x.s[4 * n + 1] = pv.y * (x.s[4 * n + 1] - d.y);
      x.s[4 * n + 2] = pv.z * (x.s[4 * n + 2] - d.x);
      x.s[4 * n + 3] = pv.w * (x.s[4 * n + 3] - d.y);
    }
    if (i + 2 < t.n_tiles) named_arrive(kPEmpty + (i & 1));
  }
  pack_p(x.a, x.s);
  issue_begin(x.acc, x.a);
  issue_rs(x.acc, x.a, role_a ? do_tile : q_tile);
  issue_end(x.acc, x.a);
}

// Two consumer warpgroups (A: threads 0-127, B: 128-255) and nothing else.
__global__ void __launch_bounds__(256, 1)
    dkv_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int kv0 = blockIdx.x * kRows;
  // the warpgroup's role, warp-uniform
  const bool role_a = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0) == 0;
  // a: the warpgroup's resident tile (K for A, V for B)
  const Block t{smem + (role_a ? DkvSmem::k : DkvSmem::v), 0,
                smem + DkvSmem::q, smem + DkvSmem::dout,
                smem + DkvSmem::bars, smem + DkvSmem::counts,
                (int)blockIdx.y, h, b, (p.s_len + kBlockKV - 1) / kBlockKV};
  const uint32_t stats = smem + DkvSmem::stats, pt = smem + DkvSmem::pt;

  // a stage is full after its 32 lanes' cp.async arrivals, lane 0's
  // expect_tx and the tiles' bytes
  if (threadIdx.x == 0) init_ring(t, 33);
  __syncthreads();
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      prefetch_map(&p.tm_k);
      prefetch_map(&p.tm_v);
      prefetch_map(&p.tm_q);
      prefetch_map(&p.tm_do);
      mbar_expect_tx(t.once(), 2 * kTileBytes);
      load_rows_if(true, &p.tm_k, smem + DkvSmem::k, kAtom, t.once(), kv0, h,
                   b);
      load_rows_if(true, &p.tm_v, smem + DkvSmem::v, kAtom, t.once(), kv0, h,
                   b);
    }
    for (int i = 0; i < kRing && i < t.n_tiles; ++i)
      load_q_if(true, p, t, stats, i);
  }

  DkvState x;
  zero(x.acc);
  mbar_wait(t.once(), 0);
  dkv_step<true>(p, t, stats, pt, role_a, 0, x);
  for (int i = 1; i < t.n_tiles; ++i)
    dkv_step<false>(p, t, stats, pt, role_a, i, x);
  wgmma_wait<0>();
  fence_regs(x.acc);
  fence_regs(x.a);
  if (role_a)
    store_rows(p.out1, p.o1_sb, p.o1_ss, p.o1_sh, b, h, x.acc, 1.f, kv0,
               p.t_len);
  else
    store_rows(p.out0, p.o0_sb, p.o0_ss, p.o0_sh, b, h, x.acc, p.scale, kv0,
               p.t_len);
}

// ------------------------------------------------------------------ host

// Encode the four input maps, fill the scalars and launch `kernel` (its
// shared-memory limit raised to `smem_bytes`) over ceil(len / 64) x B*H
// blocks of `threads`, len S (dq) or T (dk/dv).  `s` holds the element
// strides (sb, sl, sh) in the C entries' order: dq: q, k, v, o, dO, dq;
// dk/dv: q, k, v, dO, dk, dv.
int launch_bwd(void (*kernel)(BwdParams), int smem_bytes, int threads,
               bool dq, const void* q, const void* k, const void* v,
               const void* o, const void* dout, const void* lse, void* delta,
               void* out0, void* out1, int b, int h, int s_len, int t_len,
               const long long* s, float scale, void* stream) {
  if (b <= 0 || h <= 0 || s_len <= 0 || t_len <= 0 || (long long)b * h > 65535)
    return (int)cudaErrorInvalidValue;
  if (const cudaError_t err = bind_context()) return (int)err;
  BwdParams p{};
  const long long* sd = dq ? s + 12 : s + 9;  // dO's
  const long long* so = dq ? s + 15 : s + 12;  // the first output's
  if (!encode_map(&p.tm_q, q, b, s_len, h, s[0], s[1], s[2], kRows, kD) ||
      !encode_map(&p.tm_k, k, b, t_len, h, s[3], s[4], s[5], kRows, kD) ||
      !encode_map(&p.tm_v, v, b, t_len, h, s[6], s[7], s[8], kRows, kD) ||
      !encode_map(&p.tm_do, dout, b, s_len, h, sd[0], sd[1], sd[2], kRows,
                  kD))
    return (int)cudaErrorInvalidValue;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  if (dq) {
    p.o_sb = s[9];
    p.o_ss = s[10];
    p.o_sh = s[11];
    p.do_sb = sd[0];
    p.do_ss = sd[1];
    p.do_sh = sd[2];
  }
  p.out0 = static_cast<__nv_bfloat16*>(out0);
  p.out1 = static_cast<__nv_bfloat16*>(out1);
  p.o0_sb = so[0];
  p.o0_ss = so[1];
  p.o0_sh = so[2];
  if (!dq) {
    p.o1_sb = s[15];
    p.o1_ss = s[16];
    p.o1_sh = s[17];
  }
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.heads = h;
  p.s_len = s_len;
  p.t_len = t_len;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  dim3 grid(((dq ? s_len : t_len) + kRows - 1) / kRows, b * h);
  kernel<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes, with the other backward entries'
// argument lists.  Tensors (B, len, H, 256) bf16 with the element strides
// in `strides` (sb, sl, sh each; head_dim stride 1), lse and delta (B*H, S)
// fp32 contiguous.  Each launches on `stream`, allocates nothing, and
// returns a CUDA error code (0 = launched).
//
// dq and delta; strides of q, k, v, o, dO, dq.
extern "C" int flash_bwd_dq_d256_bf16(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* delta, void* dq, int b, int h,
                                      int s_len, int t_len,
                                      const long long* strides, float scale,
                                      void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DqSmem::bytes);
  if (attr != cudaSuccess) return (int)attr;
  return launch_bwd(dq_kernel, DqSmem::bytes, 128, true, q, k, v, o, dout,
                    lse, delta, dq, nullptr, b, h, s_len, t_len, strides,
                    scale, stream);
}

// dk and dv from the dq kernel's delta; strides of q, k, v, dO, dk, dv.
extern "C" int flash_bwd_dkv_d256_bf16(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int b, int h,
                                       int s_len, int t_len,
                                       const long long* strides, float scale,
                                       void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DkvSmem::bytes);
  if (attr != cudaSuccess) return (int)attr;
  return launch_bwd(dkv_kernel, DkvSmem::bytes, 256, false, q, k, v, nullptr,
                    dout, lse, const_cast<void*>(delta), dk, dv, b, h, s_len,
                    t_len, strides, scale, stream);
}
