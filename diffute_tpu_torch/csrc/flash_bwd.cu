// Flash-attention backward for Hopper (sm_90a): two kernels, dq and dk/dv.
//
//   q, o, dO (B, S, H, 64), k, v (B, T, H, 64)   bf16, any strides TMA takes
//   lse (B*H, S) fp32 natural log, as the forwards write it
//   delta (B*H, S) fp32 = rowsum(dO * O): written by the dq kernel, read by
//     the dk/dv kernel
//   dq (B, S, H, 64), dk, dv (B, T, H, 64)       bf16 through their strides
//
// Both recompute p = exp(s*scale - lse) from the saved LSE, as one FMA and
// one exp2 per score (scale*log2(e) folded in, q not prescaled), then
//   dv = p^T dO,  dp = dO v^T,  ds = p * (dp - delta),
//   dq = ds k * scale,  dk = ds^T q * scale.
//
// flash_bwd_dq_sm90_kernel replaces the Pallas TPU kernel `_bwd_dq_kernel`
// of diffute_tpu/ops/flash_attention.py (pl.pallas_call in
// `_flash_bwd_3d`), which carries dq in VMEM scratch across a sequential kv
// grid axis, and the plain-XLA delta its caller computes.  Here a block owns
// 128 q rows of one (batch, head) (flash_sm90.cuh's layout: a producer warp,
// two consumer warpgroups of 64 rows), computes delta from its dO and O tiles
// in shared memory, writes it out for the dk/dv kernel, and walks the kv
// tiles with dq in registers: per tile S = Q K^T and dP = dO V^T (two
// shared-memory wgmmas), ds in registers, dQ += dS K (register-A wgmma, K
// read MN-major as the forward reads V).
//
// flash_bwd_dkv_sm90_kernel replaces `_bwd_dkv_kernel` (same file, same call
// site), which carries dk and dv across a sequential q grid axis.  Here a
// block owns 128 kv rows (64 a consumer warpgroup), loads their K and V tiles
// once and walks the q tiles with dk and dv in registers, so there are no
// atomics and each output element is written by one block: the result is
// deterministic.  The products dv += p^T dO and dk += ds^T q need p and ds
// transposed as the A operand, so the kernel computes the transposed tiles
// directly (S^T = K Q^T, dP^T = V dO^T, K and V as the shared-memory A
// operand), which leaves p^T and ds^T in the accumulator layout, and that is
// wgmma's register-A layout.  lse and delta then index the tile's *columns*:
// the producer warp copies each q tile's 64 + 64 values by pointer (from L2;
// a TMA map would need S * 4 bytes a multiple of 16) into shared memory
// beside the tile, zero past S, and the consumers read them as float2.
//
// What bounds them on the H100: operations.  Per score dq does three
// 2*64-FLOP products, dk/dv four (7 products where the function needs 5:
// both kernels recompute s and dp), against one exp2 and a few fp32 ops; the
// inputs are a few MB, re-read from L2 per 128-row block.  What the design
// does about it: asynchronous wgmma (in dq the next tile's S and dP are
// issued while the previous tile's dQ product still runs; dk/dv has no
// registers for that, see dkv_step), two consumer warpgroups whose products
// overlap each other's arithmetic, TMA loads by a producer warp into a
// three-stage ring (the consumers issue no load and no __syncthreads), no
// shared-memory round trip between the products, the scale folded into the
// exp2 FMA and applied to dq and dk once at the end, and the ragged edges
// handled by TMA's zero fill instead of per-element masks.
//
// Ragged edges.  dq: kv rows past T read as zeros and the last tile sets
// their scores to -inf, so p = 0.  dk/dv: q rows past S read as zeros (so
// dO = 0 there) and their lse and delta are written as 0, which gives p =
// exp2(0) = 1 and ds = 1 * (0 - 0) = 0: they contribute nothing.  Rows past
// the end of an output are not written.

#include "flash_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kTile = 64;                       // q and kv rows of a tile
constexpr int kTileBytes = kTile * kRowBytes;   // 8 KB
constexpr int kBlockRows = kConsumers * kTile;  // 128 rows a block

// One __grid_constant__ parameter for both kernels (the dk/dv kernel leaves
// tm_o unset).  out0/out1 are dq/- or dk/dv, with element strides (batch,
// row, head; head_dim stride 1).
struct BwdParams {
  CUtensorMap tm_q, tm_k, tm_v, tm_o, tm_do;
  __nv_bfloat16* out0;
  __nv_bfloat16* out1;
  long long o0_sb, o0_sl, o0_sh, o1_sb, o1_sl, o1_sh;
  const float* lse;  // (B*H, S), natural log
  float* delta;      // (B*H, S)
  int heads, s_len, t_len;
  float scale, scale_log2;
};

// The mbarriers after the tiles: `once` for the tiles loaded once a block,
// then full and empty per ring stage.
struct Ring {
  uint32_t base;
  static constexpr int kBytes = (1 + 2 * kStages) * 8;
  __device__ uint32_t once() const { return base; }
  __device__ uint32_t full(int s) const { return base + 8 * (1 + s); }
  __device__ uint32_t empty(int s) const {
    return base + 8 * (1 + kStages + s);
  }
  // full_count: arrivals that complete a stage's load (besides its bytes)
  __device__ void init(uint32_t full_count) const {
    mbar_init(once(), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), full_count);
      mbar_init(empty(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// Shared memory of the dq kernel: Q, dO and O of each consumer, then the
// K and V ring.
struct DqSmem {
  static constexpr int q = 0;
  static constexpr int dout = q + kConsumers * kTileBytes;
  static constexpr int o = dout + kConsumers * kTileBytes;
  static constexpr int k = o + kConsumers * kTileBytes;
  static constexpr int v = k + kStages * kTileBytes;
  static constexpr int bars = v + kStages * kTileBytes;
  static constexpr int bytes = bars + Ring::kBytes + 1024;  // + alignment
};

// Shared memory of the dk/dv kernel: K and V of each consumer, then the Q
// and dO ring and each stage's 64 lse * log2(e) and 64 delta values.
struct DkvSmem {
  static constexpr int k = 0;
  static constexpr int v = k + kConsumers * kTileBytes;
  static constexpr int q = v + kConsumers * kTileBytes;
  static constexpr int dout = q + kStages * kTileBytes;
  static constexpr int stats = dout + kStages * kTileBytes;
  static constexpr int kStatsBytes = 2 * kTile * 4;
  static constexpr int bars = stats + kStages * kStatsBytes;
  static constexpr int bytes = bars + Ring::kBytes + 1024;
};

__device__ __forceinline__ void st_shared_f32(uint32_t addr, float x) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(x) : "memory");
}

__device__ __forceinline__ float2 ld_shared_f32x2(uint32_t addr) {
  float2 x;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(x.x), "=f"(x.y)
               : "r"(addr)
               : "memory");
  return x;
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 x;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
               : "r"(addr)
               : "memory");
  return x;
}

__device__ __forceinline__ float dot_bf16x2(uint32_t a, uint32_t b,
                                            float acc) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&a));
  const float2 y = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&b));
  return fmaf(x.y, y.y, fmaf(x.x, y.x, acc));
}

// rowsum(a * b) in fp32 of this thread's rows lo and lo + 8 of two
// 128-byte-swizzled 64 x 64 tiles: each quad thread sums 16 columns, then
// the quad adds them (as store_rows adds l).  The swizzle puts 16-byte chunk
// c of row r at chunk c ^ (r & 7).
__device__ __forceinline__ float2 row_dots(uint32_t a_tile, uint32_t b_tile,
                                           int lo) {
  const int t = threadIdx.x & 3;
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = lo + 8 * half;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const uint32_t off = r * kRowBytes + (((2 * t + cc) ^ (r & 7)) << 4);
      const uint4 x = ld_shared_v4(a_tile + off), y = ld_shared_v4(b_tile + off);
      float acc = sum[half];
      acc = dot_bf16x2(x.x, y.x, acc);
      acc = dot_bf16x2(x.y, y.y, acc);
      acc = dot_bf16x2(x.z, y.z, acc);
      acc = dot_bf16x2(x.w, y.w, acc);
      sum[half] = acc;
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    sum[0] += __shfl_xor_sync(0xffffffffu, sum[0], off);
    sum[1] += __shfl_xor_sync(0xffffffffu, sum[1], off);
  }
  return make_float2(sum[0], sum[1]);
}

// Write the warpgroup's 64 x 64 accumulator times f as bf16 rows
// [row0, row0 + 64) of (batch b, head h) through the strides; rows at or
// past n_rows are dropped.
__device__ __forceinline__ void store_tile(__nv_bfloat16* out, long long sb,
                                           long long sl, long long sh, int b,
                                           int h, const float (&acc)[32],
                                           float f, int row0, int n_rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r_lo = row0 + ((threadIdx.x >> 5) & 3) * 16 + g, r_hi = r_lo + 8;
  __nv_bfloat16* base = out + b * sb + h * sh;
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n) {
    const int c = n * 8 + t * 2;
    if (r_lo < n_rows)
      *reinterpret_cast<uint32_t*>(base + r_lo * sl + c) =
          pack_bf16(acc[4 * n] * f, acc[4 * n + 1] * f);
    if (r_hi < n_rows)
      *reinterpret_cast<uint32_t*>(base + r_hi * sl + c) =
          pack_bf16(acc[4 * n + 2] * f, acc[4 * n + 3] * f);
  }
}

// ------------------------------------------------------------------- dq

// One thread: Q, dO and O of each consumer whose rows start before S, then
// K_j and V_j for every kv tile j into stage j % kStages.
__device__ __forceinline__ void produce_dq(const BwdParams& p, uint32_t smem,
                                           const Ring& ring, int b, int h,
                                           int row0, int n_tiles) {
  prefetch_map(&p.tm_q);
  prefetch_map(&p.tm_do);
  prefetch_map(&p.tm_o);
  prefetch_map(&p.tm_k);
  prefetch_map(&p.tm_v);
  const int n_wg = min(kConsumers, (p.s_len - row0 + kTile - 1) / kTile);
  mbar_expect_tx(ring.once(), n_wg * 3 * kTileBytes);
  for (int w = 0; w < n_wg; ++w) {
    const int row = row0 + w * kTile;
    tma_load(smem + DqSmem::q + w * kTileBytes, &p.tm_q, ring.once(), h, row,
             b);
    tma_load(smem + DqSmem::dout + w * kTileBytes, &p.tm_do, ring.once(), h,
             row, b);
    tma_load(smem + DqSmem::o + w * kTileBytes, &p.tm_o, ring.once(), h, row,
             b);
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    mbar_wait(ring.empty(st), ((j / kStages) & 1) ^ 1);  // round 0 passes
    mbar_expect_tx(ring.full(st), 2 * kTileBytes);
    tma_load(smem + DqSmem::k + st * kTileBytes, &p.tm_k, ring.full(st), h,
             j * kTile, b);
    tma_load(smem + DqSmem::v + st * kTileBytes, &p.tm_v, ring.full(st), h,
             j * kTile, b);
  }
}

// Per consumer thread: S (32 regs), dP (32), dQ (32) and dS as the A operand
// (16) of its warpgroup's 64 q rows.
struct DqState {
  float s[32], dp[32], dq[32];
  uint32_t ds[4][4];
  float lse2_lo, lse2_hi, delta_lo, delta_hi;
};

// Tile j: S_j and dP_j issued while dQ += dS_{j-1} K_{j-1} still runs, that
// product retired (its stage released), then dS_j and dQ += dS_j K_j, which
// runs on into the next tile.  The first tile and the last are separate
// instances, so no branch sits in the body while a product is in flight.
template <bool kFirst, bool kLast>
__device__ __forceinline__ void dq_step(const BwdParams& p, const Ring& ring,
                                        uint32_t q_tile, uint32_t do_tile,
                                        uint32_t k_ring, uint32_t v_ring,
                                        int j, DqState& x) {
  const int st = j % kStages;
  const uint32_t k_tile = k_ring + st * kTileBytes;
  mbar_wait(ring.full(st), (j / kStages) & 1);
  issue_begin(x.s, x.dp);
  issue_qk(x.s, q_tile, k_tile);
  issue_qk(x.dp, do_tile, v_ring + st * kTileBytes);
  issue_end(x.s, x.dp);
  if (!kFirst) {
    wgmma_wait<1>();
    fence_regs(x.dq);
    fence_regs(x.ds);
    release(ring.empty((j - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_regs(x.s);
  fence_regs(x.dp);
  if (kLast) mask_tail(x.s, j * kTile, p.t_len);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    x.s[4 * n] = exp2f(fmaf(x.s[4 * n], p.scale_log2, -x.lse2_lo)) *
                 (x.dp[4 * n] - x.delta_lo);
    x.s[4 * n + 1] = exp2f(fmaf(x.s[4 * n + 1], p.scale_log2, -x.lse2_lo)) *
                     (x.dp[4 * n + 1] - x.delta_lo);
    x.s[4 * n + 2] = exp2f(fmaf(x.s[4 * n + 2], p.scale_log2, -x.lse2_hi)) *
                     (x.dp[4 * n + 2] - x.delta_hi);
    x.s[4 * n + 3] = exp2f(fmaf(x.s[4 * n + 3], p.scale_log2, -x.lse2_hi)) *
                     (x.dp[4 * n + 3] - x.delta_hi);
  }
  pack_p(x.ds, x.s);
  issue_begin(x.dq, x.ds);
  issue_pv(x.dq, x.ds, k_tile);
  issue_end(x.dq, x.ds);
}

__device__ __forceinline__ void consume_dq(const BwdParams& p, uint32_t smem,
                                           const Ring& ring, int wg, int b,
                                           int h, int wg_row0, int n_tiles) {
  const uint32_t q_tile = smem + DqSmem::q + wg * kTileBytes;
  const uint32_t do_tile = smem + DqSmem::dout + wg * kTileBytes;
  const uint32_t k_ring = smem + DqSmem::k, v_ring = smem + DqSmem::v;
  const int lo = ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
  const int r_lo = wg_row0 + lo, r_hi = r_lo + 8;
  const size_t bh = (size_t)b * p.heads + h;
  DqState x;
  // rows past S: lse = 0 (their dq is never stored)
  const float* lb = p.lse + bh * p.s_len;
  x.lse2_lo = r_lo < p.s_len ? lb[r_lo] * kLog2e : 0.f;
  x.lse2_hi = r_hi < p.s_len ? lb[r_hi] * kLog2e : 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) x.dq[i] = 0.f;

  // ---- delta = rowsum(dO * O) from the shared tiles, for the dk/dv kernel
  mbar_wait(ring.once(), 0);
  const float2 d = row_dots(do_tile, smem + DqSmem::o + wg * kTileBytes, lo);
  x.delta_lo = d.x;
  x.delta_hi = d.y;
  if ((threadIdx.x & 3) == 0) {
    float* db = p.delta + bh * p.s_len;
    if (r_lo < p.s_len) db[r_lo] = d.x;
    if (r_hi < p.s_len) db[r_hi] = d.y;
  }

  if (n_tiles == 1) {
    dq_step<true, true>(p, ring, q_tile, do_tile, k_ring, v_ring, 0, x);
  } else {
    dq_step<true, false>(p, ring, q_tile, do_tile, k_ring, v_ring, 0, x);
    for (int j = 1; j < n_tiles - 1; ++j)
      dq_step<false, false>(p, ring, q_tile, do_tile, k_ring, v_ring, j, x);
    dq_step<false, true>(p, ring, q_tile, do_tile, k_ring, v_ring,
                         n_tiles - 1, x);
  }
  wgmma_wait<0>();
  fence_regs(x.dq);
  fence_regs(x.ds);
  release(ring.empty((n_tiles - 1) % kStages));
  store_tile(p.out0, p.o0_sb, p.o0_sl, p.o0_sh, b, h, x.dq, p.scale, wg_row0,
             p.s_len);
}

// The role split of flash_sm90.cuh: warpgroup 0 the producer (24 registers),
// warpgroups 1 and 2 the consumers (240).
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  const Ring ring{smem + DqSmem::bars};
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int row0 = blockIdx.x * kBlockRows;
  const int n_tiles = (p.t_len + kTile - 1) / kTile;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (threadIdx.x == 0) ring.init(1);
  __syncthreads();
  if (wg == 0) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) produce_dq(p, smem, ring, b, h, row0, n_tiles);
  } else {
    setmaxnreg_inc<240>();
    consume_dq(p, smem, ring, wg - 1, b, h, row0 + (wg - 1) * kTile, n_tiles);
  }
}

// ---------------------------------------------------------------- dk/dv

// Warp 0 of the producer warpgroup.  Lane 0 loads K and V of each consumer
// whose rows start before T, then Q_i and dO_i for every q tile i; every
// lane first writes two rows of the tile's lse * log2(e) and delta (0 past
// S) into the stage and arrives, so a stage is full after 32 arrivals and
// its bytes.
__device__ __forceinline__ void produce_dkv(const BwdParams& p, uint32_t smem,
                                            const Ring& ring, int b, int h,
                                            int row0, int n_tiles) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    prefetch_map(&p.tm_q);
    prefetch_map(&p.tm_do);
    prefetch_map(&p.tm_k);
    prefetch_map(&p.tm_v);
    const int n_wg = min(kConsumers, (p.t_len - row0 + kTile - 1) / kTile);
    mbar_expect_tx(ring.once(), n_wg * 2 * kTileBytes);
    for (int w = 0; w < n_wg; ++w) {
      tma_load(smem + DkvSmem::k + w * kTileBytes, &p.tm_k, ring.once(), h,
               row0 + w * kTile, b);
      tma_load(smem + DkvSmem::v + w * kTileBytes, &p.tm_v, ring.once(), h,
               row0 + w * kTile, b);
    }
  }
  const size_t bh = (size_t)b * p.heads + h;
  const float* lb = p.lse + bh * p.s_len;
  const float* db = p.delta + bh * p.s_len;
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    mbar_wait(ring.empty(st), ((i / kStages) & 1) ^ 1);  // round 0 passes
    const uint32_t stats = smem + DkvSmem::stats + st * DkvSmem::kStatsBytes;
#pragma unroll
    for (int r = lane; r < kTile; r += 32) {
      const int row = i * kTile + r;
      const bool ok = row < p.s_len;
      st_shared_f32(stats + 4 * r, ok ? lb[row] * kLog2e : 0.f);
      st_shared_f32(stats + 4 * (kTile + r), ok ? db[row] : 0.f);
    }
    if (lane == 0) {
      mbar_expect_tx(ring.full(st), 2 * kTileBytes);
      tma_load(smem + DkvSmem::q + st * kTileBytes, &p.tm_q, ring.full(st), h,
               i * kTile, b);
      tma_load(smem + DkvSmem::dout + st * kTileBytes, &p.tm_do,
               ring.full(st), h, i * kTile, b);
    } else {
      mbar_arrive(ring.full(st));
    }
  }
}

// Per consumer thread: dK, dV (32 regs each), S^T (32), dP^T (32) and P^T,
// dS^T as A operands (16 each) of its warpgroup's 64 kv rows.
struct DkvState {
  float dk[32], dv[32], s[32], dp[32];
  uint32_t pa[4][4], da[4][4];
};

// Q tile i: S^T_i and dP^T_i, then P^T (in s) and dS^T (in dp) in fp32, both
// rounded to bf16 A operands, then dV += P^T dO and dK += dS^T Q, waited for
// before the stage is released.  Issuing tile i+1's S^T and dP^T while these
// two products still ran (as the dq kernel does) keeps about 160 registers
// live across the issue; ptxas allocates at most the 168 that a 384-thread
// block allows (setmaxnreg does not raise that), so it serialized every
// wgmma (C7512) and the kernel ran slower on an H100.  The other consumer
// warpgroup's products fill the tensor cores while this one waits.
__device__ __forceinline__ void dkv_step(const BwdParams& p, const Ring& ring,
                                         uint32_t k_tile, uint32_t v_tile,
                                         uint32_t smem, int i, DkvState& x) {
  const int st = i % kStages;
  const uint32_t q_tile = smem + DkvSmem::q + st * kTileBytes;
  const uint32_t do_tile = smem + DkvSmem::dout + st * kTileBytes;
  const uint32_t stats = smem + DkvSmem::stats + st * DkvSmem::kStatsBytes;
  mbar_wait(ring.full(st), (i / kStages) & 1);
  issue_begin(x.s, x.dp);
  issue_qk(x.s, k_tile, q_tile);
  issue_qk(x.dp, v_tile, do_tile);
  issue_end(x.s, x.dp);
  wgmma_wait<0>();
  fence_regs(x.s);
  fence_regs(x.dp);
  // columns 8n + 2t + {0, 1} are q rows of the tile: lse and delta by column
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 l = ld_shared_f32x2(stats + 4 * (8 * n + 2 * t));
    x.s[4 * n] = exp2f(fmaf(x.s[4 * n], p.scale_log2, -l.x));
    x.s[4 * n + 1] = exp2f(fmaf(x.s[4 * n + 1], p.scale_log2, -l.y));
    x.s[4 * n + 2] = exp2f(fmaf(x.s[4 * n + 2], p.scale_log2, -l.x));
    x.s[4 * n + 3] = exp2f(fmaf(x.s[4 * n + 3], p.scale_log2, -l.y));
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 d = ld_shared_f32x2(stats + 4 * (kTile + 8 * n + 2 * t));
    x.dp[4 * n] = x.s[4 * n] * (x.dp[4 * n] - d.x);
    x.dp[4 * n + 1] = x.s[4 * n + 1] * (x.dp[4 * n + 1] - d.y);
    x.dp[4 * n + 2] = x.s[4 * n + 2] * (x.dp[4 * n + 2] - d.x);
    x.dp[4 * n + 3] = x.s[4 * n + 3] * (x.dp[4 * n + 3] - d.y);
  }
  pack_p(x.pa, x.s);
  pack_p(x.da, x.dp);
  issue_begin(x.dv, x.pa, x.dk, x.da);
  issue_pv(x.dv, x.pa, do_tile);
  issue_pv(x.dk, x.da, q_tile);
  issue_end(x.dv, x.pa, x.dk, x.da);
  wgmma_wait<0>();
  fence_regs(x.dv);
  fence_regs(x.dk);
  fence_regs(x.pa);
  fence_regs(x.da);
  release(ring.empty(st));
}

__device__ __forceinline__ void consume_dkv(const BwdParams& p, uint32_t smem,
                                            const Ring& ring, int wg, int b,
                                            int h, int wg_row0, int n_tiles) {
  const uint32_t k_tile = smem + DkvSmem::k + wg * kTileBytes;
  const uint32_t v_tile = smem + DkvSmem::v + wg * kTileBytes;
  DkvState x;
#pragma unroll
  for (int i = 0; i < 32; ++i) x.dk[i] = x.dv[i] = 0.f;
  mbar_wait(ring.once(), 0);
  for (int i = 0; i < n_tiles; ++i)
    dkv_step(p, ring, k_tile, v_tile, smem, i, x);
  store_tile(p.out0, p.o0_sb, p.o0_sl, p.o0_sh, b, h, x.dk, p.scale, wg_row0,
             p.t_len);
  store_tile(p.out1, p.o1_sb, p.o1_sl, p.o1_sh, b, h, x.dv, 1.f, wg_row0,
             p.t_len);
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  const Ring ring{smem + DkvSmem::bars};
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int row0 = blockIdx.x * kBlockRows;
  const int n_tiles = (p.s_len + kTile - 1) / kTile;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (threadIdx.x == 0) ring.init(32);
  __syncthreads();
  if (wg == 0) {
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32) produce_dkv(p, smem, ring, b, h, row0, n_tiles);
  } else {
    setmaxnreg_inc<240>();
    consume_dkv(p, smem, ring, wg - 1, b, h, row0 + (wg - 1) * kTile,
                n_tiles);
  }
}

// ------------------------------------------------------------------ host

// Encode the four or five input maps (o only for dq), fill the scalars and
// launch `kernel` (its shared-memory limit already raised to `smem_bytes`)
// over ceil(rows / 128) x B*H blocks.  `s` holds the element
// strides (sb, sl, sh) of q, k, v, o (or dO), dO (or dk), and the last
// output, in the C entries' order.
int launch_bwd(void (*kernel)(BwdParams), int smem_bytes, bool dq,
               const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* delta, void* out0,
               void* out1, int b, int h, int s_len, int t_len,
               const long long* s, float scale, void* stream) {
  if (b <= 0 || h <= 0 || s_len <= 0 || t_len <= 0 || (long long)b * h > 65535)
    return (int)cudaErrorInvalidValue;
  if (const cudaError_t err = bind_context()) return (int)err;
  BwdParams p{};
  // dq: q, k, v, o, dO, dq; dk/dv: q, k, v, dO, dk, dv
  const long long* sd = dq ? s + 12 : s + 9;
  if (!encode_map(&p.tm_q, q, b, s_len, h, s[0], s[1], s[2], kTile) ||
      !encode_map(&p.tm_k, k, b, t_len, h, s[3], s[4], s[5], kTile) ||
      !encode_map(&p.tm_v, v, b, t_len, h, s[6], s[7], s[8], kTile) ||
      !encode_map(&p.tm_do, dout, b, s_len, h, sd[0], sd[1], sd[2], kTile) ||
      (dq && !encode_map(&p.tm_o, o, b, s_len, h, s[9], s[10], s[11], kTile)))
    return (int)cudaErrorInvalidValue;
  p.out0 = static_cast<__nv_bfloat16*>(out0);
  p.out1 = static_cast<__nv_bfloat16*>(out1);
  p.o0_sb = s[dq ? 15 : 12];
  p.o0_sl = s[dq ? 16 : 13];
  p.o0_sh = s[dq ? 17 : 14];
  p.o1_sb = dq ? 0 : s[15];
  p.o1_sl = dq ? 0 : s[16];
  p.o1_sh = dq ? 0 : s[17];
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.heads = h;
  p.s_len = s_len;
  p.t_len = t_len;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  dim3 grid(((dq ? s_len : t_len) + kBlockRows - 1) / kBlockRows, b * h);
  kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.  Tensors (B, len, H, 64) bf16 with the
// element strides in `strides` (sb, sl, sh each; head_dim stride 1), lse
// and delta (B*H, S) fp32 contiguous.  Each launches on `stream`, allocates
// nothing, and returns a CUDA error code (0 = launched).
//
// dq and delta; strides of q, k, v, o, dO, dq.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq, int b,
                                 int h, int s_len, int t_len,
                                 const long long* strides, float scale,
                                 void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DqSmem::bytes);
  if (attr != cudaSuccess) return (int)attr;
  return launch_bwd(flash_bwd_dq_sm90_kernel, DqSmem::bytes, true, q, k, v, o,
                    dout, lse, delta, dq, nullptr, b, h, s_len, t_len, strides,
                    scale, stream);
}

// dk and dv from the dq kernel's delta; strides of q, k, v, dO, dk, dv.
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int b,
                                  int h, int s_len, int t_len,
                                  const long long* strides, float scale,
                                  void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DkvSmem::bytes);
  if (attr != cudaSuccess) return (int)attr;
  return launch_bwd(flash_bwd_dkv_sm90_kernel, DkvSmem::bytes, false, q, k, v,
                    nullptr, dout, lse, const_cast<void*>(delta), dk, dv, b, h,
                    s_len, t_len, strides, scale, stream);
}
