// Flash-attention backward on fp32 inputs at head_dim 512 for Hopper
// (sm_90a): the dq kernel (which also writes delta) and the dk/dv kernel,
// fp32 in and out, fp32 LSE and delta.  The SD2 VAE's mid-block (one head
// of 512) runs them when an fp32 model trains with
// VAEConfig.use_flash_attention (stage 1 in fp32, the JAX trainers'
// default precision).  The two forwards at 512 are flash_fp32_d512_sm90.cu,
// on the same cluster layout (its constants, products, loads and launch are
// flash_fp32_d512_sm90.cuh's); the other fp32 flash kernels flash_fp32.cu.
//
// Replaces the Pallas TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel`
// (both pl.pallas_call in `_flash_bwd_3d`) of
// diffute_tpu/ops/flash_attention.py on fp32 inputs at that width, in the
// natural domain as JAX computes fp32 (`log2_domain=False`):
//
//   delta = rowsum(dO * O), p = exp(s * scale - lse), ds = p (dP - delta),
//   dq = ds k * scale, dv = p^T dO, dk = ds^T q * scale, s = q k^T,
//   dP = dO v^T; p and ds stay fp32.
//
//   q, o, dO (B, S, H, 512), k, v (B, T, H, 512)  fp32, any strides TMA
//     takes (multiples of 16 bytes, the last one 1)
//   lse (B*H, S) fp32 natural log, as the forwards write it
//   delta (B*H, S) fp32: written by the dq kernel, read by the dk/dv kernel
//   dq (B, S, H, 512), dk, dv (B, T, H, 512)  fp32 through their strides
//
// The precision contract of flash_fp32.cu holds unchanged: every product
// is 3xTF32 on mma.sync.m16n8k8.tf32 (x = hi + lo, hi = cvt.rna(x), lo the
// TF32 rounding of the rest, both by integer operations that give
// cvt.rna's bits; lo_a hi_b and hi_a lo_b first, then hi hi);
// no tensor-core accumulator sums more than 32 columns of head_dim or 32
// rows of the streamed axis before an fp32 add (their accumulation rounds
// toward zero); o, dq, dk and dv within relative L2 1e-5 of the tiled
// plain fp32 version, delta within 1e-5; no float atomics, every sum in a
// fixed order, each output element written by one block: the same bits
// every run.
//
// What bounds them on the H100: operations.  3xTF32 takes three TF32
// products for one, so 494.7 TF32 TFLOP/s give 164.9 fp32 TFLOP/s; dq
// issues 6 S T D FLOPs a head (S, dP, dQ), dk/dv 8 (S, dP, dV, dK).  On-chip
// room is what shaped the first cut (flash_fp32.cu's Fp32<512, 16>): a
// 512-wide fp32 row is 2 KB, so one SM held 16-row tiles, each streamed
// byte served 16 rows (17.2 GB from L2 a launch at (4, 4096^2)), and eight
// 64-column warp slices exchanged partial scores behind two barriers a
// tile.  The products stay on mma.sync: wgmma reads a shared fp32 operand
// as its TF32 truncation, so 3xTF32 there needs each streamed tile's hi and
// lo planes beside it, which this layout's shared memory does not hold.
//
// Layout.  A cluster of four blocks (kRanks) splits head_dim: block r owns
// columns [128 r, 128 r + 128) of every tile and the cluster's kRows = 64
// resident rows (q rows for dq, kv rows for dk/dv), so each streamed byte
// serves 64 rows.  The other axis streams in kBlockKV = 32-row tiles, one
// tile the length of each dQ, dV or dK chain.  TMA loads every tile as
// boxes of 32 fp32 columns (128 bytes) with the 128-byte swizzle: column c
// of row r of a box lies at (c ^ ((r & 7) << 2)), flash_fp32.cu's pattern
// on a 32-word row, so every fragment read below hits 32 distinct banks.
// There is no producer warp: thread 0 (and, for dk/dv, warp 0's lanes,
// which copy lse and delta beside the tiles by cp.async) refill a ring
// stage once a cluster barrier has shown that every warp is done with it.
//
// A tile's scores, across the cluster, in a fixed order.  Eight warps, each
// a 32 x 32 share of a product (two m16 by four n8 tiles: every split A
// fragment serves four mma.sync, every B fragment two).  For the scores
// warp (p, h, c) computes rows [32 h, 32 h + 32) of S (p = 0; dk/dv: S^T)
// or dP (p = 1; dP^T) over the 64 columns [64 c, 64 c + 64) of the
// block's 128 as two chains of 32 from zero (kScoreChain) added in fp32,
// and stores each m16 tile through
// distributed shared memory into the receive buffer of the block that
// reduces its 16 rows, in the accumulator's layout (one float4 a lane and
// 8 columns).  After a cluster barrier, block r reduce-scatters: warps 0-3
// add each rank's two chains of rows [16 r, 16 r + 16) and sum the ranks
// in order, 0 to 3, form p and ds for those rows (a quarter of the
// exponentials each), and write them into every block's gather buffer,
// while warps 4-7 go on to the next tile's products.  (Pulling the
// partials from the other blocks instead put a remote load's round trip
// on every tile's critical path.)  After a second cluster barrier each
// warp multiplies the gathered rows [32 h, 32 h + 32) by columns [32 q,
// 32 q + 32) of the streamed tile: dQ += dS K (dk/dv: dV += p^T dO, dK +=
// dS^T Q), each 8-column block summed from zero over the tile's 32 rows
// and added in fp32.
//
// Barriers.  The two cluster barriers of tile j overlap work: between the
// arrival that publishes tile j's partials and the wait for everyone's,
// each warp runs tile j - 1's output product; between the arrival that
// publishes tile j's gathered p and ds and its wait, tile j + 1's score
// products.  The gather buffers alternate by tile parity (a block may
// still read tile j - 1's while another writes tile j's); one partial
// buffer serves every tile (tile j + 1's partials are written after the
// wait that follows every block's reads of tile j's).  Every access of a
// block's memory by another ends before the last wait of both, so no block
// exits while another may still reach it.
//
// Shared memory (232,448 bytes a block at most): dq, Q and dO slices
// resident (2 x 32 KB), K and V slices in a ring of kDqRing = 3 stages
// (3 x 32 KB), the received partials (32 KB), the gather buffer (2 x 8 KB),
// delta's partials: 209.3 KB.  dk/dv, K and V resident (64 KB), Q and dO in
// kDkvRing = 3 stages (96 KB) with each stage's 32 lse and 32 delta values,
// the received partials (32 KB), p^T's and dS^T's gather buffers (2 x 2 x
// 8 KB): 225.8 KB.  (Two blocks a cluster, 256 columns each, would need
// 64 KB a resident slice and 32 KB a streamed one: two stages of the dk/dv
// kernel do not fit.)
//
// Ragged edges.  TMA reads rows past S or T as zeros.  dq sets the scores
// of kv columns at or past T to -inf (p = 0).  dk/dv: q rows past S have
// dO = 0 and lse = delta = 0, so p = 1 and ds = 1 * (0 - 0) = 0: they add
// nothing.  Rows past the end of an output are not stored.

#include "flash_fp32_d512_sm90.cuh"

namespace {

using namespace fp32_d512;
using fp32_tma::BwdParams;

// the partial scores a block receives for its 16 rows, float4
// [product][source rank][64-column half][8-column step][lane]
constexpr int kPartBytes = 2 * 2 * kRows * kBlockKV * 4;  // 32 KB
constexpr int kDqRing = 3, kDkvRing = 3;
// the k-steps (8 head_dim columns each) of one tensor-core chain of a
// score partial: a warp's 64 columns are two chains of 32, added in
// round-to-nearest fp32.  The chains' truncation biases S toward zero by
// about what they sum: at fp32 stage-1 scores (|s| up to 78 after the
// scale) one chain of 64 put S 8.9e-6 low on average and dk 1.5e-5 from
// the backward's own function in fp64 on the deferred forward's o and LSE,
// two chains of 32 4.9e-6 and 7.2e-6, at the same speed (an H100;
// tools/fp32_d512_bwd_variants.py --chain-study)
constexpr int kScoreChain = 4;

__device__ __forceinline__ float ld_cluster_f(uint32_t addr) {
  float x;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(x)
               : "r"(addr)
               : "memory");
  return x;
}

// acc += out_tile(...), each 8-column block added in fp32.
__device__ __forceinline__ void out_part(Acc& acc, const float4* gath, int rp,
                                         const float* b, int c0) {
  Acc part;
  out_tile(part, gath, rp, b, c0);
#pragma unroll
  for (int j = 0; j < 4 * kM; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] += part[j][i];
}

// Write a warp's 32 x 32 accumulator times f as fp32 rows [row0, row0 + 32)
// (those below n_rows), columns [c0, c0 + 32), of `dst` (row stride
// `stride`).
__device__ __forceinline__ void store_rows(float* dst, long long stride,
                                           const Acc& acc, float f, int row0,
                                           int n_rows, int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const int r_lo = row0 + 16 * m + g, r_hi = r_lo + 8;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float* x = acc[4 * m + n];
      const int c = c0 + n * 8 + 2 * t;
      if (r_lo < n_rows)
        *reinterpret_cast<float2*>(dst + r_lo * stride + c) =
            make_float2(x[0] * f, x[1] * f);
      if (r_hi < n_rows)
        *reinterpret_cast<float2*>(dst + r_hi * stride + c) =
            make_float2(x[2] * f, x[3] * f);
    }
  }
}

// --------------------------------------------------------- reduce-scatter

// The reduce-scatter of a tile is warps 0-3's (kReducers threads): thread
// (kk, lane) of them takes rows g and g + 8 of rows [16 rank, 16 rank +
// 16) of the cluster's 64 (the gathered operand's row group `rank`) and the
// tile's columns 8 kk + 2t, + 1: one float4 of the accumulator layout.
// Warps 4-7 go on to the next tile's products meanwhile.  `part` is the
// float offset of its float4 in the receive buffer (product 0, rank 0),
// `gath_at` the addresses of its float4 in each rank's gather buffer
// (parity 0; the other kGathBytes on).
constexpr int kReducers = 128;

struct Reducer {
  int row, col;  // row g of the cluster's 64, column 2t of the tile
  int part;
  uint32_t gath_at[kRanks];
};

__device__ __forceinline__ Reducer reducer(const Block& t) {
  const int lane = threadIdx.x & 31, kk = (threadIdx.x >> 5) & 3;
  Reducer x;
  x.row = t.rank * 16 + (lane >> 2);
  x.col = kk * 8 + 2 * (lane & 3);
  x.part = (kk * 32 + lane) * 4;
  const uint32_t slot = ((t.rank * 4 + kk) * 32 + lane) * 16;
#pragma unroll
  for (int q = 0; q < kRanks; ++q) x.gath_at[q] = map_rank(t.gath + slot, q);
  return x;
}

// The cluster's sum of this thread's four scores of a tile (product
// `prod`) from the receive buffer `part`: each rank's two 64-column halves
// added, then the ranks in order.
__device__ __forceinline__ float4 sum_ranks(const float* part,
                                            const Reducer& x, int prod) {
  constexpr int kChainF = 4 * 32 * 4;  // floats of one half's partial
  const float* src = part + x.part + prod * kRanks * 2 * kChainF;
  float4 v[kRanks];
#pragma unroll
  for (int q = 0; q < kRanks; ++q) {
    const float4 c0 = *reinterpret_cast<const float4*>(src + 2 * q * kChainF);
    const float4 c1 =
        *reinterpret_cast<const float4*>(src + (2 * q + 1) * kChainF);
    v[q] = make_float4(c0.x + c1.x, c0.y + c1.y, c0.z + c1.z, c0.w + c1.w);
  }
  float4 s = v[0];
#pragma unroll
  for (int q = 1; q < kRanks; ++q) {
    s.x += v[q].x;
    s.y += v[q].y;
    s.z += v[q].z;
    s.w += v[q].w;
  }
  return s;
}

// Write a float4 into every rank's gather buffer (`off` bytes past the
// thread's slot).
__device__ __forceinline__ void scatter(const Reducer& x, uint32_t off,
                                        float4 v) {
#pragma unroll
  for (int q = 0; q < kRanks; ++q) st_cluster_f4(x.gath_at[q] + off, v);
}

// ------------------------------------------------------------------- dq

// Shared memory of the dq kernel: the Q and dO slices (resident), the K
// and V stages, the partials, the gather buffer's two parities, delta's
// partials and the mbarriers.
struct DqSmem {
  static constexpr int q = 0;
  static constexpr int dout = q + kResBytes;
  static constexpr int k = dout + kResBytes;
  static constexpr int v = k + kDqRing * kStreamBytes;
  static constexpr int part = v + kDqRing * kStreamBytes;
  static constexpr int gath = part + kPartBytes;
  static constexpr int dpart = gath + 2 * kGathBytes;
  static constexpr int bars = dpart + kRows * 4;
  static constexpr int bytes = bars + (1 + kDqRing) * 8 + 1024;  // + align
  static_assert(bytes <= 232448, "227 KB a block");
};

// K and V of kv tile j into stage j % kDqRing.
__device__ __forceinline__ void load_kv(const BwdParams& p, const Block& t,
                                        int j) {
  const int st = j % kDqRing;
  mbar_expect_tx(t.full(st), 2 * kStreamBytes);
  load_slice(&p.tm_k, t.ring0 + st * kStreamBytes, kStreamBox, t.full(st),
             t.col0, j * kBlockKV, t.h, t.bb);
  load_slice(&p.tm_v, t.ring1 + st * kStreamBytes, kStreamBox, t.full(st),
             t.col0, j * kBlockKV, t.h, t.bb);
}

// Tile j's reduce-scatter: this thread's four scores and dP values summed
// across the cluster, p = exp(s * scale - lse) with kv columns at or past
// T at -inf, ds = p (dP - delta), into every rank's gather buffer of
// tile j's parity.  `lse` and `delta` hold rows g and g + 8.
__device__ __forceinline__ void dq_reduce(const BwdParams& p,
                                          const float* part, const Reducer& x,
                                          int j, float2 lse, float2 delta) {
  float4 s = sum_ranks(part, x, 0);
  const float4 dp = sum_ranks(part, x, 1);
  s.x *= p.scale;
  s.y *= p.scale;
  s.z *= p.scale;
  s.w *= p.scale;
  const int col = j * kBlockKV + x.col;
  if (col >= p.t_len) s.x = s.z = -INFINITY;
  if (col + 1 >= p.t_len) s.y = s.w = -INFINITY;
  scatter(x, (j & 1) * kGathBytes,
          make_float4(expf(s.x - lse.x) * (dp.x - delta.x),
                      expf(s.y - lse.x) * (dp.y - delta.x),
                      expf(s.z - lse.y) * (dp.z - delta.y),
                      expf(s.w - lse.y) * (dp.w - delta.y)));
}

__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t smem = (raw + 1023) & ~1023u;
  float* fs = reinterpret_cast<float*>(smem_raw + (smem - raw));
  const int rank = cluster_rank();
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int q0 = (blockIdx.x / kRanks) * kRows;
  const Block t{rank, rank * kCols, (int)blockIdx.y, h, b,
                (p.t_len + kBlockKV - 1) / kBlockKV, smem + DqSmem::q,
                smem + DqSmem::dout, smem + DqSmem::k, smem + DqSmem::v,
                smem + DqSmem::part, smem + DqSmem::gath,
                smem + DqSmem::bars, 0};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the scores: product (S or dP), 32-row half, 64-column half; the
  // output: 32-row half, 32-column quarter of the block's 128
  const int prod = warp >> 2, rp = (warp >> 1) & 1, ch = warp & 1;
  const int orp = warp >> 2, cq = warp & 3;

  if (threadIdx.x == 0) init_bars(t, kDqRing, 1);
  __syncthreads();
  cluster_arrive();  // this block runs: the others may store into it
  if (threadIdx.x == 0) {
    prefetch_map(&p.tm_q);
    prefetch_map(&p.tm_do);
    prefetch_map(&p.tm_k);
    prefetch_map(&p.tm_v);
    mbar_expect_tx(t.once(), 2 * kResBytes);
    load_slice(&p.tm_q, t.res0, kResBox, t.once(), t.col0, q0, h, b);
    load_slice(&p.tm_do, t.res1, kResBox, t.once(), t.col0, q0, h, b);
    for (int j = 0; j < kDqRing && j < t.n_tiles; ++j) load_kv(p, t, j);
  }

  // ---- delta's partials: rowsum(dO * O) over this block's 128 columns of
  // the cluster's rows [8 warp, 8 warp + 8), a lane 4 columns in order,
  // then a fixed butterfly; rows past S 0.
  {
    const float* ob = p.o + b * p.o_sb + h * p.o_sh + t.col0 + 4 * lane;
    const float* db = p.dout + b * p.do_sb + h * p.do_sh + t.col0 + 4 * lane;
    float* dpart = fs + DqSmem::dpart / 4;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int rr = warp * 8 + i, row = q0 + rr;
      float acc = 0.f;
      if (row < p.s_len) {
        const float4 o4 = *reinterpret_cast<const float4*>(ob + row * p.o_ss);
        const float4 d4 =
            *reinterpret_cast<const float4*>(db + row * p.do_ss);
        acc = fmaf(o4.x, d4.x, acc);
        acc = fmaf(o4.y, d4.y, acc);
        acc = fmaf(o4.z, d4.z, acc);
        acc = fmaf(o4.w, d4.w, acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) dpart[rr] = acc;
    }
  }

  const bool reduces = threadIdx.x < kReducers;
  const Reducer x = reducer(t);
  // rows past S: lse = 0 (their dq is never stored)
  const int row = q0 + x.row;
  const float* lb = p.lse + (size_t)blockIdx.y * p.s_len;
  const float2 lse = make_float2(row < p.s_len ? lb[row] : 0.f,
                                 row + 8 < p.s_len ? lb[row + 8] : 0.f);
  const float* q_s = fs + DqSmem::q / 4;
  const float* do_s = fs + DqSmem::dout / 4;
  const float* k_s = fs + DqSmem::k / 4;
  const float* v_s = fs + DqSmem::v / 4;
  const float4* gath = reinterpret_cast<const float4*>(fs + DqSmem::gath / 4);
  const float* part = fs + DqSmem::part / 4;
  uint32_t part_dst[kM];
  part_slots(part_dst, t, prod, rp, ch);
  // this warp's product: S = Q K^T (0) or dP = dO V^T (1)
  const float* a_s = prod ? do_s : q_s;
  const float* b_s = prod ? v_s : k_s;
  constexpr int kStageF = kStreamBytes / 4;

  Acc dq, acc;
  zero_acc(dq);
  mbar_wait(t.once(), 0);

  // ---- tile 0
  mbar_wait(t.full(0), 0);
  scores_part<8, kScoreChain>(acc, a_s, 32 * rp, b_s, 64 * ch);
  cluster_wait();  // every block of the cluster runs
  put_part(part_dst, acc);
  cluster_arrive();  // tile 0's partials and delta's
  cluster_wait();
  float2 delta = make_float2(0.f, 0.f);
  if (reduces) {
    // rows g and g + 8 summed across the cluster in rank order; thread
    // (kk = 0, t = 0) writes them
    float v[2][kRanks];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int q = 0; q < kRanks; ++q)
        v[e][q] = ld_cluster_f(
            map_rank(smem + DqSmem::dpart + 4 * (x.row + 8 * e), q));
    delta = make_float2(((v[0][0] + v[0][1]) + v[0][2]) + v[0][3],
                        ((v[1][0] + v[1][1]) + v[1][2]) + v[1][3]);
    if ((threadIdx.x & 0x63) == 0) {
      float* db = p.delta + (size_t)blockIdx.y * p.s_len;
      if (row < p.s_len) db[row] = delta.x;
      if (row + 8 < p.s_len) db[row + 8] = delta.y;
    }
    dq_reduce(p, part, x, 0, lse, delta);
  }
  cluster_arrive();  // tile 0's ds gathered

  const int n = t.n_tiles;
  for (int j = 1; j < n; ++j) {
    const int st = j % kDqRing, prev = (j - 1) % kDqRing;
    mbar_wait(t.full(st), (j / kDqRing) & 1);
    scores_part<8, kScoreChain>(acc, a_s, 32 * rp, b_s + st * kStageF,
                                64 * ch);
    cluster_wait();  // tile j - 1's ds gathered, every read of its partials
                     // and of tile j - 2's stage done
    if (threadIdx.x == 0 && j >= 2 && j - 2 + kDqRing < n)
      load_kv(p, t, j - 2 + kDqRing);
    put_part(part_dst, acc);
    cluster_arrive();  // tile j's partials
    out_part(dq, gath + ((j - 1) & 1) * (kGathBytes / 16), orp,
             k_s + prev * kStageF, 32 * cq);
    cluster_wait();
    if (reduces) dq_reduce(p, part, x, j, lse, delta);
    cluster_arrive();  // tile j's ds gathered
  }
  cluster_wait();
  out_part(dq, gath + ((n - 1) & 1) * (kGathBytes / 16), orp,
           k_s + ((n - 1) % kDqRing) * kStageF, 32 * cq);

  float* dqb = p.out0 + b * p.o0_sb + h * p.o0_sh;
  store_rows(dqb, p.o0_ss, dq, p.scale, q0 + 32 * orp, p.s_len,
             t.col0 + 32 * cq);
}

// ---------------------------------------------------------------- dk/dv

// Shared memory of the dk/dv kernel: the K and V slices (resident), the Q
// and dO stages, the partials, p^T's and dS^T's gather buffers (two
// parities each), each stage's 32 lse and 32 delta values and the
// mbarriers.
struct DkvSmem {
  static constexpr int k = 0;
  static constexpr int v = k + kResBytes;
  static constexpr int q = v + kResBytes;
  static constexpr int dout = q + kDkvRing * kStreamBytes;
  static constexpr int part = dout + kDkvRing * kStreamBytes;
  static constexpr int gath = part + kPartBytes;  // p^T, then dS^T
  static constexpr int kStatsBytes = 2 * kBlockKV * 4;
  static constexpr int stats = gath + 4 * kGathBytes;
  static constexpr int bars = stats + kDkvRing * kStatsBytes;
  static constexpr int bytes = bars + (1 + kDkvRing) * 8 + 1024;  // + align
  static_assert(bytes <= 232448, "227 KB a block");
};

// Q, dO, lse and delta of q tile i into stage i % kDkvRing, by warp 0:
// every lane copies one row's lse and delta by cp.async (0 past S) and
// arrives on the stage's full barrier when they land (32 arrivals), lane 0
// expects the tiles' bytes (one more) and issues their box loads.
__device__ __forceinline__ void load_q(const BwdParams& p, const Block& t,
                                       int i) {
  const int lane = threadIdx.x & 31, st = i % kDkvRing;
  const float* lb = p.lse + (size_t)t.bh * p.s_len;
  const float* db = p.delta + (size_t)t.bh * p.s_len;
  const uint32_t dst = t.stats + st * DkvSmem::kStatsBytes + 4 * lane;
  const int r = i * kBlockKV + lane;
  const int nb = r < p.s_len ? 4 : 0, src = nb ? r : 0;
  asm volatile(
      "cp.async.ca.shared.global [%0], [%2], 4, %4;\n"
      "cp.async.ca.shared.global [%1], [%3], 4, %4;\n"
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%5];\n" ::"r"(dst),
      "r"(dst + 4 * kBlockKV), "l"(lb + src), "l"(db + src), "r"(nb),
      "r"(t.full(st))
      : "memory");
  if (lane == 0) {
    mbar_expect_tx(t.full(st), 2 * kStreamBytes);
    load_slice(&p.tm_q, t.ring0 + st * kStreamBytes, kStreamBox, t.full(st),
               t.col0, i * kBlockKV, t.h, t.bb);
    load_slice(&p.tm_do, t.ring1 + st * kStreamBytes, kStreamBox,
               t.full(st), t.col0, i * kBlockKV, t.h, t.bb);
  }
}

// Tile i's reduce-scatter: this thread's two S^T and dP^T values summed
// across the cluster; p^T = exp(s * scale - lse) and dS^T = p^T (dP^T -
// delta), lse and delta by column (the tile's q rows), into every rank's
// gather buffers.
__device__ __forceinline__ void dkv_reduce(const BwdParams& p,
                                           const float* part, const Reducer& x,
                                           int i, const float* stats) {
  const float4 s = sum_ranks(part, x, 0);
  const float4 dp = sum_ranks(part, x, 1);
  const float* sv = stats + (i % kDkvRing) * (DkvSmem::kStatsBytes / 4);
  const float2 l = *reinterpret_cast<const float2*>(sv + x.col);
  const float2 dl = *reinterpret_cast<const float2*>(sv + kBlockKV + x.col);
  const float4 pt = make_float4(
      expf(s.x * p.scale - l.x), expf(s.y * p.scale - l.y),
      expf(s.z * p.scale - l.x), expf(s.w * p.scale - l.y));
  const uint32_t par = (i & 1) * kGathBytes;
  scatter(x, par, pt);
  scatter(x, 2 * kGathBytes + par,
          make_float4(pt.x * (dp.x - dl.x), pt.y * (dp.y - dl.y),
                      pt.z * (dp.z - dl.x), pt.w * (dp.w - dl.y)));
}

__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t smem = (raw + 1023) & ~1023u;
  float* fs = reinterpret_cast<float*>(smem_raw + (smem - raw));
  const int rank = cluster_rank();
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int kv0 = (blockIdx.x / kRanks) * kRows;
  const Block t{rank, rank * kCols, (int)blockIdx.y, h, b,
                (p.s_len + kBlockKV - 1) / kBlockKV, smem + DkvSmem::k,
                smem + DkvSmem::v, smem + DkvSmem::q, smem + DkvSmem::dout,
                smem + DkvSmem::part, smem + DkvSmem::gath,
                smem + DkvSmem::bars, smem + DkvSmem::stats};
  const int warp = threadIdx.x >> 5;
  // the scores: product (S^T or dP^T), 32-row half, 64-column half; the
  // outputs: 32-row half, 32-column quarter of the block's 128
  const int prod = warp >> 2, rp = (warp >> 1) & 1, ch = warp & 1;
  const int orp = warp >> 2, cq = warp & 3;

  // a stage is full after its 32 lanes' cp.async arrivals, lane 0's
  // expect_tx and the tiles' bytes
  if (threadIdx.x == 0) init_bars(t, kDkvRing, kBlockKV + 1);
  __syncthreads();
  cluster_arrive();  // this block runs: the others may store into it
  if (warp == 0) {
    if (threadIdx.x == 0) {
      prefetch_map(&p.tm_k);
      prefetch_map(&p.tm_v);
      prefetch_map(&p.tm_q);
      prefetch_map(&p.tm_do);
      mbar_expect_tx(t.once(), 2 * kResBytes);
      load_slice(&p.tm_k, t.res0, kResBox, t.once(), t.col0, kv0, h, b);
      load_slice(&p.tm_v, t.res1, kResBox, t.once(), t.col0, kv0, h, b);
    }
    for (int i = 0; i < kDkvRing && i < t.n_tiles; ++i) load_q(p, t, i);
  }

  const bool reduces = threadIdx.x < kReducers;
  const Reducer x = reducer(t);
  const float* k_s = fs + DkvSmem::k / 4;
  const float* v_s = fs + DkvSmem::v / 4;
  const float* q_s = fs + DkvSmem::q / 4;
  const float* do_s = fs + DkvSmem::dout / 4;
  const float* stats = fs + DkvSmem::stats / 4;
  const float4* gath_p =
      reinterpret_cast<const float4*>(fs + DkvSmem::gath / 4);
  const float4* gath_ds = gath_p + 2 * (kGathBytes / 16);
  const float* part = fs + DkvSmem::part / 4;
  uint32_t part_dst[kM];
  part_slots(part_dst, t, prod, rp, ch);
  // this warp's product: S^T = K Q^T (0) or dP^T = V dO^T (1)
  const float* a_s = prod ? v_s : k_s;
  const float* b_s = prod ? do_s : q_s;
  constexpr int kStageF = kStreamBytes / 4;

  Acc dk, dv, acc;
  zero_acc(dk);
  zero_acc(dv);
  mbar_wait(t.once(), 0);

  // ---- q tile 0
  mbar_wait(t.full(0), 0);
  scores_part<8, kScoreChain>(acc, a_s, 32 * rp, b_s, 64 * ch);
  cluster_wait();  // every block of the cluster runs
  put_part(part_dst, acc);
  cluster_arrive();  // tile 0's partials
  cluster_wait();
  if (reduces) dkv_reduce(p, part, x, 0, stats);
  cluster_arrive();  // tile 0's p^T and dS^T gathered

  const int n = t.n_tiles;
  for (int i = 1; i < n; ++i) {
    const int st = i % kDkvRing, prev = (i - 1) % kDkvRing;
    mbar_wait(t.full(st), (i / kDkvRing) & 1);
    scores_part<8, kScoreChain>(acc, a_s, 32 * rp, b_s + st * kStageF,
                                64 * ch);
    cluster_wait();  // tile i - 1's p^T and dS^T gathered, every read of
                     // its partials and of tile i - 2's stage done
    if (warp == 0 && i >= 2 && i - 2 + kDkvRing < n)
      load_q(p, t, i - 2 + kDkvRing);
    put_part(part_dst, acc);
    cluster_arrive();  // tile i's partials
    const int par = ((i - 1) & 1) * (kGathBytes / 16);
    out_part(dv, gath_p + par, orp, do_s + prev * kStageF, 32 * cq);
    out_part(dk, gath_ds + par, orp, q_s + prev * kStageF, 32 * cq);
    cluster_wait();
    if (reduces) dkv_reduce(p, part, x, i, stats);
    cluster_arrive();  // tile i's p^T and dS^T gathered
  }
  cluster_wait();
  const int last = (n - 1) % kDkvRing, par = ((n - 1) & 1) * (kGathBytes / 16);
  out_part(dv, gath_p + par, orp, do_s + last * kStageF, 32 * cq);
  out_part(dk, gath_ds + par, orp, q_s + last * kStageF, 32 * cq);

  const int row0 = kv0 + 32 * orp, c0 = t.col0 + 32 * cq;
  store_rows(p.out0 + b * p.o0_sb + h * p.o0_sh, p.o0_ss, dk, p.scale, row0,
             p.t_len, c0);
  store_rows(p.out1 + b * p.o1_sb + h * p.o1_sh, p.o1_ss, dv, 1.f, row0,
             p.t_len, c0);
}

// ------------------------------------------------------------------ host

// Fill the parameter (the resident tensors' boxes kRows rows, the streamed
// ones' kBlockKV) and launch over clusters of kRanks blocks.
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
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(dq ? s_len : t_len, b * h, smem_bytes,
                     static_cast<cudaStream_t>(stream), &attr);
  void* args[] = {&p};
  const cudaError_t err =
      cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes, with the other backward entries'
// argument lists.  Tensors (B, len, H, 512) fp32 with the element strides
// in `strides` (sb, sl, sh each; head_dim stride 1), lse and delta (B*H,
// S) fp32 contiguous.  Each launches on `stream`, allocates nothing, and
// returns a CUDA error code (0 = launched).
//
// dq and delta; strides of q, k, v, o, dO, dq.
extern "C" int flash_bwd_dq_d512_fp32(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* delta, void* dq, int b, int h,
                                      int s_len, int t_len,
                                      const long long* strides, float scale,
                                      void* stream) {
  static const cudaError_t attr = allow_smem(dq_kernel, DqSmem::bytes);
  if (attr != cudaSuccess) return (int)attr;
  return launch_bwd(dq_kernel, DqSmem::bytes, true, q, k, v, o, dout, lse,
                    delta, dq, nullptr, b, h, s_len, t_len, strides, scale,
                    stream);
}

// dk and dv from the dq kernel's delta; strides of q, k, v, dO, dk, dv.
extern "C" int flash_bwd_dkv_d512_fp32(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int b, int h,
                                       int s_len, int t_len,
                                       const long long* strides, float scale,
                                       void* stream) {
  static const cudaError_t attr = allow_smem(dkv_kernel, DkvSmem::bytes);
  if (attr != cudaSuccess) return (int)attr;
  return launch_bwd(dkv_kernel, DkvSmem::bytes, false, q, k, v, nullptr,
                    dout, lse, const_cast<void*>(delta), dk, dv, b, h, s_len,
                    t_len, strides, scale, stream);
}

// cudaOccupancyMaxActiveClusters of the dq (dkv = 0) or the dk/dv kernel
// (dkv = 1): the clusters of kRanks blocks the card runs at once; a
// negative CUDA error code if the query fails.
extern "C" int flash_bwd_d512_fp32_max_clusters(int dkv) {
  return dkv ? max_clusters(dkv_kernel, DkvSmem::bytes)
             : max_clusters(dq_kernel, DqSmem::bytes);
}
