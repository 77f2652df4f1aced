// Flash-attention backward at head_dim 256 on fp32 inputs for Hopper
// (sm_90a): the dq kernel (which also writes delta) and the dk/dv kernel,
// fp32 in and out, fp32 LSE and delta.  The small VAE's mid-block
// (small_config, one head of 256) runs them when an fp32 model trains with
// VAEConfig.use_flash_attention: 2 pairs at (B*H, S, T) = (16, 4096, 4096)
// a stage-1 step at batch 16.  The two forwards at 256 are
// flash_fp32_d256_sm90.cu, on the same cluster layout and the same score
// code (flash_fp32_d256_sm90.cuh), so the p this pair recomputes and the
// LSE the forward wrote come from the same bits of S.
//
// Replaces the Pallas TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel`
// (both pl.pallas_call in `_flash_bwd_3d`) of
// diffute_tpu/ops/flash_attention.py on fp32 inputs at that width, in the
// natural domain (JAX's `log2_domain=False` for fp32):
//
//   p = exp(s * scale - lse), ds = p (dO v^T - delta), dq = ds k * scale,
//   dv = p^T dO, dk = ds^T q * scale, delta = rowsum(dO * O)
//
// The precision contract of every fp32 kernel (flash_fp32.cu's head):
//   * every product is 3xTF32: each operand x split into hi = tf32(x) to
//     nearest and lo = tf32(x - hi), a b = lo_a hi_b + hi_a lo_b + hi_a
//     hi_b (the small terms first), accumulated in fp32;
//   * the tensor cores' fp32 accumulation rounds toward zero, so no
//     tensor-core sum is longer than 32 columns of head_dim or 32 rows of
//     the streamed axis: a block's 64 columns of S or dP are two chains of
//     32 (4 k-steps x 3) added in fp32 (kScoreChain of
//     flash_fp32_d512_bwd_sm90.cu: one chain of 64 put S 8.9e-6 low at
//     stage-1 scores there), the four blocks' partials summed in rank
//     order, 0 to 3, as the first cut summed its four 64-column slices; each
//     part of ds k, p^T dO and ds^T q one 32-row streamed tile (12 products)
//     from zero, then added to dq, dv or dk by an fp32 add;
//   * p and ds stay fp32; delta is summed in the first cut's order (a lane
//     columns c * 32 + lane by fmaf, then a butterfly over the warp), so it
//     keeps those bits.
//
//   q, o, dO (B, S, H, 256), k, v (B, T, H, 256) fp32, any strides TMA takes
//     (multiples of 16 bytes, the last one 1)
//   lse (B*H, S) fp32 natural log, as the forwards write it
//   delta (B*H, S) fp32: written by the dq kernel, read by the dk/dv kernel
//   dq (B, S, H, 256), dk, dv (B, T, H, 256) fp32 through their strides
//
// What bounds them on the H100: operations.  3xTF32 takes three TF32
// products for one, so 494.7 TF32 TFLOP/s give 164.9 at best.  tf32 wgmma
// takes both operands K-major only and reads an operand in shared memory as
// its TF32 truncation (tf32_wgmma_sm90.cuh), so each operand needs hi and
// lo planes, and each kernel's second product a transposed pair.  At 256 a
// 64-row fp32 plane is 64 KB: Q and dO as hi and lo planes alone would
// fill a block.  So:
//
// Layout (flash_fp32_d256_sm90.cuh: its constants, the score products and
// the exchange).  A cluster of four blocks (kRanks) splits head_dim: block r owns
// columns [64 r, 64 r + 64) of every tile and the cluster's kRows = 64
// resident rows (q rows for dq, kv rows for dk/dv); the other axis streams
// in kBlockKV = 32-row tiles.  Inside a block, flash_fp32_d64_bwd_sm90.cu's
// schedule on its 64 columns: a producer warpgroup (warpgroup 0) loads
// every tile by TMA through the strides (boxes of 32 fp32 columns, 128-byte
// swizzle, rows past S or T read as zeros) and splits it once: the natural
// hi plane in place of the raw tile, the lo plane beside it, and for the
// streamed operand of the second product the transposed pair, in the
// permuted order the score's register A takes.  The natural planes and the
// transposed ones are two rings of two stages each, released apart (the
// natural ones when a tile's score products retire, the transposed ones
// when its output product does), so a consumer issues the next tile's
// scores while this tile's exchange runs.
//
// The exchange, per streamed tile, without a cluster barrier.  Each
// consumer warp w holds 16 rows of its block's 64-column partial of S and
// dP (dk/dv: S^T and dP^T) and stores them with st.async into the receive
// buffer of block w, which reduces rows [16 w, 16 w + 16) (a reduce-scatter,
// 2 KB a product from each rank); the stores complete on that block's
// receive mbarrier.  Block r's reducers wait on it, sum the ranks in order,
// form p and ds for their rows (dq: ds; dk/dv: p^T by warpgroup A, dS^T by
// B), and store them with st.async into every block's gather buffer, in the
// accumulator layout the owning warp's register A takes, completing on
// that block's gather mbarrier.  Single buffers suffice: a block sends a
// tile's partials only after it has read the previous tile's gathered
// operand, which every reducer sent only after reading the previous
// partials.  Each phase of an exchange mbarrier is armed (one arrival with
// the expected bytes) by a thread that has waited on the phase before it,
// before that thread's own stores that the new phase waits for, so no
// byte of a phase can land before its phase is armed, and no phase can
// complete before every thread has seen the one before it.  One cluster
// barrier at the start (every block's mbarriers initialised) and one at
// the end.  The exchange's two remote trips a tile run under the next
// tile's score products: dq with two buffers of each, tile j + 1's
// partials sent before tile j's ds was waited for, ran no faster (7.70
// against 7.82 ms at (16, 4096^2), on an H100 in separate calls).  By
// count, shared-memory bandwidth holds the pair (PERF.md): a dq block
// moves about 300 KB a tile through it (the score products' A and B 144
// KB, the producer's reads and splits 72 KB, the exchange 48 KB), dk/dv
// about 370, near 1.2 and 1.5 us a tile at 128 bytes a clock.
//
// dq kernel (dq_kernel, 256 threads): one consumer warpgroup of the 64 q
// rows; Q and dO resident as planes (64 KB), K and V natural (32 KB a
// stage), K^T (16 KB a stage).  Per kv tile j: S_{j+1} and dP_{j+1}
// issued, tile j - 1's dQ part retired (added, its K^T stage released),
// tile j's reduce, its gathered ds split into A fragments, dQ's part dS K_j
// issued, S_{j+1} and dP_{j+1} retired and sent.  delta: each block its 16
// reduced rows from O and dO in L2 before the first tile.
//
// dk/dv kernel (dkv_kernel, 384 threads): two consumer warpgroups share the
// block's 64 kv rows by role (flash_fp32_d64_bwd_sm90.cu's split): A
// computes S^T = K Q^T, reduces p^T = exp(S^T * scale - lse) and runs dV
// += p^T dO; B computes dP^T = V dO^T, reduces dS^T = p^T (dP^T - delta)
// (p^T again from the same sums: the same bits) and runs dK += dS^T Q.  K
// and V resident as planes (64 KB); Q and dO natural (32 KB a stage); Q^T
// and dO^T (32 KB a stage) with the tile's 32 lse and 32 delta values,
// which the producer copies beside them (zeros past S).
//
// Shared memory: dq 189,616 B, dk/dv 231,024 B: one block an SM.
//
// Ragged edges.  TMA reads rows past S or T as zeros.  dq: the reduce sets
// scores at or past T to -inf, so p = 0; q rows past S have lse = delta =
// 0 and dO = 0, so ds = 0.  dk/dv: q rows past S have dO = 0 and lse =
// delta = 0, so p = exp(0) = 1 and ds = 1 * (0 - 0) = 0: they add nothing.
// Rows past the end of an output are not stored.

#include "flash_fp32_d256_sm90.cuh"

namespace {

using namespace fp32_d256;
using fp32_tma::BwdParams;
using cluster_sm90::cluster_arrive;
using cluster_sm90::cluster_rank;
using cluster_sm90::cluster_wait;
using cluster_sm90::mbar_wait_cluster;

// what a reducer receives a tile: float4 [product][rank][n-tile][lane]
constexpr int kRecvBytes = 2 * kRanks * kWarpPart;     // 16 KB
// named barriers: the producer's split, the dq consumer's delta
constexpr int kSplitBar = 1, kDeltaBar = 2;

// ------------------------------------------------------------------- dq

// Shared memory of the dq kernel: Q's and dO's planes (hi, lo each), the
// natural ring (K, V; hi and lo each), the transposed ring (K^T), the
// receive and gather buffers, the reduced rows' delta, the mbarriers.
struct DqSmem {
  static constexpr int q = 0;  // hi; lo kRes further
  static constexpr int dout = 2 * kRes;
  static constexpr int nat = 4 * kRes;
  static constexpr int k = 0, v = 2 * kPlane;   // in a natural stage
  static constexpr int kNatStage = 4 * kPlane;  // 32 KB
  static constexpr int tr = nat + kRing * kNatStage;
  static constexpr int kTrStage = 2 * kPlane;   // 16 KB: K^T
  static constexpr int recv = tr + kRing * kTrStage;
  static constexpr int gath = recv + kRecvBytes;
  static constexpr int delta = gath + kGathBytes;
  static constexpr int bars = delta + 16 * 4;
  static constexpr int bytes = bars + kBarBytes + 1024;  // + alignment
  static_assert(bytes <= 232448, "227 KB a block");
};

// K and V of kv tile i into its natural stage, completing on full.
__device__ __forceinline__ void load_kv(const BwdParams& p, uint32_t smem,
                                        const BarrierSet& bars, const Block& t,
                                        int i) {
  const int st = i % kRing;
  const uint32_t stage = smem + DqSmem::nat + st * DqSmem::kNatStage;
  mbar_expect_tx(bars.full(st), 2 * kPlane);
  load_plane(&p.tm_k, stage + DqSmem::k, kStreamBox, bars.full(st),
             t.col0, i * kBlockKV, t.h, t.b);
  load_plane(&p.tm_v, stage + DqSmem::v, kStreamBox, bars.full(st),
             t.col0, i * kBlockKV, t.h, t.b);
}

// The producer warpgroup of the dq kernel: Q and dO once; then each kv
// tile i split once, natural planes first; thread 0 loads tile i + 1 into
// the other natural stage once tile i - 1's scores released it, and the
// warpgroup writes tile i's K^T once tile i - 2's output product released
// its transposed stage.
__device__ __forceinline__ void dq_produce(const BwdParams& p, uint32_t smem,
                                           const BarrierSet& bars, const Block& t) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    prefetch_map(&p.tm_q);
    prefetch_map(&p.tm_do);
    prefetch_map(&p.tm_k);
    prefetch_map(&p.tm_v);
    mbar_expect_tx(bars.res_full(), 2 * kRes);
    load_plane(&p.tm_q, smem + DqSmem::q, kResBox, bars.res_full(),
               t.col0, t.row0, t.h, t.b);
    load_plane(&p.tm_do, smem + DqSmem::dout, kResBox, bars.res_full(),
               t.col0, t.row0, t.h, t.b);
    load_kv(p, smem, bars, t, 0);
  }
  mbar_wait(bars.res_full(), 0);
  split_plane(smem + DqSmem::q, kRes, tid);
  split_plane(smem + DqSmem::dout, kRes, tid);
  fence_proxy_async();
  mbar_arrive(bars.res_ready());
  for (int i = 0; i < t.n_tiles; ++i) {
    const int st = i % kRing, ph = (i / kRing) & 1;
    const uint32_t nat = smem + DqSmem::nat + st * DqSmem::kNatStage;
    const uint32_t tr = smem + DqSmem::tr + st * DqSmem::kTrStage;
    StreamRaw<2, 1> raw;
    mbar_wait(bars.full(st), ph);
    read_stream<2, 1>({nat + DqSmem::k, nat + DqSmem::v}, raw, tid);
    warpgroup_sync(kSplitBar);
    write_natural<2, 1>({nat + DqSmem::k, nat + DqSmem::v}, raw, tid);
    fence_proxy_async();
    mbar_arrive(bars.nat_ready(st));
    if (tid == 0 && i + 1 < t.n_tiles) {
      if (i >= 1) mbar_wait(bars.nat_empty((i + 1) % kRing),
                            ((i - 1) / kRing) & 1);
      load_kv(p, smem, bars, t, i + 1);
    }
    if (i >= kRing) mbar_wait(bars.tr_empty(st), ph ^ 1);
    write_transposed<2, 1>({tr}, raw, tid);
    fence_proxy_async();
    mbar_arrive(bars.tr_ready(st));
  }
}

// delta = rowsum(dO * O) in fp32 of the block's 16 reduced rows [row0 +
// 16 rank, + 16), four a warp, as the first cut sums it: lane l takes
// columns c * 32 + l by fmaf, then a butterfly over the warp (every lane
// the same sum); written out for the dk/dv kernel and into `dst` (shared,
// 16 floats).  Rows past S: 0.
__device__ __forceinline__ void reduced_deltas(const BwdParams& p,
                                               const Block& t, uint32_t dst) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const float* ob = p.o + t.b * p.o_sb + t.h * p.o_sh + lane;
  const float* db = p.dout + t.b * p.do_sb + t.h * p.do_sh + lane;
  float* out = p.delta + (size_t)(t.b * p.heads + t.h) * p.s_len;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = 16 * t.rank + 4 * warp + i, row = t.row0 + rr;
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
    if (lane == 0) {
      st_shared_f32(dst + 4 * (4 * warp + i), acc);
      if (row < p.s_len) out[row] = acc;
    }
  }
}

// Per thread: S's and dP's two chains (16 registers each), the dQ part and
// dq (32 each), dS's A fragments (hi and lo, 16 each); as a reducer its
// rows' lse and delta.
struct DqState {
  float sa[kS], sb[kS], pa[kS], pb[kS], part[32], dq[32];
  uint32_t hi[kSteps][4], lo[kSteps][4];
  float2 lse, delta;
};

// Tile j's reduce on this block's 16 rows: S and dP summed across the
// cluster, p = exp(s * scale - lse) with kv columns at or past T at -inf,
// ds = p (dP - delta), into every block's gather buffer.
__device__ __forceinline__ void dq_reduce(const BwdParams& p, uint32_t recv,
                                          const BarrierSet& bars, const Exchange& x,
                                          const DqState& st, int j,
                                          int n_tiles) {
  mbar_wait_cluster(bars.recv(), j & 1);
  if ((threadIdx.x & 127) == 0 && j + 1 < n_tiles)
    mbar_expect_tx(bars.recv(), kRecvBytes);
  float4 s = sum_ranks(recv, 0);
  const float4 dp = sum_ranks(recv, 1);
  s.x *= p.scale;
  s.y *= p.scale;
  s.z *= p.scale;
  s.w *= p.scale;
  const int col = j * kBlockKV + ((threadIdx.x >> 5) & 3) * 8 +
                  2 * (threadIdx.x & 3);
  if (col >= p.t_len) s.x = s.z = -INFINITY;
  if (col + 1 >= p.t_len) s.y = s.w = -INFINITY;
  scatter(x, 0,
          make_float4(expf(s.x - st.lse.x) * (dp.x - st.delta.x),
                      expf(s.y - st.lse.x) * (dp.y - st.delta.x),
                      expf(s.z - st.lse.y) * (dp.z - st.delta.y),
                      expf(s.w - st.lse.y) * (dp.w - st.delta.y)));
}

// grid (4 ceil(S / 64), B*H) in clusters of four: warpgroup 0 produces, 1
// consumes the cluster's 64 q rows over the block's 64 columns.
__global__ void __launch_bounds__(256, 1)
    dq_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int rank = cluster_rank();
  const Block t{rank,
                rank * kCols,
                (int)blockIdx.y / p.heads,
                (int)blockIdx.y % p.heads,
                (int)(blockIdx.x / kRanks) * kRows,
                (p.t_len + kBlockKV - 1) / kBlockKV};
  const BarrierSet bars{smem + DqSmem::bars};
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (threadIdx.x == 0) bars.init(4, kRecvBytes, kGathBytes);
  __syncthreads();
  cluster_arrive();  // every block's mbarriers initialised and armed
  cluster_wait();
  if (wg == 0) {
    dq_produce(p, smem, bars, t);
  } else {
    const int n = t.n_tiles;
    const uint32_t recv = smem + DqSmem::recv, gath = smem + DqSmem::gath;
    const Exchange x = exchange(t, recv, gath, bars);
    DqState st;
    reduced_deltas(p, t, smem + DqSmem::delta);
    warpgroup_sync(kDeltaBar);
    {
      // this reducer's rows g and g + 8 of the block's 16; past S lse = 0
      const int g = (threadIdx.x & 31) >> 2;
      const int row = t.row0 + 16 * rank + g;
      const float* lb = p.lse + (size_t)blockIdx.y * p.s_len;
      st.lse = make_float2(row < p.s_len ? lb[row] : 0.f,
                           row + 8 < p.s_len ? lb[row + 8] : 0.f);
      st.delta = make_float2(ld_shared_f32(smem + DqSmem::delta + 4 * g),
                             ld_shared_f32(smem + DqSmem::delta +
                                           4 * (g + 8)));
    }
    zero(st.dq);
    const uint32_t q_hi = smem + DqSmem::q, do_hi = smem + DqSmem::dout;
    mbar_wait(bars.res_ready(), 0);

    // tile 0's scores, sent
    mbar_wait(bars.nat_ready(0), 0);
    issue_begin(st.sa, st.sb, st.pa, st.pb);
    issue_scores(st.sa, st.sb, q_hi, q_hi + kRes, smem + DqSmem::nat,
                 smem + DqSmem::nat + kPlane);
    issue_scores(st.pa, st.pb, do_hi, do_hi + kRes,
                 smem + DqSmem::nat + DqSmem::v,
                 smem + DqSmem::nat + DqSmem::v + kPlane);
    issue_end(st.sa, st.sb, st.pa, st.pb);
    wgmma_wait<0>();
    fence_regs(st.sa);
    fence_regs(st.sb);
    fence_regs(st.pa);
    fence_regs(st.pb);
    release_warp(bars.nat_empty(0));
    send_part(x.part_at, x.part_bar, st.sa, st.sb);
    send_part(x.part_at + kRanks * kWarpPart, x.part_bar, st.pa, st.pb);

    for (int j = 0; j < n; ++j) {
      const bool more = j + 1 < n;
      if (more) {
        const int s1 = (j + 1) % kRing;
        const uint32_t nat = smem + DqSmem::nat + s1 * DqSmem::kNatStage;
        mbar_wait(bars.nat_ready(s1), ((j + 1) / kRing) & 1);
        issue_begin(st.sa, st.sb, st.pa, st.pb);
        issue_scores(st.sa, st.sb, q_hi, q_hi + kRes, nat + DqSmem::k,
                     nat + DqSmem::k + kPlane);
        issue_scores(st.pa, st.pb, do_hi, do_hi + kRes, nat + DqSmem::v,
                     nat + DqSmem::v + kPlane);
        issue_end(st.sa, st.sb, st.pa, st.pb);
      }
      if (j >= 1) {
        // tile j - 1's dQ part
        if (more)
          wgmma_wait<1>();
        else
          wgmma_wait<0>();
        fence_regs(st.part);
        fence_regs(st.hi);
        fence_regs(st.lo);
        add_part(st.dq, st.part);
        release_warp(bars.tr_empty((j - 1) % kRing));
      }
      dq_reduce(p, recv, bars, x, st, j, n);
      mbar_wait_cluster(bars.gath(), j & 1);
      if ((threadIdx.x & 127) == 0 && more)
        mbar_expect_tx(bars.gath(), kGathBytes);
      gathered_frags(gath, st.hi, st.lo);
      const int s0 = j % kRing;
      const uint32_t kt = smem + DqSmem::tr + s0 * DqSmem::kTrStage;
      mbar_wait(bars.tr_ready(s0), (j / kRing) & 1);
      issue_begin(st.part, st.hi, st.lo);
      issue_out(st.part, st.hi, st.lo, kt, kt + kPlane);
      issue_end(st.part, st.hi, st.lo);
      if (more) {
        wgmma_wait<1>();
        fence_regs(st.sa);
        fence_regs(st.sb);
        fence_regs(st.pa);
        fence_regs(st.pb);
        release_warp(bars.nat_empty((j + 1) % kRing));
        send_part(x.part_at, x.part_bar, st.sa, st.sb);
        send_part(x.part_at + kRanks * kWarpPart, x.part_bar, st.pa, st.pb);
      }
    }
    wgmma_wait<0>();
    fence_regs(st.part);
    fence_regs(st.hi);
    fence_regs(st.lo);
    add_part(st.dq, st.part);
    store_rows(p.out0, p.o0_sb, p.o0_ss, p.o0_sh, t.b, t.h, t.col0, st.dq,
               p.scale, t.row0, p.s_len);
  }
  // no block leaves while another may still store into it
  cluster_arrive();
  cluster_wait();
}

// ---------------------------------------------------------------- dk/dv

// Shared memory of the dk/dv kernel: K's and V's planes (hi, lo each), the
// natural ring (Q, dO), the transposed ring (Q^T, dO^T), the receive
// buffer, the gather buffers of p^T and dS^T, each transposed stage's 32
// lse and 32 delta values, the mbarriers.
struct DkvSmem {
  static constexpr int k = 0;  // hi; lo kRes further
  static constexpr int v = 2 * kRes;
  static constexpr int nat = 4 * kRes;
  static constexpr int q = 0, dout = 2 * kPlane;  // in a natural stage
  static constexpr int kNatStage = 4 * kPlane;    // 32 KB
  static constexpr int tr = nat + kRing * kNatStage;
  static constexpr int qt = 0, dot = 2 * kPlane;  // in a transposed stage
  static constexpr int kTrStage = 4 * kPlane;     // 32 KB
  static constexpr int recv = tr + kRing * kTrStage;
  static constexpr int gath_p = recv + kRecvBytes;
  static constexpr int gath_ds = gath_p + kGathBytes;
  static constexpr int kStats = 2 * kBlockKV * 4;  // lse, delta
  static constexpr int stats = gath_ds + kGathBytes;
  static constexpr int bars = stats + kRing * kStats;
  static constexpr int bytes = bars + kBarBytes + 1024;  // + alignment
  static_assert(bytes <= 232448, "227 KB a block");
};

// Q and dO of q tile i into its natural stage, completing on full.
__device__ __forceinline__ void load_q(const BwdParams& p, uint32_t smem,
                                       const BarrierSet& bars, const Block& t,
                                       int i) {
  const int st = i % kRing;
  const uint32_t stage = smem + DkvSmem::nat + st * DkvSmem::kNatStage;
  mbar_expect_tx(bars.full(st), 2 * kPlane);
  load_plane(&p.tm_q, stage + DkvSmem::q, kStreamBox, bars.full(st),
             t.col0, i * kBlockKV, t.h, t.b);
  load_plane(&p.tm_do, stage + DkvSmem::dout, kStreamBox, bars.full(st),
             t.col0, i * kBlockKV, t.h, t.b);
}

// The producer warpgroup of the dk/dv kernel: K and V once, then each q
// tile as dq_produce's kv tiles, Q^T and dO^T with the tile's lse and
// delta (threads 0-63, zeros past S).
__device__ __forceinline__ void dkv_produce(const BwdParams& p,
                                            uint32_t smem, const BarrierSet& bars,
                                            const Block& t) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    prefetch_map(&p.tm_q);
    prefetch_map(&p.tm_do);
    prefetch_map(&p.tm_k);
    prefetch_map(&p.tm_v);
    mbar_expect_tx(bars.res_full(), 2 * kRes);
    load_plane(&p.tm_k, smem + DkvSmem::k, kResBox, bars.res_full(),
               t.col0, t.row0, t.h, t.b);
    load_plane(&p.tm_v, smem + DkvSmem::v, kResBox, bars.res_full(),
               t.col0, t.row0, t.h, t.b);
    load_q(p, smem, bars, t, 0);
  }
  mbar_wait(bars.res_full(), 0);
  split_plane(smem + DkvSmem::k, kRes, tid);
  split_plane(smem + DkvSmem::v, kRes, tid);
  fence_proxy_async();
  mbar_arrive(bars.res_ready());
  const size_t bh = (size_t)(t.b * p.heads + t.h) * p.s_len;
  const float* stat = (tid < kBlockKV ? p.lse : p.delta) + bh;
  for (int i = 0; i < t.n_tiles; ++i) {
    const int st = i % kRing, ph = (i / kRing) & 1;
    const uint32_t nat = smem + DkvSmem::nat + st * DkvSmem::kNatStage;
    const uint32_t tr = smem + DkvSmem::tr + st * DkvSmem::kTrStage;
    const int r = i * kBlockKV + (tid & (kBlockKV - 1));
    const float sv = tid < 2 * kBlockKV && r < p.s_len ? stat[r] : 0.f;
    StreamRaw<2, 2> raw;
    mbar_wait(bars.full(st), ph);
    read_stream<2, 2>({nat + DkvSmem::q, nat + DkvSmem::dout}, raw, tid);
    warpgroup_sync(kSplitBar);
    write_natural<2, 2>({nat + DkvSmem::q, nat + DkvSmem::dout}, raw, tid);
    fence_proxy_async();
    mbar_arrive(bars.nat_ready(st));
    if (tid == 0 && i + 1 < t.n_tiles) {
      if (i >= 1) mbar_wait(bars.nat_empty((i + 1) % kRing),
                            ((i - 1) / kRing) & 1);
      load_q(p, smem, bars, t, i + 1);
    }
    if (i >= kRing) mbar_wait(bars.tr_empty(st), ph ^ 1);
    write_transposed<2, 2>({tr + DkvSmem::qt, tr + DkvSmem::dot}, raw, tid);
    if (tid < 2 * kBlockKV)
      st_shared_f32(smem + DkvSmem::stats + st * DkvSmem::kStats + tid * 4,
                    sv);
    fence_proxy_async();
    mbar_arrive(bars.tr_ready(st));
  }
}

// Per thread: its role's score product as two chains (16 registers each),
// its part and accumulator (dV for A, dK for B; 32 each), the output
// product's A fragments (hi and lo, 16 each).
struct DkvState {
  float sa[kS], sb[kS], part[32], acc[32];
  uint32_t hi[kSteps][4], lo[kSteps][4];
};

// Q tile i's reduce on this block's 16 kv rows, columns the tile's q rows
// (lse and delta by column from the transposed stage's statistics): A,
// p^T = exp(S^T * scale - lse) into every block's p^T gather buffer; B,
// dS^T = p^T (dP^T - delta) into the dS^T one.
__device__ __forceinline__ void dkv_reduce(const BwdParams& p, uint32_t smem,
                                           const BarrierSet& bars,
                                           const Exchange& x, bool role_a,
                                           int i, int n_tiles) {
  const uint32_t recv = smem + DkvSmem::recv;
  mbar_wait_cluster(bars.recv(), i & 1);
  if (threadIdx.x == 128 && i + 1 < n_tiles)
    mbar_expect_tx(bars.recv(), kRecvBytes);
  const float4 s = sum_ranks(recv, 0);
  const uint32_t sv = smem + DkvSmem::stats + (i % kRing) * DkvSmem::kStats +
                      4 * (((threadIdx.x >> 5) & 3) * 8 +
                           2 * (threadIdx.x & 3));
  const float2 l = ld_shared_f32x2(sv);
  const float4 pt = make_float4(
      expf(s.x * p.scale - l.x), expf(s.y * p.scale - l.y),
      expf(s.z * p.scale - l.x), expf(s.w * p.scale - l.y));
  if (role_a) {
    scatter(x, 0, pt);
  } else {
    const float4 dp = sum_ranks(recv, 1);
    const float2 d = ld_shared_f32x2(sv + 4 * kBlockKV);
    scatter(x, kGathBytes,
            make_float4(pt.x * (dp.x - d.x), pt.y * (dp.y - d.y),
                        pt.z * (dp.z - d.x), pt.w * (dp.w - d.y)));
  }
}

// grid (4 ceil(T / 64), B*H) in clusters of four: warpgroup 0 produces,
// 1 (A) and 2 (B) consume by role.
__global__ void __launch_bounds__(384, 1)
    dkv_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int rank = cluster_rank();
  const Block t{rank,
                rank * kCols,
                (int)blockIdx.y / p.heads,
                (int)blockIdx.y % p.heads,
                (int)(blockIdx.x / kRanks) * kRows,
                (p.s_len + kBlockKV - 1) / kBlockKV};
  const BarrierSet bars{smem + DkvSmem::bars};
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (threadIdx.x == 0) bars.init(8, kRecvBytes, 2 * kGathBytes);
  __syncthreads();
  cluster_arrive();  // every block's mbarriers initialised and armed
  cluster_wait();
  if (wg == 0) {
    dkv_produce(p, smem, bars, t);
  } else {
    const bool role_a = wg == 1;
    const int n = t.n_tiles;
    // the reducers' float4s go to the gather buffer of their role's
    // operand (p^T, then dS^T kGathBytes on)
    const Exchange x =
        exchange(t, smem + DkvSmem::recv, smem + DkvSmem::gath_p, bars);
    const uint32_t part_at = x.part_at + (role_a ? 0 : kRanks * kWarpPart);
    // the role's resident A and streamed B of the scores, and the output
    // product's gathered A and transposed B
    const uint32_t a_hi = smem + (role_a ? DkvSmem::k : DkvSmem::v);
    const int b_off = role_a ? DkvSmem::q : DkvSmem::dout;
    const int bt_off = role_a ? DkvSmem::dot : DkvSmem::qt;
    const uint32_t gath = smem + (role_a ? DkvSmem::gath_p : DkvSmem::gath_ds);
    DkvState st;
    zero(st.acc);
    mbar_wait(bars.res_ready(), 0);

    // q tile 0's scores, sent
    mbar_wait(bars.nat_ready(0), 0);
    issue_begin(st.sa, st.sb);
    issue_scores(st.sa, st.sb, a_hi, a_hi + kRes, smem + DkvSmem::nat + b_off,
                 smem + DkvSmem::nat + b_off + kPlane);
    issue_end(st.sa, st.sb);
    wgmma_wait<0>();
    fence_regs(st.sa);
    fence_regs(st.sb);
    release_warp(bars.nat_empty(0));
    send_part(part_at, x.part_bar, st.sa, st.sb);

    for (int i = 0; i < n; ++i) {
      const bool more = i + 1 < n;
      if (more) {
        const int s1 = (i + 1) % kRing;
        const uint32_t nat =
            smem + DkvSmem::nat + s1 * DkvSmem::kNatStage + b_off;
        mbar_wait(bars.nat_ready(s1), ((i + 1) / kRing) & 1);
        issue_begin(st.sa, st.sb);
        issue_scores(st.sa, st.sb, a_hi, a_hi + kRes, nat, nat + kPlane);
        issue_end(st.sa, st.sb);
      }
      if (i >= 1) {
        // tile i - 1's part
        if (more)
          wgmma_wait<1>();
        else
          wgmma_wait<0>();
        fence_regs(st.part);
        fence_regs(st.hi);
        fence_regs(st.lo);
        add_part(st.acc, st.part);
        release_warp(bars.tr_empty((i - 1) % kRing));
      }
      const int s0 = i % kRing;
      mbar_wait(bars.tr_ready(s0), (i / kRing) & 1);  // the tile's lse, delta
      dkv_reduce(p, smem, bars, x, role_a, i, n);
      mbar_wait_cluster(bars.gath(), i & 1);
      if (threadIdx.x == 128 && more)
        mbar_expect_tx(bars.gath(), 2 * kGathBytes);
      gathered_frags(gath, st.hi, st.lo);
      const uint32_t bt =
          smem + DkvSmem::tr + s0 * DkvSmem::kTrStage + bt_off;
      issue_begin(st.part, st.hi, st.lo);
      issue_out(st.part, st.hi, st.lo, bt, bt + kPlane);
      issue_end(st.part, st.hi, st.lo);
      if (more) {
        wgmma_wait<1>();
        fence_regs(st.sa);
        fence_regs(st.sb);
        release_warp(bars.nat_empty((i + 1) % kRing));
        send_part(part_at, x.part_bar, st.sa, st.sb);
      }
    }
    wgmma_wait<0>();
    fence_regs(st.part);
    fence_regs(st.hi);
    fence_regs(st.lo);
    add_part(st.acc, st.part);
    if (role_a)
      store_rows(p.out1, p.o1_sb, p.o1_ss, p.o1_sh, t.b, t.h, t.col0,
                 st.acc, 1.f, t.row0, p.t_len);
    else
      store_rows(p.out0, p.o0_sb, p.o0_ss, p.o0_sh, t.b, t.h, t.col0,
                 st.acc, p.scale, t.row0, p.t_len);
  }
  // no block leaves while another may still store into it
  cluster_arrive();
  cluster_wait();
}

// ------------------------------------------------------------------ host

constexpr int kDqThreads = 256, kDkvThreads = 384;

// Fill the parameter (the resident tensors' boxes kRows rows, the streamed
// ones' kBlockKV) and launch `kernel` over clusters of kRanks blocks, one
// a 64-row tile of S (dq) or T (dk/dv) and B*H.
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
  const cudaLaunchConfig_t cfg = cluster_sm90::cluster_config(
      kRanks, kRows, dq ? kDqThreads : kDkvThreads, dq ? s_len : t_len, b * h,
      smem_bytes, static_cast<cudaStream_t>(stream), &attr);
  void* args[] = {&p};
  const cudaError_t err =
      cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes, with the other backward entries'
// argument lists (the names flash_fp32.cu gave them at head_dim 256).
// Tensors (B, len, H, 256) fp32 with the element strides in `strides` (sb,
// sl, sh each; head_dim stride 1), lse and delta (B*H, S) fp32
// contiguous.  Each launches on `stream`, allocates nothing, and returns a
// CUDA error code (0 = launched).
//
// dq and delta; strides of q, k, v, o, dO, dq.
extern "C" int flash_bwd_dq_d256_fp32(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* delta, void* dq, int b, int h,
                                      int s_len, int t_len,
                                      const long long* strides, float scale,
                                      void* stream) {
  static const cudaError_t attr =
      cluster_sm90::allow_smem(dq_kernel, DqSmem::bytes);
  if (attr != cudaSuccess) return (int)attr;
  return launch_bwd(dq_kernel, DqSmem::bytes, true, q, k, v, o, dout, lse,
                    delta, dq, nullptr, b, h, s_len, t_len, strides, scale,
                    stream);
}

// dk and dv from the dq kernel's delta; strides of q, k, v, dO, dk, dv.
extern "C" int flash_bwd_dkv_d256_fp32(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int b, int h,
                                       int s_len, int t_len,
                                       const long long* strides, float scale,
                                       void* stream) {
  static const cudaError_t attr =
      cluster_sm90::allow_smem(dkv_kernel, DkvSmem::bytes);
  if (attr != cudaSuccess) return (int)attr;
  return launch_bwd(dkv_kernel, DkvSmem::bytes, false, q, k, v, nullptr,
                    dout, lse, const_cast<void*>(delta), dk, dv, b, h, s_len,
                    t_len, strides, scale, stream);
}

// cudaOccupancyMaxActiveClusters of the dq (dkv = 0) or the dk/dv kernel
// (dkv = 1): the clusters of kRanks blocks the card runs at once; a
// negative CUDA error code if the query fails.
extern "C" int flash_bwd_d256_fp32_max_clusters(int dkv) {
  return dkv ? cluster_sm90::max_clusters(dkv_kernel, kRanks, kRows,
                                          kDkvThreads, DkvSmem::bytes)
             : cluster_sm90::max_clusters(dq_kernel, kRanks, kRows,
                                          kDqThreads, DqSmem::bytes);
}
