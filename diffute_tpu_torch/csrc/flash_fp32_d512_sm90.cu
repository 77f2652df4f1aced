// Flash-attention forwards on fp32 inputs at head_dim 512 for Hopper
// (sm_90a): the standard forward and the deferred-softmax forward, fp32 in
// and out, the LSE in fp32.  The SD2 VAE's mid-block (one head of 512) runs
// them when an fp32 model encodes or decodes with
// VAEConfig.use_flash_attention (fp32 serving and stage-1 training, the
// JAX trainers' default precision); PIPELINE_FWD takes the deferred one.
// The backward pair at 512 is flash_fp32_d512_bwd_sm90.cu, on the same
// cluster layout (flash_fp32_d512_sm90.cuh); the other fp32 flash kernels
// are flash_fp32.cu.
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
//   q (B, S, H, 512), k, v (B, T, H, 512)  fp32, any strides TMA takes
//     (multiples of 16 bytes, the last one 1)
//   o (B, S, H, 512) fp32 through its strides (the wrappers hand it
//     contiguous), lse (B*H, S) fp32 natural log
//
// The precision contract of flash_fp32.cu holds unchanged: every product
// is 3xTF32 on mma.sync.m16n8k8.tf32 (x = hi + lo, both TF32 by integer
// operations that give cvt.rna's bits; lo_a hi_b and hi_a lo_b first, then
// hi hi); no tensor-core accumulator sums more than 32 columns of head_dim
// (a score chain) or 32 kv rows (a p v tile) before an fp32 add; o within
// relative L2 1e-5 of the tiled plain fp32 forward at the kernel's kv tile
// and domain, the LSE within 1e-5; no float atomics, every sum in a fixed
// order, each output element written by one block: the same bits every run.
//
// What bounds them on the H100: operations.  3xTF32 takes three TF32
// products for one, so 494.7 TF32 TFLOP/s give 164.9 fp32 TFLOP/s; a
// forward issues 4 S T D FLOPs a head (S and P V).  The first cut
// (flash_fp32.cu's Fp32<512, 16>) held 16-row tiles, so each streamed byte
// served 16 q rows (17.2 GB from L2 a launch at (4, 4096^2)), and its eight
// 64-column warp slices summed each tile's partial scores behind two block
// barriers, every warp then running the same softmax.
//
// Layout (flash_fp32_d512_sm90.cuh).  A cluster of four blocks splits
// head_dim: block r owns columns [128 r, 128 r + 128) of q, k, v and o and
// the cluster owns kRows = 64 resident q rows, so each streamed byte serves
// 64 rows (4.3 GB from L2 at (4, 4096^2)).  kv streams in kBlockKV = 32-row
// tiles, K and V through rings of three stages each, TMA boxes of 32
// columns with the 128-byte swizzle onto one mbarrier a stage; there is no
// producer warp: thread 0 refills a stage once a cluster barrier has shown
// that every warp of its block is done with it.  One kv tile is one p v
// chain: o = o alpha + (p v)_tile, the tile summed from zero and added in
// fp32.
//
// A tile's scores, across the cluster, in a fixed order.  Eight warps; warp
// (h, c) computes the 32 x 32 partial S of rows [32 h, 32 h + 32) over the
// block's columns [32 c, 32 c + 32) (one TMA box, a chain of four k-steps
// from zero) and stores each m16 tile through distributed shared memory
// into the receive buffer of the block that reduces its 16 rows (push, not
// pull: a remote load's round trip stayed off the backward pair's critical
// path).  After the cluster barrier, block r adds, for rows [16 r, 16 r +
// 16), each rank's four chains ((c0 + c1) + (c2 + c3)) and the ranks in
// order, 0 to 3, scales (standard) and masks, and runs the online softmax of
// those rows only: a quarter of the exponentials each, once, on all eight
// warps.  A warp holds two rows, 16 lanes a row's 32 columns, so each
// tile's row max and, at the end, each row's sum are shuffles within the
// warp; each thread keeps its row's m and its share of l in registers and
// writes p and, for the row, alpha into every block's gather buffer.  Warp
// (h, c) then rescales its 32 x 32 share of o (rows [32 h, 32 h + 32),
// columns [32 c, 32 c + 32)) by alpha and adds the gathered p times the
// tile's v.  At the end block r writes the LSE of its 16 rows and sends
// their l to every block, which divides its columns of o and stores them.
//
// One cluster barrier a tile, its latency hidden.  Body j: wait (tile j's
// partials and tile j - 1's p are everywhere); tile j's softmax; tile j +
// 1's score products and partials; arrive; tile j - 1's p v while the
// barrier completes.  So p v runs a tile behind the softmax in both
// forwards, as `_fwd_kernel_pipelined` defers it on the TPU: the deferred
// forward runs the standard one's schedule, on prescaled q in base 2.  The
// partials alternate by tile parity; p and alpha cycle through three sets
// (a block reads tile j - 1's while another writes tile j's, and may write
// tile j + 1's before the first is done); a V stage is refilled three
// bodies after its p v.  (Two barriers a tile, as the backward pair has,
// gave the same bits 2-6% slower on the card.)  Every access of a block's
// memory by another ends before the last wait, so no block exits while
// another may still reach it.
//
// Shared memory (232,448 bytes a block at most): the q slice resident (32
// KB), K and V slices in three stages each (6 x 16 KB), the received
// partials by parity (2 x 32 KB), p and alpha in three sets (3 x 8.25 KB),
// the rows' l: 217 KB.
//
// Ragged edges.  TMA reads rows past S or T as zeros.  The standard forward
// sets the scores of kv columns at or past T to -inf before the max (a zero
// score would count); the deferred forward takes T a whole number, at least
// two, of tiles.  q rows past S are not stored.

#include "flash_fp32_d512_sm90.cuh"

namespace {

using namespace fp32_d512;

constexpr float kLn2 = 0.6931471805599453f;
// K and V stream through rings of their own: K tile j is done with once
// tile j's scores are, V tile j only after tile j's p v one body later
constexpr int kKRing = 3, kVRing = 3;
// p and alpha by tile modulo 3: a block reads tile j - 1's while another
// writes tile j's and the next tile's may already follow
constexpr int kGathSets = 3;
// the score chains of a block's 128 columns: 32 columns (a box) each
constexpr int kChains = kCols / kBox;
// the partial scores a block receives for its 16 rows of one tile, float4
// [source rank][32-column chain][8-column step][lane]
constexpr int kPartBytes = kRanks * kChains * 16 * kBlockKV * 4;  // 32 KB

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

// Shared memory: the q slice (resident), the K and V stages, the partials
// by tile parity, p and alpha (64 rows) by tile modulo 3, the rows' l and
// the mbarriers (the q slice's, then K's stages, then V's).
struct FwdSmem {
  static constexpr int q = 0;
  static constexpr int k = q + kResBytes;
  static constexpr int v = k + kKRing * kStreamBytes;
  static constexpr int part = v + kVRing * kStreamBytes;
  static constexpr int gath = part + 2 * kPartBytes;
  static constexpr int alpha = gath + kGathSets * kGathBytes;
  static constexpr int lsum = alpha + kGathSets * kRows * 4;
  static constexpr int bars = lsum + kRows * 4;
  static constexpr int bytes = bars + (1 + kKRing + kVRing) * 8 + 1024;
  static_assert(bytes <= 232448, "227 KB a block");
};

// K (or V) of kv tile j into its ring's stage.
__device__ __forceinline__ void load_k(const FwdParams& p, const Block& t,
                                       int j) {
  const int st = j % kKRing;
  mbar_expect_tx(t.full(st), kStreamBytes);
  load_slice(&p.tm_k, t.ring0 + st * kStreamBytes, kStreamBox, t.full(st),
             t.col0, j * kBlockKV, t.h, t.bb);
}

__device__ __forceinline__ void load_v(const FwdParams& p, const Block& t,
                                       int j) {
  const int st = j % kVRing;
  mbar_expect_tx(t.full(kKRing + st), kStreamBytes);
  load_slice(&p.tm_v, t.ring1 + st * kStreamBytes, kStreamBox,
             t.full(kKRing + st), t.col0, j * kBlockKV, t.h, t.bb);
}

// A softmax thread: warp w takes rows w and w + 8 of the block's 16 (rows
// 16 r + w, + 8 of the cluster's 64); lane (n, e, t) = (lane >> 3, lane >> 2
// & 1, lane & 3) row w + 8 e and the tile's columns 8 n + 2t, + 1: half of
// one float4 of the accumulator layout, at lane' = 4 w + t of its 8-column
// step.  The 16 lanes of one e hold a row's 32 columns.  Its state is the
// row's m and l (l this thread's share of the sum).
struct Softmax {
  int n, t, row;             // row of the cluster's 64
  int part;                  // float2 index in a receive buffer
  uint32_t gath_at[kRanks];  // its float2 in each rank's first p buffer
  float m, l;
};

__device__ __forceinline__ Softmax softmax_of(const Block& t) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int e = (lane >> 2) & 1;
  Softmax x;
  x.n = lane >> 3;
  x.t = lane & 3;
  x.row = t.rank * 16 + w + 8 * e;
  const int slot = x.n * 32 + 4 * w + x.t;  // float4 of one chain's partial
  x.part = 2 * slot + e;
#pragma unroll
  for (int q = 0; q < kRanks; ++q)
    x.gath_at[q] = map_rank(t.gath + (t.rank * 4 * 32 + slot) * 16 + 8 * e, q);
  x.m = -INFINITY;
  x.l = 0.f;
  return x;
}

// The cluster's sum of this thread's two scores of a tile from the receive
// buffer `part`: each rank's four chains added as (c0 + c1) + (c2 + c3),
// then the ranks in order.
__device__ __forceinline__ float2 sum_ranks(const float2* part,
                                            const Softmax& x) {
  constexpr int kChainV = 2 * 4 * 32;  // float2s of one chain's partial
  float2 s = make_float2(0.f, 0.f);
#pragma unroll
  for (int q = 0; q < kRanks; ++q) {
    const float2* src = part + x.part + q * kChains * kChainV;
    const float2 c0 = src[0], c1 = src[kChainV], c2 = src[2 * kChainV],
                 c3 = src[3 * kChainV];
    const float2 v = make_float2((c0.x + c1.x) + (c2.x + c3.x),
                                 (c0.y + c1.y) + (c2.y + c3.y));
    s = q == 0 ? v : make_float2(s.x + v.x, s.y + v.y);
  }
  return s;
}

template <bool kBase2>
__device__ __forceinline__ float ex(float x) {
  return kBase2 ? exp2f(x) : expf(x);
}

// the max (sum) of a value over the 16 lanes that hold the same row (the
// lane bits of t and n), by a fixed butterfly: every lane gets the same bits
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  return x + __shfl_xor_sync(0xffffffffu, x, 16);
}

// Tile j's softmax for this thread's two scores: summed across the
// cluster, scaled (standard) with kv columns at or past T at -inf, the
// row's new max, alpha = exp(m_old - m_new), p = exp(s - m_new), l = l
// alpha + rowsum(p) (this thread's share); p into every rank's p buffer
// j % 3 and, from lanes n = t = 0, the row's alpha.  After the last tile
// (`last`): l summed over the row's lanes, the row's LSE written and l sent
// to every rank.
template <bool kBase2>
__device__ __forceinline__ void reduce_tile(const FwdParams& p,
                                            const Block& t,
                                            const float2* part, Softmax& x,
                                            int j, bool last, int q0) {
  float2 s = sum_ranks(part, x);
  if (!kBase2) {
    s.x *= p.scale;
    s.y *= p.scale;
    const int col = j * kBlockKV + x.n * 8 + 2 * x.t;
    if (col >= p.t_len) s.x = -INFINITY;
    if (col + 1 >= p.t_len) s.y = -INFINITY;
  }
  const float mn = fmaxf(x.m, row_max(fmaxf(s.x, s.y)));
  const float a = ex<kBase2>(x.m - mn);
  x.m = mn;
  const float2 pt = make_float2(ex<kBase2>(s.x - mn), ex<kBase2>(s.y - mn));
  x.l = x.l * a + (pt.x + pt.y);
  const int set = j % kGathSets;
#pragma unroll
  for (int q = 0; q < kRanks; ++q)
    st_cluster_f2(x.gath_at[q] + set * kGathBytes, pt);
  const bool writes = x.n == 0 && x.t == 0;
  const uint32_t alpha_at =
      t.gath + kGathSets * kGathBytes + (set * kRows + x.row) * 4;
  if (writes)
#pragma unroll
    for (int q = 0; q < kRanks; ++q) st_cluster_f(map_rank(alpha_at, q), a);
  if (!last) return;
  const float l = row_sum(x.l);
  if (writes) {
    const uint32_t l_at = t.gath + kGathSets * (kGathBytes + kRows * 4) +
                          x.row * 4;
#pragma unroll
    for (int q = 0; q < kRanks; ++q) st_cluster_f(map_rank(l_at, q), l);
    if (q0 + x.row < p.s_len)
      p.lse[(size_t)t.bh * p.s_len + q0 + x.row] =
          kBase2 ? (mn + log2f(l)) * kLn2 : mn + logf(l);
  }
}

// o (32 x 32: rows [32 rp, 32 rp + 32), columns [c0, c0 + 32)) = o alpha
// + p v over the tile: the gathered p's row groups 2 rp, 2 rp + 1 times the
// stage's v, summed from zero over its 32 rows, then added in fp32 to o
// rescaled by each row's alpha.
__device__ __forceinline__ void out_fwd(Acc& o, const float4* gath,
                                        const float* alpha, int rp,
                                        const float* v, int c0) {
  const int g = (threadIdx.x & 31) >> 2;
  Acc part;
  out_tile(part, gath, rp, v, c0);
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const float a_lo = alpha[32 * rp + 16 * m + g];
    const float a_hi = alpha[32 * rp + 16 * m + g + 8];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float* x = o[4 * m + n];
      const float* y = part[4 * m + n];
      x[0] = fmaf(x[0], a_lo, y[0]);
      x[1] = fmaf(x[1], a_lo, y[1]);
      x[2] = fmaf(x[2], a_hi, y[2]);
      x[3] = fmaf(x[3], a_hi, y[3]);
    }
  }
}

template <bool kBase2>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const __grid_constant__ FwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t smem = (raw + 1023) & ~1023u;
  float* fs = reinterpret_cast<float*>(smem_raw + (smem - raw));
  const int rank = cluster_rank();
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int q0 = (blockIdx.x / kRanks) * kRows;
  const int n = (p.t_len + kBlockKV - 1) / kBlockKV;
  const Block t{rank, rank * kCols, (int)blockIdx.y, h, b, n,
                smem + FwdSmem::q, 0, smem + FwdSmem::k, smem + FwdSmem::v,
                smem + FwdSmem::part, smem + FwdSmem::gath,
                smem + FwdSmem::bars, 0};
  // the scores' share: 32-row half, 32-column chain; o's: the same half,
  // the same 32 columns
  const int warp = threadIdx.x >> 5;
  const int rp = warp >> 2, ch = warp & 3;

  if (threadIdx.x == 0) init_bars(t, kKRing + kVRing, 1);
  __syncthreads();
  cluster_arrive();  // this block runs: the others may store into it
  if (threadIdx.x == 0) {
    prefetch_map(&p.tm_q);
    prefetch_map(&p.tm_k);
    prefetch_map(&p.tm_v);
    mbar_expect_tx(t.once(), kResBytes);
    load_slice(&p.tm_q, t.res0, kResBox, t.once(), t.col0, q0, h, b);
    for (int j = 0; j < kKRing && j < n; ++j) load_k(p, t, j);
    for (int j = 0; j < kVRing && j < n; ++j) load_v(p, t, j);
  }

  Softmax x = softmax_of(t);
  float* q_s = fs + FwdSmem::q / 4;
  const float* k_s = fs + FwdSmem::k / 4;
  const float* v_s = fs + FwdSmem::v / 4;
  const float2* part = reinterpret_cast<const float2*>(fs + FwdSmem::part / 4);
  const float4* gath = reinterpret_cast<const float4*>(fs + FwdSmem::gath / 4);
  const float* alpha = fs + FwdSmem::alpha / 4;
  const float* lsum = fs + FwdSmem::lsum / 4;
  uint32_t part_dst[kM];
  part_slots<kChains>(part_dst, t, 0, rp, ch);
  constexpr int kStageF = kStreamBytes / 4;
  constexpr int kPartV = kPartBytes / 8;  // float2s of one partial buffer
  constexpr int kGathV = kGathBytes / 16;

  mbar_wait(t.once(), 0);
  if (kBase2) {
    // q' = q * fp32(scale * log2 e), once, in place: elementwise, so four
    // slices scaled apart give the bits of each row scaled whole
    for (int i = threadIdx.x; i < kResBytes / 4; i += kThreads)
      q_s[i] *= p.scale_log2;
    __syncthreads();
  }

  Acc o, acc;
  zero_acc(o);

  // ---- kv tile 0's partials
  mbar_wait(t.full(0), 0);
  scores_part<kBox / 8>(acc, q_s, 32 * rp, k_s, 32 * ch);
  cluster_wait();  // every block of the cluster runs
  put_part(part_dst, acc);
  cluster_arrive();  // tile 0's partials

  // Body j: tile j's softmax on every warp (partials of parity j), tile j
  // + 1's partials (parity j + 1), the cluster barrier's arrival, then tile
  // j - 1's p v while the barrier completes.
  for (int j = 0; j < n; ++j) {
    cluster_wait();  // tile j's partials and tile j - 1's p everywhere;
                     // every warp done with K tile j and V tile j - 3
    if (threadIdx.x == 0) {
      if (j + kKRing < n) load_k(p, t, j + kKRing);
      if (j >= 3 && j - 3 + kVRing < n) load_v(p, t, j - 3 + kVRing);
    }
    reduce_tile<kBase2>(p, t, part + (j & 1) * kPartV, x, j, j == n - 1, q0);
    if (j + 1 < n) {
      const int st = (j + 1) % kKRing;
      mbar_wait(t.full(st), ((j + 1) / kKRing) & 1);
      scores_part<kBox / 8>(acc, q_s, 32 * rp, k_s + st * kStageF, 32 * ch);
      uint32_t dst[kM];
#pragma unroll
      for (int m = 0; m < kM; ++m)
        dst[m] = part_dst[m] + ((j + 1) & 1) * kPartBytes;
      put_part(dst, acc);
    }
    cluster_arrive();  // tile j's p and alpha (the last: l too); tile j +
                       // 1's partials
    if (j >= 1) {
      const int set = (j - 1) % kGathSets, st = (j - 1) % kVRing;
      mbar_wait(t.full(kKRing + st), ((j - 1) / kVRing) & 1);
      out_fwd(o, gath + set * kGathV, alpha + set * kRows, rp,
              v_s + st * kStageF, 32 * ch);
    }
  }
  cluster_wait();
  {
    const int set = (n - 1) % kGathSets, st = (n - 1) % kVRing;
    mbar_wait(t.full(kKRing + st), ((n - 1) / kVRing) & 1);
    out_fwd(o, gath + set * kGathV, alpha + set * kRows, rp,
            v_s + st * kStageF, 32 * ch);
  }

  // ---- o / l through o's strides, rows past S dropped
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  float* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const int r = 32 * rp + 16 * m + g;
    const float l_lo = lsum[r], l_hi = lsum[r + 8];
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
      const float* y = o[4 * m + nn];
      const int c = t.col0 + 32 * ch + nn * 8 + 2 * tq;
      if (q0 + r < p.s_len)
        *reinterpret_cast<float2*>(ob + (q0 + r) * p.o_ss + c) =
            make_float2(y[0] / l_lo, y[1] / l_lo);
      if (q0 + r + 8 < p.s_len)
        *reinterpret_cast<float2*>(ob + (q0 + r + 8) * p.o_ss + c) =
            make_float2(y[2] / l_hi, y[3] / l_hi);
    }
  }
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
      allow_smem(fwd_kernel<kBase2>, FwdSmem::bytes);
  if (attr != cudaSuccess) return (int)attr;
  if (const cudaError_t err = sm90::bind_context()) return (int)err;
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
  const cudaLaunchConfig_t cfg =
      cluster_config(s_len, b * h, FwdSmem::bytes,
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
// argument lists.  q, k, v, o (B, len, H, 512) fp32 with the element
// strides in `strides` (sb, sl, sh each of q, k, v, o; head_dim stride 1),
// lse (B*H, S) fp32 contiguous.  Each launches on `stream`, allocates
// nothing, and returns a CUDA error code (0 = launched).
extern "C" int flash_fwd_d512_fp32(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int b,
                                   int h, int s_len, int t_len,
                                   const long long* strides, float scale,
                                   void* stream) {
  return launch_fwd<false>(q, k, v, o, lse, b, h, s_len, t_len, strides,
                           scale, stream);
}

// The deferred-softmax forward: t_len a multiple of 32 of at least 64.
extern "C" int flash_fwd_pipelined_d512_fp32(const void* q, const void* k,
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
extern "C" int flash_fwd_d512_fp32_max_clusters(int pipelined) {
  return pipelined ? max_clusters(fwd_kernel<true>, FwdSmem::bytes)
                   : max_clusters(fwd_kernel<false>, FwdSmem::bytes);
}
