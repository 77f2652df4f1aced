// Flash-attention forwards at head_dim 256 for Hopper (sm_90a): the
// standard forward and the deferred-softmax forward, bf16 in, bf16 out,
// fp32 LSE.  The small VAE's mid-block (`small_config`, one head of 256)
// runs them with VAEConfig.use_flash_attention.
//
// Replaces the Pallas TPU kernels `_fwd_kernel` (pl.pallas_call in
// `_flash_fwd_3d`) and `_fwd_kernel_pipelined` (in
// `_flash_fwd_3d_pipelined`) of diffute_tpu/ops/flash_attention.py at that
// width.  As at head_dim 64 (flash_fwd.cu), one block owns q rows of one
// (batch, head) and walks the kv tiles itself with the online-softmax state
// in registers; the deferred one issues tile j + 1's scores ahead of tile
// j's softmax, as the TPU kernel's two score buffers do.
//
//   q (B, S, H, 256), k/v (B, T, H, 256)  bf16, any strides TMA takes
//     (multiples of 16 bytes, the last one 1)
//   o (B, S, H, 256) bf16 through its strides, lse (B*H, S) fp32 natural log
//
//   s = q k^T, online softmax in base 2 (scale*log2 e folded into one FMA
//   on the fp32 score), p rounded to bf16 against the running max, o += p v
//
// What bounds them on the H100: operations.  A score costs 2*256 FLOPs in
// each product against one exp2, so the softmax is an eighth of the
// head_dim-64 kernels' share; what the design has to give the tensor cores
// is wgmma on operands that arrive without the consumers' help, and a
// softmax that runs while a product is in flight.
//
// Block layout: one or two consumer warpgroups, each owning 64 q rows x all
// 256 columns, so the score contraction over head_dim is one warpgroup's
// wgmma chain and no partial scores are exchanged.  There is no producer:
// thread 0 issues the first TMA loads, and the last warp to release a ring
// stage refills it (release_kv), so the block is 255 registers a thread
// (fwd_d256_kernel says why).  The consumers take no __syncthreads; they
// wait on the stages' full barriers.  A block has two consumer warpgroups
// (128 q rows; K and V read from L2 once per 128 rows) or one (64 rows)
// where two would leave SMs without a block (the launcher's rule,
// consumers_for); each warpgroup computes its rows by the same instructions
// in either, so both layouts give the same bits.
//
// Tiles.  A 256-wide bf16 row is 512 bytes: four TMA boxes of 64 columns,
// each loaded into its own 128-byte-swizzled block ([rows][64], 1024-byte
// aligned), which is the layout wgmma's descriptors read.  q is 32 KB a
// consumer; the kv tile is 64 rows, K and V each in a ring of two stages
// (64 + 128 KB with two consumers; 32-row tiles, three or four stages, ran
// slower on an H100: PERF.md).
//
// Products.  S = Q K^T: wgmma m64nBNk16 with both operands in shared
// memory, 16 k-steps, the descriptors stepping 32 bytes within a swizzle
// atom and one block of [rows][64] between atoms; BN / 2 fp32 registers a
// thread.  O += P V: P from registers (bf16, the accumulator layout) and V
// in shared memory in its MN-major (transposed) form, N = 256 (one wgmma a
// k-step, the descriptor's leading offset the step between V's four
// column blocks).  o is 128 fp32 registers a thread.
//
// Both forwards walk the same kv tile and run the same softmax step, so
// they round p against the same running maxima and give the same bits.
// The backward at this width (dq and dk/dv) is flash_d256_bwd_sm90.cu, on
// the same boxes and the same N = 256 product (flash_sm90.cuh).
//
// Ragged edges.  TMA reads rows past S or T as zeros; the last kv tile
// masks its columns at or past T to -inf; rows past S are not stored.

#include "flash_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kD = 256;
constexpr int kAtoms = kD / kHeadDim;            // 64-column boxes a row
// the kv tile (ops/flash_attention.py: D256_FWD_BLOCK_KV) and the ring's
// depth
constexpr int kBlockKV = 64;
constexpr int kRing = 2;
constexpr int kQAtom = kWgRows * kRowBytes;      // 8 KB
constexpr int kQBytes = kAtoms * kQAtom;         // 32 KB: a consumer's q
constexpr int kKVAtom = kBlockKV * kRowBytes;
constexpr int kKVBytes = kAtoms * kKVAtom;       // one K (or V) stage
constexpr int kS = kBlockKV / 2;                 // score registers a thread
constexpr int kPSteps = kBlockKV / 16;           // k-steps of P V
// at most two consumer warpgroups and nothing else: 255 registers a thread
constexpr int kMaxThreads = 2 * 128;

// Offsets into the block's dynamic shared memory (after 1024-byte
// alignment) with C consumer warpgroups.
template <int C>
struct Layout {
  static constexpr int q = 0;
  static constexpr int k = q + C * kQBytes;
  static constexpr int v = k + kRing * kKVBytes;
  // q_full, then k_full and v_full per stage
  static constexpr int bars = v + kRing * kKVBytes;
  // the K and V stages' release counts
  static constexpr int counts = bars + (1 + 2 * kRing) * 8;
  static constexpr int bytes = counts + 2 * kRing * 4 + 1024;
  static_assert(bytes <= 232448, "227 KB a block");
};

struct Ring {
  uint32_t bars, counts;
  __device__ uint32_t q_full() const { return bars; }
  __device__ uint32_t k_full(int s) const { return bars + 8 * (1 + s); }
  __device__ uint32_t v_full(int s) const {
    return bars + 8 * (1 + kRing + s);
  }
  __device__ uint32_t k_count(int s) const { return counts + 4 * s; }
  __device__ uint32_t v_count(int s) const {
    return counts + 4 * (kRing + s);
  }
};

// What a consumer warpgroup reads and loads: its q tile, the K and V rings,
// its block's (batch, head) and kv tiles, and the block's warps (each
// releases every stage once).
struct Block {
  uint32_t q, k, v;
  int b, h, n_tiles, warps;
};

// ----------------------------------------------------------------- loads

// The four box loads of a K or V tile (rows `row`..) into `dst`, one per
// 64-column block, and the bytes they bring expected on `full`; issued
// only where `go` holds, as predicated instructions, so that no branch sits
// among products in flight (ptxas serializes wgmma across branches).
__device__ __forceinline__ void load_kv_if(bool go, const CUtensorMap* map,
                                           uint32_t dst, uint32_t full,
                                           int row, const Block& blk) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %0, 0;\n"
      " @p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%1], %2;\n"
      " @p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%3], [%7, {%11, %8, %9, %10}], [%1];\n"
      " @p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%4], [%7, {%12, %8, %9, %10}], [%1];\n"
      " @p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%5], [%7, {%13, %8, %9, %10}], [%1];\n"
      " @p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%6], [%7, {%14, %8, %9, %10}], [%1];\n}\n" ::"r"(
          (int)go),
      "r"(full), "r"(kKVBytes), "r"(dst), "r"(dst + kKVAtom),
      "r"(dst + 2 * kKVAtom), "r"(dst + 3 * kKVAtom),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(blk.h), "r"(row), "r"(blk.b),
      "r"(0), "r"(kHeadDim), "r"(2 * kHeadDim), "r"(3 * kHeadDim)
      : "memory");
  static_assert(kAtoms == 4, "four boxes a row");
}

// A warp is done reading K (or V: `map`, `ring`, `full`, `count` of its
// kind) of kv tile j.  Lane 0 adds the warp to the stage's release count,
// acquire-release, so every warp's reads of the stage happen before what
// the last of them does next: refill the stage with tile j + kRing.  The
// block has no producer: its C warpgroups are all the threads, and 255
// registers a thread are what o (128) and the score tiles need.
__device__ __forceinline__ void release_kv(const CUtensorMap* map,
                                           uint32_t ring, uint32_t full,
                                           uint32_t count, int j,
                                           const Block& blk) {
  uint32_t before = 0;
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, %1, 0;\n"
      " @p atom.acq_rel.cta.shared::cta.add.u32 %0, [%2], 1;\n}\n"
      : "+r"(before)
      : "r"(threadIdx.x & 31), "r"(count)
      : "memory");
  const int next = j + kRing;
  const bool last = (threadIdx.x & 31) == 0 &&
                    before + 1 == (uint32_t)(blk.warps * (j / kRing + 1));
  load_kv_if(last && next < blk.n_tiles, map, ring + (j % kRing) * kKVBytes,
             full, next * kBlockKV, blk);
}

__device__ __forceinline__ void release_k(const FwdParams& p,
                                          const Ring& ring, const Block& blk,
                                          int j) {
  release_kv(&p.tm_k, blk.k, ring.k_full(j % kRing), ring.k_count(j % kRing),
             j, blk);
}

__device__ __forceinline__ void release_v(const FwdParams& p,
                                          const Ring& ring, const Block& blk,
                                          int j) {
  release_kv(&p.tm_v, blk.v, ring.v_full(j % kRing), ring.v_count(j % kRing),
             j, blk);
}

// Thread 0 before the consumers start: the q tiles of the C consumers, and
// K and V of the first kRing kv tiles.
template <int C>
__device__ __forceinline__ void prologue(const FwdParams& p, const Ring& ring,
                                         const Block& blk, uint32_t q_ring,
                                         int q_row0) {
  prefetch_map(&p.tm_q);
  prefetch_map(&p.tm_k);
  prefetch_map(&p.tm_v);
  mbar_expect_tx(ring.q_full(), C * kQBytes);
#pragma unroll
  for (int w = 0; w < C; ++w)
#pragma unroll
    for (int a = 0; a < kAtoms; ++a)
      tma_load_at(q_ring + w * kQBytes + a * kQAtom, &p.tm_q, ring.q_full(),
                  a * kHeadDim, blk.h, q_row0 + w * kWgRows, blk.b);
  for (int j = 0; j < kRing && j < blk.n_tiles; ++j) {
    load_kv_if(true, &p.tm_k, blk.k + j * kKVBytes, ring.k_full(j),
               j * kBlockKV, blk);
    load_kv_if(true, &p.tm_v, blk.v + j * kKVBytes, ring.v_full(j),
               j * kBlockKV, blk);
  }
}

// ----------------------------------------------------------------- wgmma

// S (64 x BN) = Q (64 x 256) K^T: 16 k-steps of 16 columns, four in each
// 64-column block, 32 bytes apart in its swizzled rows.
__device__ __forceinline__ void issue_qk(float (&s)[kS], uint32_t q_tile,
                                         uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int a = kk / 4, c = (kk % 4) * 32;
    wgmma_ss_n64(s, desc_sw128(q_tile + a * kQAtom + c, 1),
                 desc_sw128(k_tile + a * kKVAtom + c, 1), kk > 0);
  }
}

// O (64 x 256) += P (64 x BN, registers) V: BN / 16 k-steps of 16 kv rows,
// each 16 rows (2048 bytes) further into every column block of the V tile;
// the leading offset is the step between the blocks.
__device__ __forceinline__ void issue_pv(float (&o)[kAtoms][32],
                                         const uint32_t (&pk)[kPSteps][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kPSteps; ++kk)
    wgmma_rs_n256(o, pk[kk],
                  desc_sw128(v_tile + kk * 16 * kRowBytes, kKVAtom >> 4));
}

__device__ __forceinline__ void rescale_o(float (&o)[kAtoms][32],
                                          float2 alpha) {
#pragma unroll
  for (int c = 0; c < kAtoms; ++c) rescale(o[c], alpha);
}

// --------------------------------------------------------------- schedules

// The standard forward.  Per consumer thread: S (BN / 2 registers), O (128)
// and P (BN / 4).  Tile j >= 1 issues S_j = Q K_j^T and then
// O += P_{j-1} V_{j-1}, and runs tile j's softmax while the second is in
// flight; the first tile and the last are peeled so that the steady loop
// has no branch while a product is in flight (ptxas serializes wgmma
// across such branches).  Only the last tile can be ragged.  The two
// consumer warpgroups issue independently: turns through named barriers,
// as flash_fwd.cu's take them, ran this schedule slower on an H100.
struct Standard {
  struct State {
    float s[kS];
    float o[kAtoms][32];
    uint32_t pk[kPSteps][4];
    RowState st;
  };

  template <bool kLast>
  __device__ __forceinline__ static void step(const FwdParams& p,
                                              const Ring& ring, const Block& t,
                                              int j, State& x) {
    const int stage = j % kRing, prev = (j - 1) % kRing;
    mbar_wait(ring.k_full(stage), (j / kRing) & 1);
    mbar_wait(ring.v_full(prev), ((j - 1) / kRing) & 1);
    issue_begin(x.s, x.o, x.pk);
    issue_qk(x.s, t.q, t.k + stage * kKVBytes);
    issue_end(x.s);
    issue_pv(x.o, x.pk, t.v + prev * kKVBytes);
    issue_end(x.o, x.pk);
    wgmma_wait<1>();
    fence_regs(x.s);
    if (kLast) mask_tail(x.s, j * kBlockKV, p.t_len);
    const float2 alpha = softmax_step(x.s, x.st, p.scale_log2);
    wgmma_wait<0>();
    fence_regs(x.o);
    fence_regs(x.pk);
    // both products retired: release K_j and V_{j-1} here, where none is
    // in flight
    release_k(p, ring, t, j);
    release_v(p, ring, t, j - 1);
    rescale_o(x.o, alpha);
    pack_p(x.pk, x.s);
  }

  __device__ __forceinline__ static void run(const FwdParams& p,
                                             const Ring& ring, const Block& t,
                                             float (&o)[kAtoms][32],
                                             RowState& st) {
    const int n_tiles = t.n_tiles;
    State x;
#pragma unroll
    for (int c = 0; c < kAtoms; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) x.o[c][i] = 0.f;
    x.st = {-INFINITY, -INFINITY, 0.f, 0.f};

    // ---- tile 0: S_0 alone
    mbar_wait(ring.q_full(), 0);
    mbar_wait(ring.k_full(0), 0);
    issue_begin(x.s);
    issue_qk(x.s, t.q, t.k);
    issue_end(x.s);
    wgmma_wait<0>();
    fence_regs(x.s);
    release_k(p, ring, t, 0);
    mask_tail(x.s, 0, p.t_len);
    // O is still 0, so the rescale the deferred schedule applies here
    // multiplies zeros: the same bits
    rescale_o(x.o, softmax_step(x.s, x.st, p.scale_log2));
    pack_p(x.pk, x.s);

    for (int j = 1; j < n_tiles - 1; ++j)
      step<false>(p, ring, t, j, x);
    if (n_tiles > 1) step<true>(p, ring, t, n_tiles - 1, x);

    // ---- the last P V
    const int last = (n_tiles - 1) % kRing;
    mbar_wait(ring.v_full(last), ((n_tiles - 1) / kRing) & 1);
    issue_begin(x.o, x.pk);
    issue_pv(x.o, x.pk, t.v + last * kKVBytes);
    issue_end(x.o, x.pk);
    wgmma_wait<0>();
    fence_regs(x.o);
    fence_regs(x.pk);
    release_v(p, ring, t, n_tiles - 1);
#pragma unroll
    for (int c = 0; c < kAtoms; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = x.o[c][i];
    st = x.st;
  }
};

// The deferred-softmax forward.  Per consumer thread: two score tiles
// (`cur` S_j, `nxt` S_{j+1}), O and P.  Body j issues S_{j+1} first,
// retires P_{j-1} V_{j-1} (queued ahead of it), runs tile j's softmax on
// `cur` while S_{j+1} is in flight, rescales O, issues O += P_j V_j and
// waits for S_{j+1} only, so P_j V_j runs on into the next body.  wgmma
// always writes `nxt` and the softmax always reads `cur`; S_{j+1} moves
// from one to the other once retired.  The first body and the last are
// separate instances: no branch while a product is in flight.  The
// dispatch rule gives T a whole number (>= 2) of tiles, so no column is
// masked.
struct Deferred {
  struct State {
    float cur[kS], nxt[kS];
    float o[kAtoms][32];
    uint32_t pk[kPSteps][4];
    RowState st;
  };

  template <bool kFirst, bool kLast>
  __device__ __forceinline__ static void body(const FwdParams& p,
                                              const Ring& ring, const Block& t,
                                              int j, State& x) {
    const int nst = (j + 1) % kRing;
    if (!kLast) {  // produce (the last body only consumes)
      mbar_wait(ring.k_full(nst), ((j + 1) / kRing) & 1);
      issue_begin(x.nxt);
      issue_qk(x.nxt, t.q, t.k + nst * kKVBytes);
      issue_end(x.nxt);
    }
    if (!kFirst) {  // retire P_{j-1} V_{j-1}; S_{j+1} runs on
      if (kLast)
        wgmma_wait<0>();
      else
        wgmma_wait<1>();
      fence_regs(x.o);
      fence_regs(x.pk);
      release_v(p, ring, t, j - 1);
    }
    rescale_o(x.o, softmax_step(x.cur, x.st, p.scale_log2));
    pack_p(x.pk, x.cur);
    const int sj = j % kRing;
    mbar_wait(ring.v_full(sj), (j / kRing) & 1);
    issue_begin(x.o, x.pk);
    issue_pv(x.o, x.pk, t.v + sj * kKVBytes);
    issue_end(x.o, x.pk);
    if (!kLast) {  // retire S_{j+1}; P_j V_j runs on into the next body
      wgmma_wait<1>();
      fence_regs(x.nxt);
      release_k(p, ring, t, j + 1);
#pragma unroll
      for (int i = 0; i < kS; ++i) x.cur[i] = x.nxt[i];
    }
  }

  __device__ __forceinline__ static void run(const FwdParams& p,
                                             const Ring& ring, const Block& t,
                                             float (&o)[kAtoms][32],
                                             RowState& st) {
    const int n_tiles = t.n_tiles;
    State x;
#pragma unroll
    for (int c = 0; c < kAtoms; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) x.o[c][i] = 0.f;
    x.st = {-INFINITY, -INFINITY, 0.f, 0.f};

    // ---- prologue: S_0, consume nothing
    mbar_wait(ring.q_full(), 0);
    mbar_wait(ring.k_full(0), 0);
    issue_begin(x.nxt);
    issue_qk(x.nxt, t.q, t.k);
    issue_end(x.nxt);
    wgmma_wait<0>();
    fence_regs(x.nxt);
    release_k(p, ring, t, 0);
#pragma unroll
    for (int i = 0; i < kS; ++i) x.cur[i] = x.nxt[i];

    body<true, false>(p, ring, t, 0, x);  // n_tiles >= 2
    for (int j = 1; j < n_tiles - 1; ++j) body<false, false>(p, ring, t, j, x);
    body<false, true>(p, ring, t, n_tiles - 1, x);
    wgmma_wait<0>();
    fence_regs(x.o);
    fence_regs(x.pk);
    release_v(p, ring, t, n_tiles - 1);
#pragma unroll
    for (int c = 0; c < kAtoms; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = x.o[c][i];
    st = x.st;
  }
};

// ------------------------------------------------------------- epilogue

// Normalise and write the warpgroup's 64 rows of o (through its strides)
// and their natural-log LSE; rows at or past s_len are dropped.
__device__ __forceinline__ void store_rows(const FwdParams& p,
                                           const float (&o)[kAtoms][32],
                                           RowState st, int b, int h,
                                           int wg_row0) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    st.l_lo += __shfl_xor_sync(0xffffffffu, st.l_lo, off);
    st.l_hi += __shfl_xor_sync(0xffffffffu, st.l_hi, off);
  }
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r_lo = wg_row0 + ((threadIdx.x >> 5) & 3) * 16 + g;
  const int r_hi = r_lo + 8;
  const float inv_lo = 1.f / st.l_lo, inv_hi = 1.f / st.l_hi;
  __nv_bfloat16* base = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int c = 0; c < kAtoms; ++c)
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n) {
      const int col = c * kHeadDim + n * 8 + t * 2;
      if (r_lo < p.s_len)
        *reinterpret_cast<uint32_t*>(base + r_lo * p.o_ss + col) =
            pack_bf16(o[c][4 * n] * inv_lo, o[c][4 * n + 1] * inv_lo);
      if (r_hi < p.s_len)
        *reinterpret_cast<uint32_t*>(base + r_hi * p.o_ss + col) =
            pack_bf16(o[c][4 * n + 2] * inv_hi, o[c][4 * n + 3] * inv_hi);
    }
  if (t == 0) {
    float* lb = p.lse + (size_t)(b * p.heads + h) * p.s_len;
    if (r_lo < p.s_len) lb[r_lo] = (st.m_lo + log2f(st.l_lo)) * kLn2;
    if (r_hi < p.s_len) lb[r_hi] = (st.m_hi + log2f(st.l_hi)) * kLn2;
  }
}

// ------------------------------------------------------------ the kernel

// C consumer warpgroups (1 or 2) and nothing else; `Schedule` is Standard
// or Deferred.  Thread 0 issues the first loads, and each stage is refilled
// by the last warp to release it (release_kv).  Both layouts take the
// launch bounds of 256 threads, so ptxas may give every thread 255
// registers: o alone is 128.  (A producer warpgroup and `setmaxnreg`, as at
// head_dim 64, leave ptxas 168 a thread: a 384-thread block allows no more,
// whatever setmaxnreg asks at run time, and a 288-thread block counts as
// 384 (warps are allocated four at a time).  Both forwards spilled and
// serialized their wgmmas there.)
template <int C, class Schedule>
__global__ void __launch_bounds__(kMaxThreads, 1)
    fwd_d256_kernel(const __grid_constant__ FwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  const Ring ring{smem + Layout<C>::bars, smem + Layout<C>::counts};
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int q_row0 = blockIdx.x * C * kWgRows;
  // the warpgroup index, warp-uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const Block blk{smem + Layout<C>::q + wg * kQBytes, smem + Layout<C>::k,
                  smem + Layout<C>::v, b, h,
                  (p.t_len + kBlockKV - 1) / kBlockKV, 4 * C};

  if (threadIdx.x == 0) {
    mbar_init(ring.q_full(), 1);
    for (int s = 0; s < kRing; ++s) {
      mbar_init(ring.k_full(s), 1);
      mbar_init(ring.v_full(s), 1);
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(ring.k_count(s)),
                   "r"(0)
                   : "memory");
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(ring.v_count(s)),
                   "r"(0)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    prologue<C>(p, ring, blk, smem + Layout<C>::q, q_row0);
  }
  __syncthreads();

  float o[kAtoms][32];
  RowState st;
  Schedule::run(p, ring, blk, o, st);
  store_rows(p, o, st, b, h, q_row0 + wg * kWgRows);
}

// ------------------------------------------------------------------ host

// The consumer warpgroups a block where the caller leaves it to the
// launcher: two (128 q rows, K and V read once per 128 rows) when that
// gives every SM a block, else one (twice the blocks).
int consumers_for(int bh, int s_len) {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const long long blocks = (long long)((s_len + 2 * kWgRows - 1) /
                                       (2 * kWgRows)) * bh;
  return blocks >= sms ? 2 : 1;
}

template <int C, class Schedule>
int launch_layout(const FwdParams& p, int bh, int s_len, void* stream) {
  auto kernel = fwd_d256_kernel<C, Schedule>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<C>::bytes);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((s_len + C * kWgRows - 1) / (C * kWgRows), bh);
  kernel<<<grid, C * 128, Layout<C>::bytes,
           static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// q/k/v/o (B, len, H, 256) bf16 with the element strides in `strides` (q,
// k, v, o: sb, sl, sh each; head_dim stride 1); lse (B*H, S) fp32.
// `consumers` 1 or 2, or 0 for consumers_for's choice.  Launches on
// `stream`, allocates nothing, returns a CUDA error code (0 = launched).
template <class Schedule>
int launch_d256(const void* q, const void* k, const void* v, void* o,
               void* lse, int b, int h, int s_len, int t_len,
               const long long* strides, float scale, void* stream,
               int consumers) {
  if (b <= 0 || h <= 0 || s_len <= 0 || t_len <= 0 ||
      (long long)b * h > 65535 || consumers < 0 || consumers > 2)
    return (int)cudaErrorInvalidValue;
  if (const cudaError_t err = bind_context()) return (int)err;
  FwdParams p;
  const long long* s = strides;
  if (!encode_map(&p.tm_q, q, b, s_len, h, s[0], s[1], s[2], kWgRows, kD) ||
      !encode_map(&p.tm_k, k, b, t_len, h, s[3], s[4], s[5], kBlockKV, kD) ||
      !encode_map(&p.tm_v, v, b, t_len, h, s[6], s[7], s[8], kBlockKV, kD))
    return (int)cudaErrorInvalidValue;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.o_sb = s[9];
  p.o_ss = s[10];
  p.o_sh = s[11];
  p.heads = h;
  p.s_len = s_len;
  p.t_len = t_len;
  p.scale_log2 = scale * kLog2e;
  if (consumers == 0) consumers = consumers_for(b * h, s_len);
  if (consumers == 1)
    return launch_layout<1, Schedule>(p, b * h, s_len, stream);
  return launch_layout<2, Schedule>(p, b * h, s_len, stream);
}

// the deferred schedule's rule: T a whole number of tiles, two or more
bool deferred_takes(int t_len) {
  return t_len % kBlockKV == 0 && t_len >= 2 * kBlockKV;
}

}  // namespace

// Plain C entry points for ctypes, with the other forwards' argument lists
// (see launch_d256) and, after the stream, the consumer warpgroups a block
// (1 or 2; 0 leaves them to consumers_for).  The deferred forward refuses a
// t_len its dispatch rule refuses (cudaErrorInvalidValue).
extern "C" int flash_fwd_d256_bf16(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int b,
                                   int h, int s_len, int t_len,
                                   const long long* strides, float scale,
                                   void* stream, int consumers) {
  return launch_d256<Standard>(q, k, v, o, lse, b, h, s_len, t_len, strides,
                              scale, stream, consumers);
}

extern "C" int flash_fwd_pipelined_d256_bf16(const void* q, const void* k,
                                             const void* v, void* o,
                                             void* lse, int b, int h,
                                             int s_len, int t_len,
                                             const long long* strides,
                                             float scale, void* stream,
                                             int consumers) {
  if (!deferred_takes(t_len)) return (int)cudaErrorInvalidValue;
  return launch_d256<Deferred>(q, k, v, o, lse, b, h, s_len, t_len, strides,
                              scale, stream, consumers);
}

// The consumer warpgroups a block the launcher takes for (B*H, S).
extern "C" int flash_fwd_d256_consumers(int bh, int s_len) {
  return consumers_for(bh, s_len);
}
