// Hopper (sm_90a) building blocks shared by the two flash-attention
// forwards (flash_fwd.cu, flash_fwd_pipelined.cu) and the backward
// (flash_bwd.cu): the TMA tensor maps that read q, k and v through their
// strides, mbarriers, the two wgmma shapes every flash kernel issues, the
// forwards' producer warp, online-softmax step and epilogue.  Each forward
// adds only its consumer schedule; the backward keeps the block layout below
// and adds its own loads and schedules.
//
// Block layout.  Warpgroup 0 is the producer: after `setmaxnreg.dec` one
// thread of it issues every TMA load (the q tile of each consumer, then K and
// V tile by tile into a ring of kStages stages, each with a full and an empty
// mbarrier); its other threads exit.  Warpgroups 1 and 2 are consumers, each
// owning 64 q rows, so a block takes 128 q rows and K/V are read from L2 once
// per 128 q rows.  Consumers do no loads and no __syncthreads; they wait on
// the full barriers and each warp releases a stage by one arrival on its
// empty barrier.  (One consumer warpgroup a block, 64 q rows and two blocks
// an SM, was slower at every shape the main paths run: at 128 registers a
// thread on entry ptxas spilled and serialized the wgmmas.)
//
// Shared memory.  A head_dim-64 bf16 row is 128 bytes, so every tile is
// loaded with the 128-byte swizzle that wgmma's descriptors read: an 8-row,
// 1024-byte pattern, so each tile starts 1024-byte aligned.
//
// Fragments.  In a warpgroup, warp w owns rows 16w .. 16w+15 of the 64-row
// tile; lane = 4g + t owns rows 16w + g ("lo") and 16w + g + 8 ("hi").  An
// fp32 wgmma accumulator of N columns holds, at 4n + i, row (i < 2 ? lo : hi)
// and column 8n + 2t + (i & 1); that is also the layout of wgmma's register A
// operand, so the softmax's P goes from the score registers to the P.V
// product without leaving registers.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sm90 {

constexpr int kHeadDim = 64;
constexpr int kRowBytes = kHeadDim * 2;  // one bf16 row: the swizzle span
// K/V ring depth: three stages ran the deferred schedule's 64-row tiles
// faster than two on an H100 and left flash_fwd.cu level
constexpr int kStages = 3;
constexpr int kWgRows = 64;              // q rows a consumer warpgroup
constexpr int kConsumers = 2;            // consumer warpgroups a block
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kQTileBytes = kWgRows * kRowBytes;   // 8 KB
// A kv tile of BN rows (Consume::kBlockKV; both schedules take 64) is
// BN * 128 bytes; its score tile holds BN / 2 fp32 registers a thread.
template <int BN>
__host__ __device__ constexpr int kv_tile_bytes() { return BN * kRowBytes; }
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// a wait that polls this many SM clocks (about 10 s) traps: a lost
// arrival becomes a launch error rather than a hung card
constexpr long long kWaitClocks = 20000000000LL;

// ---------------------------------------------------------------- params

// Everything a launch needs, passed by value as one __grid_constant__
// parameter: the tensor maps live in parameter space and no device state
// outlives the call.
struct FwdParams {
  CUtensorMap tm_q, tm_k, tm_v;
  __nv_bfloat16* o;
  float* lse;                   // (B*H, S), natural log
  long long o_sb, o_ss, o_sh;   // o's element strides (head_dim stride 1)
  int heads, s_len, t_len;
  float scale_log2;             // softmax scale * log2(e)
};

// ------------------------------------------------------- device helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  if (done) return;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (clock64() - t0 > kWaitClocks) __trap();
  } while (!done);
}

// 4-D TMA load of box {64, 1, rows, 1} at (0, h, row, b) into `dst`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int h, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(h), "r"(row),
      "r"(b)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// named barriers between the two consumer warpgroups (id 0 is
// __syncthreads)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// ----------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor of a 128-byte-swizzled tile: start
// address >> 4, leading and stride byte offsets >> 4, layout 1 (128B).
// The stride byte offset is the 1024-byte step between 8-row groups; the
// leading one is unused by the shapes here (one 128-byte atom wide).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tie registers to this point of the instruction stream (an empty asm: no
// instruction is emitted), so the compiler neither reads a wgmma accumulator
// before its wait nor moves a write past the next issue.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define SM90_F8(a, i)                                                   \
  "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]),           \
      "+f"(a[i + 4]), "+f"(a[i + 5]), "+f"(a[i + 6]), "+f"(a[i + 7])
#define SM90_F32(a) SM90_F8(a, 0), SM90_F8(a, 8), SM90_F8(a, 16), SM90_F8(a, 24)

// d (64 x 64, fp32) (+)= A (64 x 16, smem, K-major) * B (16 x 64, smem,
// K-major), scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SM90_F32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, fp32) += A (64 x 16 bf16, registers) * B (16 x 64, smem,
// MN-major: 16 rows of 64 contiguous n, i.e. trans-b = 1).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SM90_F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S (64 x 64) = Q (64 x 64) K^T: four k-steps of 16 head-dim columns, each
// 32 bytes further into the swizzled rows.  The fences are issue_begin /
// issue_end's.
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t q_tile,
                                         uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk)
    wgmma_ss_n64(s, desc_sw128(q_tile + kk * 32, 1),
                 desc_sw128(k_tile + kk * 32, 1), kk > 0);
}

// O (64 x 64) += P (64 x 16K, registers) V: K k-steps of 16 kv rows, each
// 16 rows (2048 bytes) further into the V tile.
template <int K>
__device__ __forceinline__ void issue_pv(float (&o)[32],
                                         const uint32_t (&p)[K][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
    wgmma_rs_n64(o, p[kk], desc_sw128(v_tile + kk * 16 * kRowBytes,
                                      (K * 16 * kRowBytes) >> 4));
}

// Brackets of an issue: every register the wgmmas read or write is pinned
// before wgmma.fence (so no arithmetic that defines it sinks between the
// fence and the products, which would make ptxas serialize them) and again
// after the commit (so nothing that reads it rises above its wait).
template <class... Regs>
__device__ __forceinline__ void issue_begin(Regs&... regs) {
  (fence_regs(regs), ...);
  wgmma_fence();
}

template <class... Regs>
__device__ __forceinline__ void issue_end(Regs&... regs) {
  wgmma_commit();
  (fence_regs(regs), ...);
}

// ------------------------------------------------------- shared storage

// Offsets into the block's dynamic shared memory (after 1024-byte alignment).
template <int BN>
struct Smem {
  static constexpr int q = 0;
  static constexpr int k = q + kConsumers * kQTileBytes;
  static constexpr int v = k + kStages * kv_tile_bytes<BN>();
  static constexpr int bars = v + kStages * kv_tile_bytes<BN>();
  // q_full, then k_full, k_empty, v_full, v_empty per stage
  static constexpr int n_bars = 1 + 4 * kStages;
  static constexpr int bytes = bars + n_bars * 8 + 1024;  // + alignment slack
};

struct Bars {
  uint32_t base;
  __device__ uint32_t q_full() const { return base; }
  __device__ uint32_t k_full(int s) const { return base + 8 * (1 + s); }
  __device__ uint32_t k_empty(int s) const {
    return base + 8 * (1 + kStages + s);
  }
  __device__ uint32_t v_full(int s) const {
    return base + 8 * (1 + 2 * kStages + s);
  }
  __device__ uint32_t v_empty(int s) const {
    return base + 8 * (1 + 3 * kStages + s);
  }
};

// ------------------------------------------------------------- producer

// One thread: the q tiles of the consumers, then K_j and V_j for every kv
// tile j into stage j % kStages once its consumers have released it.
template <int BN>
__device__ __forceinline__ void produce(const FwdParams& p, uint32_t smem,
                                        const Bars& bars, int b, int h,
                                        int q_row0, int n_tiles) {
  prefetch_map(&p.tm_q);
  prefetch_map(&p.tm_k);
  prefetch_map(&p.tm_v);
  mbar_expect_tx(bars.q_full(), kConsumers * kQTileBytes);
#pragma unroll
  for (int w = 0; w < kConsumers; ++w)
    tma_load(smem + Smem<BN>::q + w * kQTileBytes, &p.tm_q, bars.q_full(),
             h, q_row0 + w * kWgRows, b);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const uint32_t parity = ((j / kStages) & 1) ^ 1;  // round 0 passes
    mbar_wait(bars.k_empty(st), parity);
    mbar_expect_tx(bars.k_full(st), kv_tile_bytes<BN>());
    tma_load(smem + Smem<BN>::k + st * kv_tile_bytes<BN>(), &p.tm_k,
             bars.k_full(st), h, j * BN, b);
    mbar_wait(bars.v_empty(st), parity);
    mbar_expect_tx(bars.v_full(st), kv_tile_bytes<BN>());
    tma_load(smem + Smem<BN>::v + st * kv_tile_bytes<BN>(), &p.tm_v,
             bars.v_full(st), h, j * BN, b);
  }
}

// ------------------------------------------------------------- consumer

// The online-softmax state of a thread's two rows, in base 2.
struct RowState {
  float m_lo, m_hi;  // running max of s * scale_log2
  float l_lo, l_hi;  // running sum of p (this thread's columns)
};

// Mask the columns at or past t_len of the score tile (R = BN / 2
// registers) starting at kv column col0.
template <int R>
__device__ __forceinline__ void mask_tail(float (&s)[R], int col0, int t_len) {
  if (col0 + 2 * R <= t_len) return;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < R / 4; ++n) {
    const int c = col0 + n * 8 + t * 2;
    if (c >= t_len) s[4 * n] = s[4 * n + 2] = -INFINITY;
    if (c + 1 >= t_len) s[4 * n + 1] = s[4 * n + 3] = -INFINITY;
  }
}

// Softmax step on one score tile, in place: s becomes p = exp2(s * c - m),
// the running max and sum advance; returns the factors (alpha_lo,
// alpha_hi) that rescale the output accumulated so far.
template <int R>
__device__ __forceinline__ float2 softmax_step(float (&s)[R], RowState& st,
                                               float scale_log2) {
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int n = 0; n < R / 4; ++n) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[4 * n], s[4 * n + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  const float mn_lo = fmaxf(st.m_lo, mx_lo * scale_log2);
  const float mn_hi = fmaxf(st.m_hi, mx_hi * scale_log2);
  const float2 alpha = make_float2(exp2f(st.m_lo - mn_lo),
                                   exp2f(st.m_hi - mn_hi));
  st.m_lo = mn_lo;
  st.m_hi = mn_hi;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int n = 0; n < R / 4; ++n) {
    s[4 * n] = exp2f(fmaf(s[4 * n], scale_log2, -mn_lo));
    s[4 * n + 1] = exp2f(fmaf(s[4 * n + 1], scale_log2, -mn_lo));
    s[4 * n + 2] = exp2f(fmaf(s[4 * n + 2], scale_log2, -mn_hi));
    s[4 * n + 3] = exp2f(fmaf(s[4 * n + 3], scale_log2, -mn_hi));
    sum_lo += s[4 * n] + s[4 * n + 1];
    sum_hi += s[4 * n + 2] + s[4 * n + 3];
  }
  st.l_lo = st.l_lo * alpha.x + sum_lo;
  st.l_hi = st.l_hi * alpha.y + sum_hi;
  return alpha;
}

__device__ __forceinline__ void rescale(float (&o)[32], float2 alpha) {
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n) {
    o[4 * n] *= alpha.x;
    o[4 * n + 1] *= alpha.x;
    o[4 * n + 2] *= alpha.y;
    o[4 * n + 3] *= alpha.y;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// p (fp32 accumulator layout) rounded to bf16 as wgmma's register A operand.
template <int K>
__device__ __forceinline__ void pack_p(uint32_t (&a)[K][4],
                                       const float (&s)[8 * K]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// One arrival per warp: the barrier counts 4 * kConsumers.
__device__ __forceinline__ void release(uint32_t bar) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// Normalise and write the warpgroup's 64 rows of o (through its strides)
// and their natural-log LSE; rows at or past s_len are dropped.
__device__ __forceinline__ void store_rows(const FwdParams& p,
                                           const float (&o)[32], RowState st,
                                           int b, int h, int wg_row0) {
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
  for (int n = 0; n < kHeadDim / 8; ++n) {
    const int c = n * 8 + t * 2;
    if (r_lo < p.s_len)
      *reinterpret_cast<uint32_t*>(base + r_lo * p.o_ss + c) =
          pack_bf16(o[4 * n] * inv_lo, o[4 * n + 1] * inv_lo);
    if (r_hi < p.s_len)
      *reinterpret_cast<uint32_t*>(base + r_hi * p.o_ss + c) =
          pack_bf16(o[4 * n + 2] * inv_hi, o[4 * n + 3] * inv_hi);
  }
  if (t == 0) {
    float* lb = p.lse + (size_t)(b * p.heads + h) * p.s_len;
    if (r_lo < p.s_len) lb[r_lo] = (st.m_lo + log2f(st.l_lo)) * kLn2;
    if (r_hi < p.s_len) lb[r_hi] = (st.m_hi + log2f(st.l_hi)) * kLn2;
  }
}

// ------------------------------------------------------------ the kernel

// Block prologue and the role split; `Consume` is the schedule: its kv
// tile Consume::kBlockKV and
//   Consume::run(p, smem, bars, wg, n_tiles, o, st)
// with wg the consumer warpgroup (0 or 1), filling o and st.  The launch
// bounds fix the entry register count at 168, which setmaxnreg
// redistributes: the producer gives up all but 24, the consumers take 240.
template <class Consume>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ FwdParams p) {
  constexpr int BN = Consume::kBlockKV;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  const Bars bars{smem + Smem<BN>::bars};
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int q_row0 = blockIdx.x * kConsumers * kWgRows;
  const int n_tiles = (p.t_len + BN - 1) / BN;
  // the warpgroup index, warp-uniform as the role split below needs it
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);

  if (threadIdx.x == 0) {
    mbar_init(bars.q_full(), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars.k_full(s), 1);
      mbar_init(bars.v_full(s), 1);
      mbar_init(bars.k_empty(s), 4 * kConsumers);
      mbar_init(bars.v_empty(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) produce<BN>(p, smem, bars, b, h, q_row0, n_tiles);
  } else {
    setmaxnreg_inc<240>();
    float o[32];
    RowState st;
    Consume::run(p, smem, bars, wg - 1, n_tiles, o, st);
    store_rows(p, o, st, b, h, q_row0 + (wg - 1) * kWgRows);
  }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the runtime
// (cudaGetDriverEntryPoint), so the build needs no -lcuda.
inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &status);
#endif
    return status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(ptr)
               : nullptr;
  }();
  return fn;
}

// Make the current device's primary context current on the calling thread,
// once per thread.  A thread that has made no runtime call yet has none
// (PyTorch's autograd threads skip cudaSetDevice for device 0), and
// cuTensorMapEncodeTiled, which runs before the launch would bind one, fails
// without it.
inline cudaError_t bind_context() {
  static thread_local bool bound = false;
  if (bound) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  bound = err == cudaSuccess;
  return err;
}

// A (B, L, H, 64) bf16 tensor with element strides (sb, sl, sh, 1) as a 4-D
// map of dims (64, H, L, B) and box (64, 1, rows, 1), 128-byte swizzle;
// rows past L read as zeros.  Returns false if the encoder refuses it.
inline bool encode_map(CUtensorMap* map, const void* base, int b, int len,
                       int h, long long sb, long long sl, long long sh,
                       int rows) {
  EncodeTiledFn fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[4] = {kHeadDim, (cuuint64_t)h, (cuuint64_t)len,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sl * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {kHeadDim, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The C entry of both forwards.  q/k/v/o are (B, len, H, 64) bf16 with the
// element strides in `strides` (q, k, v, o: sb, sl, sh each; head_dim
// stride 1); lse (B*H, S) fp32.  Launches on `stream`, allocates nothing,
// returns a CUDA error code (0 = launched).
template <class Consume>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               int b, int h, int s_len, int t_len, const long long* strides,
               float scale, void* stream) {
  constexpr int BN = Consume::kBlockKV;
  if (b <= 0 || h <= 0 || s_len <= 0 || t_len <= 0 || (long long)b * h > 65535)
    return (int)cudaErrorInvalidValue;
  if (const cudaError_t err = bind_context()) return (int)err;
  FwdParams p;
  const long long* s = strides;
  if (!encode_map(&p.tm_q, q, b, s_len, h, s[0], s[1], s[2], kWgRows) ||
      !encode_map(&p.tm_k, k, b, t_len, h, s[3], s[4], s[5], BN) ||
      !encode_map(&p.tm_v, v, b, t_len, h, s[6], s[7], s[8], BN))
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
  auto kernel = flash_fwd_sm90_kernel<Consume>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<BN>::bytes);
  if (attr != cudaSuccess) return (int)attr;
  const int rows = kConsumers * kWgRows;
  dim3 grid((s_len + rows - 1) / rows, b * h);
  kernel<<<grid, kThreads, Smem<BN>::bytes, static_cast<cudaStream_t>(
                                                stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace sm90
