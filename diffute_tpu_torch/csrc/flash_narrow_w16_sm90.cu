// Flash attention's two bf16 forwards at tile width 16 (head_dims 8 and 16)
// for Hopper (sm_90a): the standard forward and the deferred-softmax
// forward, one kernel on a flag.  These are the tiny model's widths: its
// UNet's heads are 8 wide (three self-attentions of 65,536 tokens and one of
// 16,384 a 512^2 pass), its VAE mid-block's single head 16 wide with
// VAEConfig.use_flash_attention.  The backward pair at width 16 and every
// other narrow width and dtype stay with flash_narrow.cu.
//
// Replaces the Pallas TPU kernels of diffute_tpu/ops/flash_attention.py at
// those widths: `_fwd_kernel` (pl.pallas_call in `_flash_fwd_3d`) and
// `_fwd_kernel_pipelined` (in `_flash_fwd_3d_pipelined`).  Their BlockSpecs
// carry (m, l, acc) in VMEM scratch across a sequential kv grid axis; here
// one block owns kRows query rows of one (batch, head) and walks the kv
// axis itself.
//
//   q (B, S, H, D), k/v (B, T, H, D) bf16, D = 8 or 16, any strides that
//     are whole 16-byte chunks with the last one 1 (16-byte cp.async)
//   o (B, S, H, D) bf16 through its strides; lse (B*H, S) fp32 natural log
//
// The arithmetic is flash_narrow.cu's bf16 forward's (the plain version
// flash_fwd_tiled_reference of ops/flash_attention.py at kv tile
// kBlockKV, domain "base2"): s = q k^T in fp32 on the tensor cores, the row
// max of each 64-column tile, p = exp2(s * scale log2 e - m) with the scale
// folded into one FMA, p rounded to bf16 against the running max before
// p v, l the fp32 sum of the fp32 p through one explicit fmaf a tile, o =
// acc * (1 / l), the LSE (m + log2 l) ln 2.  The deferred forward runs the
// same code on the same tiles in another order: the standard one's bits.
//
// What bounds it on the H100.  A score costs 2 D multiply-adds in each
// product (32 or 64 tensor-core FLOPs) against one exponential.  The
// special-function unit (MUFU) gives 16 exponentials a clock an SM, a warp
// instruction every 8 clocks on each of the 4 schedulers, against 1,024
// bf16 tensor-core FLOPs a clock an SM, so the exponentials set the least
// time: at (B*H, S, T) = (2, 65536, 65536) 8.6e9 of them take about 2.05 ms
// at 1.98 GHz.  The kernel reaches that only if each scheduler issues
// fewer than 8 instructions a score, the MUFU's included, and keeps the
// MUFU fed.  What the design does about it:
//   - every exponential is one MUFU.EX2 (ex2.approx.ftz.f32 by inline PTX;
//     exp2f without -ftz lowers to a compare, two predicated multiplies and
//     the MUFU): it flushes only results below 2^-126, which add nothing
//     to an fp32 l of at least 1 or to a bf16 o;
//   - the products are sized to D, not to the tile width: at D = 8 the
//     scores take m16n8k8 and p v one 8-column output tile, rows of K, V
//     and q are 16 bytes in shared memory, nothing is zero-filled but
//     ragged rows; only the last kv tile of a ragged T is masked, in a
//     copy of the tile's code of its own;
//   - the row max is a tree, not a chain; alpha, the scale and the
//     negated max are once a tile;
//   - a block is kWarps = 4 warps of 16 query rows (64 rows) and K and V
//     stream through a kStages-deep cp.async ring with one barrier a kv
//     tile.  Blocks of 8 warps (128 rows, half the L2 reads) ran 5-12%
//     slower: a scheduler's 8 warps then come from 4 blocks, not 8, and
//     more of them are in step.  A ring on full and empty mbarriers with
//     no barrier a tile gained 3-4% on 8-warp blocks at D = 8, lost 8% at
//     16 and lost on 4-warp blocks: its waits took the loop from 213 to
//     287 instructions a tile;
//   - __launch_bounds__(128, kMinBlocks8) keeps both forwards at D = 8 at
//     64 registers (the deferred one with a 16-byte spill, which cost
//     less than the 2 blocks an SM 80 registers lose), 8 blocks an SM:
//     1,056 slots, so (2, 65536^2) takes 1.94 waves of its 2,048 blocks
//     and (4, 16384^2) 0.97 of its 1,024; at D = 16 (o and q twice as
//     wide) the standard forward takes kMinBlocks16 = 5, 96 registers:
//     (1, 65536^2) takes 1.55 waves and ran 3% faster than at 6 blocks (80
//     registers) and 17-21% faster than at 8 (64 registers, a 72-byte
//     spill); the deferred one, with two score tiles live, takes
//     kMinBlocks16Deferred = 4, 128 registers (1.94 waves): 12% faster than
//     at 5 (96 registers, a 24-byte spill, 516 instructions a trip of two
//     tiles against 488) and within 1% of the standard forward.
// SASS count (tools/narrow_w16_probes.py --sass: the loop over a kv tile,
// 32 scores a thread; H100 build).  D = 8, standard: 211 instructions,
// 6.59 a score: 34 MUFU.EX2 (32 scores, 2 alphas), 36 FMNMX, 34 FFMA, 32
// FADD, 16 F2FP, 12 HMMA, 6 FMUL, 4 SHFL, and 37 of ring, addresses and
// loop.  The deferred forward 6.52 a score; at D = 16 7.22 and 7.63.
// flash_narrow.cu's width-16 forward issued 14.41 (78 FMUL, 34 FSETP
// around its 34 MUFU, 16 CS2R clearing accumulators).  So the loop issues
// 211 instructions a warp against the MUFU's 272 clocks: the exponentials
// bound it, and it reaches 69% of their bound at (2, 65536^2).
//
// Layout.  Warp w owns query rows [16 w, 16 w + 16) of the block's tile and
// all D columns: its 16 x 64 score tile is 32 fp32 a thread (rows g and
// g + 8, columns 8 n + 2 t, + 1 of each of the 8 column tiles), its o 4 or
// 8 fp32.  Rows of 32 bytes (D = 16) are stored by 16-byte chunks, chunk c
// of row r at c ^ ((r >> 2) & 1), so the 8 rows one ldmatrix reads fall
// on distinct banks; 16-byte rows need no swizzle.
//
// Ragged edges.  Query rows past S and kv rows past T are zero-filled
// (cp.async's src-size 0); the kv columns past T of the last tile are
// masked to -inf; rows past S are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma_sync.cuh"
#include "tf32_sm90.cuh"

namespace {

using namespace bf16_mma;
using namespace tf32_sm90;

// the kv tile (ops/flash_attention.py NARROW_BLOCK_KV[16]) and the query
// rows a block (NARROW_W16_FWD_ROWS there, kRows = 16 kWarps); the K and V
// ring's stages; the launch bounds' blocks an SM at D = 8 (both forwards)
// and at D = 16 (the standard forward, then the deferred one)
constexpr int kBlockKV = 64;
constexpr int kWarps = 4, kStages = 4, kMinBlocks8 = 8, kMinBlocks16 = 5,
              kMinBlocks16Deferred = 4;
constexpr int kRows = 16 * kWarps;
constexpr int kThreads = 32 * kWarps;
constexpr float kLn2 = 0.6931471805599453f;
static_assert((kStages & (kStages - 1)) == 0 && kStages >= 3,
              "a power of two stages, at least three (the deferred forward "
              "waits a tile ahead)");

template <int kD>
struct Tile {
  static_assert(kD == 8 || kD == 16, "tile width 16: D = 8 or 16");
  static constexpr int kRowBytes = 2 * kD;
  static constexpr int kChunks = kD / 8;  // 16-byte chunks a row
  static constexpr int kQBytes = kRows * kRowBytes;
  static constexpr int kKVBytes = kBlockKV * kRowBytes;
  // q | k[kStages] | v[kStages]
  static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes;
  // the 16-byte chunks of a tile's K and V and the threads that copy them,
  // each kPer of them
  static constexpr int kTileChunks = 2 * kBlockKV * kChunks;
  static constexpr int kPer = (kTileChunks + kThreads - 1) / kThreads;
  static constexpr int kLoaders = kTileChunks / kPer;
  static_assert(kTileChunks % kPer == 0, "whole chunks a loader");
  static constexpr int kQRegs = kD / 4;  // q's A fragment: m16k8 or m16k16
  static constexpr int kOT = kD / 8;     // 8-column output tiles
};

// byte offset of chunk c of row r in a tile
template <int kD>
__device__ __forceinline__ uint32_t chunk_off(int r, int c) {
  if constexpr (kD == 8)
    return r * 16;
  else
    return r * 32 + ((c ^ ((r >> 2) & 1)) << 4);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

struct Params {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* o;
  float* lse;
  long long st[12];  // (sb, sl, sh) of q, k, v, o
  int heads, s_len, t_len;
  float scale_log2;
};

// The online softmax state of one thread's two rows (g and g + 8 of its
// warp's 16): the running max in log2 units and this thread's share of l.
struct Stats {
  float m_lo, m_hi, l_lo, l_hi;
};

// The q A fragment of this warp's 16 rows, from the q tile at `qt`.
template <int kD>
__device__ __forceinline__ void load_q_frag(uint32_t (&qa)[Tile<kD>::kQRegs],
                                            uint32_t qt, int warp, int lane) {
  if constexpr (kD == 8) {
    ldmatrix_x2(qa, qt + chunk_off<8>(warp * 16 + (lane & 15), 0));
  } else {
    const int mi = lane >> 3, mr = lane & 7;
    ldmatrix_x4(qa, qt + chunk_off<16>(warp * 16 + (mi & 1) * 8 + mr,
                                       mi >> 1));
  }
}

// s (16 x 64, fp32) = this warp's q rows times the K tile at `kt`,
// transposed.
template <int kD>
__device__ __forceinline__ void scores(float (&s)[8][4],
                                       const uint32_t (&qa)[Tile<kD>::kQRegs],
                                       uint32_t kt, int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
  if constexpr (kD == 8) {
    // 4 column tiles an ldmatrix: kv rows 32 h + lane
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t b[4];
      ldmatrix_x4(b, kt + chunk_off<8>(32 * h + lane, 0));
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_bf16_k8(s[4 * h + i], qa, b[i]);
    }
  } else {
    // (n0, k lo), (n0, k hi), (n0 + 8, k lo), (n0 + 8, k hi)
    const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t b[4];
      ldmatrix_x4(b, kt + chunk_off<16>(16 * p + (mi >> 1) * 8 + mr, mi & 1));
      mma_bf16(s[2 * p], qa, b[0], b[1]);
      mma_bf16(s[2 * p + 1], qa, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ float max_tree(float (&x)[8]) {
#pragma unroll
  for (int w = 4; w > 0; w >>= 1)
#pragma unroll
    for (int i = 0; i < w; ++i) x[i] = fmaxf(x[i], x[i + w]);
  return x[0];
}

// Tile j's online softmax on its raw scores `s` (kMask: the columns at or
// past t_len of a tile starting at col0 are -inf), then o += p v with the
// V tile at `vt`.  Both forwards run this code on the same scores.
template <int kD, bool kMask>
__device__ __forceinline__ void consume(float (&s)[8][4],
                                        float (&o)[Tile<kD>::kOT][4],
                                        Stats& st, uint32_t vt, float c,
                                        int col0, int t_len, int lane) {
  if constexpr (kMask) {
    const int t = lane & 3;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = col0 + n * 8 + t * 2;
      if (col >= t_len) s[n][0] = s[n][2] = -INFINITY;
      if (col + 1 >= t_len) s[n][1] = s[n][3] = -INFINITY;
    }
  }
  float a[8], b[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    a[n] = fmaxf(s[n][0], s[n][1]);
    b[n] = fmaxf(s[n][2], s[n][3]);
  }
  float mx_lo = max_tree(a), mx_hi = max_tree(b);
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  const float mn_lo = fmaxf(st.m_lo, mx_lo * c);
  const float mn_hi = fmaxf(st.m_hi, mx_hi * c);
  const float alpha_lo = ex2(st.m_lo - mn_lo);
  const float alpha_hi = ex2(st.m_hi - mn_hi);
  st.m_lo = mn_lo;
  st.m_hi = mn_hi;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    s[n][0] = ex2(fmaf(s[n][0], c, -mn_lo));
    s[n][1] = ex2(fmaf(s[n][1], c, -mn_lo));
    s[n][2] = ex2(fmaf(s[n][2], c, -mn_hi));
    s[n][3] = ex2(fmaf(s[n][3], c, -mn_hi));
  }
  // the row sums column tile by column tile; starting from the first pair,
  // not from 0, gives the same bits with two adds fewer
  float sum_lo = s[0][0] + s[0][1], sum_hi = s[0][2] + s[0][3];
#pragma unroll
  for (int n = 1; n < 8; ++n) {
    sum_lo += s[n][0] + s[n][1];
    sum_hi += s[n][2] + s[n][3];
  }
  // one explicit FMA, so that both forwards round the sum alike
  st.l_lo = fmaf(st.l_lo, alpha_lo, sum_lo);
  st.l_hi = fmaf(st.l_hi, alpha_hi, sum_hi);
#pragma unroll
  for (int n = 0; n < Tile<kD>::kOT; ++n) {
    o[n][0] *= alpha_lo;
    o[n][1] *= alpha_lo;
    o[n][2] *= alpha_hi;
    o[n][3] *= alpha_hi;
  }
  // p as the A fragments of p v (the accumulator layout is the A layout)
  uint32_t pa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
  if constexpr (kD == 8) {
    // (kv 32 h + 0-7), (+ 8-15), (+ 16-23), (+ 24-31), transposed: b0, b1
    // of two 16-row contraction steps
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t v4[4];
      ldmatrix_x4_trans(v4, vt + chunk_off<8>(32 * h + lane, 0));
      mma_bf16(o[0], pa[2 * h], v4[0], v4[1]);
      mma_bf16(o[0], pa[2 * h + 1], v4[2], v4[3]);
    }
  } else {
    // transposed: (k lo, n0), (k hi, n0), (k lo, n0 + 8), (k hi, n0 + 8)
    const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t v4[4];
      ldmatrix_x4_trans(v4,
                        vt + chunk_off<16>(kk * 16 + (mi & 1) * 8 + mr, mi >> 1));
      mma_bf16(o[0], pa[kk], v4[0], v4[1]);
      mma_bf16(o[1], pa[kk], v4[2], v4[3]);
    }
  }
}

// One thread's share of every K and V tile: kPer chunks, chunk i being
// chunk `c` of row `row[i]` of K or V (or none: active false).
template <int kD>
struct Loader {
  const __nv_bfloat16* src[Tile<kD>::kPer];  // its chunks of the next tile
  long long step[Tile<kD>::kPer];            // kBlockKV rows, in elements
  uint32_t dst[Tile<kD>::kPer];  // its chunks' bytes in stage 0 of a ring
  int row[Tile<kD>::kPer];
  bool active;
};

template <int kD>
__device__ __forceinline__ Loader<kD> make_loader(const Params& p, int b,
                                                  int h, uint32_t base,
                                                  int tid) {
  using TL = Tile<kD>;
  Loader<kD> ld;
  ld.active = tid < TL::kLoaders;
#pragma unroll
  for (int i = 0; i < TL::kPer; ++i) {
    const int id = (tid + i * kThreads) % TL::kTileChunks;
    const int tensor = id / (kBlockKV * TL::kChunks);  // 0: K, 1: V
    const int rem = id % (kBlockKV * TL::kChunks);
    const int r = rem / TL::kChunks, c = rem % TL::kChunks;
    const long long* st = p.st + 3 * (1 + tensor);
    ld.src[i] = (tensor ? p.v : p.k) + b * st[0] + h * st[2] + r * st[1] +
                c * 8;
    ld.step[i] = kBlockKV * st[1];
    ld.dst[i] = base + TL::kQBytes + tensor * kStages * TL::kKVBytes +
                chunk_off<kD>(r, c);
    ld.row[i] = r;
  }
  return ld;
}

// A loader's share of tile j into ring stage j % kStages (rows at or past
// t_len zero-filled: cp.async's src-size 0 reads nothing).
template <int kD>
__device__ __forceinline__ void load_kv(Loader<kD>& ld, int j, int t_len) {
  if (!ld.active) return;
#pragma unroll
  for (int i = 0; i < Tile<kD>::kPer; ++i) {
    const bool ok = j * kBlockKV + ld.row[i] < t_len;
    cp_async_16(ld.dst[i] + (j & (kStages - 1)) * Tile<kD>::kKVBytes,
                ld.src[i], ok ? 16 : 0);
    ld.src[i] += ld.step[i];
  }
}

template <int kD, bool kDeferred>
__global__ void __launch_bounds__(kThreads,
                                  kD == 8      ? kMinBlocks8
                                  : kDeferred ? kMinBlocks16Deferred
                                              : kMinBlocks16)
    fwd_kernel(Params p) {
  using TL = Tile<kD>;
  __shared__ __align__(128) unsigned char smem[TL::kSmem];
  const uint32_t base = smem_u32(smem);
  const uint32_t kring = base + TL::kQBytes;
  const uint32_t vring = kring + kStages * TL::kKVBytes;
  constexpr int kLead = kDeferred ? 1 : 0;  // S is a tile ahead

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kRows;
  const int t_len = p.t_len;
  const int n_tiles = (t_len + kBlockKV - 1) / kBlockKV;

  // ---- q (rows past S zero-filled) with tile 0, then tiles 1..kStages-2,
  // a cp.async group each
  if (tid < kRows * TL::kChunks) {
    const int r = tid / TL::kChunks, c = tid % TL::kChunks;
    const bool ok = q0 + r < p.s_len;
    const __nv_bfloat16* g =
        p.q + b * p.st[0] + h * p.st[2] +
        (ok ? (long long)(q0 + r) * p.st[1] + c * 8 : 0);
    cp_async_16(base + chunk_off<kD>(r, c), g, ok ? 16 : 0);
  }
  Loader<kD> ld = make_loader<kD>(p, b, h, base, tid);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_kv<kD>(ld, i, t_len);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2 - kLead>();
  __syncthreads();

  uint32_t qa[TL::kQRegs];
  load_q_frag<kD>(qa, base, warp, lane);
  const float c = p.scale_log2;
  float o[TL::kOT][4];
#pragma unroll
  for (int n = 0; n < TL::kOT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  Stats st = {-INFINITY, -INFINITY, 0.f, 0.f};

  // Body j's wait, barrier and refill: tile j + kLead is in, and every
  // warp is done with tile j - 1, whose stage takes tile j + kStages - 1
  // (an empty group past the end keeps the count).  Body 0's wait is the
  // prologue's.
  auto refill = [&](int j) {
    if (j > 0) {
      cp_async_wait<kStages - 2 - kLead>();
      __syncthreads();
    }
    if (j + kStages - 1 < n_tiles) load_kv<kD>(ld, j + kStages - 1, t_len);
    cp_async_commit();
  };
  auto kt = [&](int j) {
    return kring + (j & (kStages - 1)) * TL::kKVBytes;
  };
  auto vt = [&](int j) {
    return vring + (j & (kStages - 1)) * TL::kKVBytes;
  };

  if constexpr (!kDeferred) {
    // ---- the full tiles, then a ragged last one masked
    const int n_full = t_len / kBlockKV;
    for (int j = 0; j < n_full; ++j) {
      refill(j);
      float s[8][4];
      scores<kD>(s, qa, kt(j), lane);
      consume<kD, false>(s, o, st, vt(j), c, 0, t_len, lane);
    }
    if (n_full < n_tiles) {
      refill(n_full);
      float s[8][4];
      scores<kD>(s, qa, kt(n_full), lane);
      consume<kD, true>(s, o, st, vt(n_full), c, n_full * kBlockKV, t_len,
                        lane);
    }
  } else {
    // ---- S(j + 1) issued before tile j's softmax; t_len is a whole number
    // (at least two) of tiles.  Two bodies a trip, the score tiles taking
    // turns, so no tile is copied.
    float sa[8][4], sb[8][4];
    scores<kD>(sa, qa, kt(0), lane);
    int j = 0;
    for (; j + 2 < n_tiles; j += 2) {
      refill(j);
      scores<kD>(sb, qa, kt(j + 1), lane);
      consume<kD, false>(sa, o, st, vt(j), c, 0, t_len, lane);
      refill(j + 1);
      scores<kD>(sa, qa, kt(j + 2), lane);
      consume<kD, false>(sb, o, st, vt(j + 1), c, 0, t_len, lane);
    }
    if (j + 1 < n_tiles) {
      refill(j);
      scores<kD>(sb, qa, kt(j + 1), lane);
      consume<kD, false>(sa, o, st, vt(j), c, 0, t_len, lane);
      refill(j + 1);
      consume<kD, false>(sb, o, st, vt(j + 1), c, 0, t_len, lane);
    } else {
      refill(j);
      consume<kD, false>(sa, o, st, vt(j), c, 0, t_len, lane);
    }
  }
  cp_async_wait<0>();

  // ---- o = acc / l through o's strides, the natural-log LSE
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    st.l_lo += __shfl_xor_sync(0xffffffffu, st.l_lo, off);
    st.l_hi += __shfl_xor_sync(0xffffffffu, st.l_hi, off);
  }
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
  const float f_lo = 1.f / st.l_lo, f_hi = 1.f / st.l_hi;
  const long long* os = p.st + 9;
  __nv_bfloat16* ob = p.o + b * os[0] + h * os[2] + t * 2;
#pragma unroll
  for (int n = 0; n < TL::kOT; ++n) {
    if (r_lo < p.s_len)
      *reinterpret_cast<uint32_t*>(ob + r_lo * os[1] + n * 8) =
          pack_bf16(o[n][0] * f_lo, o[n][1] * f_lo);
    if (r_hi < p.s_len)
      *reinterpret_cast<uint32_t*>(ob + r_hi * os[1] + n * 8) =
          pack_bf16(o[n][2] * f_hi, o[n][3] * f_hi);
  }
  if (t == 0) {
    float* lb = p.lse + (long long)bh * p.s_len;
    if (r_lo < p.s_len) lb[r_lo] = (st.m_lo + log2f(st.l_lo)) * kLn2;
    if (r_hi < p.s_len) lb[r_hi] = (st.m_hi + log2f(st.l_hi)) * kLn2;
  }
}

template <int kD, bool kDeferred>
int launch(const Params& p, int bh, void* stream) {
  dim3 grid((p.s_len + kRows - 1) / kRows, bh);
  fwd_kernel<kD, kDeferred>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

int forward(bool deferred, const void* q, const void* k, const void* v,
            void* o, void* lse, int b, int h, int s_len, int t_len, int d,
            const long long* strides, float scale, void* stream) {
  if (b <= 0 || h <= 0 || s_len <= 0 || t_len <= 0 || b * h > 65535 ||
      (d != 8 && d != 16))
    return (int)cudaErrorInvalidValue;
  if (deferred && (t_len % kBlockKV || t_len < 2 * kBlockKV))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  for (int i = 0; i < 12; ++i) p.st[i] = strides[i];
  p.heads = h;
  p.s_len = s_len;
  p.t_len = t_len;
  // rounded to fp32 once, as the JAX package's `q * (scale * _LOG2E)` is
  p.scale_log2 = (float)((double)scale * 1.4426950408889634);
  if (d == 8)
    return deferred ? launch<8, true>(p, b * h, stream)
                    : launch<8, false>(p, b * h, stream);
  return deferred ? launch<16, true>(p, b * h, stream)
                  : launch<16, false>(p, b * h, stream);
}

template <int kD, bool kDeferred>
int blocks_per_sm() {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, fwd_kernel<kD, kDeferred>, kThreads, 0);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

// Plain C entry points for ctypes, flash_narrow.cu's argument lists: the
// head_dim `d` (8 or 16) after t_len; tensors (B, len, H, d) bf16 with the
// element strides in `strides` (sb, sl, sh of q, k, v, o; head_dim stride
// 1), lse (B*H, S) fp32 contiguous.  flash_fwd_pipelined_w16_bf16 refuses a
// t_len that is not a whole number, at least two, of kBlockKV-row tiles.
// Each launches on `stream`, allocates nothing, and returns a CUDA error
// code (0 = launched; cudaErrorInvalidValue for arguments it refuses).

extern "C" int flash_fwd_w16_bf16(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int b, int h, int s_len,
                                  int t_len, int d, const long long* strides,
                                  float scale, void* stream) {
  return forward(false, q, k, v, o, lse, b, h, s_len, t_len, d, strides,
                 scale, stream);
}

extern "C" int flash_fwd_pipelined_w16_bf16(const void* q, const void* k,
                                            const void* v, void* o, void* lse,
                                            int b, int h, int s_len,
                                            int t_len, int d,
                                            const long long* strides,
                                            float scale, void* stream) {
  return forward(true, q, k, v, o, lse, b, h, s_len, t_len, d, strides, scale,
                 stream);
}

// The blocks of kThreads threads an SM runs at once of the standard (0) or
// deferred (1) forward at head_dim d (8 or 16), by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor (minus a CUDA error code if
// the query fails, 0 for a d it does not take): the waves of a launch are
// its ceil(S / kRows) * B*H blocks over this times the SMs.
extern "C" int flash_fwd_w16_bf16_blocks_per_sm(int deferred, int d) {
  if (d == 8) return deferred ? blocks_per_sm<8, true>() : blocks_per_sm<8, false>();
  if (d == 16)
    return deferred ? blocks_per_sm<16, true>() : blocks_per_sm<16, false>();
  return 0;
}
