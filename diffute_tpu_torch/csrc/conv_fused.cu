// Fused GroupNorm + SiLU + 3x3 convolution (padding 1) for Hopper (sm_90a),
// NCHW bf16 in and out, fp32 accumulation.
//
// Replaces the Pallas TPU kernel `_kernel` of diffute_tpu/ops/conv_fused.py
// (`_fwd_impl`'s pl.pallas_call).  It computes the same function, not the
// same grid.  The Pallas kernel keeps one sample's zero-padded normalised
// slab (H+2, W+2, C) in VMEM, recomputes the GroupNorm statistics in every
// Cout tile and runs nine shifted whole-slab matmuls; a thread block has
// 227 KB, so here the statistics come once from gn_stats_bf16 (groupnorm.cu)
// and the convolution is an implicit GEMM over small tiles:
//
//   out[b, co, p] = bias[co] + sum_{tap, ci} w[co, tap, ci] * n[b, ci, p + tap]
//   n = bf16(silu(x * a_c + d_c)) inside the image and 0 outside it
//
// (the zero padding is of the NORMALISED tensor: an out-of-image tap adds 0,
// not silu(d_c)).  GEMM view: M = Cout (wgmma's 64-row tiles), N = 64
// output pixels, K = 9 * Cin walked in chunks of 16 input channels.  Both
// operands are MN-major in shared memory (16 rows of k, each 64 contiguous
// output channels or pixels, 128-byte swizzle): in NCHW a channel's pixels
// are contiguous, and the weights are repacked once into that layout.  The
// normalised tensor never reaches device memory.
//
// What bounds it on the H100: operations, 18*Cin*Cout per pixel on the tensor
// cores (the byte bound is 4 to 100 times lower at the UNet's shapes); in
// this design, before them, the producers' normalisation and the latency of
// the weights' path from L2.  Each 64-pixel block reads the weights of every
// output channel it owns once per 16-channel chunk, 64 FLOPs per weight
// byte: one chunk's products (45 wgmma m64n64k16 at five Cout tiles, 5.9
// MFLOP) take about 1,400 SM clocks at the tensor cores' peak, no longer than
// normalising the chunk's patch and less than a 92 KB copy's latency from L2
// under load.  What the design does:
//   - a block owns 64 output pixels (1 x 64, 2 x 32, 4 x 16 or 8 x 8, the
//     widest that divides W) and up to five 64-channel Cout tiles: all of
//     Cout 320, a quarter of 1280, so each normalised element feeds 320 x
//     18 tensor FLOPs (a design of 128-channel tiles normalises the patch
//     again for every tile, and computes 384 channels for Cout 320).  320
//     channels x 64 pixels is 80 fp32 accumulators a consumer thread; more
//     pixels do not fit in the registers of a 512-thread block;
//   - two producer warpgroups.  Warp 0 copies the weights by bulk copies,
//     one contiguous run of the repacked tensor per kernel row (ky) of a
//     chunk, into a ring of six sub-stages (two chunks), so a row's buffer
//     is refilled as soon as its 15 products are done (two whole-chunk
//     stages of 92 KB ran slower at every shape);  The other 224 threads load the raw
//     x halo patch and its GroupNorm parameters into registers two chunks
//     ahead, normalise each chunk's patch ONCE into registers before they
//     wait for its buffer, zero it outside the image (after the affine),
//     and store it nine times, shifted by each tap, into the swizzled B
//     tiles (a two-chunk ring), so that every tap is a plain 64-pixel
//     operand.  The lanes of a warp take runs of one patch row, so the
//     taps a row feeds are the same across the warp;
//   - warpgroups 2 and 3 split the Cout tiles (3 + 2 at five) and issue
//     3 wgmma m64n64k16 per tile and kernel row from the two shared
//     operands, each row's before the previous row's are waited for; they
//     do no loads and no __syncthreads;
//   - where the grid would leave the card empty (64-pixel blocks give 64
//     blocks at 64^2, 4 at 8^2) Cin is split over blockIdx.z into fp32
//     partial sums, added in a fixed order by a second kernel (no float
//     atomics: the result is deterministic).
// Tried on an H100 and slower (PERF.md): a 4-D TMA of the raw patch into one
// shared buffer, or one producer warpgroup, left the producers' latency in
// every chunk; clusters of 2 and 4 blocks that multicast the weights cut
// their L2 traffic, but each chunk waited for the slowest block of its
// cluster.

#include "gemm_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kCk = 16;                    // input channels a chunk
constexpr int kPix = 64;                   // output pixels a block
constexpr int kMaxTiles = 5;               // 64-channel Cout tiles a block
constexpr int kOpBytes = kCk * kPix * 2;   // one 16 x 64 bf16 operand tile
constexpr int kRowBytes = 3 * kOpBytes;    // a Cout tile's 3 taps of a ky
constexpr int kBBytes = 9 * kOpBytes;      // the nine B tiles: 18,432 bytes
// A (the weights) runs through a ring of ky-row sub-stages, three a chunk,
// B (the normalised patch) through a ring of two chunks
constexpr int kAStages = 6;
constexpr int kBStages = 2;
constexpr int kProducers = 2;              // producer warpgroups
constexpr int kConvThreads = (kProducers + kConsumers) * 128;
// warp 0 copies the weights; the producers' other threads normalise
constexpr int kNormThreads = kProducers * 128 - 32;
// 8-pixel runs of a chunk's halo patch a normalising thread takes: the
// patch is 16 channels x (TR + 2) rows x TW / 8 runs, at most 384
constexpr int kItems = (384 + kNormThreads - 1) / kNormThreads;

struct ConvParams {
  const __nv_bfloat16* x;
  const __nv_bfloat16* wp;
  const float* mean;
  const float* rstd;
  const void* gamma;
  const void* beta;
  const void* bias;
  __nv_bfloat16* out;
  float* partial;
  int gn_bf16, bias_bf16;
  int batch, cin, cout, h, w;
  int tw_shift, tiles_x, tiles_y;
  int cpg, groups, chunks_per_split;
  // ceil(2^32 / cpg): c / cpg = (c * magic) >> 32 for every c < 2^16
  unsigned long long cpg_magic;
  int m_tiles, tiles_per_block;
};

// Shared memory: the A ring (each sub-stage one ky row of the block's Cout
// tiles: tiles x 3 taps x 16 x 64), the B ring, then the barriers of both.
struct ConvSmem {
  int a_stage, b, bars, bytes;
  __host__ __device__ explicit ConvSmem(int tiles) {
    a_stage = tiles * kRowBytes;
    b = kAStages * a_stage;
    bars = b + kBStages * kBBytes;
    bytes = bars + 2 * (kAStages + kBStages) * 8 + 1024;  // + alignment
  }
};

__device__ __forceinline__ float ld_param(const void* p, int i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ uint32_t norm_silu_bits(float x, float a, float d) {
  const float u = fmaf(x, a, d);
  return (uint32_t)__bfloat16_as_ushort(
      __float2bfloat16_rn(__fdividef(u, 1.f + __expf(-u))));
}

// ---------------------------------------------------------------- producer

// One 8-pixel run of the halo patch: its channel, patch row and column
// group, where it starts in its channel plane of x, and what lies outside.
struct Item {
  int cl, rr, cg;   // cl < 0: no item
  int x_off;        // offset of the run's first pixel in the channel plane
  bool row_ok, left_ok, right_ok;
};

// What the producer loads for one item two chunks ahead: the run, its two
// neighbours and the GroupNorm parameters of its channel, all as raw bits
// (bf16 in the low half, or fp32), so that no instruction uses a load's
// value before the chunk that needs it.
struct Raw {
  uint4 v;
  uint32_t left, right, gamma, beta;
  float mean, rstd;
};

__device__ __forceinline__ uint32_t ld_bits(const void* p, int i, int is_bf16) {
  return is_bf16 ? (uint32_t)__ldg(static_cast<const unsigned short*>(p) + i)
                 : __ldg(static_cast<const uint32_t*>(p) + i);
}

__device__ __forceinline__ float bits_float(uint32_t bits, int is_bf16) {
  return __uint_as_float(is_bf16 ? bits << 16 : bits);
}

__device__ __forceinline__ void load_raw(Raw (&raw)[kItems],
                                         const Item (&items)[kItems],
                                         const ConvParams& p, int b,
                                         int chunk) {
  const size_t plane = (size_t)p.h * p.w;
  const __nv_bfloat16* xc = p.x + ((size_t)b * p.cin + chunk * kCk) * plane;
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(xc);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const Item& it = items[k];
    if (it.cl < 0 || !it.row_ok) continue;
    raw[k].v = __ldg(reinterpret_cast<const uint4*>(xc + it.x_off));
    raw[k].left = it.left_ok ? (uint32_t)__ldg(xs + it.x_off - 1) : 0u;
    raw[k].right = it.right_ok ? (uint32_t)__ldg(xs + it.x_off + 8) : 0u;
    const int ci = chunk * kCk + it.cl;
    const int bg = b * p.groups + (int)((ci * p.cpg_magic) >> 32);
    raw[k].gamma = ld_bits(p.gamma, ci, p.gn_bf16);
    raw[k].beta = ld_bits(p.beta, ci, p.gn_bf16);
    raw[k].mean = __ldg(p.mean + bg);
    raw[k].rstd = __ldg(p.rstd + bg);
  }
}

// e[k][j]: the bf16 bits of columns col - 1 .. col + 8 of item k's run,
// normalised, zero outside the image.  No branch: every item's ten values
// are computed and masked, so the compiler interleaves all of them.
__device__ __forceinline__ void normalise(uint32_t (&e)[kItems][10],
                                          const Item (&items)[kItems],
                                          const Raw (&raw)[kItems],
                                          int gn_bf16) {
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const Item& it = items[k];
    const bool ok = it.cl >= 0 && it.row_ok;
    const float a = bits_float(raw[k].gamma, gn_bf16) * raw[k].rstd;
    const float d = bits_float(raw[k].beta, gn_bf16) - raw[k].mean * a;
    const uint32_t w[4] = {raw[k].v.x, raw[k].v.y, raw[k].v.z, raw[k].v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t lo = norm_silu_bits(__uint_as_float(w[j] << 16), a, d);
      const uint32_t hi =
          norm_silu_bits(__uint_as_float(w[j] & 0xFFFF0000u), a, d);
      e[k][1 + 2 * j] = ok ? lo : 0u;
      e[k][2 + 2 * j] = ok ? hi : 0u;
    }
    const uint32_t l = norm_silu_bits(__uint_as_float(raw[k].left << 16), a, d);
    const uint32_t r =
        norm_silu_bits(__uint_as_float(raw[k].right << 16), a, d);
    e[k][0] = ok && it.left_ok ? l : 0u;
    e[k][9] = ok && it.right_ok ? r : 0u;
  }
}

// Store each run into the B tile of every tap that reads it: tap (dy, dx)
// holds, at output pixel (r, c), the patch pixel (r + dy, c + dx - 1); row
// cl of a tile is 128 bytes with 16-byte chunk j at j ^ (cl & 7).
__device__ __forceinline__ void store_b(const uint32_t (&e)[kItems][10],
                                        const Item (&items)[kItems],
                                        uint32_t b_s, int tr, int g8) {
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const Item& it = items[k];
    if (it.cl < 0) continue;
    uint4 vec[3];
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      vec[dx].x = e[k][dx] | (e[k][dx + 1] << 16);
      vec[dx].y = e[k][dx + 2] | (e[k][dx + 3] << 16);
      vec[dx].z = e[k][dx + 4] | (e[k][dx + 5] << 16);
      vec[dx].w = e[k][dx + 6] | (e[k][dx + 7] << 16);
    }
    const uint32_t row_base = b_s + (it.cl >> 3) * 1024 + (it.cl & 7) * 128;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int r = it.rr - dy;
      if (r < 0 || r >= tr) continue;
      const uint32_t dst =
          row_base + (((r * g8 + it.cg) ^ (it.cl & 7)) << 4);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        st_shared_v4(dst + (3 * dy + dx) * kOpBytes, vec[dx]);
    }
  }
}

// Warp 0 of the producers: lane 0 copies sub-stage j (chunk j / 3, kernel
// row ky = j % 3) of the block's weights, one contiguous run of the packed
// tensor, once the consumers have released its buffer.
__device__ __forceinline__ void load_weights(const ConvParams& p,
                                             uint32_t smem, const ConvSmem& sm,
                                             const GemmRing& ring_a, int mt0,
                                             int tiles, int chunk0,
                                             int n_chunks) {
  const uint32_t bytes = tiles * kRowBytes;
  const uint8_t* w = reinterpret_cast<const uint8_t*>(p.wp) +
                     ((size_t)chunk0 * 3 * p.m_tiles + mt0) * kRowBytes;
  for (int j = 0; j < 3 * n_chunks; ++j) {
    const int st = j % kAStages;
    ring_a.wait_empty(j);
    mbar_expect_tx(ring_a.full(st), bytes);
    bulk_load(smem + st * sm.a_stage, w + (size_t)j * p.m_tiles * kRowBytes,
              bytes, ring_a.full(st));
  }
}

// The producers' other threads.  Each one's share of a chunk's patch and
// its GroupNorm parameters are loaded two chunks ahead into one of two
// register sets, used in turn (the loop body is two chunks: a copy from one
// set to the other would wait for loads issued one chunk earlier), and the
// chunk is normalised into registers BEFORE the producers wait for its B
// buffer, so that only the stores stand between the consumers' release of
// the buffer and its refill.
__device__ __forceinline__ void normalise_patches(const ConvParams& p,
                                                  uint32_t smem,
                                                  const ConvSmem& sm,
                                                  const GemmRing& ring_b,
                                                  int b, int row0, int col0,
                                                  int chunk0, int n_chunks) {
  const int tid = threadIdx.x - 32;
  const int tw = 1 << p.tw_shift, tr = kPix >> p.tw_shift;
  const int r2 = tr + 2, g8 = tw >> 3;

  Item items[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int id = tid + i * kNormThreads;
    Item& it = items[i];
    it.cl = -1;
    it.rr = it.cg = it.x_off = 0;
    it.row_ok = it.left_ok = it.right_ok = false;
    if (id < kCk * r2 * g8) {
      // patch row slowest: the lanes of a warp share one (two at TW = 8),
      // so the taps that row feeds are the same across the warp
      it.cg = id % g8;
      it.cl = (id / g8) % kCk;
      it.rr = id / (g8 * kCk);
      const int row = row0 + it.rr - 1, col = col0 + it.cg * 8;
      it.row_ok = row >= 0 && row < p.h;
      it.left_ok = it.row_ok && col > 0;
      it.right_ok = it.row_ok && col + 8 < p.w;
      it.x_off = it.cl * p.h * p.w + row * p.w + col;
    }
  }

  auto chunk = [&](int i, Raw (&raw)[kItems]) {
    const int st = i % kBStages;
    uint32_t e[kItems][10];
    normalise(e, items, raw, p.gn_bf16);
    if (i + 2 < n_chunks) load_raw(raw, items, p, b, chunk0 + i + 2);
    ring_b.wait_empty(i);
    store_b(e, items, smem + sm.b + st * kBBytes, tr, g8);
    fence_proxy_async();
    mbar_arrive(ring_b.full(st));
  };
  Raw ra[kItems], rb[kItems];
  load_raw(ra, items, p, b, chunk0);
  if (n_chunks > 1) load_raw(rb, items, p, b, chunk0 + 1);
  int i = 0;
  for (; i + 1 < n_chunks; i += 2) {
    chunk(i, ra);
    chunk(i + 1, rb);
  }
  if (i < n_chunks) chunk(i, ra);
}

// ---------------------------------------------------------------- consumer

template <int NT>
__device__ __forceinline__ void fence_acc(float (&acc)[NT][32]) {
#pragma unroll
  for (int t = 0; t < NT; ++t) fence_regs(acc[t]);
}

// Sub-stage j's 3 * NT products: kernel row ky = j % 3 of chunk j / 3,
// tile t of this warpgroup being Cout tile tile0 + t of the block.
template <int NT>
__device__ __forceinline__ void issue_row(float (&acc)[NT][32], uint32_t smem,
                                          const ConvSmem& sm, int tile0,
                                          int j) {
  const uint32_t a_s = smem + (j % kAStages) * sm.a_stage;
  const uint32_t b_s =
      smem + sm.b + ((j / 3) % kBStages) * kBBytes + (j % 3) * kRowBytes;
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
    const uint64_t db = desc_sw128(b_s + kx * kOpBytes, kOpBytes >> 4);
#pragma unroll
    for (int t = 0; t < NT; ++t)
      wgmma_ss_mn_n64(acc[t],
                      desc_sw128(a_s + (tile0 + t) * kRowBytes +
                                     kx * kOpBytes, kOpBytes >> 4),
                      db);
  }
  wgmma_commit();
  fence_acc(acc);
}

// Chunk i, its three kernel rows in turn.  Each row's products are issued
// before the previous row's are waited for; the wait then releases that
// row's weights, and at the chunk's first row the previous chunk's B
// buffer.  The first chunk is a separate instance (it has no previous row),
// so no branch sits in the body while a product is in flight.
template <int NT, bool kFirst>
__device__ __forceinline__ void consume_chunk(float (&acc)[NT][32],
                                              uint32_t smem, const ConvSmem& sm,
                                              const GemmRing& ring_a,
                                              const GemmRing& ring_b,
                                              int tile0, int i) {
  const int j = 3 * i;
  ring_b.wait_full(i);
  ring_a.wait_full(j);
  issue_row<NT>(acc, smem, sm, tile0, j);
  if (!kFirst) {
    wgmma_wait<1>();
    fence_acc(acc);
    release(ring_a.empty((j - 1) % kAStages));
    release(ring_b.empty((i - 1) % kBStages));
  }
#pragma unroll
  for (int ky = 1; ky < 3; ++ky) {
    ring_a.wait_full(j + ky);
    issue_row<NT>(acc, smem, sm, tile0, j + ky);
    wgmma_wait<1>();
    fence_acc(acc);
    release(ring_a.empty((j + ky - 1) % kAStages));
  }
}

template <int NT>
__device__ __forceinline__ void store_acc(const ConvParams& p,
                                          const float (&acc)[NT][32], int b,
                                          int row0, int col0, int co_tile0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int lo = ((threadIdx.x >> 5) & 3) * 16 + g;
  const int tw = 1 << p.tw_shift;
  const size_t plane = (size_t)p.h * p.w;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int co = (co_tile0 + t) * 64 + lo + 8 * half;
      if (co >= p.cout) continue;
      const float bv = p.partial ? 0.f : ld_param(p.bias, co, p.bias_bf16);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int px = n * 8 + t4 * 2;
        const int row = row0 + (px >> p.tw_shift), col = col0 + (px & (tw - 1));
        if (row >= p.h) continue;
        const size_t off = ((size_t)b * p.cout + co) * plane +
                           (size_t)row * p.w + col;
        const float v0 = acc[t][4 * n + 2 * half] + bv;
        const float v1 = acc[t][4 * n + 2 * half + 1] + bv;
        if (p.partial) {
          const size_t z = (size_t)blockIdx.z * p.batch * p.cout * plane;
          *reinterpret_cast<float2*>(p.partial + z + off) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<uint32_t*>(p.out + off) = pack_bf16(v0, v1);
        }
      }
    }
  }
}

// One consumer warpgroup with NT Cout tiles (NT = 0: it only releases the
// buffers).
template <int NT>
__device__ __forceinline__ void consume(const ConvParams& p, uint32_t smem,
                                        const ConvSmem& sm,
                                        const GemmRing& ring_a,
                                        const GemmRing& ring_b, int tile0,
                                        int n_chunks, int b, int row0,
                                        int col0, int co_tile0) {
  if constexpr (NT == 0) {
    for (int i = 0; i < n_chunks; ++i) {
      ring_b.wait_full(i);
      for (int ky = 0; ky < 3; ++ky) {
        ring_a.wait_full(3 * i + ky);
        release(ring_a.empty((3 * i + ky) % kAStages));
      }
      release(ring_b.empty(i % kBStages));
    }
  } else {
    float acc[NT][32];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[t][j] = 0.f;
    consume_chunk<NT, true>(acc, smem, sm, ring_a, ring_b, tile0, 0);
    for (int i = 1; i < n_chunks; ++i)
      consume_chunk<NT, false>(acc, smem, sm, ring_a, ring_b, tile0, i);
    wgmma_wait<0>();
    fence_acc(acc);
    release(ring_a.empty((3 * n_chunks - 1) % kAStages));
    release(ring_b.empty((n_chunks - 1) % kBStages));
    store_acc<NT>(p, acc, b, row0, col0, co_tile0 + tile0);
  }
}

__global__ void __launch_bounds__(kConvThreads, 1)
    gn_silu_conv3x3_kernel(const __grid_constant__ ConvParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  const ConvSmem sm(p.tiles_per_block);
  const GemmRing ring_a{smem + sm.bars, kAStages};
  const GemmRing ring_b{smem + sm.bars + 2 * kAStages * 8, kBStages};
  const int tw = 1 << p.tw_shift, tr = kPix >> p.tw_shift;
  int tile = blockIdx.x;
  const int tx = tile % p.tiles_x;
  tile /= p.tiles_x;
  const int ty = tile % p.tiles_y, b = tile / p.tiles_y;
  const int row0 = ty * tr, col0 = tx * tw;
  const int mt0 = blockIdx.y * p.tiles_per_block;
  const int tiles = min(p.tiles_per_block, p.m_tiles - mt0);
  const int n_all = p.cin / kCk;
  const int chunk0 = blockIdx.z * p.chunks_per_split;
  const int n_chunks = min(p.chunks_per_split, n_all - chunk0);
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);

  if (threadIdx.x == 0) {
    ring_a.init(1);
    ring_b.init(kNormThreads);
  }
  __syncthreads();
  if (wg < kProducers) {
    if (threadIdx.x == 0)
      load_weights(p, smem, sm, ring_a, mt0, tiles, chunk0, n_chunks);
    else if (threadIdx.x >= 32) {
      // launched behind the statistics kernel (programmatic dependent
      // launch): x, mean and rstd are read only once it has finished
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      normalise_patches(p, smem, sm, ring_b, b, row0, col0, chunk0, n_chunks);
    }
    return;
  }
  const int cw = wg - kProducers;  // consumer warpgroup 0 or 1
  // the first consumer warpgroup takes the first ceil(tiles / 2) Cout
  // tiles, the second the rest; a block of the last Cout tiles may own
  // fewer
  const int first = (p.tiles_per_block + 1) / 2;
  const int nt = cw == 0 ? min(first, tiles) : max(0, tiles - first);
  const int tile0 = cw == 0 ? 0 : first;
  switch (nt) {
    case 0:
      consume<0>(p, smem, sm, ring_a, ring_b, tile0, n_chunks, b, row0,
                 col0, mt0);
      break;
    case 1:
      consume<1>(p, smem, sm, ring_a, ring_b, tile0, n_chunks, b, row0,
                 col0, mt0);
      break;
    case 2:
      consume<2>(p, smem, sm, ring_a, ring_b, tile0, n_chunks, b, row0,
                 col0, mt0);
      break;
    default:
      consume<3>(p, smem, sm, ring_a, ring_b, tile0, n_chunks, b, row0,
                 col0, mt0);
      break;
  }
}

// out = bf16(sum_z partial[z] + bias), the splits added in index order.
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ partial,
                     const void* __restrict__ bias, int bias_bf16,
                     __nv_bfloat16* __restrict__ out, long long total_pairs,
                     long long split_stride, int splits, int plane, int cout) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total_pairs) return;
  const float2* p = reinterpret_cast<const float2*>(partial) + i;
  float2 s = p[0];
  for (int z = 1; z < splits; ++z) {
    const float2 t = p[(size_t)z * (split_stride / 2)];
    s.x += t.x;
    s.y += t.y;
  }
  const float bv = ld_param(bias, (int)((2 * i / plane) % cout), bias_bf16);
  reinterpret_cast<uint32_t*>(out)[i] = pack_bf16(s.x + bv, s.y + bv);
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream`, allocates nothing,
// and returns a CUDA error code (0 = launched).
//   x (B, Cin, H, W) bf16, 16-byte aligned; mean, rstd (B, groups) fp32;
//   gamma, beta (Cin) and bias (Cout) bf16 or fp32; wp (Cin/16, ceil(Cout /
//   64), 9, 16, 64) bf16 from pack_conv3x3_weight: [c][t][3*ky + kx][i] is
//   a row of the 64 output channels 64*t .. 64*t + 63 for input channel
//   16*c + i, 0 past Cout, its 16-byte chunk j stored at j ^ (i % 8);
//   out (B, Cout, H, W) bf16.  Cin % 16 == 0, W % 8 == 0.  A block owns
//   `tiles` (1 to 5) Cout tiles of 64.
//   splits > 1: Cin's chunks are split over `splits` grid planes into
//   partial (splits, B, Cout, H, W) fp32, then reduced into out.
extern "C" int gn_silu_conv3x3_bf16(const void* x, const void* mean,
                                    const void* rstd, const void* gamma,
                                    const void* beta, int gn_bf16,
                                    const void* wp, const void* bias,
                                    int bias_bf16, void* out, void* partial,
                                    int batch, int cin, int cout, int h, int w,
                                    int groups, int tiles, int splits,
                                    void* stream) {
  if (batch <= 0 || cin <= 0 || cout <= 0 || h <= 0 || w <= 0 || cin % kCk ||
      w % 8 || groups <= 0 || cin % groups || cin >= 65536 || splits <= 0 ||
      tiles <= 0 ||
      tiles > kMaxTiles || (splits > 1 && partial == nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wp) % 16)
    return (int)cudaErrorInvalidValue;
  ConvParams p;
  p.tw_shift = w % 64 == 0 ? 6 : w % 32 == 0 ? 5 : w % 16 == 0 ? 4 : 3;
  const int tw = 1 << p.tw_shift, tr = kPix / tw;
  const int n_chunks = cin / kCk;
  p.chunks_per_split = (n_chunks + splits - 1) / splits;
  if ((long long)p.chunks_per_split * (splits - 1) >= n_chunks)
    return (int)cudaErrorInvalidValue;  // an empty last split
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.wp = static_cast<const __nv_bfloat16*>(wp);
  p.mean = static_cast<const float*>(mean);
  p.rstd = static_cast<const float*>(rstd);
  p.gamma = gamma;
  p.beta = beta;
  p.bias = bias;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.partial = splits > 1 ? static_cast<float*>(partial) : nullptr;
  p.gn_bf16 = gn_bf16;
  p.bias_bf16 = bias_bf16;
  p.batch = batch; p.cin = cin; p.cout = cout; p.h = h; p.w = w;
  p.tiles_x = w / tw;
  p.tiles_y = (h + tr - 1) / tr;
  p.cpg = cin / groups;
  p.cpg_magic = (0x100000000ull + p.cpg - 1) / p.cpg;
  p.groups = groups;
  p.m_tiles = (cout + 63) / 64;
  p.tiles_per_block = tiles;
  const ConvSmem sm(tiles);
  static const cudaError_t attr = cudaFuncSetAttribute(
      gn_silu_conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ConvSmem(kMaxTiles).bytes);
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(batch * p.tiles_y * p.tiles_x, (p.m_tiles + tiles - 1) / tiles,
            splits);
  // programmatic dependent launch: the block's prologue and its weight
  // copies may start while the statistics kernel before it still runs
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kConvThreads, 1, 1);
  cfg.dynamicSmemBytes = sm.bytes;
  cfg.stream = st;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  void* args[] = {&p};
  const cudaError_t launched = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(gn_silu_conv3x3_kernel), args);
  int err = (int)cudaGetLastError();
  if (launched != cudaSuccess) return (int)launched;
  if (err != 0 || splits == 1) return err;
  const long long total = (long long)batch * cout * h * w;  // even: w % 8 == 0
  const long long pairs = total / 2;
  splitk_reduce_kernel<<<(unsigned)((pairs + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(partial), bias, bias_bf16,
      static_cast<__nv_bfloat16*>(out), pairs, total, splits, h * w, cout);
  return (int)cudaGetLastError();
}
