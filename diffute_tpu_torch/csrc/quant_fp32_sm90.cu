// int8-weight matmul on fp32 activations for Hopper (sm_90a):
// y = ((x @ q^T) * s) + bias, fp32 x and y, int8 q, fp32 scale and bias.
//
// Replaces the Pallas TPU kernel `_w8_kernel` of diffute_tpu/ops/quant.py
// (`_pallas_matmul_w8`'s pl.pallas_call) on fp32 inputs, and the bias add of
// the JAX layer `QuantDense` (diffute_tpu/models/layers.py): the product in
// fp32, times the per-feature scale, rounded, then the bias added and the
// sum rounded, all in fp32 (no fused multiply-add).  The bf16 kernel is
// quant.cu.
//
//   x (M, K) fp32 row-major; q (N, K) int8 as the layer keeps it (no
//   repacked copy: the fp32 kernel adds no bytes to serving memory);
//   s (N) fp32 or bf16; bias (N) fp32 or none -> y (M, N) fp32
//
// Precision.  The port's fp32 paths turn TF32 off, so the kernel is accurate
// to fp32, not to TF32 (held to relative L2 1e-5 of the plain fp32 version,
// chip_smoke.py phase 3g):
//   * every int8 value is exact in TF32 (|q| <= 127 has 7 significant bits
//     of TF32's 11), so only x is split: hi = tf32(x) (cvt.rna's bits), lo =
//     tf32(x - hi), and x q = lo q + hi q, two TF32 products where fp32
//     operands take three; the dropped part of x is 2^-22 of it.  TF32
//     alone (hi q) reads about 3e-4 from fp32 and fails the bound;
//   * the tensor cores' fp32 accumulation rounds toward zero, so no
//     tensor-core sum spans more than one 32-wide k tile (4 k-steps x the
//     two products, from zero); each tile's sum is added to the running fp32
//     sum by an ordinary round-to-nearest add.
//
// What bounds it on the H100: the TF32 rate over the two products (2 M N K
// over 494.7 / 2 TFLOP/s) at every UNet shape, the weight bytes close behind
// at M = 64.  What the design does about it:
//   - yT = q . xT, so the weight is wgmma's register A operand: each of the
//     two consumer warpgroups owns 64 output features (wgmma's M) and the
//     block BT tokens (wgmma's N: 64, or 128 where M allows it, which cuts
//     the wgmma count and the q tiles re-read; a 384-thread block leaves
//     ptxas 168 registers a thread, so at 128 the next tile's fragment is
//     not prefetched).  A thread reads its fragment's 8 bytes of two q rows
//     a tile as one load each: the tile's contraction runs in a permuted k
//     order, fragment k = t and t + 4 of step s taking k = 8t + 2s and 8t +
//     2s + 1, and the x planes are written in that order;
//   - the producer warpgroup's thread 0 keeps the x tile (TMA, K-major, 32
//     fp32 a row, 128-byte swizzle, rows past M and columns past K read as
//     zeros) and the q tile (TMA, 128 features x 32 bytes, zeros past N and
//     K) two tiles ahead of the split in a ring of four or six stages; the
//     warpgroup splits each x tile once, in place, into a hi plane and a lo
//     plane (each thread reads its row's chunks before it writes, and at 64
//     tokens two threads share a row, so they meet at a barrier between),
//     fences the writes into the async proxy (tf32 wgmma reads only shared
//     operands, K-major) and arrives on the stage's ready barrier.  The
//     consumers never split: each tile is split once, not once per block of
//     features;
//   - a consumer converts a tile's fragment (a byte permute and an fp32
//     subtraction a value; at 64 tokens while the tile before's products
//     run), issues the tile's eight products as one chain from zero, and
//     adds the tile's sum to its own;
//   - where the output tiles leave the card's SMs idle (M = 64 and 256, the
//     glyph tokens), K is split over blockIdx.z into one wave of blocks (a
//     second, partial wave cost more than the split gained):
//     every block writes its fp32 partial tile to a workspace, and the block
//     that finishes last for a tile (a ticket counter, reset by that block)
//     adds the partials in split order (gemm_sm90.cuh's split_sum), so two
//     runs give the same bits; no float atomics, no second launch;
//   - the scale and the bias are applied to the sum, the tile goes through
//     shared memory, and y is written in 16-byte runs of a row.
// What holds it (an H100; tools/w8_fp32_probes.py, builds that drop one
// part): a tile costs about 0.6 us a block at 64 tokens, and leaving out
// the loads, the split or the products each saves only 6-27% of it: no
// single part sets the pace alone.

#include "tf32_wgmma_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBF = 128;                // output features a block
constexpr int kBK = 32;                 // k a tile: one 128-byte row of x
constexpr int kQBytes = kBF * kBK;      // 4 KB of q a tile
constexpr int kOutRow = 64 * 4 + 16;    // staged output row: 64 fp32 + 16 B
constexpr int kSplitBar = 5;            // the splitters' named barrier

// The layout at BT tokens a block: the ring's depth, the tiles loaded
// ahead of the split, a plane's bytes, a stage's (hi plane, lo plane, q),
// and the offsets into the dynamic shared memory (after 1024-byte
// alignment): the stages (each 1024-byte aligned, as the swizzle needs),
// the two consumer warpgroups' output tiles, the full, empty and ready
// barriers, the split-K flag.
template <int BT>
struct W8Tile {
  static constexpr int ring = BT == 64 ? 6 : 4;
  static constexpr int lead = ring - 2;  // tiles loaded ahead of the split
  static constexpr int x_bytes = BT * kBK * 4;
  static constexpr int stage = 2 * x_bytes + kQBytes;
  static constexpr int out = ring * stage;
  static constexpr int bars = out + 2 * BT * kOutRow;
  static constexpr int flag = bars + 3 * ring * 8;
  static constexpr int bytes = flag + 16 + 1024;  // + alignment slack
  static_assert(stage % 1024 == 0 && x_bytes % 1024 == 0, "swizzle atoms");
  static_assert(bytes <= 232448, "227 KB a block");
  __device__ static uint32_t ready(uint32_t smem, int st) {
    return smem + bars + 8 * (2 * ring + st);
  }
};

struct W8Params {
  CUtensorMap tm_x;  // x: dims (K, M) fp32, box (32, BT), 128-byte swizzle
  CUtensorMap tm_q;  // q: dims (K, N) uint8, box (32, 128)
  const void* scale;
  const float* bias;  // nullptr: no bias
  float* y;
  float* ws;
  int* tickets;
  int scale_bf16, m, n, k;
  int tiles_per_split;
};

// ------------------------------------------------------------- producer

// Tile j (of this block's split) into stage j % ring: x rows m0.., q rows
// n0.., k from (tile0 + j) * 32.
template <int BT>
__device__ __forceinline__ void load_tile(const W8Params& p, uint32_t smem,
                                          const GemmRing& ring, int m0, int n0,
                                          int tile0, int j) {
  using T = W8Tile<BT>;
  const int st = j % T::ring;
  const uint32_t base = smem + st * T::stage;
  ring.wait_empty(j);
  mbar_expect_tx(ring.full(st), T::x_bytes + kQBytes);
  tma_load_2d(base, &p.tm_x, ring.full(st), (tile0 + j) * kBK, m0);
  tma_load_2d(base + 2 * T::x_bytes, &p.tm_q, ring.full(st),
              (tile0 + j) * kBK, n0);
}

// The producer warpgroup: thread 0 issues the loads `lead` tiles ahead (the
// stage it refills was released two tiles before the one split
// now, so it seldom waits; loading every free stage as soon as it freed ran
// slower on an H100), and every thread splits its half rows of each tile:
// half h of row r reads x[r][8 j + 4 h + e] (chunks 2 j + h) and writes
// plane chunks 4 h + w, whose element j is x[r][8 j + 4 h + w]: step s =
// 2 h + (w >> 1) of the permuted order, fragment k = j + 4 (w & 1).  At 64
// tokens thread (h, r) takes one half; at 128 thread r both.
template <int BT>
__device__ __forceinline__ void produce(const W8Params& p, uint32_t smem,
                                        const GemmRing& ring, int m0, int n0,
                                        int tile0, int n_tiles) {
  using T = W8Tile<BT>;
  constexpr int kHalves = BT / 64;
  const int tid = threadIdx.x, r = tid % BT, h0 = tid / BT;
  if (tid == 0) {
    prefetch_map(&p.tm_x);
    prefetch_map(&p.tm_q);
    for (int j = 0; j < T::lead && j < n_tiles; ++j)
      load_tile<BT>(p, smem, ring, m0, n0, tile0, j);
  }
  const uint32_t row = r * 128, sw = r & 7;
  for (int i = 0; i < n_tiles; ++i) {
    if (tid == 0 && i + T::lead < n_tiles)
      load_tile<BT>(p, smem, ring, m0, n0, tile0, i + T::lead);
    const int st = i % T::ring;
    const uint32_t hi_s = smem + st * T::stage + row, lo_s = hi_s + T::x_bytes;
    ring.wait_full(i);
    uint4 v[kHalves][4];
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[hh][j] = ld_shared_u4(hi_s + (((2 * j + h0 + hh) ^ sw) << 4));
    if constexpr (BT == 64) warpgroup_sync(kSplitBar);  // the other half read
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        uint32_t e[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          e[j] = w == 0 ? v[hh][j].x : w == 1 ? v[hh][j].y
               : w == 2 ? v[hh][j].z : v[hh][j].w;
        uint4 hi, lo;
        split4(e, hi, lo);
        const uint32_t at = ((4 * (h0 + hh) + w) ^ sw) << 4;
        st_shared_v4(hi_s + at, hi);
        st_shared_v4(lo_s + at, lo);
      }
    fence_proxy_async();
    mbar_arrive(T::ready(smem, st));
  }
}

// ------------------------------------------------------------- consumer

// four int8 values (a 32-bit word) -> their exact fp32 bits: bytes biased
// by 128 (xor 0x80) sit in the mantissa of 2^23; subtracting 2^23 + 128
// leaves q
__device__ __forceinline__ void int8x4_bits(uint32_t w, uint32_t (&f)[4]) {
  const uint32_t b = w ^ 0x80808080u, m = 0x4B000000u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __float_as_uint(
        __uint_as_float(__byte_perm(b, m, 0x7650 + e)) - 8388736.f);
}

// This thread's A fragments of one tile, for the four k steps: features
// 16 w + g and + 8 of the warpgroup's 64, bytes 8 t .. 8 t + 7 of each
// (k = 8 t + 2 s and + 1 for step s: fragment k t and t + 4).
__device__ __forceinline__ void load_frag(uint32_t (&a)[4][4], uint32_t q_s) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t at = q_s + (16 * warp + g) * kBK + 8 * t;
  uint32_t lo0, lo1, hi0, hi1;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n"
               : "=r"(lo0), "=r"(lo1) : "r"(at) : "memory");
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n"
               : "=r"(hi0), "=r"(hi1) : "r"(at + 8 * kBK) : "memory");
  uint32_t f[4][4];  // row g: k 8t..8t+3, 8t+4..; row g + 8: the same
  int8x4_bits(lo0, f[0]);
  int8x4_bits(lo1, f[1]);
  int8x4_bits(hi0, f[2]);
  int8x4_bits(hi1, f[3]);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int wd = s >> 1, e = 2 * (s & 1);
    a[s][0] = f[wd][e];
    a[s][1] = f[2 + wd][e];
    a[s][2] = f[wd][e + 1];
    a[s][3] = f[2 + wd][e + 1];
  }
}

template <int BT>
__device__ __forceinline__ uint32_t frag_at(uint32_t smem, int i, int cw) {
  using T = W8Tile<BT>;
  return smem + (i % T::ring) * T::stage + 2 * T::x_bytes + cw * 64 * kBK;
}

template <int BT>
__device__ __forceinline__ void wait_tile(uint32_t smem, const GemmRing& ring,
                                          int i) {
  using T = W8Tile<BT>;
  ring.wait_full(i);
  mbar_wait(T::ready(smem, i % T::ring), (i / T::ring) & 1);
}

// A tile's eight products from zero into `part`: the lo plane's four k
// steps (the small terms first), then the hi plane's.
template <int BT>
__device__ __forceinline__ void issue_tile(float (&part)[BT / 2],
                                           uint32_t (&a)[4][4],
                                           uint32_t hi_s) {
  issue_begin(part, a);
#pragma unroll
  for (int s = 0; s < 4; ++s)
    wgmma_tf32(part, a[s], tf32_desc(hi_s + W8Tile<BT>::x_bytes, s, 0), s > 0);
#pragma unroll
  for (int s = 0; s < 4; ++s)
    wgmma_tf32(part, a[s], tf32_desc(hi_s, s, 0), 1);
  issue_end(part, a);
}

// One tile: its products with fragments `a`, then, while they run, the
// next tile's fragments into `b` (kNext), then the wait, the round-to-
// nearest add and the release.
template <int BT, bool kNext>
__device__ __forceinline__ void tile_step(float (&acc)[BT / 2],
                                          float (&part)[BT / 2],
                                          uint32_t (&a)[4][4],
                                          uint32_t (&b)[4][4], uint32_t smem,
                                          const GemmRing& ring, int cw,
                                          int i) {
  using T = W8Tile<BT>;
  issue_tile<BT>(part, a, smem + (i % T::ring) * T::stage);
  if (kNext) {
    wait_tile<BT>(smem, ring, i + 1);
    load_frag(b, frag_at<BT>(smem, i + 1, cw));
  }
  wgmma_wait<0>();
  fence_regs(part);
  fence_regs(a);
#pragma unroll
  for (int j = 0; j < BT / 2; ++j) acc[j] = __fadd_rn(acc[j], part[j]);
  release(ring.empty(i % T::ring));
}

// The consumer's main loop.  At 64 tokens two tiles a body (the fragment
// sets take turns, so neither is copied), the last tile peeled so no
// branch sits in the body while a product is in flight; at 128 the
// running sum and a tile's take 128 registers, so a tile's fragment is
// converted after its wait, with no second set.
template <int BT>
__device__ __forceinline__ void consume(float (&acc)[BT / 2], uint32_t smem,
                                        const GemmRing& ring, int cw,
                                        int n_tiles) {
  uint32_t a[4][4], b[4][4];
  float part[BT / 2];
  if constexpr (BT == 128) {
    for (int i = 0; i < n_tiles; ++i) {
      wait_tile<BT>(smem, ring, i);
      load_frag(a, frag_at<BT>(smem, i, cw));
      tile_step<BT, false>(acc, part, a, b, smem, ring, cw, i);
    }
    return;
  }
  wait_tile<BT>(smem, ring, 0);
  load_frag(a, frag_at<BT>(smem, 0, cw));
  int i = 0;
  for (; i < n_tiles - 2; i += 2) {
    tile_step<BT, true>(acc, part, a, b, smem, ring, cw, i);
    tile_step<BT, true>(acc, part, b, a, smem, ring, cw, i + 1);
  }
  if (i == n_tiles - 2) {
    tile_step<BT, true>(acc, part, a, b, smem, ring, cw, i);
    tile_step<BT, false>(acc, part, b, a, smem, ring, cw, i + 1);
  } else {
    tile_step<BT, false>(acc, part, a, b, smem, ring, cw, i);
  }
}

// grid (ceil(M / BT), ceil(N / 128), splits)
template <int BT>
__global__ void __launch_bounds__(kThreads, 1)
    w8_fp32_kernel(const __grid_constant__ W8Params p) {
  using T = W8Tile<BT>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* smem_ptr = smem_raw + (smem - smem_u32(smem_raw));
  const GemmRing ring{smem + T::bars, T::ring};
  const int m0 = blockIdx.x * BT, n0 = blockIdx.y * kBF;
  const int k_tiles = (p.k + kBK - 1) / kBK;
  const int tile0 = blockIdx.z * p.tiles_per_split;
  const int n_tiles = min(p.tiles_per_split, k_tiles - tile0);
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);

  if (threadIdx.x == 0) {
    ring.init(1);
    for (int s = 0; s < T::ring; ++s) mbar_init(T::ready(smem, s), 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg == 0) {
    produce<BT>(p, smem, ring, m0, n0, tile0, n_tiles);
    return;
  }
  const int cw = wg - 1, tid = threadIdx.x - 128;
  const int f0 = n0 + cw * 64;  // this warpgroup's first feature
  float acc[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
  if (f0 < p.n) {
    consume<BT>(acc, smem, ring, cw, n_tiles);
  } else {  // past N: release the stages, add zeros
    for (int i = 0; i < n_tiles; ++i) {
      wait_tile<BT>(smem, ring, i);
      release(ring.empty(i % T::ring));
    }
  }

  if (gridDim.z > 1 &&
      !split_sum<BT / 2>(acc, p.ws, p.tickets,
                         blockIdx.y * gridDim.x + blockIdx.x,
                         gridDim.x * gridDim.y, blockIdx.z, gridDim.z, 256,
                         tid, reinterpret_cast<int*>(smem_ptr + T::flag),
                         [] { named_sync(1); }))
    return;

  // ---- epilogue: acc is yT (features x tokens); scale, round, add the
  // bias, round, into a [token][feature] tile in shared memory
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int lo = ((threadIdx.x >> 5) & 3) * 16 + g;
  const uint32_t out_s = smem + T::out + cw * BT * kOutRow;
  float sc[2] = {0.f, 0.f}, bi[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = f0 + lo + 8 * h;
    if (f < p.n) {
      sc[h] = p.scale_bf16 ? __bfloat162float(
                                 static_cast<const __nv_bfloat16*>(p.scale)[f])
                           : static_cast<const float*>(p.scale)[f];
      if (p.bias) bi[h] = p.bias[f];
    }
  }
#pragma unroll
  for (int n = 0; n < BT / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tok = n * 8 + t4 * 2 + (i & 1), h = i >> 1;
      float v = __fmul_rn(acc[4 * n + i], sc[h]);
      if (p.bias) v = __fadd_rn(v, bi[h]);
      asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(out_s + tok * kOutRow +
                                                     (lo + 8 * h) * 4),
                   "f"(v)
                   : "memory");
    }
  warpgroup_sync(3 + cw);
  // 16-byte runs of a row: token tok, features f0 + 4 fg .. + 3
  for (int idx = tid & 127; idx < BT * 16; idx += 128) {
    const int tok = idx >> 4, fg = idx & 15;
    const int row = m0 + tok, f = f0 + fg * 4;
    if (row >= p.m || f >= p.n) continue;
    const uint4 v = ld_shared_u4(out_s + tok * kOutRow + fg * 16);
    float* dst = p.y + (size_t)row * p.n + f;
    if ((p.n & 3) == 0) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const float e[4] = {__uint_as_float(v.x), __uint_as_float(v.y),
                          __uint_as_float(v.z), __uint_as_float(v.w)};
      for (int j = 0; j < 4 && f + j < p.n; ++j) dst[j] = e[j];
    }
  }
}

// x (M, K) fp32 row-major as a 2-D map of dims (K, M), box (32, bt),
// 128-byte swizzle; q (N, K) int8 as dims (K, N), box (32, 128), no
// swizzle.  Elements past M, N or K read as zeros.
bool encode_maps(W8Params& p, const void* x, const void* q, int m, int n,
                 int k, int bt) {
  EncodeTiledFn fn = encode_fn();
  if (!fn) return false;
  const cuuint32_t elem[2] = {1, 1};
  const cuuint64_t x_dims[2] = {(cuuint64_t)k, (cuuint64_t)m};
  const cuuint64_t x_strides[1] = {(cuuint64_t)k * 4};
  const cuuint32_t x_box[2] = {kBK, (cuuint32_t)bt};
  const cuuint64_t q_dims[2] = {(cuuint64_t)k, (cuuint64_t)n};
  const cuuint64_t q_strides[1] = {(cuuint64_t)k};
  const cuuint32_t q_box[2] = {kBK, kBF};
  return fn(&p.tm_x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(x),
            x_dims, x_strides, x_box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         fn(&p.tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(q),
            q_dims, q_strides, q_box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BT>
int launch(const W8Params& p, int splits, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      w8_fp32_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      W8Tile<BT>::bytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((p.m + BT - 1) / BT, (p.n + kBF - 1) / kBF, splits);
  w8_fp32_kernel<BT><<<grid, kThreads, W8Tile<BT>::bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream`, allocates nothing,
// and returns a CUDA error code (0 = launched).
//   x (M, K) fp32 row-major and q (N, K) int8 row-major, both 16-byte
//   aligned, K % 16 == 0; scale (N) fp32 or bf16; bias (N) fp32 or nullptr;
//   y (M, N) fp32, 16-byte aligned.  bt (64 or 128) tokens a block.  splits
//   > 1 splits K's 32-wide tiles over `splits` grid planes of
//   ceil(ceil(K / 32) / splits) tiles (the last one not empty): workspace
//   then holds splits * ceil(M / bt) * ceil(N / 128) * 256 * bt / 2 floats
//   and tickets one zeroed int per output tile (left zeroed).
extern "C" int w8_matmul_fp32(const void* x, const void* q, const void* scale,
                              int scale_bf16, const void* bias, void* y,
                              void* workspace, void* tickets, int M, int N,
                              int K, int bt, int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || splits <= 0 ||
      (bt != 64 && bt != 128) || (N + kBF - 1) / kBF > 65535 ||
      (splits > 1 && (workspace == nullptr || tickets == nullptr)) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return (int)cudaErrorInvalidValue;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int per = (k_tiles + splits - 1) / splits;
  if ((long long)per * (splits - 1) >= k_tiles)  // an empty last split
    return (int)cudaErrorInvalidValue;
  if (const cudaError_t err = bind_context()) return (int)err;
  W8Params p;
  if (!encode_maps(p, x, q, M, N, K, bt)) return (int)cudaErrorInvalidValue;
  p.scale = scale;
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<float*>(y);
  p.ws = static_cast<float*>(workspace);
  p.tickets = static_cast<int*>(tickets);
  p.scale_bf16 = scale_bf16;
  p.m = M;
  p.n = N;
  p.k = K;
  p.tiles_per_split = per;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bt == 128 ? launch<128>(p, splits, st) : launch<64>(p, splits, st);
}
