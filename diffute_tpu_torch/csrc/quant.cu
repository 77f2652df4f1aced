// int8-weight matmul for Hopper (sm_90a): y = bf16(bf16((x @ q^T) * s) +
// bias), or bf16((x @ q^T) * s) without a bias; bf16 x and y, int8 q, fp32
// accumulation.
//
// Replaces the Pallas TPU kernel `_w8_kernel` of diffute_tpu/ops/quant.py
// (`_pallas_matmul_w8`'s pl.pallas_call) and the bias add of the JAX layer
// `QuantDense` (diffute_tpu/models/layers.py), in its order of roundings.
// It computes the same function, not the same grid: the Pallas kernel holds
// a (256, K) x tile and a whole (K, 256) int8 weight panel in VMEM per grid
// step; here a block owns 128 output features x BT tokens (BT = 64 or 128)
// and walks K in steps of 64 through a ring of shared-memory stages.
//
//   x (M, K) bf16 row-major; the int8 weight q (N, K) (one output feature
//   per row, as nn.Linear keeps its weight) repacked once by
//   pack_w8_weight; s (N) fp32 or bf16; bias (N) bf16 or none
//   -> y (M, N) bf16
//
// What bounds it on the H100: at M = 64 and 256 (the 8^2 and 16^2 levels of
// the UNet) the weight bytes: N*K int8 read once against 2*M*N*K operations
// is 2M = 128 to 512 FLOP/byte, around the card's 295 FLOP/byte line, and the
// int8 storage halves those bytes against bf16, which is the kernel's reason
// to exist.  At M = 1024 and 4096 the tensor cores, or the bytes of y where
// N is wide.  What the design does about it:
//   - yT = q . xT, so the weight is wgmma's A operand: each consumer
//     warpgroup owns 64 output features (wgmma's M) and converts its int8
//     fragment to bf16 in registers (the register-A form; -127..127 are exact
//     in bf16, so no dequantised copy exists anywhere), and the tokens are
//     wgmma's N, which fits the small token counts of the 8^2 and 16^2
//     levels (M = 64: a 64-token tile, nothing wasted);
//   - warpgroup 0's thread 0 keeps four stages of loads in flight: the x
//     tile by TMA (K-major, 128-byte swizzle, rows past M and columns past K
//     read as zeros) and the two warpgroups' int8 fragments by one 8 KB bulk
//     copy.  The weight is repacked once (pack_w8_weight) so that each
//     thread's fragment of a 64-wide k step is one 16-byte run, offset by 128
//     so that a byte permute, an fp32 subtraction and a second permute make
//     four exact bf16 values without an int-to-float conversion;
//   - a consumer converts stage i+1's fragment while stage i's four products
//     run; where M >= 2048 or N >= 4096 a block takes 128 tokens, so each
//     weight tile is read from L2 M / 128 times (64 x 64 tiles would read it
//     M / 64 times), elsewhere 64, which puts more blocks on the card;
//   - the per-feature scale commutes with the contraction and is applied
//     once to the fp32 accumulator, rounded to bf16, then the bias is added
//     and the sum rounded again: the roundings of the TPU kernel followed by
//     the JAX layer's bias add, in one launch.  The tile goes through shared
//     memory, so y is written in 16-byte runs of a row;
//   - where the output tiles are too few to fill the card and K is deep
//     (K = 5120 at M = 64 and 256), K is split over blockIdx.z: every block
//     writes its fp32 partial tile to a workspace, and the block that
//     finishes last for a tile (a ticket counter, reset by that block) adds
//     the partials in split order (gemm_sm90.cuh's split_sum), so the sum
//     does not depend on which block came last; no float atomics, no second
//     launch.

#include "gemm_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBF = 128;           // output features a block
constexpr int kBK = 64;            // k a stage
constexpr int kQTile = 64 * kBK;   // one warpgroup's int8 fragments a stage
constexpr int kOutRow = 144;       // staged output row: 64 bf16 + 16 bytes

struct W8Params {
  CUtensorMap tm_x;  // x: dims (K, M), box (64, BT), 128-byte swizzle
  const uint8_t* qp;
  const void* scale;
  const __nv_bfloat16* bias;  // nullptr: no bias
  __nv_bfloat16* y;
  float* ws;
  int* tickets;
  int scale_bf16, m, n, k;
  int f_tiles;  // 64-feature tiles of the repacked weight (even)
  int chunks_per_split;
};

template <int BT>
struct W8Smem {
  static constexpr int stages = 4;
  static constexpr int x_bytes = BT * 128;
  static constexpr int stage = x_bytes + 2 * kQTile;
  static constexpr int out = stages * stage;
  static constexpr int bars = out + kConsumers * BT * kOutRow;
  static constexpr int flag = bars + 2 * stages * 8;
  static constexpr int bytes = flag + 16 + 1024;  // + alignment slack
};

// four biased bytes (q + 128) of k = 2t, 2t+1, 2t+8, 2t+9 -> the bf16 pairs
// (2t, 2t+1) and (2t+8, 2t+9): 0x4B0000uu is the fp32 2^23 + uu, so
// subtracting 2^23 + 128 leaves q exactly, and an integer of at most 8
// significant bits is its fp32 value's upper half
__device__ __forceinline__ void cvt_q(uint32_t w, uint32_t& p01,
                                      uint32_t& p89) {
  const uint32_t m = 0x4B000000u;
  const float f0 = __uint_as_float(__byte_perm(w, m, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(w, m, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(w, m, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(w, m, 0x7653)) - 8388736.f;
  p01 = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  p89 = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// This thread's A fragments of one stage, for the four k steps: rows lo
// (16w + g) and hi (lo + 8) of the warpgroup's 64 features.
__device__ __forceinline__ void load_frag(uint32_t (&a)[4][4], uint32_t q_s) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const uint4 lo = ld_shared_u4(q_s + ((warp * 2) * 32 + lane) * 16);
  const uint4 hi = ld_shared_u4(q_s + ((warp * 2 + 1) * 32 + lane) * 16);
  cvt_q(lo.x, a[0][0], a[0][2]);
  cvt_q(hi.x, a[0][1], a[0][3]);
  cvt_q(lo.y, a[1][0], a[1][2]);
  cvt_q(hi.y, a[1][1], a[1][3]);
  cvt_q(lo.z, a[2][0], a[2][2]);
  cvt_q(hi.z, a[2][1], a[2][3]);
  cvt_q(lo.w, a[3][0], a[3][2]);
  cvt_q(hi.w, a[3][1], a[3][3]);
}

template <int BT>
__device__ __forceinline__ void mma_k(float (&acc)[BT / 2],
                                      const uint32_t (&a)[4], uint64_t db) {
  if constexpr (BT == 128)
    wgmma_rs_n128(acc, a, db);
  else
    wgmma_rs_n64_k(acc, a, db);
}

// Stage i's four products: k step kk is 32 bytes further into the
// swizzled x rows.
template <int BT>
__device__ __forceinline__ void issue_stage(float (&acc)[BT / 2],
                                            uint32_t (&a)[4][4],
                                            uint32_t x_s) {
  issue_begin(acc, a);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_k<BT>(acc, a[kk], desc_sw128(x_s + kk * 32, 1));
  issue_end(acc, a);
}

template <int BT>
__device__ __forceinline__ void produce(const W8Params& p, uint32_t smem,
                                        const GemmRing& ring, int m0,
                                        int f_tile0, int chunk0,
                                        int n_chunks) {
  using S = W8Smem<BT>;
  prefetch_map(&p.tm_x);
  const uint8_t* q = p.qp + ((size_t)chunk0 * p.f_tiles + f_tile0) * kQTile;
  for (int i = 0; i < n_chunks; ++i) {
    const int st = i % S::stages;
    const uint32_t x_s = smem + st * S::stage;
    ring.wait_empty(i);
    mbar_expect_tx(ring.full(st), S::x_bytes + 2 * kQTile);
    tma_load_2d(x_s, &p.tm_x, ring.full(st), (chunk0 + i) * kBK, m0);
    bulk_load(x_s + S::x_bytes, q + (size_t)i * p.f_tiles * kQTile,
              2 * kQTile, ring.full(st));
  }
}

// One stage: its products with fragments `a`, then, while they run, the
// next stage's fragments into `b` (kNext), then the wait and the release.
template <int BT, bool kNext>
__device__ __forceinline__ void stage_step(float (&acc)[BT / 2],
                                           uint32_t (&a)[4][4],
                                           uint32_t (&b)[4][4], uint32_t smem,
                                           const GemmRing& ring, int cw,
                                           int i) {
  using S = W8Smem<BT>;
  issue_stage<BT>(acc, a, smem + (i % S::stages) * S::stage);
  if (kNext) {
    ring.wait_full(i + 1);
    load_frag(b, smem + ((i + 1) % S::stages) * S::stage + S::x_bytes +
                     cw * kQTile);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(a);
  release(ring.empty(i % S::stages));
}

// The consumer's main loop: stage i+1's fragments are converted while stage
// i's products run, into the other of two register sets (the loop body is
// two stages, so neither set is copied; a copy made ptxas serialize the
// products, C7513), and the last stage is peeled, so no branch sits in the
// body while a product is in flight.
template <int BT>
__device__ __forceinline__ void consume(float (&acc)[BT / 2], uint32_t smem,
                                        const GemmRing& ring, int cw,
                                        int n_chunks) {
  using S = W8Smem<BT>;
  uint32_t a[4][4], b[4][4];
  ring.wait_full(0);
  load_frag(a, smem + S::x_bytes + cw * kQTile);
  int i = 0;
  for (; i < n_chunks - 2; i += 2) {
    stage_step<BT, true>(acc, a, b, smem, ring, cw, i);
    stage_step<BT, true>(acc, b, a, smem, ring, cw, i + 1);
  }
  if (i == n_chunks - 2) {
    stage_step<BT, true>(acc, a, b, smem, ring, cw, i);
    stage_step<BT, false>(acc, b, a, smem, ring, cw, i + 1);
  } else {
    stage_step<BT, false>(acc, a, b, smem, ring, cw, i);
  }
}

template <int BT>
__global__ void __launch_bounds__(kThreads, 1)
    w8_matmul_kernel(const __grid_constant__ W8Params p) {
  using S = W8Smem<BT>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* smem_ptr = smem_raw + (smem - smem_u32(smem_raw));
  const GemmRing ring{smem + S::bars, S::stages};
  const int m0 = blockIdx.x * BT, f_tile0 = blockIdx.y * 2;
  const int n_all = (p.k + kBK - 1) / kBK;
  const int chunk0 = blockIdx.z * p.chunks_per_split;
  const int n_chunks = min(p.chunks_per_split, n_all - chunk0);
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);

  if (threadIdx.x == 0) ring.init(1);
  __syncthreads();
  if (wg == 0) {
    if (threadIdx.x == 0)
      produce<BT>(p, smem, ring, m0, f_tile0, chunk0, n_chunks);
    return;
  }
  const int cw = wg - 1, tid = threadIdx.x - 128;
  const int f0 = (f_tile0 + cw) * 64;  // this warpgroup's first feature
  float acc[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
  if (f0 < p.n) {
    consume<BT>(acc, smem, ring, cw, n_chunks);
  } else {  // past N: release the stages, add zeros
    for (int i = 0; i < n_chunks; ++i) {
      ring.wait_full(i);
      release(ring.empty(i % S::stages));
    }
  }

  if (gridDim.z > 1 &&
      !split_sum<BT / 2>(acc, p.ws, p.tickets, blockIdx.y * gridDim.x +
                         blockIdx.x, gridDim.x * gridDim.y, blockIdx.z,
                         gridDim.z, 256, tid,
                         reinterpret_cast<int*>(smem_ptr + S::flag),
                         [] { named_sync(1); }))
    return;

  // ---- epilogue: acc is yT (features x tokens); scale, round, add the
  // bias, round, into a [token][feature] tile in shared memory
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int lo = ((threadIdx.x >> 5) & 3) * 16 + g;
  const uint32_t out_s = smem + S::out + cw * BT * kOutRow;
  float sc[2] = {0.f, 0.f}, bi[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = f0 + lo + 8 * h;
    if (f < p.n) {
      sc[h] = p.scale_bf16
                  ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.scale)[f])
                  : static_cast<const float*>(p.scale)[f];
      if (p.bias) bi[h] = __bfloat162float(p.bias[f]);
    }
  }
#pragma unroll
  for (int n = 0; n < BT / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tok = n * 8 + t4 * 2 + (i & 1), h = i >> 1;
      __nv_bfloat16 v = __float2bfloat16_rn(acc[4 * n + i] * sc[h]);
      if (p.bias) v = __float2bfloat16_rn(__bfloat162float(v) + bi[h]);
      asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(out_s + tok * kOutRow +
                                                      (lo + 8 * h) * 2),
                   "h"(__bfloat16_as_ushort(v))
                   : "memory");
    }
  warpgroup_sync(3 + cw);
  // 16-byte runs of a row: token tok, features f0 + 8 fg .. + 7
  const int tw = tid & 127;
  for (int idx = tw; idx < BT * 8; idx += 128) {
    const int tok = idx >> 3, fg = idx & 7;
    const int row = m0 + tok, f = f0 + fg * 8;
    if (row >= p.m || f >= p.n) continue;
    const uint4 v = ld_shared_u4(out_s + tok * kOutRow + fg * 16);
    __nv_bfloat16* dst = p.y + (size_t)row * p.n + f;
    if ((p.n & 7) == 0) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
      for (int j = 0; j < 8 && f + j < p.n; ++j) dst[j] = e[j];
    }
  }
}

// x (M, K) bf16 row-major as a 2-D map of dims (K, M), box (64, BT),
// 128-byte swizzle; rows past M and columns past K read as zeros.
bool encode_x_map(CUtensorMap* map, const void* x, int m, int k, int bt) {
  EncodeTiledFn fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)m};
  const cuuint64_t strides[1] = {(cuuint64_t)k * 2};
  const cuuint32_t box[2] = {kBK, (cuuint32_t)bt};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BT>
int launch(const W8Params& p, int splits, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      w8_matmul_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      W8Smem<BT>::bytes);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((p.m + BT - 1) / BT, p.f_tiles / 2, splits);
  w8_matmul_kernel<BT><<<grid, kThreads, W8Smem<BT>::bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream`, allocates nothing,
// and returns a CUDA error code (0 = launched).
//   x (M, K) bf16 row-major, 16-byte aligned, K % 16 == 0; qp from
//   pack_w8_weight: (ceil(K / 64), f_tiles, 4096) uint8, q + 128 in the
//   consumers' fragment order, f_tiles = 2 * ceil(N / 128), 128 (q = 0) past
//   N and K; scale (N) fp32 or bf16; bias (N) bf16 or nullptr; y (M, N)
//   bf16.  bt (64 or 128) tokens a block.  splits > 1 splits K's 64-wide
//   steps over `splits` grid planes: workspace then holds splits * ceil(M /
//   bt) * f_tiles / 2 * 256 * bt / 2 floats and tickets one zeroed int per
//   output tile (left zeroed).
extern "C" int w8_matmul_bf16(const void* x, const void* qp, const void* scale,
                              int scale_bf16, const void* bias, void* y,
                              void* workspace, void* tickets, int M, int N,
                              int K, int bt, int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || splits <= 0 ||
      (bt != 64 && bt != 128) ||
      (splits > 1 && (workspace == nullptr || tickets == nullptr)) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(qp) % 16)
    return (int)cudaErrorInvalidValue;
  const int k_steps = (K + kBK - 1) / kBK;
  const int per = (k_steps + splits - 1) / splits;
  if ((long long)per * (splits - 1) >= k_steps)  // an empty last split
    return (int)cudaErrorInvalidValue;
  if (const cudaError_t err = bind_context()) return (int)err;
  W8Params p;
  if (!encode_x_map(&p.tm_x, x, M, K, bt)) return (int)cudaErrorInvalidValue;
  p.qp = static_cast<const uint8_t*>(qp);
  p.scale = scale;
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.ws = static_cast<float*>(workspace);
  p.tickets = static_cast<int*>(tickets);
  p.scale_bf16 = scale_bf16;
  p.m = M;
  p.n = N;
  p.k = K;
  p.f_tiles = 2 * ((N + kBF - 1) / kBF);
  p.chunks_per_split = per;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bt == 128 ? launch<128>(p, splits, st) : launch<64>(p, splits, st);
}
