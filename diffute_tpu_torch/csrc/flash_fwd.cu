// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out, fp32 LSE.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// diffute_tpu/ops/flash_attention.py (called through `_flash_fwd_3d`'s
// pl.pallas_call).  It computes the same quantity, not the same grid: the
// Pallas kernel walks the kv axis as a sequential grid dimension and carries
// (m, l, acc) in VMEM scratch between grid steps; here one thread block owns
// a 64-row q tile of one (batch, head) and loops over the kv tiles itself,
// with the online-softmax state in registers.
//
//   q (BH, S, 64), k/v (BH, T, 64)  bf16, contiguous
//   o (BH, S, 64) bf16,  lse (BH, S) fp32 natural-log log-sum-exp
//
// What bounds it on the H100: at head_dim 64 each score costs 2*64 FLOPs in
// QK^T and 2*64 in PV (256 tensor FLOPs) against one exp2 and a few fp32 ops
// of the online softmax.  The tensor cores do about 4096 bf16 FLOPs per SM
// clock (989 TFLOP/s over 132 SMs) and the SM about 16 exp2 per clock, so a
// score costs ~1/16 clock on either unit: the exp2 is as expensive as both
// matmuls, and bytes are not the limit (K/V are re-read once per 64-row q
// tile and mostly hit L2).  The kernel reaches the tensor-core rate only if
// the softmax of one warp overlaps the matmuls of another.  What this design
// does about it:
//   - softmax_scale*log2(e) is folded into the exp2 argument as one FMA
//     (exp2(s*c - m)), so there is no separate scale pass over the scores
//     and q is not prescaled (the TPU kernel's bf16 prescale added an
//     operand rounding; this costs none);
//   - the fp32 scores stay in the mma accumulator registers and feed the PV
//     product as bf16 A fragments without a trip through shared memory;
//   - the ragged kv tail is masked only in the last tile;
//   - 4 warps per block and several blocks per SM (36 KB of shared memory
//     each) give the warp schedulers other warps' mma.sync to issue while
//     one warp runs its exp2.
// This first cut uses mma.sync.m16n8k16 (4 warps x 16 q rows) and a
// double-buffered cp.async K/V ring in padded shared memory; wgmma, TMA and
// the warp specialisation that overlaps softmax and matmul by design are
// left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kBlockQ = 64;           // q rows per block (4 warps x 16)
constexpr int kBlockKV = 64;          // kv rows per shared-memory tile
constexpr int kThreads = 128;
constexpr int kPad = 8;               // bf16 elements of row padding
constexpr int kRow = kHeadDim + kPad; // 72 elements = 144 bytes: ldmatrix rows
                                      // of one 8x8 load land in distinct banks

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  // src_bytes == 0 zero-fills the 16 destination bytes (ragged tail rows)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// D = A(16x16 bf16, row) * B(16x8 bf16, col) + D, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy kv rows [row0, row0+64) of one (BH, T, 64) tensor into a padded
// [64][72] shared tile; rows at or past `t_len` are zero-filled.
__device__ __forceinline__ void load_kv_tile(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             int row0, int t_len) {
  // 64 rows x 8 chunks of 16 bytes = 512 chunks, 4 per thread
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int chunk = threadIdx.x + i * kThreads;
    int r = chunk >> 3, c = (chunk & 7) * 8;
    int row = row0 + r;
    bool ok = row < t_len;
    const __nv_bfloat16* g = src + (size_t)(ok ? row : 0) * kHeadDim + c;
    cp_async_16(smem_u32(dst + r * kRow + c), g, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int s_len, int t_len, float scale_log2) {
  __shared__ __align__(128) __nv_bfloat16 k_s[2][kBlockKV * kRow];
  __shared__ __align__(128) __nv_bfloat16 v_s[2][kBlockKV * kRow];

  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma group and thread-in-group
  const int q_row0 = blockIdx.x * kBlockQ + warp * 16;

  const __nv_bfloat16* qb = q + (size_t)bh * s_len * kHeadDim;
  const __nv_bfloat16* kb = k + (size_t)bh * t_len * kHeadDim;
  const __nv_bfloat16* vb = v + (size_t)bh * t_len * kHeadDim;

  const int n_tiles = (t_len + kBlockKV - 1) / kBlockKV;
  load_kv_tile(k_s[0], kb, 0, t_len);
  load_kv_tile(v_s[0], vb, 0, t_len);
  cp_async_commit();

  // Q A-fragments for the 4 k-steps of head_dim 64, read once from global.
  uint32_t qa[4][4];
  {
    const int r_lo = q_row0 + g, r_hi = q_row0 + g + 8;
    const uint32_t* lo = reinterpret_cast<const uint32_t*>(
        qb + (size_t)min(r_lo, s_len - 1) * kHeadDim);
    const uint32_t* hi = reinterpret_cast<const uint32_t*>(
        qb + (size_t)min(r_hi, s_len - 1) * kHeadDim);
    const bool ok_lo = r_lo < s_len, ok_hi = r_hi < s_len;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = kk * 8 + tig;  // in 32-bit words: (kk*16 + tig*2) / 2
      qa[kk][0] = ok_lo ? lo[c] : 0u;
      qa[kk][1] = ok_hi ? hi[c] : 0u;
      qa[kk][2] = ok_lo ? lo[c + 4] : 0u;
      qa[kk][3] = ok_hi ? hi[c + 4] : 0u;
    }
  }

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max, log2 units
  float l_lo = 0.f, l_hi = 0.f;              // running sum of p

  // ldmatrix row addresses: thread t feeds row (t & 7) of 8x8 matrix (t >> 3)
  const int mi = lane >> 3, mr = lane & 7;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_kv_tile(k_s[buf ^ 1], kb, (j + 1) * kBlockKV, t_len);
      load_kv_tile(v_s[buf ^ 1], vb, (j + 1) * kBlockKV, t_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // ---- S = Q K^T for this warp's 16 rows x 64 kv columns (fp32)
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
    const __nv_bfloat16* kt = k_s[buf];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        // matrices: (kv n0, d k0), (n0, k0+8), (n0+8, k0), (n0+8, k0+8)
        const int row = p * 16 + (mi >> 1) * 8 + mr;
        const int col = kk * 16 + (mi & 1) * 8;
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(b0, b1, b2, b3, smem_u32(kt + row * kRow + col));
        mma_bf16(s[2 * p], qa[kk], b0, b1);
        mma_bf16(s[2 * p + 1], qa[kk], b2, b3);
      }
    }

    // ---- mask the ragged kv tail (only the last tile can have one)
    const int col0 = j * kBlockKV;
    if (col0 + kBlockKV > t_len) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = col0 + n * 8 + tig * 2;
        if (c >= t_len) { s[n][0] = -INFINITY; s[n][2] = -INFINITY; }
        if (c + 1 >= t_len) { s[n][1] = -INFINITY; s[n][3] = -INFINITY; }
      }
    }

    // ---- online softmax in base 2; rows g (lo) and g+8 (hi)
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo * scale_log2);
    const float mn_hi = fmaxf(m_hi, mx_hi * scale_log2);
    const float alpha_lo = exp2f(m_lo - mn_lo);
    const float alpha_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;

    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = exp2f(fmaf(s[n][0], scale_log2, -mn_lo));
      s[n][1] = exp2f(fmaf(s[n][1], scale_log2, -mn_lo));
      s[n][2] = exp2f(fmaf(s[n][2], scale_log2, -mn_hi));
      s[n][3] = exp2f(fmaf(s[n][3], scale_log2, -mn_hi));
      sum_lo += s[n][0] + s[n][1];
      sum_hi += s[n][2] + s[n][3];
    }
    l_lo = l_lo * alpha_lo + sum_lo;  // per-thread partial; reduced at the end
    l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= alpha_lo;
      acc[n][1] *= alpha_lo;
      acc[n][2] *= alpha_hi;
      acc[n][3] *= alpha_hi;
    }

    // ---- O += P V; P's accumulator layout is the A-fragment layout
    const __nv_bfloat16* vt = v_s[buf];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        // transposed matrices: (kv k0, d n0), (k0+8, n0), (k0, n0+8), (k0+8, n0+8)
        const int row = kk * 16 + (mi & 1) * 8 + mr;
        const int col = p * 16 + (mi >> 1) * 8;
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3, smem_u32(vt + row * kRow + col));
        mma_bf16(acc[2 * p], pa, b0, b1);
        mma_bf16(acc[2 * p + 1], pa, b2, b3);
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this buffer
  }

  // ---- finalize: full row sums across the 4 threads of a row group
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  const int r_lo = q_row0 + g, r_hi = q_row0 + g + 8;
  __nv_bfloat16* ob = o + (size_t)bh * s_len * kHeadDim;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + tig * 2;
    if (r_lo < s_len)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r_lo * kHeadDim + c) =
          pack_bf16(acc[n][0] * inv_lo, acc[n][1] * inv_lo);
    if (r_hi < s_len)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r_hi * kHeadDim + c) =
          pack_bf16(acc[n][2] * inv_hi, acc[n][3] * inv_hi);
  }
  if (tig == 0) {
    const float ln2 = 0.6931471805599453f;
    float* lb = lse + (size_t)bh * s_len;
    if (r_lo < s_len) lb[r_lo] = (m_lo + log2f(l_lo)) * ln2;
    if (r_hi < s_len) lb[r_hi] = (m_hi + log2f(l_hi)) * ln2;
  }
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream`, allocates nothing,
// and returns cudaGetLastError() (0 = launched).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int s_len, int t_len,
                              float scale, void* stream) {
  if (bh <= 0 || s_len <= 0 || t_len <= 0) return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  dim3 grid((s_len + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), s_len, t_len, scale_log2);
  return (int)cudaGetLastError();
}
