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

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBlockQ = kTile;   // q rows per block (4 warps x 16)
constexpr int kBlockKV = kTile;  // kv rows per shared-memory tile

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
  load_tile(k_s[0], kb, 0, t_len);
  load_tile(v_s[0], vb, 0, t_len);
  cp_async_commit();

  // Q A-fragments for the 4 k-steps of head_dim 64, read once from global.
  uint32_t qa[4][4];
  load_a_frags(qa, qb, q_row0, s_len);

  float acc[8][4];
  zero_acc(acc);
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max, log2 units
  float l_lo = 0.f, l_hi = 0.f;              // running sum of p

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(k_s[buf ^ 1], kb, (j + 1) * kBlockKV, t_len);
      load_tile(v_s[buf ^ 1], vb, (j + 1) * kBlockKV, t_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // ---- S = Q K^T for this warp's 16 rows x 64 kv columns (fp32)
    float s[8][4];
    zero_acc(s);
    mma_nt(s, qa, k_s[buf]);

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
    uint32_t pa[4][4];
    pack_frags(pa, s);
    mma_nn(acc, pa, v_s[buf]);
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
  store_acc(o + (size_t)bh * s_len * kHeadDim, acc, q_row0, s_len, inv_lo,
            inv_hi);
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
  const float scale_log2 = scale * kLog2e;
  dim3 grid((s_len + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), s_len, t_len, scale_log2);
  return (int)cudaGetLastError();
}
