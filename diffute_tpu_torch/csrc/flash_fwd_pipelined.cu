// Deferred-softmax flash-attention forward for Hopper (sm_90a): bf16 in,
// bf16 out, fp32 LSE.  The same function as flash_fwd.cu under another
// schedule.
//
// Replaces the Pallas TPU kernel `_fwd_kernel_pipelined` of
// diffute_tpu/ops/flash_attention.py (called through
// `_flash_fwd_3d_pipelined`'s pl.pallas_call).  That kernel walks kv as a
// sequential grid dimension of n_kv + 1 steps: step j writes the score tile
// of kv tile j into one of two VMEM buffers (by parity) and runs the softmax
// update of tile j - 1 from the other, so that the matrix unit and the vector
// unit have independent work in one body.  Here there is no grid dimension
// over kv and no scratch: one thread block owns a 64-row q tile of one
// (batch, head) and walks the kv tiles itself, and the two score tiles are
// two register sets (s0 / s1, by kv parity) of each warp.
//
//   q (BH, S, 64), k/v (BH, T, 64)  bf16, contiguous; T a multiple of 64, >= 128
//   o (BH, S, 64) bf16,  lse (BH, S) fp32 natural-log log-sum-exp
//
// The schedule.  A prologue computes S_0 = Q K_0^T and consumes nothing.  Body
// j starts S_{j+1} = Q K_{j+1}^T FIRST and then runs tile j's softmax (max,
// exp2, row sum, rescale) and O += P_j V_j; S_{j+1} has no data dependence on
// that softmax, so within one warp's instruction stream the tensor-core
// product of the next tile is in flight while the exp2 of this one runs.
// The last body only consumes.  (flash_fwd.cu relies on OTHER warps' products
// to cover a warp's exp2; this kernel also gives each warp its own.)
//
// What bounds it on the H100: operations, as for flash_fwd.cu (256 tensor
// FLOPs a score against one exp2; the exp2 unit costs as much as both
// products), so the gain, if any, is the overlap above.  What it costs: two
// live score tiles are 64 fp32 registers a thread instead of 32: 168 registers
// under __launch_bounds__(128) with no spill, so three blocks fit an SM.  Read
// on an H100 (chip_smoke.py, PERF.md): level with flash_fwd.cu, between 2%
// faster and 5% slower from 1024 to 16384 tokens, and bit-identical to it,
// since only the order of the instructions differs, not the arithmetic.
//
// Shared memory.  K of tile j + 1 and V of tile j are live together, so K and
// V each have a two-deep ring, loaded one body ahead as ONE cp.async group
// {K_{j+2}, V_{j+1}} per body: 36 KB, as flash_fwd.cu.  One __syncthreads per
// body, at its top: it publishes the group that body reads and retires the
// previous body's reads of the buffers the next group overwrites.
//
// Scale.  softmax_scale * log2(e) is folded into the exp2 argument as one FMA
// on the fp32 score (exp2(s*c - m)), as in flash_fwd.cu; q is NOT pre-scaled
// and rounded to bf16 as the TPU kernel's caller does.  The plain version
// (ops/flash_attention.py: flash_fwd_pipelined_reference) scales the same way.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBlockQ = kTile;   // q rows per block (4 warps x 16)
constexpr int kBlockKV = kTile;  // kv rows per shared-memory tile

// The online-softmax state of a warp's 16 rows: rows g (lo) and g + 8 (hi).
struct RowState {
  float m_lo, m_hi;  // running max, log2 units
  float l_lo, l_hi;  // running sum of p (this thread's partial)
};

// Consume one score tile: softmax update in base 2, then O += P V.
__device__ __forceinline__ void consume(float (&s)[8][4], float (&acc)[8][4],
                                        RowState& st,
                                        const __nv_bfloat16* v_tile,
                                        float scale_log2) {
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
  const float mn_lo = fmaxf(st.m_lo, mx_lo * scale_log2);
  const float mn_hi = fmaxf(st.m_hi, mx_hi * scale_log2);
  const float alpha_lo = exp2f(st.m_lo - mn_lo);
  const float alpha_hi = exp2f(st.m_hi - mn_hi);
  st.m_lo = mn_lo;
  st.m_hi = mn_hi;

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
  st.l_lo = st.l_lo * alpha_lo + sum_lo;
  st.l_hi = st.l_hi * alpha_hi + sum_hi;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    acc[n][0] *= alpha_lo;
    acc[n][1] *= alpha_lo;
    acc[n][2] *= alpha_hi;
    acc[n][3] *= alpha_hi;
  }
  uint32_t pa[4][4];
  pack_frags(pa, s);
  mma_nn(acc, pa, v_tile);
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_pipelined_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int s_len, int t_len,
                           float scale_log2) {
  __shared__ __align__(128) __nv_bfloat16 k_s[2][kBlockKV * kRow];
  __shared__ __align__(128) __nv_bfloat16 v_s[2][kBlockKV * kRow];

  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q_row0 = blockIdx.x * kBlockQ + warp * 16;

  const __nv_bfloat16* qb = q + (size_t)bh * s_len * kHeadDim;
  const __nv_bfloat16* kb = k + (size_t)bh * t_len * kHeadDim;
  const __nv_bfloat16* vb = v + (size_t)bh * t_len * kHeadDim;

  const int n_tiles = t_len / kBlockKV;  // >= 2, no ragged tail (entry point)

  // group {K_0}, then group {K_1, V_0}
  load_tile(k_s[0], kb, 0, t_len);
  cp_async_commit();
  load_tile(k_s[1], kb, kBlockKV, t_len);
  load_tile(v_s[0], vb, 0, t_len);
  cp_async_commit();

  uint32_t qa[4][4];
  load_a_frags(qa, qb, q_row0, s_len);

  float acc[8][4];
  zero_acc(acc);
  RowState st = {-INFINITY, -INFINITY, 0.f, 0.f};

  // ---- prologue: produce S_0, consume nothing
  float s0[8][4], s1[8][4];  // the two live score tiles, by kv parity
  cp_async_wait<1>();
  __syncthreads();
  zero_acc(s0);
  mma_nt(s0, qa, k_s[0]);

  // Body j: `cur` holds S_j; S_{j+1} goes into `nxt` ahead of S_j's softmax.
  auto body = [&](int j, float (&cur)[8][4], float (&nxt)[8][4]) {
    cp_async_wait<0>();  // {K_{j+1}, V_j} has landed
    __syncthreads();     // ... for every warp; body j-1's reads are done
    // one body ahead: K_{j+2} over K_j, V_{j+1} over V_{j-1}
    if (j + 2 < n_tiles)
      load_tile(k_s[j & 1], kb, (j + 2) * kBlockKV, t_len);
    if (j + 1 < n_tiles)
      load_tile(v_s[(j + 1) & 1], vb, (j + 1) * kBlockKV, t_len);
    cp_async_commit();
    if (j + 1 < n_tiles) {  // produce (the last body only consumes)
      zero_acc(nxt);
      mma_nt(nxt, qa, k_s[(j + 1) & 1]);
    }
    consume(cur, acc, st, v_s[j & 1], scale_log2);
  };
  for (int j = 0; j < n_tiles; j += 2) {
    body(j, s0, s1);
    if (j + 1 < n_tiles) body(j + 1, s1, s0);
  }

  // ---- finalize: full row sums across the 4 threads of a row group
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    st.l_lo += __shfl_xor_sync(0xffffffffu, st.l_lo, off);
    st.l_hi += __shfl_xor_sync(0xffffffffu, st.l_hi, off);
  }
  const float inv_lo = 1.f / st.l_lo, inv_hi = 1.f / st.l_hi;
  const int r_lo = q_row0 + g, r_hi = q_row0 + g + 8;
  store_acc(o + (size_t)bh * s_len * kHeadDim, acc, q_row0, s_len, inv_lo,
            inv_hi);
  if (tig == 0) {
    // base 2 -> natural log: the backward kernels take p = exp(s*scale - lse)
    const float ln2 = 0.6931471805599453f;
    float* lb = lse + (size_t)bh * s_len;
    if (r_lo < s_len) lb[r_lo] = (st.m_lo + log2f(st.l_lo)) * ln2;
    if (r_hi < s_len) lb[r_hi] = (st.m_hi + log2f(st.l_hi)) * ln2;
  }
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream`, allocates nothing,
// and returns cudaGetLastError() (0 = launched).  t_len must be a multiple of
// the 64-row kv tile with at least two tiles (cudaErrorInvalidValue
// otherwise): the prologue and the bodies assume whole tiles.
extern "C" int flash_fwd_pipelined_bf16(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int bh, int s_len, int t_len,
                                        float scale, void* stream) {
  if (bh <= 0 || s_len <= 0 || t_len < 2 * kBlockKV || t_len % kBlockKV)
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * kLog2e;
  dim3 grid((s_len + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_pipelined_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), s_len, t_len, scale_log2);
  return (int)cudaGetLastError();
}
