// Flash-attention backward for Hopper (sm_90a): two kernels, dq and dk/dv.
//
//   q, dO (BH, S, 64), k, v (BH, T, 64)            bf16, contiguous
//   lse (BH, S) fp32 natural log, as flash_fwd.cu writes it
//   delta (BH, S) fp32 = rowsum(dO * O), computed by the caller
//   dq (BH, S, 64), dk, dv (BH, T, 64)             bf16, fp32 accumulation
//
// Both recompute p = exp(s*scale - lse) from the saved LSE, as one FMA and
// one exp2 per score (scale*log2(e) folded in, q not prescaled), then
//   dv = p^T dO,  dp = dO v^T,  ds = p * (dp - delta),
//   dq = ds k * scale,  dk = ds^T q * scale.
//
// flash_bwd_dq_kernel replaces the Pallas TPU kernel `_bwd_dq_kernel` of
// diffute_tpu/ops/flash_attention.py (pl.pallas_call in `_flash_bwd_3d`),
// which carries dq in VMEM scratch across a sequential kv grid axis.  Here
// one block owns a 64-row q tile of one (batch, head), loops over the kv
// tiles itself and keeps dq in registers: the forward kernel's structure,
// with K and V tiles double-buffered through cp.async.
//
// flash_bwd_dkv_kernel replaces `_bwd_dkv_kernel` (same file, same call
// site), which carries dk and dv across a sequential q grid axis.  Here one
// block owns a 64-row kv tile and loops over the q tiles with dk and dv in
// registers, so there are no atomics and the result is deterministic.  The
// products dv += p^T dO and dk += ds^T q need p and ds transposed as the A
// operand.  The kernel computes the transposed tiles directly (s^T = k q^T,
// dp^T = v dO^T, with K and V rows as A fragments held in registers), which
// leaves p^T and ds^T in the accumulator layout that re-packs to a bf16 A
// fragment without shared memory; lse and delta then index *columns* of the
// tile and are staged in shared memory beside the q and dO tiles, which are
// read as B operands both plain (for s^T, dp^T) and with ldmatrix.trans
// (for dv, dk).
//
// What bounds them on the H100: operations, not bytes.  Per score dq does
// three 2*64-FLOP products (6*S*T*64*BH in all), dk/dv four (8*S*T*64*BH),
// against one exp2 and three fp32 ops; inputs are a few MB and K/V (or q/dO)
// tiles are re-read per block from L2.  As in the forward the exp2 competes
// with mma.sync for issue slots, less so here (one exp2 per three or four
// products).  What the design does about it: no shared-memory round trip
// between the products (accumulator -> A fragment in registers), the scale
// folded into the exp2 FMA and applied to dq/dk once at the end, ragged
// edges handled by zero-filled tiles instead of per-element masks (dq masks
// only its last kv tile), and 4 warps per block with 36 KB of shared memory
// so several blocks share an SM.  mma.sync.m16n8k16, as the forward; wgmma,
// TMA and warp specialisation are later work.
//
// Ragged edges.  dq: kv rows past T are zero-filled and the last tile sets
// their scores to -inf, so p = 0.  dk/dv: q rows past S are zero-filled (so
// dO = 0 there) and their staged lse and delta are zero-filled too, which
// gives p = exp2(0) = 1 and ds = 1 * (0 - 0) = 0: they contribute nothing
// and exp2 never sees an uninitialised lse.  Rows past the end of an output
// are not written.

#include "flash_common.cuh"

namespace {

using namespace flash;

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int s_len, int t_len,
                    float scale, float scale_log2) {
  __shared__ __align__(128) __nv_bfloat16 k_s[2][kTile * kRow];
  __shared__ __align__(128) __nv_bfloat16 v_s[2][kTile * kRow];

  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q_row0 = blockIdx.x * kTile + warp * 16;

  const __nv_bfloat16* kb = k + (size_t)bh * t_len * kHeadDim;
  const __nv_bfloat16* vb = v + (size_t)bh * t_len * kHeadDim;

  const int n_tiles = (t_len + kTile - 1) / kTile;
  load_tile(k_s[0], kb, 0, t_len);
  load_tile(v_s[0], vb, 0, t_len);
  cp_async_commit();

  uint32_t qa[4][4], doa[4][4];
  load_a_frags(qa, q + (size_t)bh * s_len * kHeadDim, q_row0, s_len);
  load_a_frags(doa, dout + (size_t)bh * s_len * kHeadDim, q_row0, s_len);

  // rows g (lo) and g+8 (hi); rows past S get lse = delta = 0 (never stored)
  const int r_lo = q_row0 + g, r_hi = q_row0 + g + 8;
  const float* lb = lse + (size_t)bh * s_len;
  const float* db = delta + (size_t)bh * s_len;
  const float lse2_lo = r_lo < s_len ? lb[r_lo] * kLog2e : 0.f;
  const float lse2_hi = r_hi < s_len ? lb[r_hi] * kLog2e : 0.f;
  const float delta_lo = r_lo < s_len ? db[r_lo] : 0.f;
  const float delta_hi = r_hi < s_len ? db[r_hi] : 0.f;

  float acc[8][4];
  zero_acc(acc);

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(k_s[buf ^ 1], kb, (j + 1) * kTile, t_len);
      load_tile(v_s[buf ^ 1], vb, (j + 1) * kTile, t_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // ---- s = q k^T and dp = dO v^T for 16 q rows x 64 kv columns
    float s[8][4], dp[8][4];
    zero_acc(s);
    mma_nt(s, qa, k_s[buf]);
    zero_acc(dp);
    mma_nt(dp, doa, v_s[buf]);

    // ---- the ragged kv tail: p = 0 there (only the last tile has one)
    const int col0 = j * kTile;
    if (col0 + kTile > t_len) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = col0 + n * 8 + tig * 2;
        if (c >= t_len) { s[n][0] = -INFINITY; s[n][2] = -INFINITY; }
        if (c + 1 >= t_len) { s[n][1] = -INFINITY; s[n][3] = -INFINITY; }
      }
    }

    // ---- ds = p * (dp - delta), p = exp2(s*scale*log2e - lse*log2e)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = exp2f(fmaf(s[n][0], scale_log2, -lse2_lo)) * (dp[n][0] - delta_lo);
      s[n][1] = exp2f(fmaf(s[n][1], scale_log2, -lse2_lo)) * (dp[n][1] - delta_lo);
      s[n][2] = exp2f(fmaf(s[n][2], scale_log2, -lse2_hi)) * (dp[n][2] - delta_hi);
      s[n][3] = exp2f(fmaf(s[n][3], scale_log2, -lse2_hi)) * (dp[n][3] - delta_hi);
    }

    // ---- dq += ds k; ds's accumulator layout is the A-fragment layout
    uint32_t dsa[4][4];
    pack_frags(dsa, s);
    mma_nn(acc, dsa, k_s[buf]);
    __syncthreads();  // the next iteration's loads overwrite this buffer
  }

  store_acc(dq + (size_t)bh * s_len * kHeadDim, acc, q_row0, s_len, scale,
            scale);
}

// lse and delta of q rows [row0, row0+64) into shared memory (threads 0..63
// copy lse, 64..127 delta); rows at or past `s_len` are zero-filled.
__device__ __forceinline__ void load_row_stats(float* lse_dst, float* delta_dst,
                                               const float* lse_src,
                                               const float* delta_src,
                                               int row0, int s_len) {
  const int r = threadIdx.x & 63;
  const bool ok = row0 + r < s_len;
  const float* src = (threadIdx.x < 64 ? lse_src : delta_src) + (ok ? row0 + r : 0);
  float* dst = (threadIdx.x < 64 ? lse_dst : delta_dst) + r;
  cp_async_4(smem_u32(dst), src, ok ? 4 : 0);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int s_len, int t_len,
                     float scale, float scale_log2) {
  __shared__ __align__(128) __nv_bfloat16 q_s[2][kTile * kRow];
  __shared__ __align__(128) __nv_bfloat16 do_s[2][kTile * kRow];
  __shared__ __align__(16) float lse_s[2][kTile];
  __shared__ __align__(16) float delta_s[2][kTile];

  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tig = lane & 3;
  const int kv_row0 = blockIdx.x * kTile + warp * 16;

  const __nv_bfloat16* qb = q + (size_t)bh * s_len * kHeadDim;
  const __nv_bfloat16* dob = dout + (size_t)bh * s_len * kHeadDim;
  const float* lb = lse + (size_t)bh * s_len;
  const float* db = delta + (size_t)bh * s_len;

  const int n_tiles = (s_len + kTile - 1) / kTile;
  load_tile(q_s[0], qb, 0, s_len);
  load_tile(do_s[0], dob, 0, s_len);
  load_row_stats(lse_s[0], delta_s[0], lb, db, 0, s_len);
  cp_async_commit();

  // this warp's 16 kv rows of K and V as A fragments; rows past T are zero
  // (their dk/dv rows are never stored)
  uint32_t ka[4][4], va[4][4];
  load_a_frags(ka, k + (size_t)bh * t_len * kHeadDim, kv_row0, t_len);
  load_a_frags(va, v + (size_t)bh * t_len * kHeadDim, kv_row0, t_len);

  float dk_acc[8][4], dv_acc[8][4];
  zero_acc(dk_acc);
  zero_acc(dv_acc);

  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < n_tiles) {
      load_tile(q_s[buf ^ 1], qb, (i + 1) * kTile, s_len);
      load_tile(do_s[buf ^ 1], dob, (i + 1) * kTile, s_len);
      load_row_stats(lse_s[buf ^ 1], delta_s[buf ^ 1], lb, db, (i + 1) * kTile,
                     s_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // ---- p^T = exp2(k q^T * scale*log2e - lse*log2e): 16 kv rows x 64 q
    // columns; lse indexes the columns
    float st[8][4];
    zero_acc(st);
    mma_nt(st, ka, q_s[buf]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l = *reinterpret_cast<const float2*>(
          &lse_s[buf][n * 8 + tig * 2]);
      const float l0 = l.x * kLog2e, l1 = l.y * kLog2e;
      st[n][0] = exp2f(fmaf(st[n][0], scale_log2, -l0));
      st[n][1] = exp2f(fmaf(st[n][1], scale_log2, -l1));
      st[n][2] = exp2f(fmaf(st[n][2], scale_log2, -l0));
      st[n][3] = exp2f(fmaf(st[n][3], scale_log2, -l1));
    }

    // ---- dv += p^T dO
    uint32_t a[4][4];
    pack_frags(a, st);
    mma_nn(dv_acc, a, do_s[buf]);

    // ---- ds^T = p^T * (dp^T - delta), dp^T = v dO^T
    float dpt[8][4];
    zero_acc(dpt);
    mma_nt(dpt, va, do_s[buf]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 d = *reinterpret_cast<const float2*>(
          &delta_s[buf][n * 8 + tig * 2]);
      st[n][0] *= dpt[n][0] - d.x;
      st[n][1] *= dpt[n][1] - d.y;
      st[n][2] *= dpt[n][2] - d.x;
      st[n][3] *= dpt[n][3] - d.y;
    }

    // ---- dk += ds^T q
    pack_frags(a, st);
    mma_nn(dk_acc, a, q_s[buf]);
    __syncthreads();  // the next iteration's loads overwrite this buffer
  }

  store_acc(dk + (size_t)bh * t_len * kHeadDim, dk_acc, kv_row0, t_len, scale,
            scale);
  store_acc(dv + (size_t)bh * t_len * kHeadDim, dv_acc, kv_row0, t_len, 1.f,
            1.f);
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream`, allocates
// nothing, and returns cudaGetLastError() (0 = launched).
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int bh, int s_len,
                                 int t_len, float scale, void* stream) {
  if (bh <= 0 || s_len <= 0 || t_len <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((s_len + kTile - 1) / kTile, bh);
  flash_bwd_dq_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), s_len,
      t_len, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int bh,
                                  int s_len, int t_len, float scale,
                                  void* stream) {
  if (bh <= 0 || s_len <= 0 || t_len <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((t_len + kTile - 1) / kTile, bh);
  flash_bwd_dkv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), s_len, t_len, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}
