// fp32 tensors through TMA, the host side shared by the fp32 kernels fed
// by tensor maps (sm_90a): the map of a (B, L, H, D) fp32 tensor read in
// boxes of 32 columns (the backward pairs at 64, 256 and 512 and the
// forwards at 512), and the backward pairs' one kernel parameter, filled
// from the C entries' arguments (flash_fp32_d64_bwd_sm90.cu,
// flash_fp32_d256_bwd_sm90.cu, flash_fp32_d512_bwd_sm90.cu).

#pragma once

#include "flash_sm90.cuh"

namespace fp32_tma {

constexpr int kBox = 32;  // fp32 columns of a box: one 128-byte span

// A (B, L, H, d) fp32 tensor with element strides (sb, sl, sh, 1) as a
// 4-D map of dims (d, H, L, B) and box (32, 1, rows, 1): one 128-byte
// span of a row, 128-byte swizzle; rows past L read as zeros.
inline bool encode_fp32(CUtensorMap* map, const void* base, int d, int b,
                        int len, int h, long long sb, long long sl,
                        long long sh, int rows) {
  sm90::EncodeTiledFn fn = sm90::encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h,
                              (cuuint64_t)len, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 4, (cuuint64_t)sl * 4,
                                 (cuuint64_t)sb * 4};
  const cuuint32_t box[4] = {kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One __grid_constant__ parameter for both kernels of a backward pair (the
// dk/dv kernel leaves o unset).  out0/out1 are dq/- or dk/dv, with element
// strides (batch, row, head; head_dim stride 1).
struct BwdParams {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  const float* o;     // dq: delta's O rows
  const float* dout;  // dq: delta's dO rows
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  float* out0;
  float* out1;
  long long o0_sb, o0_ss, o0_sh, o1_sb, o1_ss, o1_sh;
  const float* lse;  // (B*H, S), natural log
  float* delta;      // (B*H, S)
  int heads, s_len, t_len;
  float scale;
};

// p for a launch of dq (`dq`) or dk/dv at head_dim d: the four input maps
// (q's and dO's boxes q_rows rows, k's and v's kv_rows), the pointers,
// strides and scalars.  `s` holds the element strides (sb, sl, sh) in the
// C entries' order: dq: q, k, v, o, dO, dq; dk/dv: q, k, v, dO, dk, dv.
// Returns a CUDA error code: cudaErrorInvalidValue for a shape the kernels
// do not take or a map the encoder refuses.
inline cudaError_t fill_params(BwdParams& p, int d, bool dq, int q_rows,
                               int kv_rows, const void* q, const void* k,
                               const void* v, const void* o, const void* dout,
                               const void* lse, void* delta, void* out0,
                               void* out1, int b, int h, int s_len, int t_len,
                               const long long* s, float scale) {
  if (b <= 0 || h <= 0 || s_len <= 0 || t_len <= 0 || (long long)b * h > 65535)
    return cudaErrorInvalidValue;
  if (const cudaError_t err = sm90::bind_context()) return err;
  const long long* sd = dq ? s + 12 : s + 9;   // dO's
  const long long* so = dq ? s + 15 : s + 12;  // the first output's
  if (!encode_fp32(&p.tm_q, q, d, b, s_len, h, s[0], s[1], s[2], q_rows) ||
      !encode_fp32(&p.tm_k, k, d, b, t_len, h, s[3], s[4], s[5], kv_rows) ||
      !encode_fp32(&p.tm_v, v, d, b, t_len, h, s[6], s[7], s[8], kv_rows) ||
      !encode_fp32(&p.tm_do, dout, d, b, s_len, h, sd[0], sd[1], sd[2],
                   q_rows))
    return cudaErrorInvalidValue;
  p.o = static_cast<const float*>(o);
  p.dout = static_cast<const float*>(dout);
  if (dq) {
    p.o_sb = s[9];
    p.o_ss = s[10];
    p.o_sh = s[11];
    p.do_sb = sd[0];
    p.do_ss = sd[1];
    p.do_sh = sd[2];
  }
  p.out0 = static_cast<float*>(out0);
  p.out1 = static_cast<float*>(out1);
  p.o0_sb = so[0];
  p.o0_ss = so[1];
  p.o0_sh = so[2];
  if (!dq) {
    p.o1_sb = s[15];
    p.o1_ss = s[16];
    p.o1_sh = s[17];
  }
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.heads = h;
  p.s_len = s_len;
  p.t_len = t_len;
  p.scale = scale;
  return cudaSuccess;
}

}  // namespace fp32_tma
