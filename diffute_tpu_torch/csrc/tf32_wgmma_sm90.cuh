// tf32 wgmma pieces shared by the fp32 kernels that run their products on
// Hopper's warpgroup MMA (sm_90a): the int8 matmul (quant_fp32_sm90.cu)
// and the head_dim-64 fp32 flash backward pair
// (flash_fp32_d64_bwd_sm90.cu).
//
//   * tf32 wgmma takes both operands K-major only, and reads an operand in
//     shared memory as its TF32 truncation, so fp32 accuracy (3xTF32, or
//     2xTF32 where one side is exact) needs each operand split into a hi
//     and a lo plane of TF32 values: hi = tf32(x) to nearest (cvt.rna's
//     bits, by integer operations), lo = tf32(x - hi) (split4);
//   * a plane is [rows][32] fp32 boxes (one 128-byte span a row, the
//     128-byte swizzle TMA writes and wgmma reads: an 8-row, 1024-byte
//     pattern, so a box starts 1024-byte aligned); a k-step is 8 columns,
//     32 bytes further into the box, four a box (tf32_desc);
//   * the products: m64nNk8 with A from registers (the fragment of
//     mma.m16n8k8.tf32: rows g and g + 8 of the warp's 16, columns t and
//     t + 4) or from shared memory, B from shared memory.

#pragma once

#include "gemm_sm90.cuh"
#include "tf32_sm90.cuh"

namespace sm90 {

#define SM90_F16(a) SM90_F8(a, 0), SM90_F8(a, 8)
// the instructions, for the wrappers below and for kernels that issue a
// chain of them in one asm statement (flash_fp32_d64_bwd_sm90.cu: a few
// descriptors live, stepped by adds, where 24 separate wrappers let ptxas
// hoist 24); operands: the accumulator, A's registers or descriptor, B's
// descriptor, then "p, 1, 1" (scale-d, scale-a, scale-b)
#define TF32_WGMMA_N32 "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
#define TF32_WGMMA_N64 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
#define TF32_WGMMA_N128 \
  "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "

// Descriptor of k-step s (columns 8 s .. 8 s + 7) of a K-major plane whose
// 32-column boxes lie `box_bytes` apart.
__device__ __forceinline__ uint64_t tf32_desc(uint32_t plane, int s,
                                              uint32_t box_bytes) {
  return desc_sw128(plane + (s >> 2) * box_bytes + (s & 3) * 32, 1);
}

// hi = tf32(x) to nearest (ties away), lo = tf32(x - hi), four values:
// the planes' TF32 bits, each exact in TF32 so wgmma's truncation keeps it.
__device__ __forceinline__ void split4(const uint32_t (&x)[4], uint4& hi,
                                       uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float f = __uint_as_float(x[j]);
    h[j] = tf32_sm90::rna_tf32(f);
    l[j] = tf32_sm90::rna_tf32(f - __uint_as_float(h[j]));
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// d (64 x 32, fp32) (+)= A (64 x 8 tf32, registers) * B (8 x 32 tf32,
// smem, K-major); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      TF32_WGMMA_N32
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : SM90_F16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 64) (+)= A (registers) * B (8 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      TF32_WGMMA_N64
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : SM90_F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 128) (+)= A (registers) * B (8 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      TF32_WGMMA_N128
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : SM90_F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 32) (+)= A (64 x 8 tf32, smem, K-major) * B (8 x 32, smem,
// K-major)
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      TF32_WGMMA_N32
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}\n"
      : SM90_F16(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) (+)= A (smem, K-major) * B (8 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      TF32_WGMMA_N64
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1;\n}\n"
      : SM90_F32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128) (+)= A (smem, K-major) * B (8 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      TF32_WGMMA_N128
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : SM90_F64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

}  // namespace sm90
