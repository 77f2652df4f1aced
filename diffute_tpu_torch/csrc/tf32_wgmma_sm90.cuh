// tf32 wgmma pieces shared by the fp32 kernels that run their products on
// Hopper's warpgroup MMA (sm_90a): the int8 matmul (quant_fp32_sm90.cu),
// the fp32 flash backward pairs at head_dim 64 (flash_fp32_d64_bwd_sm90.cu)
// and 256 (flash_fp32_d256_bwd_sm90.cu) and the fp32 forwards at 256
// (flash_fp32_d256_sm90.cu).
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
//     t + 4) or from shared memory, B from shared memory;
//   * the flash pieces (the backward pairs' and the 256 forwards'): the
//     loads of a block's 64 columns by TMA, a producer warpgroup's splits
//     of raw TMA tiles into planes (natural, and transposed in the
//     permuted order), a score tile (an fp32 accumulator) split into
//     register A fragments in that order, the output product over a
//     32-row streamed tile with that A, and the store of its 64 x 64
//     accumulator through the strides.

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
#define TF32_ACC32                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
// one m64n64k8 product: A registers A4, B at descriptor B + OB (16-byte
// units), in an asm statement that declares `db` and `p`
#define TF32_RS_N64(A4, B, OB)                                           \
  " add.s64 db, " B ", " #OB ";\n"                                       \
  " " TF32_WGMMA_N64 "{" TF32_ACC32                                      \
  "}, {" A4 "}, db, p, 1, 1;\n"

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

// ------------------------------------------------- shared memory, barriers

__device__ __forceinline__ uint32_t ld_shared_b32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr) : "memory");
  return x;
}

__device__ __forceinline__ float2 ld_shared_f32x2(uint32_t addr) {
  float2 x;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(x.x), "=f"(x.y)
               : "r"(addr)
               : "memory");
  return x;
}

__device__ __forceinline__ float4 ld_shared_f32x4(uint32_t addr) {
  float4 x;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(addr)
               : "memory");
  return x;
}

__device__ __forceinline__ void st_shared_f32(uint32_t addr, float x) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(x) : "memory");
}

__device__ __forceinline__ void st_shared_f32x4(uint32_t addr, float a,
                                                float b, float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// One arrival of the warp on `bar` (lane 0's), as a predicated
// instruction: no branch among products in flight.
__device__ __forceinline__ void release_warp(uint32_t bar) {
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, %1, 0;\n"
      " @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(threadIdx.x & 31)
      : "memory");
}

// ------------------------------------------------------------------ splits

// A raw chunk of four fp32 values into its hi (over the raw values, in
// place) and lo planes.
__device__ __forceinline__ void split_chunk(uint32_t hi, uint32_t lo,
                                           uint4 v) {
  const uint32_t x[4] = {v.x, v.y, v.z, v.w};
  uint4 h, l;
  split4(x, h, l);
  st_shared_v4(hi, h);
  st_shared_v4(lo, l);
}

// A resident raw plane of `bytes` at `hi` split in place, its lo plane
// `bytes` further: 16 bytes a producer thread at a time (the split is
// elementwise, so the swizzle is the same in both planes).
__device__ __forceinline__ void split_plane(uint32_t hi, int bytes, int tid) {
  for (int off = tid * 16; off < bytes; off += 128 * 16)
    split_chunk(hi + off, hi + bytes + off, ld_shared_u4(hi + off));
}

// The flash backward pairs' streamed tile: 32 rows of a block's 64
// columns, two 4 KB boxes (TMA's layout) a plane of 8 KB.
constexpr int kStreamTileBox = 32 * 32 * 4;
constexpr int kStreamTilePlane = 2 * kStreamTileBox;

// The two 32-column boxes at columns col0.. of rows `row`.. of `map` (head
// h, batch b) into the plane at `dst` (boxes `box` bytes apart),
// completing on `bar`.
__device__ __forceinline__ void load_plane(const CUtensorMap* map,
                                           uint32_t dst, uint32_t box,
                                           uint32_t bar, int col0, int row,
                                           int h, int b) {
  tma_load_at(dst, map, bar, col0, h, row, b);
  tma_load_at(dst + box, map, bar, col0 + 32, h, row, b);
}

// A streamed tile's raw values in a producer thread's registers: its
// natural chunks of each tensor, and for the first kTrans tensors the 16
// values of its transposed chunks.
template <int kTensors, int kTrans>
struct StreamRaw {
  uint4 nat[kTensors][4];
  uint32_t tr[kTrans][4][4];
};

// The transposed chunks of the first kTrans raw streamed tiles x[a]
// (read_stream's second half; the forwards at 256 read V so, and only so).
template <int kTensors, int kTrans>
__device__ __forceinline__ void read_transposed(
    const uint32_t (&x)[kTensors], StreamRaw<kTensors, kTrans>& v, int tid) {
  const int d = tid & 63, h = tid >> 6;
#pragma unroll
  for (int a = 0; a < kTrans; ++a)
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 8 * m + h + 2 * i;
        v.tr[a][m][i] = ld_shared_b32(
            x[a] + (d >> 5) * kStreamTileBox + r * 128 +
            ((((d & 31) >> 2) ^ (r & 7)) << 4) + (d & 3) * 4);
      }
}

// Read the raw streamed tiles x[a].  Thread tid of the producer: natural
// chunks tid + 128 m; transposed column d = tid % 64 (of the block's 64)
// at the stream rows of parity h = tid / 64, for the chunks h + 2 m of row
// d of the transposed plane.  A warp's reads each hit 32 distinct banks.
// The writes below come after a barrier of the warpgroup: the transposed
// reads cross the chunks other threads write in place.
template <int kTensors, int kTrans>
__device__ __forceinline__ void read_stream(
    const uint32_t (&x)[kTensors], StreamRaw<kTensors, kTrans>& v, int tid) {
#pragma unroll
  for (int a = 0; a < kTensors; ++a)
#pragma unroll
    for (int m = 0; m < 4; ++m)
      v.nat[a][m] = ld_shared_u4(x[a] + tid * 16 + m * 2048);
  read_transposed(x, v, tid);
}

// The natural planes of x[a]: hi in place of the raw tile, lo
// kStreamTilePlane further.
template <int kTensors, int kTrans>
__device__ __forceinline__ void write_natural(
    const uint32_t (&x)[kTensors], const StreamRaw<kTensors, kTrans>& v,
    int tid) {
#pragma unroll
  for (int a = 0; a < kTensors; ++a)
#pragma unroll
    for (int m = 0; m < 4; ++m)
      split_chunk(x[a] + tid * 16 + m * 2048,
                  x[a] + kStreamTilePlane + tid * 16 + m * 2048, v.nat[a][m]);
}

// The transposed pairs at xt[a] (hi) and xt[a] + kStreamTilePlane (lo):
// [64 rows (head_dim)][32 positions], 128-byte swizzle, position 8 n + p
// of row d holding stream row 8 n + 2 p (p < 4) or 8 n + 2 (p - 4) + 1
// (p >= 4), the order the output products' register A takes.  A warp's
// writes each hit 32 distinct banks.
template <int kTensors, int kTrans>
__device__ __forceinline__ void write_transposed(
    const uint32_t (&xt)[kTrans], const StreamRaw<kTensors, kTrans>& v,
    int tid) {
  const int d = tid & 63, h = tid >> 6;
#pragma unroll
  for (int a = 0; a < kTrans; ++a)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      uint4 hi, lo;
      split4(v.tr[a][m], hi, lo);
      const uint32_t at = d * 128 + (((h + 2 * m) ^ (d & 7)) << 4);
      st_shared_v4(xt[a] + at, hi);
      st_shared_v4(xt[a] + kStreamTilePlane + at, lo);
    }
}

// A score tile of K 8-column steps (fp32 accumulator layout: at 4 n + i,
// row g or g + 8 and column 8 n + 2 t + (i & 1)) as the output product's
// register A in the permuted order, split: k-step n takes (c0, c2, c1, c3)
// of its 8 columns.
template <int K>
__device__ __forceinline__ void split_frags(const float (&x)[4 * K],
                                            uint32_t (&hi)[K][4],
                                            uint32_t (&lo)[K][4]) {
#pragma unroll
  for (int n = 0; n < K; ++n) {
    const uint32_t v[4] = {
        __float_as_uint(x[4 * n]), __float_as_uint(x[4 * n + 2]),
        __float_as_uint(x[4 * n + 1]), __float_as_uint(x[4 * n + 3])};
    uint4 h, l;
    split4(v, h, l);
    hi[n][0] = h.x;
    hi[n][1] = h.y;
    hi[n][2] = h.z;
    hi[n][3] = h.w;
    lo[n][0] = l.x;
    lo[n][1] = l.y;
    lo[n][2] = l.z;
    lo[n][3] = l.w;
  }
}

// ----------------------------------------------------------------- products

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// acc += part (an output product's 64 x 64 part), each sum rounded to
// nearest: the tensor cores' accumulation rounds toward zero, so a part is
// summed from zero over one streamed tile and added here
__device__ __forceinline__ void add_part(float (&acc)[32],
                                         const float (&part)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
}

// part (64 x 64) = A (a split score tile of 32 columns, registers: 4
// k-steps) B over a streamed tile's 32 rows in 3xTF32, 12 products from
// zero, the small terms first: B the transposed planes bt_hi / bt_lo (64
// rows of head_dim, [64][32] with the 128-byte swizzle, the stream rows in
// split_frags' permuted order).
__device__ __forceinline__ void issue_out(float (&part)[32],
                                          const uint32_t (&hi)[4][4],
                                          const uint32_t (&lo)[4][4],
                                          uint32_t bt_hi, uint32_t bt_lo) {
  asm volatile(
      "{\n .reg .b64 db;\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " " TF32_WGMMA_N64 "{" TF32_ACC32
      "}, {%32, %33, %34, %35}, %65, p, 1, 1;\n"
      " setp.eq.b32 p, %66, 0;\n"
      TF32_RS_N64("%36, %37, %38, %39", "%65", 2)
      TF32_RS_N64("%40, %41, %42, %43", "%65", 4)
      TF32_RS_N64("%44, %45, %46, %47", "%65", 6)
      TF32_RS_N64("%48, %49, %50, %51", "%64", 0)
      TF32_RS_N64("%52, %53, %54, %55", "%64", 2)
      TF32_RS_N64("%56, %57, %58, %59", "%64", 4)
      TF32_RS_N64("%60, %61, %62, %63", "%64", 6)
      TF32_RS_N64("%48, %49, %50, %51", "%65", 0)
      TF32_RS_N64("%52, %53, %54, %55", "%65", 2)
      TF32_RS_N64("%56, %57, %58, %59", "%65", 4)
      TF32_RS_N64("%60, %61, %62, %63", "%65", 6)
      "}\n"
      : SM90_F32(part)
      : "r"(lo[0][0]), "r"(lo[0][1]), "r"(lo[0][2]), "r"(lo[0][3]),
        "r"(lo[1][0]), "r"(lo[1][1]), "r"(lo[1][2]), "r"(lo[1][3]),
        "r"(lo[2][0]), "r"(lo[2][1]), "r"(lo[2][2]), "r"(lo[2][3]),
        "r"(lo[3][0]), "r"(lo[3][1]), "r"(lo[3][2]), "r"(lo[3][3]),
        "r"(hi[0][0]), "r"(hi[0][1]), "r"(hi[0][2]), "r"(hi[0][3]),
        "r"(hi[1][0]), "r"(hi[1][1]), "r"(hi[1][2]), "r"(hi[1][3]),
        "r"(hi[2][0]), "r"(hi[2][1]), "r"(hi[2][2]), "r"(hi[2][3]),
        "r"(hi[3][0]), "r"(hi[3][1]), "r"(hi[3][2]), "r"(hi[3][3]),
        "l"(desc_sw128(bt_lo, 1)), "l"(desc_sw128(bt_hi, 1)), "r"(0));
}

// Write the warpgroup's 64 x 64 accumulator times f as fp32 rows [row0,
// row0 + 64), columns [col0, col0 + 64), of (batch b, head h) through the
// strides; rows at or past n_rows are dropped.
__device__ __forceinline__ void store_rows(float* out, long long sb,
                                           long long sl, long long sh, int b,
                                           int h, int col0,
                                           const float (&acc)[32], float f,
                                           int row0, int n_rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r_lo = row0 + ((threadIdx.x >> 5) & 3) * 16 + g, r_hi = r_lo + 8;
  float* base = out + b * sb + h * sh + col0;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + t * 2;
    if (r_lo < n_rows)
      *reinterpret_cast<float2*>(base + r_lo * sl + col) =
          make_float2(acc[4 * n] * f, acc[4 * n + 1] * f);
    if (r_hi < n_rows)
      *reinterpret_cast<float2*>(base + r_hi * sl + col) =
          make_float2(acc[4 * n + 2] * f, acc[4 * n + 3] * f);
  }
}

}  // namespace sm90
