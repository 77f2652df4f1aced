// Hopper (sm_90a) GEMM building blocks shared by the fused
// GroupNorm+SiLU+conv3x3 (conv_fused.cu) and the int8-weight matmul
// (quant.cu), on top of flash_sm90.cuh's mbarrier, descriptor and wgmma
// fence helpers: a ring of shared-memory stages with full and empty
// mbarriers, bulk copies and 2-D TMA loads that complete on them, the proxy
// fence that makes shared memory written by threads visible to wgmma, the
// wgmma shapes the kernels issue, and the in-order sum of split partials.
//
// Block layout of both kernels: the first warpgroup(s) produce (thread 0
// issues every bulk copy and TMA load; in the conv the producer warpgroups
// also normalise the input patch into the B operand), the last two consume
// with wgmma.  Consumers do no loads and no __syncthreads: they wait on a
// stage's full barrier and each warp releases it by one arrival on its
// empty barrier (count 4 * kConsumers).

#pragma once

#include "flash_sm90.cuh"

namespace sm90 {

// a ring of `stages` stages, each with a full and an empty mbarrier
struct GemmRing {
  uint32_t base;
  int stages;
  __device__ uint32_t full(int s) const { return base + 8 * s; }
  __device__ uint32_t empty(int s) const { return base + 8 * (stages + s); }
  // full_count: arrivals that complete a stage besides its bytes
  __device__ void init(uint32_t full_count) const {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), full_count);
      mbar_init(empty(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // round r of stage s: the producer waits for parity ((r & 1) ^ 1), so
  // round 0 passes; consumers wait for parity (r & 1)
  __device__ void wait_empty(int i) const {
    mbar_wait(empty(i % stages), ((i / stages) & 1) ^ 1);
  }
  __device__ void wait_full(int i) const {
    mbar_wait(full(i % stages), (i / stages) & 1);
  }
};

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, completing on `bar` (no tensor map).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Shared memory written by ordinary stores becomes visible to wgmma (the
// async proxy) only after this fence in each writing thread.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier of the 128 threads of one warpgroup (ids 1 and 2 are the
// consumers' named_sync pair in flash_sm90.cuh; these kernels use 3 + wg)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint4 ld_shared_u4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// d (64 x 64, fp32) += A (64 x 16, smem, MN-major) * B (16 x 64, smem,
// MN-major): both operands are 16 rows of k, each 64 contiguous m or n
// (128 bytes, 128-byte swizzle), as V is read in flash_sm90.cuh.
__device__ __forceinline__ void wgmma_ss_mn_n64(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : SM90_F32(d)
      : "l"(da), "l"(db), "r"(1));
}

#define SM90_F64(a) SM90_F32(a), SM90_F8(a, 32), SM90_F8(a, 40), \
    SM90_F8(a, 48), SM90_F8(a, 56)

// d (64 x 128, fp32) += A (64 x 16 bf16, registers) * B (16 x 128, smem,
// K-major: 128 rows of 64 k, 128-byte swizzle, as K is read in
// flash_sm90.cuh).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : SM90_F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the same with 64 columns of B
__device__ __forceinline__ void wgmma_rs_n64_k(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : SM90_F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The split-K partials of one output tile, one fp32 value per accumulator
// register: split z of tile t keeps thread i's N values at
// ((z * tiles + t) * threads + i) * N, so each thread writes and reads back
// whole 16-byte runs.  Every split block of a tile writes its partial and
// takes a ticket; the block that takes the last one (whichever it is) adds
// all partials in split order (so the sum does not depend on which block
// came last), resets the ticket and goes on to the epilogue with the sum in
// `acc`.  Returns false in the other blocks.  `sync` is a barrier of the
// `threads` consumer threads, `flag` a shared int.
template <int N, class Sync>
__device__ __forceinline__ bool split_sum(float (&acc)[N], float* ws,
                                          int* tickets, int tile, int tiles,
                                          int split, int splits, int threads,
                                          int tid, int* flag, Sync sync) {
  float4* mine = reinterpret_cast<float4*>(
      ws + ((size_t)(split * tiles + tile) * threads + tid) * N);
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    __stcg(mine + i, make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                                 acc[4 * i + 3]));
  __threadfence();
  sync();
  if (tid == 0) *flag = atomicAdd(&tickets[tile], 1) == splits - 1;
  sync();
  if (!*flag) return false;
  __threadfence();
  if (tid == 0) tickets[tile] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  for (int z = 0; z < splits; ++z) {
    const float4* part = reinterpret_cast<const float4*>(
        ws + ((size_t)(z * tiles + tile) * threads + tid) * N);
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = __ldcg(part + i);
      acc[4 * i] += v.x;
      acc[4 * i + 1] += v.y;
      acc[4 * i + 2] += v.z;
      acc[4 * i + 3] += v.w;
    }
  }
  return true;
}

}  // namespace sm90
