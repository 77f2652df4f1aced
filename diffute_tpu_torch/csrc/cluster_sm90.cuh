// Thread block cluster pieces shared by the fp32 flash kernels that split
// head_dim over a cluster of blocks (sm_90a): the two sources at head_dim
// 512 (flash_fp32_d512_sm90.cuh's layout) and the backward pair at 256
// (flash_fp32_d256_bwd_sm90.cu).  The cluster's rank, mapa, remote stores,
// the split cluster barrier, the asynchronous remote stores that complete
// on the receiving block's mbarrier, and the cluster launch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_sm90.cuh"

namespace cluster_sm90 {

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// The shared::cluster address of shared::cta address `addr` in block
// `rank` of this cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster_f(uint32_t addr, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(x)
               : "memory");
}

__device__ __forceinline__ void st_cluster_f2(uint32_t addr, float2 x) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
               "f"(x.x), "f"(x.y)
               : "memory");
}

__device__ __forceinline__ void st_cluster_f4(uint32_t addr, float4 x) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w)
               : "memory");
}

// Split cluster barrier: the arrival releases this thread's writes (to
// its own and the other blocks' shared memory), the wait acquires every
// other thread's of the cluster.  Every thread of every block calls both,
// in turns.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes into the shared memory of another block of the cluster (`addr`
// and `bar` from map_rank, both in that block), completing `bar`'s
// transaction count by 16 when they land: a weak store whose completion
// releases it at cluster scope, so the block that waits on `bar`
// (mbar_wait_cluster) reads it.
__device__ __forceinline__ void st_async_f4(uint32_t addr, float4 x,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w), "r"(bar)
      : "memory");
}

// Wait until the phase of parity `parity` of this block's mbarrier `bar`
// has completed, acquiring at cluster scope what the other blocks' st_async
// stores released there; traps after sm90::kWaitClocks, as sm90::mbar_wait.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  if (done) return;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (clock64() - t0 > sm90::kWaitClocks) __trap();
  } while (!done);
}

// ------------------------------------------------------------------ host

// A launch of `threads`-thread blocks over clusters of `ranks` blocks, one
// cluster a `tile_rows`-row tile of `rows` rows and B*H.
inline cudaLaunchConfig_t cluster_config(int ranks, int tile_rows, int threads,
                                         int rows, int bh, int smem_bytes,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks * ((rows + tile_rows - 1) / tile_rows), bh, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ranks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <class Params>
cudaError_t allow_smem(void (*kernel)(Params), int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// cudaOccupancyMaxActiveClusters of `kernel` launched as cluster_config
// (ranks, tile_rows, threads) with `bytes` of shared memory a block: the
// clusters the card runs at once; a negative CUDA error code if the query
// fails.
template <class Params>
int max_clusters(void (*kernel)(Params), int ranks, int tile_rows,
                 int threads, int bytes) {
  cudaError_t err = allow_smem(kernel, bytes);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      ranks, tile_rows, threads, tile_rows * 1024, 1, bytes, nullptr, &attr);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(
        &n, reinterpret_cast<const void*>(kernel), &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace cluster_sm90
