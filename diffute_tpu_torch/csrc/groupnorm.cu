// GroupNorm statistics and GroupNorm + SiLU for Hopper (sm_90a), NCHW bf16.
//
// Replaces the Pallas TPU kernel `_gn_silu_kernel` of
// diffute_tpu/ops/groupnorm.py (`_pallas_gn_silu_fwd_impl`'s pl.pallas_call).
// It computes the same function, not the same grid.  The Pallas kernel keeps
// one sample's whole (H*W, C) slab in VMEM, one grid step per sample, and
// reduces channels to groups with one-hot matmuls (a Mosaic workaround).  In
// NCHW a group of one sample is one contiguous run of (C/G)*H*W elements, so
// here the reduction is a plain sum over that run:
//
//   gn_stats_bf16  x (B, C, H, W) -> mean, rstd (B, G) fp32
//   gn_silu_bf16   y = silu(x * a_c + d_c),  a_c = gamma_c * rstd_g,
//                  d_c = beta_c - mean_g * a_c, rounded to bf16; one launch
//
// The statistics are shared with the fused conv kernel (conv_fused.cu).
//
// What bounds them on the H100: not bytes but latency.  Both do a few fp32
// operations per element, far below the card's 295 FLOP/byte line, and the
// UNet's tensors are 160 KB to 31 MB: 0.05 to 19 us of bytes at 3.35 TB/s,
// where a launch, a dependent load and a barrier each cost about a
// microsecond.  What the design does about it:
//   - one (sample, group) is one block up to 2,048 vectors, else a thread
//     block cluster of up to 8 blocks (`gn_plan` in ops/groupnorm.py chooses
//     the cluster and the threads from the shape, so that the blocks cover
//     the 132 SMs at 64^2); block r of the cluster takes the r-th contiguous
//     piece of the group's run;
//   - one read of x: every thread issues all (up to 8) 16-byte loads of an
//     iteration before it uses one, then takes the mean and M2 of those
//     registers in two passes over them (exact where E[x^2] - mean^2 cancels,
//     |mean| >> std);
//   - one merge tree, no atomics: (count, mean, M2) triples are merged with
//     Chan's formula down each warp (shuffles), then across the warps, then
//     across the cluster: after a cluster barrier the block that needs the
//     group's result reads every rank's triple from its shared memory
//     (distributed shared memory) and folds them in rank order.  Every step
//     has a fixed order, so the result has the same bits on every run; there
//     is no global scratch buffer, no ticket counter and no fence;
//   - GN+SiLU in one launch: the same loads also store the piece into shared
//     memory, every block of the cluster folds the ranks itself (the same
//     bits in each), and writes silu(x * a_c + d_c) from shared memory: x is
//     read once and y written once.  Where a piece exceeds the shared memory
//     a block can take (no shape of the UNet; the VAE decoder's 128 x 512^2),
//     the rest of the piece is read again from global memory for the apply.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kUnroll = 8;         // 16-byte loads a thread has in flight
constexpr int kMaxThreads = 1024;  // threads of a block
constexpr int kMaxCluster = 8;     // blocks of a cluster (the portable limit)
// dynamic shared memory a GN+SiLU block may take: the staged piece and its
// channels' (a, d) (227 KB less 1 KB for the static part)
constexpr int kMaxSmem = 232448 - 1024;

// (count, mean, sum of squared deviations) of a run of values
struct Moments {
  float n, mean, m2;
};

// Chan's formula: the moments of a and b together.  The merges are the
// block's critical path, one after another, so the weight is a fast division
// (2 ulp; an IEEE division here cost 1-2 us a launch on the H100)
__device__ __forceinline__ Moments merge(const Moments& a, const Moments& b) {
  const float n = a.n + b.n;
  const float f = n > 0.f ? __fdividef(b.n, n) : 0.f;
  const float d = b.mean - a.mean;
  return {n, fmaf(d, f, a.mean), a.m2 + b.m2 + d * d * a.n * f};
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// The moments of the first `valid` vectors of v: two passes over registers.
__device__ __forceinline__ Moments moments(const uint4 (&v)[kUnroll],
                                           int valid) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    if (j < valid) {
      float f[8];
      unpack8(v[j], f);
#pragma unroll
      for (int k = 0; k < 8; ++k) s += f[k];
    }
  }
  const float n = 8.f * (float)valid;
  const float mu = valid > 0 ? __fdividef(s, n) : 0.f;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    if (j < valid) {
      float f[8];
      unpack8(v[j], f);
#pragma unroll
      for (int k = 0; k < 8; ++k) q = fmaf(f[k] - mu, f[k] - mu, q);
    }
  }
  return {n, mu, q};
}

// This thread's moments over vectors threadIdx.x, + blockDim.x, ... of the
// piece xv[0, len).  With kStage, vectors below `staged` are also stored to
// stage[i].
template <bool kStage>
__device__ __forceinline__ Moments piece_moments(const uint4* __restrict__ xv,
                                                 int len, uint4* stage,
                                                 int staged) {
  Moments acc = {0.f, 0.f, 0.f};
  const int step = blockDim.x;
  for (int base = threadIdx.x; base < len; base += kUnroll * step) {
    uint4 v[kUnroll];
    int valid = 0;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int i = base + j * step;
      if (i < len) {
        v[j] = __ldg(xv + i);
        valid = j + 1;
      } else {
        v[j] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    acc = merge(acc, moments(v, valid));
    if (kStage) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int i = base + j * step;
        if (i < len && i < staged) stage[i] = v[j];
      }
    }
  }
  return acc;
}

// Merge down a warp in a fixed order; lane 0 holds the warp's moments.
__device__ __forceinline__ Moments warp_merge(Moments m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Moments o = {__shfl_down_sync(0xffffffffu, m.n, off),
                       __shfl_down_sync(0xffffffffu, m.mean, off),
                       __shfl_down_sync(0xffffffffu, m.m2, off)};
    m = merge(m, o);
  }
  return m;
}

// The block's moments, written to `part` by thread 0; `warps` holds 32.
__device__ __forceinline__ void block_merge(Moments m, Moments* warps,
                                            Moments* part) {
  m = warp_merge(m);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warps[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < (int)(blockDim.x >> 5) ? warps[lane] : Moments{0.f, 0.f, 0.f};
    m = warp_merge(m);
    if (lane == 0) *part = m;
  }
}

// A group's blocks are the gridDim.x blocks of one cluster, block r at
// blockIdx.x = r; a group of one block is launched without a cluster (a
// cluster launch cost about 1 us more), and skips the cluster's barriers.
//
// Split cluster barrier: arrive releases this block's shared-memory writes,
// wait acquires every other block's.  Every thread of every block calls both.
__device__ __forceinline__ void cluster_arrive() {
  if (gridDim.x > 1) asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  if (gridDim.x > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The group's moments: every rank's `part`, read through distributed shared
// memory, folded in rank order (after a cluster barrier).
__device__ __forceinline__ Moments fold_ranks(Moments* part) {
  if (gridDim.x == 1) return *part;
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = (int)gridDim.x;
  Moments p[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < ranks) p[r] = *cluster.map_shared_rank(part, r);
  Moments g = {0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < ranks) g = merge(g, p[r]);
  return g;
}

__device__ __forceinline__ float ld_affine(const void* p, int i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// grid (cluster, B*G), cluster dims (cluster, 1, 1).  Block r of cluster bg
// takes vectors [r*per, min((r+1)*per, n_vec)) of the group's n_vec.
__global__ void __launch_bounds__(kMaxThreads)
gn_stats_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ mean,
                float* __restrict__ rstd, int n_vec, int per, float eps) {
  __shared__ Moments warps[32];
  __shared__ Moments part;
  // the fused conv launched behind this kernel may start its prologue now
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int rank = blockIdx.x, bg = blockIdx.y;
  const int v0 = rank * per, len = min(per, n_vec - v0);
  const uint4* xv = reinterpret_cast<const uint4*>(x) + (size_t)bg * n_vec + v0;
  block_merge(piece_moments<false>(xv, len, nullptr, 0), warps, &part);
  cluster_arrive();
  cluster_wait();
  if (rank == 0 && threadIdx.x == 0) {
    const Moments g = fold_ranks(&part);
    mean[bg] = g.mean;
    rstd[bg] = rsqrtf(g.m2 / g.n + eps);
  }
  // rank 0 has read the others' shared memory before any block leaves (a
  // block that leaves while it is read faults the launch)
  cluster_arrive();
  cluster_wait();
}

// As gn_stats_kernel, then y = silu(x * a_c + d_c) over the block's piece.
// Dynamic shared memory: `staged` vectors of the piece, then (a, d) of each
// channel it touches (at most cpg).
__global__ void __launch_bounds__(kMaxThreads)
gn_silu_kernel(const __nv_bfloat16* __restrict__ x,
               const void* __restrict__ gamma, const void* __restrict__ beta,
               int affine_bf16, __nv_bfloat16* __restrict__ y, int n_vec,
               int per, int staged, int hw_vec, int cpg, int groups,
               float eps) {
  extern __shared__ uint4 stage[];
  __shared__ Moments warps[32];
  __shared__ Moments part;
  __shared__ float stat[2];
  const int rank = blockIdx.x, bg = blockIdx.y;
  const int v0 = rank * per, len = min(per, n_vec - v0);
  const size_t off = (size_t)bg * n_vec + v0;
  const uint4* xv = reinterpret_cast<const uint4*>(x) + off;
  block_merge(piece_moments<true>(xv, len, stage, staged), warps, &part);
  cluster_arrive();
  cluster_wait();
  if (threadIdx.x == 0) {
    const Moments g = fold_ranks(&part);  // the same bits in every block
    stat[0] = g.mean;
    stat[1] = rsqrtf(g.m2 / g.n + eps);
  }
  cluster_arrive();  // this block is done with the others' shared memory
  __syncthreads();

  // (a, d) of the piece's channels c0 .. c0 + nc - 1 of the group
  const int c0 = v0 / hw_vec, nc = (v0 + len - 1) / hw_vec - c0 + 1;
  float2* ad = reinterpret_cast<float2*>(stage + staged);
  const int cbase = (bg % groups) * cpg + c0;
  for (int t = threadIdx.x; t < nc; t += blockDim.x) {
    const float a = ld_affine(gamma, cbase + t, affine_bf16) * stat[1];
    ad[t] = make_float2(a, ld_affine(beta, cbase + t, affine_bf16) - stat[0] * a);
  }
  __syncthreads();

  uint4* yv = reinterpret_cast<uint4*>(y) + off;
  const float inv_hw = 1.f / (float)hw_vec;
#pragma unroll 4
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const uint4 v = i < staged ? stage[i] : __ldg(xv + i);
    // (v0 + i) / hw_vec: the float quotient is off by at most one below
    // 2^24 vectors (the launcher's limit), corrected in integers
    const int at = v0 + i;
    int q = __float2int_rz((float)at * inv_hw);
    q += (q + 1) * hw_vec <= at;
    q -= q * hw_vec > at;
    const float2 c = ad[q - c0];
    float f[8];
    unpack8(v, f);
    uint4 out;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float u = fmaf(f[2 * j], c.x, c.y), w = fmaf(f[2 * j + 1], c.x, c.y);
      o[j] = __floats2bfloat162_rn(__fdividef(u, 1.f + __expf(-u)),
                                   __fdividef(w, 1.f + __expf(-w)));
    }
    yv[i] = out;
  }
  cluster_wait();  // no block leaves while another may read its `part`
}

// A launch of grid (cluster, n_groups) in clusters of `cluster` blocks (no
// cluster for one).
cudaLaunchConfig_t cluster_config(int cluster, int n_groups, int threads,
                                  size_t smem, void* stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, n_groups, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cfg;
}

// Whether n_vec vectors split into `cluster` pieces of ceil(n_vec / cluster)
// with none empty, over `threads` threads a block.
bool valid_split(int n_groups, int n_vec, int cluster, int threads) {
  if (n_groups <= 0 || n_groups > 65535 || n_vec <= 0 || cluster < 1 ||
      cluster > kMaxCluster || threads < 32 || threads > kMaxThreads ||
      threads % 32)
    return false;
  const int per = (n_vec + cluster - 1) / cluster;
  return (long long)per * (cluster - 1) < n_vec;
}

int launched(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream`, allocates
// nothing, and returns the launch's CUDA error (0 = launched).  `cluster` and
// `threads` come from gn_plan (ops/groupnorm.py).

// x (n_groups runs of n_elem contiguous bf16, n_elem % 8 == 0, 16-byte
// aligned) -> mean, rstd (n_groups) fp32.
extern "C" int gn_stats_bf16(const void* x, void* mean, void* rstd,
                             int n_groups, int n_elem, int cluster,
                             int threads, float eps, void* stream) {
  if (n_elem <= 0 || n_elem % 8 ||
      !valid_split(n_groups, n_elem / 8, cluster, threads))
    return (int)cudaErrorInvalidValue;
  const int n_vec = n_elem / 8, per = (n_vec + cluster - 1) / cluster;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(cluster, n_groups, threads, 0, stream, &attr);
  return launched(cudaLaunchKernelEx(
      &cfg, gn_stats_kernel, static_cast<const __nv_bfloat16*>(x),
      static_cast<float*>(mean), static_cast<float*>(rstd), n_vec, per, eps));
}

// x, y (B, C, HW) bf16 with HW % 8 == 0, 16-byte aligned; gamma, beta (C)
// bf16 or fp32.  `staged` of each block's ceil(n_vec / cluster) vectors go
// through shared memory (all of them unless the piece exceeds it).
extern "C" int gn_silu_bf16(const void* x, const void* gamma,
                            const void* beta, int affine_bf16, void* y,
                            int batch, int channels, int hw, int groups,
                            int cluster, int threads, int staged, float eps,
                            void* stream) {
  if (batch <= 0 || channels <= 0 || hw <= 0 || hw % 8 || groups <= 0 ||
      channels % groups)
    return (int)cudaErrorInvalidValue;
  const int cpg = channels / groups;
  const long long n_vec_ll = (long long)cpg * (hw / 8);
  if (n_vec_ll >= (1 << 24) ||
      !valid_split(batch * groups, (int)n_vec_ll, cluster, threads))
    return (int)cudaErrorInvalidValue;
  const int n_vec = (int)n_vec_ll, per = (n_vec + cluster - 1) / cluster;
  const long long smem = (long long)staged * 16 + (long long)cpg * 8;
  if (staged < 0 || staged > per || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr_set = cudaFuncSetAttribute(
      gn_silu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr_set != cudaSuccess) return (int)attr_set;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      cluster, batch * groups, threads, (size_t)smem, stream, &attr);
  return launched(cudaLaunchKernelEx(
      &cfg, gn_silu_kernel, static_cast<const __nv_bfloat16*>(x), gamma, beta,
      affine_bf16, static_cast<__nv_bfloat16*>(y), n_vec, per, staged,
      hw / 8, cpg, groups, eps));
}
