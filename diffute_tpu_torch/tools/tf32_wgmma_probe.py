"""Measure the rate of tf32 ``wgmma`` chains on the card, with the A operand
from registers or from shared memory, at the widths the fp32 kernels issue.

  python -m diffute_tpu_torch.tools.tf32_wgmma_probe [--iters 2000]
      [--out FILE]

One block an SM (160 KB of shared memory keeps a second one off), one, two
or three warpgroups a block; each warpgroup runs ``--iters`` chains of 24
m64nNk8 products from zero (a 3xTF32 score over head_dim 64: 8 k-steps x
3), A from its own 64-row plane in shared memory or from registers, B from
one N-row plane all warpgroups of the block read, and waits for each chain
before the next, as a kernel that uses the sum does.  N = 32 and 64 are the
head_dim-64 fp32 backward pair's score and output products
(``csrc/flash_fp32_d64_bwd_sm90.cu``), 128 the int8 matmul's wider tile
(``csrc/quant_fp32_sm90.cu``).  The products read the header those kernels
share (``csrc/tf32_wgmma_sm90.cuh``).  For each case: CUDA-event medians of
five launches, repeated three times, and the rate against the card's dense
TF32 peak (494.7 TFLOP/s at 700 W).  Prints one JSON object per case with
the card's name and power limit, and writes them to ``--out`` if given.
Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import tempfile

import torch

PEAK_TF32_FLOPS = 494.7e12
CHAIN = 24  # products a chain: 8 k-steps x 3 (3xTF32)
SMEM = 160 * 1024

SOURCE = r"""
#include "tf32_wgmma_sm90.cuh"

using namespace sm90;

namespace {

// N columns of B; kRegA: A from registers, else from the warpgroup's plane
template <int N, bool kRegA>
__global__ void __launch_bounds__(384, 1)
    probe_kernel(float* out, int iters, int wgs) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  // A planes: 16 KB a warpgroup (64 rows x 64 columns, two boxes of 8 KB);
  // B: N rows x 64 columns, two boxes of N * 128 bytes, after them
  const uint32_t b_plane = smem + 3 * 16384;
  for (int i = threadIdx.x; i < (3 * 16384 + 2 * N * 128) / 4;
       i += blockDim.x)
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(smem + 4 * i),
                 "r"(__float_as_uint(0.125f * ((i * 37) & 7) - 0.5f))
                 : "memory");
  fence_proxy_async();
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (wg >= wgs) return;
  const uint32_t a_plane = smem + wg * 16384;
  uint32_t a[8][4];
#pragma unroll
  for (int s = 0; s < 8; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[s][j] = __float_as_uint(0.25f * ((threadIdx.x + s + j) & 3));
  float acc[N / 2], sink = 0.f;
  for (int it = 0; it < iters; ++it) {
    issue_begin(acc, a);
#pragma unroll
    for (int s = 0; s < 24; ++s) {
      const uint64_t db = tf32_desc(b_plane, s & 7, N * 128);
      if constexpr (kRegA)
        wgmma_tf32(acc, a[s & 7], db, s > 0);
      else
        wgmma_tf32_ss(acc, tf32_desc(a_plane, s & 7, 8192), db, s > 0);
    }
    issue_end(acc, a);
    wgmma_wait<0>();
    fence_regs(acc);
    sink += acc[0] + acc[N / 2 - 1];
  }
  out[(blockIdx.x * 3 + wg) * 128 + (threadIdx.x & 127)] = sink;
}

template <int N, bool kRegA>
int launch(float* out, int iters, int wgs, int blocks, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      probe_kernel<N, kRegA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  probe_kernel<N, kRegA><<<blocks, 384, SMEM_BYTES, stream>>>(out, iters,
                                                             wgs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tf32_wgmma_probe(int n, int reg_a, float* out, int iters,
                                int wgs, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wgs < 1 || wgs > 3) return (int)cudaErrorInvalidValue;
  switch (n * 2 + (reg_a != 0)) {
    case 64: return launch<32, false>(out, iters, wgs, blocks, st);
    case 65: return launch<32, true>(out, iters, wgs, blocks, st);
    case 128: return launch<64, false>(out, iters, wgs, blocks, st);
    case 129: return launch<64, true>(out, iters, wgs, blocks, st);
    case 256: return launch<128, false>(out, iters, wgs, blocks, st);
    case 257: return launch<128, true>(out, iters, wgs, blocks, st);
  }
  return (int)cudaErrorInvalidValue;
}
"""


def build() -> ctypes.CDLL:
    """Compile SOURCE with the package's nvcc flags and headers."""
    from diffute_tpu_torch.ops import _build

    directory = tempfile.mkdtemp(prefix="tf32_probe_")
    path = os.path.join(directory, "tf32_wgmma_probe.cu")
    with open(path, "w") as f:
        f.write(SOURCE)
    command = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
               f"-DSMEM_BYTES={SMEM}"]
    so = _build.build_shared_library(
        "tf32_wgmma_probe", command, [path],
        hashed=sorted(os.path.join(_build.CSRC, h)
                      for h in os.listdir(_build.CSRC) if h.endswith(".cuh")))
    lib = ctypes.CDLL(so)
    fn = lib.tf32_wgmma_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tf32_wgmma_probe: no CUDA device")
    fn = build()
    dev = torch.device("cuda", 0)
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(blocks * 3 * 128, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    name = card()
    rows = []
    for n in (32, 64, 128):
        for wgs in (1, 2, 3):
            for reg_a in (1, 0):
                def run():
                    err = fn(n, reg_a, out.data_ptr(), args.iters, wgs,
                             blocks, stream)
                    if err:
                        raise RuntimeError(f"probe n={n}: CUDA error {err}")
                run()
                torch.cuda.synchronize()
                times = []
                for _ in range(3):
                    t0, t1 = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                    t0.record()
                    for _ in range(5):
                        run()
                    t1.record()
                    torch.cuda.synchronize()
                    times.append(t0.elapsed_time(t1) / 5)
                ms = statistics.median(times)
                flops = 2 * 64 * n * 8 * CHAIN * args.iters * wgs * blocks
                row = dict(card=name, n=n, a="registers" if reg_a else
                           "shared", warpgroups=wgs, chain=CHAIN,
                           iters=args.iters, ms=ms,
                           tflops=flops / ms / 1e9,
                           share_of_tf32_peak=flops / ms / 1e-3
                           / PEAK_TF32_FLOPS)
                rows.append(row)
                print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
