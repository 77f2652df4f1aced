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
// over kv and no scratch: a block owns 128 q rows of one (batch, head) (two
// consumer warpgroups, flash_sm90.cuh) and walks the 64-row kv tiles itself,
// and the two score tiles are two register sets of each consumer thread.
//
//   q (B, S, H, 64), k/v (B, T, H, 64)  bf16, any strides TMA takes;
//   T a multiple of 64 and at least 128 (the dispatch rule)
//   o (B, S, H, 64) bf16 through its strides, lse (B*H, S) fp32 natural log
//
// The schedule, within each consumer warpgroup.  A prologue computes
// S_0 = Q K_0^T.  Body j issues S_{j+1} = Q K_{j+1}^T as an asynchronous
// wgmma FIRST, retires P_{j-1} V_{j-1} (issued by the previous body, queued
// ahead of S_{j+1}), then runs tile j's softmax (max, exp2, row sum) while
// S_{j+1} is in flight, rescales O and issues O += P_j V_j.  It then waits
// for S_{j+1} only, so P_j V_j runs on into the next body and the tensor
// cores never wait for an issue.  wgmma.wait_group 1 waits for all but the
// most recent group: after S_{j+1} it retires P_{j-1} V_{j-1}, after P_j V_j
// it retires S_{j+1}.  The two consumer warpgroups run this independently:
// flash_fwd.cu's turns, tried on this schedule, made it slower on an H100
// and ptxas serialized its wgmmas (PERF.md).
//
// What bounds it on the H100: operations, as for flash_fwd.cu (256 tensor
// FLOPs a score against one exp2; the exp2 costs as much as both products),
// so the gain is the overlap above.  What it costs: registers.  With
// 128-row kv tiles the two live score tiles are 128 fp32
// registers a consumer thread beside O and P, and ptxas spilled and
// serialized the wgmmas (tiles swapped or moved, up to 255 registers); with
// 64-row tiles the two score tiles are 64 registers and P 16.
//
// Scale.  softmax_scale * log2(e) is folded into the exp2 argument as one FMA
// on the fp32 score (exp2(s*c - m)), as in flash_fwd.cu; q is NOT pre-scaled
// and rounded to bf16 as the TPU kernel's caller does.  The plain version
// (ops/flash_attention.py: flash_fwd_pipelined_reference) scales the same way.

#include "flash_sm90.cuh"

namespace {

using namespace sm90;

// Per consumer thread: two score tiles (2 x 32 regs), O (32) and P (16).
// wgmma always writes `nxt` and the softmax always reads `cur`; S_{j+1} is
// moved from one to the other once it is retired (32 moves a tile), so no
// register is ever both an in-flight accumulator and softmax input, and
// the steady loop is one straight body.  (Swapping the two tiles' roles by
// unrolling made ptxas spill and serialize the wgmmas.)  The first body and
// the last are separate instances: no branch while a product is in flight.
struct Deferred {
  static constexpr int kBlockKV = 64;
  struct State {
    float cur[kBlockKV / 2], nxt[kBlockKV / 2];  // S_j, S_{j+1}
    float o[32];
    uint32_t pk[kBlockKV / 16][4];
    RowState st;
  };

  // Body j: `cur` holds S_j; S_{j+1} goes into `nxt` ahead of S_j's softmax.
  template <bool kFirst, bool kLast>
  __device__ __forceinline__ static void body(const FwdParams& p,
                                              const Bars& bars,
                                              uint32_t q_tile, uint32_t k_ring,
                                              uint32_t v_ring, int j,
                                              State& x) {
    const int nst = (j + 1) % kStages;
    if (!kLast) {  // produce (the last body only consumes)
      mbar_wait(bars.k_full(nst), ((j + 1) / kStages) & 1);
      issue_begin(x.nxt);
      issue_qk(x.nxt, q_tile, k_ring + nst * kv_tile_bytes<kBlockKV>());
      issue_end(x.nxt);
    }
    if (!kFirst) {  // retire P_{j-1} V_{j-1}; S_{j+1} runs on
      if (kLast)
        wgmma_wait<0>();
      else
        wgmma_wait<1>();
      fence_regs(x.o);
      fence_regs(x.pk);
      release(bars.v_empty((j - 1) % kStages));
    }
    if (kLast) mask_tail(x.cur, j * kBlockKV, p.t_len);
    const float2 alpha = softmax_step(x.cur, x.st, p.scale_log2);
    rescale(x.o, alpha);
    pack_p(x.pk, x.cur);
    const int sj = j % kStages;
    mbar_wait(bars.v_full(sj), (j / kStages) & 1);
    issue_begin(x.o, x.pk);
    issue_pv(x.o, x.pk, v_ring + sj * kv_tile_bytes<kBlockKV>());
    issue_end(x.o, x.pk);
    if (!kLast) {  // retire S_{j+1}; P_j V_j runs on into the next body
      wgmma_wait<1>();
      fence_regs(x.nxt);
      release(bars.k_empty(nst));
#pragma unroll
      for (int i = 0; i < kBlockKV / 2; ++i) x.cur[i] = x.nxt[i];
    }
  }

  __device__ __forceinline__ static void run(const FwdParams& p,
                                             uint32_t smem, const Bars& bars,
                                             int wg, int n_tiles,
                                             float (&o)[32], RowState& st) {
    const uint32_t q_tile = smem + Smem<kBlockKV>::q + wg * kQTileBytes;
    const uint32_t k_ring = smem + Smem<kBlockKV>::k;
    const uint32_t v_ring = smem + Smem<kBlockKV>::v;
    State x;
#pragma unroll
    for (int i = 0; i < 32; ++i) x.o[i] = 0.f;
    x.st = {-INFINITY, -INFINITY, 0.f, 0.f};

    // ---- prologue: S_0, consume nothing
    mbar_wait(bars.q_full(), 0);
    mbar_wait(bars.k_full(0), 0);
    issue_begin(x.nxt);
    issue_qk(x.nxt, q_tile, k_ring);
    issue_end(x.nxt);
    wgmma_wait<0>();
    fence_regs(x.nxt);
    release(bars.k_empty(0));
#pragma unroll
    for (int i = 0; i < kBlockKV / 2; ++i) x.cur[i] = x.nxt[i];

    if (n_tiles == 1) {
      body<true, true>(p, bars, q_tile, k_ring, v_ring, 0, x);
    } else {
      body<true, false>(p, bars, q_tile, k_ring, v_ring, 0, x);
      for (int j = 1; j < n_tiles - 1; ++j)
        body<false, false>(p, bars, q_tile, k_ring, v_ring, j, x);
      body<false, true>(p, bars, q_tile, k_ring, v_ring, n_tiles - 1, x);
    }
    wgmma_wait<0>();
    fence_regs(x.o);
    fence_regs(x.pk);
    release(bars.v_empty((n_tiles - 1) % kStages));
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = x.o[i];
    st = x.st;
  }
};

}  // namespace

// Plain C entry point for ctypes (see sm90::launch_fwd for the arguments).
// t_len must be a multiple of 64 of at least 128 (cudaErrorInvalidValue
// otherwise): the dispatch rule the wrapper applies.
extern "C" int flash_fwd_pipelined_bf16(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int b, int h, int s_len, int t_len,
                                        const long long* strides, float scale,
                                        void* stream) {
  if (t_len < 128 || t_len % 64) return (int)cudaErrorInvalidValue;
  return sm90::launch_fwd<Deferred>(q, k, v, o, lse, b, h, s_len, t_len,
                                    strides, scale, stream);
}
