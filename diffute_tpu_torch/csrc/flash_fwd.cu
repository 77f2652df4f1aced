// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out, fp32 LSE.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// diffute_tpu/ops/flash_attention.py (called through `_flash_fwd_3d`'s
// pl.pallas_call).  It computes the same quantity, not the same grid: the
// Pallas kernel walks the kv axis as a sequential grid dimension and carries
// (m, l, acc) in VMEM scratch between grid steps; here one thread block owns
// 128 q rows of one (batch, head) and loops over 64-row kv tiles itself,
// with the online-softmax state in registers.
//
//   q (B, S, H, 64), k/v (B, T, H, 64)  bf16, any strides TMA takes
//   o (B, S, H, 64) bf16 through its strides,
//   lse (B*H, S) fp32 natural-log log-sum-exp
//
// What bounds it on the H100: at head_dim 64 each score costs 2*64 FLOPs in
// QK^T and 2*64 in PV (256 tensor FLOPs) against one exp2 and a few fp32 ops
// of the online softmax.  The tensor cores do about 4096 bf16 FLOPs per SM
// clock and the SM about 16 exp2 per clock, so the exp2 costs as much as both
// products: the kernel reaches the tensor-core rate only if the softmax runs
// while the tensor cores are busy.  What this design does about it
// (flash_sm90.cuh has the common parts):
//   - the products are asynchronous `wgmma` (S = Q K^T with both operands in
//     shared memory, O += P V with P in registers), so a warpgroup issues a
//     product and goes on with its softmax;
//   - a producer warp loads K and V by TMA into a three-stage ring, so the
//     consumers spend no instruction and no __syncthreads on loads;
//   - two consumer warpgroups of 64 q rows each (K/V read from L2 once per
//     128 q rows) alternate through named barriers ("ping-pong"): in its
//     turn a warpgroup issues S_j = Q K_j^T and
//     O += P_{j-1} V_{j-1}, hands the turn over, and runs tile j's softmax
//     while the other warpgroup's products and its own P.V run;
//   - softmax_scale*log2(e) is one FMA on the fp32 score inside the exp2
//     (exp2(s*c - m)); q is not pre-scaled;
//   - the ragged kv tail (TMA reads zeros past T) is masked only in the last
//     tile;
//   - the kv tile is flash_fwd_pipelined.cu's, 64 rows, so the two forwards
//     do the same arithmetic in another order and give bit-identical
//     results (the PIPELINE_FWD switch changes no image).  128-row tiles
//     ran faster on an H100 but put the two forwards' 768^2 edits 3 LSB
//     apart (PERF.md).

#include "flash_sm90.cuh"

namespace {

using namespace sm90;

// Per consumer thread: S (32 regs), O (32) and P (16) of its warpgroup's
// 64 q rows.  The first tile and the last are peeled so that the steady
// loop has no branch while a product is in flight (ptxas serializes wgmma
// across such branches); only the last tile can be ragged.
struct PingPong {
  static constexpr int kBlockKV = 64;
  struct State {
    float s[kBlockKV / 2], o[32];
    uint32_t pk[kBlockKV / 16][4];
    RowState st;
  };

  // Tile j >= 1: S_j and P_{j-1} V_{j-1} in this warpgroup's turn, then
  // tile j's softmax while they (and the other warpgroup's turn) run.
  template <bool kLast>
  __device__ __forceinline__ static void step(const FwdParams& p,
                                              const Bars& bars, uint32_t q_tile,
                                              uint32_t k_ring, uint32_t v_ring,
                                              int wg, int j, State& x) {
    const int stage = j % kStages, prev = (j - 1) % kStages;
    mbar_wait(bars.k_full(stage), (j / kStages) & 1);
    mbar_wait(bars.v_full(prev), ((j - 1) / kStages) & 1);
    named_sync(1 + wg);
    issue_begin(x.s, x.o, x.pk);
    issue_qk(x.s, q_tile, k_ring + stage * kv_tile_bytes<kBlockKV>());
    issue_end(x.s);
    issue_pv(x.o, x.pk, v_ring + prev * kv_tile_bytes<kBlockKV>());
    issue_end(x.o, x.pk);
    // warpgroup 1's last hand-over would have no taker
    if (!(kLast && wg == 1)) named_arrive(2 - wg);
    wgmma_wait<1>();
    fence_regs(x.s);
    release(bars.k_empty(stage));
    if (kLast) mask_tail(x.s, j * kBlockKV, p.t_len);
    const float2 alpha = softmax_step(x.s, x.st, p.scale_log2);
    wgmma_wait<0>();
    fence_regs(x.o);
    fence_regs(x.pk);
    release(bars.v_empty(prev));
    rescale(x.o, alpha);
    pack_p(x.pk, x.s);
  }

  __device__ __forceinline__ static void run(const FwdParams& p,
                                             uint32_t smem, const Bars& bars,
                                             int wg, int n_tiles,
                                             float (&o)[32], RowState& st) {
    const uint32_t q_tile = smem + Smem<kBlockKV>::q + wg * kQTileBytes;
    const uint32_t k_ring = smem + Smem<kBlockKV>::k;
    const uint32_t v_ring = smem + Smem<kBlockKV>::v;
    // turns: warpgroup w waits on barrier 1 + w and hands over on 2 - w
    if (wg == 1) named_arrive(1);  // warpgroup 0 goes first
    State x;
#pragma unroll
    for (int i = 0; i < 32; ++i) x.o[i] = 0.f;
    x.st = {-INFINITY, -INFINITY, 0.f, 0.f};

    // ---- tile 0: S_0 alone
    mbar_wait(bars.q_full(), 0);
    mbar_wait(bars.k_full(0), 0);
    named_sync(1 + wg);
    issue_begin(x.s);
    issue_qk(x.s, q_tile, k_ring);
    issue_end(x.s);
    if (!(n_tiles == 1 && wg == 1)) named_arrive(2 - wg);
    wgmma_wait<0>();
    fence_regs(x.s);
    release(bars.k_empty(0));
    mask_tail(x.s, 0, p.t_len);
    softmax_step(x.s, x.st, p.scale_log2);  // O is still 0: no rescale
    pack_p(x.pk, x.s);

    for (int j = 1; j < n_tiles - 1; ++j)
      step<false>(p, bars, q_tile, k_ring, v_ring, wg, j, x);
    if (n_tiles > 1)
      step<true>(p, bars, q_tile, k_ring, v_ring, wg, n_tiles - 1, x);

    // ---- the last P V
    const int last = (n_tiles - 1) % kStages;
    mbar_wait(bars.v_full(last), ((n_tiles - 1) / kStages) & 1);
    issue_begin(x.o, x.pk);
    issue_pv(x.o, x.pk, v_ring + last * kv_tile_bytes<kBlockKV>());
    issue_end(x.o, x.pk);
    wgmma_wait<0>();
    fence_regs(x.o);
    fence_regs(x.pk);
    release(bars.v_empty(last));
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = x.o[i];
    st = x.st;
  }
};

}  // namespace

// Plain C entry point for ctypes (see sm90::launch_fwd for the arguments).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int b, int h, int s_len,
                              int t_len, const long long* strides,
                              float scale, void* stream) {
  return sm90::launch_fwd<PingPong>(q, k, v, o, lse, b, h, s_len, t_len,
                                    strides, scale, stream);
}
