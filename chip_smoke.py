"""Smoke run of the PyTorch port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):
  1. device: the card, torch/CUDA versions, Pillow and a TTF font;
  2. build: nvcc builds the port's CUDA kernels from diffute_tpu_torch/csrc,
     one compiler process per source, all at once;
  3. kernels: the flash-attention forward and the two backward kernels
     (dq, which also writes delta, and dk/dv) against their plain
     tile-by-tile versions (mutants of which must FAIL), in bf16 at the main
     paths' shapes plus a ragged one; kernel, plain version and one PyTorch
     library call (scaled_dot_product_attention, a yardstick the port never
     calls) timed, beside the card's bound for the same work, and the
     backward pair beside the function's bound; both also on strided
     (B, S, H, 64) views of a packed projection, the backward on a 4-D
     (B, H) = (4, 5) call too; what ptxas says of both; and
     FlashAttentionFn's backward against the backward wrapper (equal bits,
     gradients contiguous);
  3a. the deferred-softmax forward against its plain (tile by tile, base 2)
     version and against the standard forward on the same inputs, both
     timed at every shape of the 512^2, 768^2 and 1024^2 edits and the
     training step, and once on
     strided views through the PIPELINE_FWD dispatch; mutants of the
     plain version (LSE left in base 2, the last tile never consumed) must
     FAIL; what ptxas says of the kernel (registers, spills);
  3b. the UNet's opt-in kernels the same way: GroupNorm statistics and
     GroupNorm+SiLU (one launch), GN+SiLU+conv3x3 and the int8-weight
     matmul, each against its plain version, at every shape a flagged 512^2
     UNet pass launches (with its launches a pass; the tables must sum to
     44 statistics and conv, 45 GN+SiLU with use_fused_groupnorm alone, 160
     int8 and 32 once per edit) and a few more (library yardsticks:
     torch.batch_norm_stats for the statistics, F.silu(F.group_norm), that
     followed by F.conv2d, x @ q.to(bf16).T * s); mutants (a dropped cluster
     rank, rstd x 1.02, the output x 1.02 or 0.99, a dropped tap, zero
     padding applied before the affine, the scale left out) must FAIL the
     same criterion; all four give the same bits twice and the int8
     matmul's fused bias equals the two-step bit for bit; what ptxas says of
     the three sources (registers, spills, serialized wgmma);
  4. serving path: the full-width SD2-inpainting pipeline (bf16, flash on,
     random weights from a seed) runs two 50-step 512^2 single-region edits
     through DiffUTEPipeline.edit, counting kernel launches;
  5. checks: finite latents and a flash-vs-dense UNet forward at full size;
  5a. the other serving modes, flags off: a 768^2 edit with the
     deferred-softmax switch off and on (same seed: at most 2 LSB apart in
     the box; 500 flash launches, all pipelined with the switch on);
     edit_multi over three disjoint boxes; edit_batch at batch 1, 2, 4, 8
     (the batch-1 image equals edit()'s); edit_stream over 6 items at depth
     2 and 1 (each output equal to the sequential edit()); the web server on
     port 0 answering the index page, a click pair and one 20-step
     /api/edit over HTTP; edit_profiled's stage times and FLOPs;
  5b. one full-width UNet forward with each opt-in kernel alone and all
     three against the unfused float UNet, same weights and inputs; the
     shapes the flagged forward calls the conv and the int8 matmul with
     equal phase 3b's tables;
  5c. the flagged serving path: all four flags on, two 50-step DDIM edits
     (2,200 conv and statistics, 50 GN+SiLU, 8,032 int8-matmul and 500
     flash launches each, asserted), one 20-step DPM-Solver++ edit with
     guidance 3, the blend and encoder reuse 2, and one 20-step DDPM edit;
  5d. the flagged UNet forward on two CUDA streams at once, each result
     bit-identical to the run alone; then a 1024^2 edit with the switch off
     and on (750 flash launches) and one with the three flags on;
  6. training path: train.run_unet.main takes three optimizer steps at full
     width (batch 4, 512^2, bf16, flash, gradient checkpointing, AdamW,
     synthetic scenes), counting the launches of all three flash kernels;
  7. checks: parameter count, parameters changed by a step, and the loss
     gradient of four UNet weights with flash on vs off at full width.
Then one JSON line of kernel results, and last the device JSON line.
Exits non-zero, with no result, when no CUDA device is available.

    python3 chip_smoke.py --edits-only 6 [--package-root DIR]

times phase 4's edits alone (same pipeline, scene and box) and prints their
seconds and peak memory as one JSON line; with --package-root the port is
imported from another checkout, so two commits can be timed in turns on one
card.  --res 768|1024 edits at that resolution, --batch B times N calls of
edit_batch over B images, --stream DEPTH one edit_stream over the N items
(the seconds are then each image's arrival time).

    python3 chip_smoke.py --flag-timing 8

times edits with the UNet's flags off, fused conv, int8 and all on: four
pipelines over one set of weights in one process, taking turns.

    python3 chip_smoke.py --kernels-only [--package-root DIR]

builds the kernels and runs phase 3's kernel rows (forward and backward),
3a and 3b alone; with --package-root another checkout's kernels, so two
commits' kernels can be timed in turns on one card.

    python3 chip_smoke.py --fused-only [--package-root DIR]

builds the kernels and runs phase 3b alone (about a minute).

    python3 chip_smoke.py --fused-host 20 [--package-root DIR]

times the host's side of one fused-conv half (ResnetBlock2D) and one biased
int8 layer (QuantLinear) at the most launched shapes of a flagged pass, and
of one GroupNorm statistics call and one GN+SiLU call at (1, 320, 64^2).

    python3 chip_smoke.py --flash-host 20 [--package-root DIR]

times the host's side of the serving path's attention call (no-grad
dot_product_attention on (1, S, H, 64) projections, then the caller's
reshape to (1, S, H*64)) at a 512^2 edit's two flash shapes: 20 rounds of
100 calls, the host's seconds to queue them and the seconds until the card
is done, per call.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import importlib
import inspect
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

STEPS = 50
RES = 512
# full-size UNet forward with flash vs dense attention, both bf16: relative
# max error over max |eps| (a wrong kernel gives O(1))
TOL_UNET_REL = 5e-2
# backward kernels vs flash_bwd_tiled_reference (their own arithmetic: p and
# ds rounded to bf16 before the products that take them) on the same bf16
# inputs.  dq, dk, dv are fp32 results rounded once to bf16 on both sides
# (half an ulp of x is at most |x| * 2^-8), so the max abs bound follows the
# size of the gradients at each shape: BWD_HALF_ULPS half-ulps of max |ref|
# (0.26 to 0.82 read on an H100, every shape, strided views included), and
# the relative L2 error of each of dq, dk, dv within TOL_BWD_REL_L2 (9.6e-5
# to 2.0e-4 read).  The mutants must fail it: a gradient scaled by 0.99 reads
# 1.0e-2, dk with delta taken as 0 2.7e-2, dq with its last kv tile dropped
# 0.127 (at (20, 4096, 4096)).  The one-pass fp32 version, which rounds
# neither p nor ds, is about 2.5e-3 away from kernels that round as these do:
# too far to catch a 1% scale error.  delta is an fp32 sum of 64 products on
# both sides: TOL_DELTA absolute (2.4e-7 read).
BWD_HALF_ULPS, TOL_BWD_REL_L2, TOL_DELTA = 3, 1e-3, 1e-5
# full-size loss and loss gradient of single weights, flash on vs off, both
# bf16 with the same draws: relative L2 error of each gradient (a wrong
# backward kernel gives O(1); bf16 rounding gave 5e-3 at worst) and relative
# difference of the loss (2e-4 measured)
TOL_GRAD_REL, TOL_LOSS_REL = 3e-2, 1e-2
TRAIN_BATCH, TRAIN_STEPS = 4, 3
# GroupNorm+SiLU, GN+SiLU+conv3x3 and the int8 matmul against their plain
# fp32 versions on the same bf16 inputs.  Each output is an fp32 result
# rounded once to bf16 (half an ulp of y is at most |y| * 2^-8); the conv's
# normalised operand is rounded to bf16 on both sides and may differ by one
# ulp in a few elements (__expf against torch's sigmoid), and sums run in
# another order.  Max abs error within FUSED_HALF_ULPS half-ulps of max |ref|
# (1 to 2 measured: one bf16 ulp at the largest value is 2) and relative L2
# error within TOL_FUSED_REL_L2 (2.4e-4 at worst measured: both sides round
# the same fp32 value and mostly agree to the bit; a dropped tap gives 0.3,
# zero padding applied before the affine 0.1, a scale left out O(1)).
FUSED_HALF_ULPS, TOL_FUSED_REL_L2 = 3, 2e-3
# full-size UNet forward, bf16, same weights and inputs: fused GroupNorm or
# fused conv against the unfused UNet, relative max error over max |eps|
# (flash against dense gave 1.56e-2); int8 weights against float weights by
# the mean relative error and cosine of tests/test_quant.py
TOL_UNET_FUSED_REL, TOL_INT8_MEAN_REL, TOL_INT8_COS = 5e-2, 5e-2, 0.999
# every GN+SiLU+conv3x3 of a flagged 512^2 UNet pass at batch 1 (SD2:
# layers_per_block 2, channels 320/640/1280/1280): (H = W, Cin, Cout,
# launches a pass), 44 in all
CONV_SHAPES = [(64, 320, 320, 7), (64, 640, 320, 2), (64, 960, 320, 1),
               (32, 320, 640, 1), (32, 640, 640, 6), (32, 960, 640, 1),
               (32, 1280, 640, 1), (32, 1920, 640, 1),
               (16, 640, 1280, 1), (16, 1280, 1280, 6), (16, 1920, 1280, 1),
               (16, 2560, 1280, 2),
               (8, 1280, 1280, 11), (8, 2560, 1280, 3)]
# every int8 matmul of that pass, ((M, K, N), launches a pass), 160 in all:
# per transformer C -> C eight times (proj_in, q, k, v, out of
# self-attention, q, out of cross-attention, proj_out), GEGLU C -> 8C, FF
# 4C -> C; 5 transformers at 64^2, 32^2 and 16^2, 1 at 8^2
W8_SHAPES = [((4096, 320, 320), 40), ((4096, 320, 2560), 5),
             ((4096, 1280, 320), 5),
             ((1024, 640, 640), 40), ((1024, 640, 5120), 5),
             ((1024, 2560, 640), 5),
             ((256, 1280, 1280), 40), ((256, 1280, 10240), 5),
             ((256, 5120, 1280), 5),
             ((64, 1280, 1280), 8), ((64, 1280, 10240), 1),
             ((64, 5120, 1280), 1)]
# once per edit and context: the hoisted cross-attention K/V of the 577
# glyph tokens, 32 in all
W8_EDIT_SHAPES = [((577, 1024, 320), 10), ((577, 1024, 640), 10),
                  ((577, 1024, 1280), 12)]
# every GroupNorm of that pass: (C, H = W, statistics launches a flagged
# pass (one per fused conv), GN+SiLU launches a pass with use_fused_groupnorm
# alone (the conv's input norms and conv_norm_out's)), 44 and 45 in all
GN_SHAPES = [(cin, hw, n, n + ((cin, hw) == (320, 64)))
             for hw, cin, _, n in CONV_SHAPES]
assert sum(c[-1] for c in CONV_SHAPES) == 44
assert sum(s[2] for s in GN_SHAPES) == 44 and sum(s[3] for s in GN_SHAPES) == 45
assert sum(c for _, c in W8_SHAPES) == 160
assert sum(c for _, c in W8_EDIT_SHAPES) == 32
# the card's published peaks, for the bounds
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def time_ms(fn, iters: int = 25) -> float:
    """Median device time of ``fn`` over ``iters`` launches (CUDA events).
    A GPU-side sleep before each start event keeps the queue ahead of the
    host, so the events bracket device work and not the host's launch."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        torch.cuda._sleep(1_000_000)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: operations over the bf16 peak or
    bytes (inputs read once, outputs written once) over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_ops_ms": t_ops, "bound_bytes_ms": t_bytes}


def bwd_errors(got: torch.Tensor, ref: torch.Tensor,
               half_ulps: int = BWD_HALF_ULPS) -> dict:
    """Max abs and relative L2 error of a kernel's bf16 output against its
    plain version, and the max abs bound that ``ref``'s size gives."""
    diff, ref = got.float() - ref.float(), ref.float()
    return {"max_abs_err": diff.abs().max().item(),
            "rel_l2_err": (diff.norm() / ref.norm()).item(),
            "max_abs_tol": half_ulps * ref.abs().max().item() * 2.0 ** -8}


def fused_ok(err: dict) -> bool:
    return (err["max_abs_err"] <= err["max_abs_tol"]
            and err["rel_l2_err"] <= TOL_FUSED_REL_L2)


def check_fused_kernels(dev) -> dict:
    """Phase 3b: the GroupNorm+SiLU, GN+SiLU+conv3x3 and int8-matmul kernels
    against their plain versions on the card, in bf16, at the flagged UNet's
    shapes (the conv and the int8 matmul at every shape of a 512^2 pass,
    each beside its launches a pass), each timed beside its bound, its plain
    version and one library call; mutants of each must fail the same
    criterion; the conv and the int8 matmul give the same bits twice, and
    the int8 matmul's fused bias equals the two-step bit for bit.  Returns
    {kernel name: [result per shape]}."""
    import torch.nn.functional as F

    from diffute_tpu_torch.ops.conv_fused import (gn_silu_conv3x3,
                                                  gn_silu_conv3x3_reference,
                                                  pack_conv3x3_weight)
    from diffute_tpu_torch.ops import groupnorm as gn_mod
    from diffute_tpu_torch.ops.groupnorm import (group_norm_silu,
                                                 group_norm_silu_reference,
                                                 group_norm_stats,
                                                 group_norm_stats_reference)
    from diffute_tpu_torch.ops import _build
    from diffute_tpu_torch.ops.quant import (quant_matmul,
                                             quant_matmul_reference,
                                             quantize_per_channel)

    # registers, spills, and any line where ptxas made wgmma synchronous
    for source in ("groupnorm.cu", "conv_fused.cu", "quant.cu"):
        info = _build.ptxas_info(source)
        phase("ptxas", source=source, info=info,
              serialized=[line for line in info.splitlines()
                          if "serialized" in line])
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, dtype=bf16, mean=0.0, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std
                + mean).to(dtype)

    def must_fail(name, mutant, ref):
        err = bwd_errors(mutant, ref, FUSED_HALF_ULPS)
        if fused_ok(err):
            raise RuntimeError(f"{name}: the criterion passes a mutated "
                               f"result: {err}")
        return err["rel_l2_err"]

    results = {"gn_silu": [], "gn_stats": [], "conv": [], "w8": []}

    # ---- GroupNorm statistics and GroupNorm+SiLU at every shape of a
    # flagged 512^2 pass (GN_SHAPES, batch 1), then batch 2, the 768^2 and
    # 1024^2 edits' top levels, an input with |mean| >> std (where E[x^2] -
    # mean^2 cancels in fp32) and the VAE decoder's 128 x 512^2, whose groups
    # exceed a cluster's shared memory.  An older package (--package-root)
    # without gn_plan and the tiled reference is timed and held, with no
    # mutant of its merge.
    gn_plan = getattr(gn_mod, "gn_plan", None)
    tiled = getattr(gn_mod, "group_norm_stats_tiled_reference", None)
    from_stats = getattr(gn_mod, "group_norm_silu_from_stats", None)

    def stats_ok(m, r, rm, rr, mean):
        # fp32: the mean to 1e-5 of its size, rstd to 1e-4 relative
        return ((m - rm).abs().max().item() <= 1e-5 * max(1.0, abs(mean))
                and ((r - rr).abs() / rr).max().item() <= 1e-4)

    for shape, mean, n_stats, n_gn in (
            [((1, c, hw, hw), 0.0, ns, ng) for c, hw, ns, ng in GN_SHAPES]
            + [((2, 640, 32, 32), 0.0, None, None),
               ((1, 320, 96, 96), 0.0, None, None),
               ((1, 320, 128, 128), 0.0, None, None),
               ((1, 960, 128, 128), 0.0, None, None),
               ((1, 320, 64, 64), 100.0, None, None),
               ((1, 128, 512, 512), 0.0, None, None)]):
        b, c, h, w = shape
        x = randn(*shape, mean=mean)
        gamma, beta = randn(c, mean=1.0, std=0.3), randn(c, std=0.5)
        y = group_norm_silu(x, gamma, beta, 32, 1e-5)
        y2 = group_norm_silu(x, gamma, beta, 32, 1e-5)
        m, r = group_norm_stats(x, 32, 1e-5)
        m2, r2 = group_norm_stats(x, 32, 1e-5)
        torch.cuda.synchronize()
        ref = group_norm_silu_reference(x, gamma, beta, 32, 1e-5)
        rm, rr = group_norm_stats_reference(x, 32, 1e-5)
        err = bwd_errors(y, ref, FUSED_HALF_ULPS)
        stats_err = {"mean_max_abs_err": (m - rm).abs().max().item(),
                     "rstd_max_rel_err": ((r - rr).abs() / rr).max().item()}
        plan = ({k: v for k, v in gn_plan(b, c, h, w, 32).items()
                 if k in ("cluster", "threads", "silu_threads", "one_read")}
                if gn_plan else None)
        nbytes = x.numel() * 2
        res = dict(shape=list(shape), input_mean=mean,
                   launches_per_pass=n_gn, plan=plan, **err,
                   deterministic=torch.equal(y, y2),
                   ms=time_ms(lambda: group_norm_silu(x, gamma, beta, 32, 1e-5)),
                   plain_ms=time_ms(lambda: group_norm_silu_reference(
                       x, gamma, beta, 32, 1e-5)),
                   library_ms=time_ms(lambda: F.silu(F.group_norm(
                       x, 32, gamma, beta, 1e-5))),
                   **bound(10 * x.numel(), 2 * nbytes + 4 * c))
        # the library's statistics: one batch_norm_stats call over the
        # (1, B*G, n) view, fp32 (mean, 1/sqrt(var + eps)) per (sample, group)
        library = torch.batch_norm_stats(x.view(1, b * 32, -1), 1e-5)
        sres = dict(shape=list(shape), input_mean=mean,
                    launches_per_pass=n_stats, plan=plan,
                    max_abs_err=stats_err["mean_max_abs_err"], **stats_err,
                    deterministic=torch.equal(m, m2) and torch.equal(r, r2),
                    ms=time_ms(lambda: group_norm_stats(x, 32, 1e-5)),
                    plain_ms=time_ms(lambda: group_norm_stats_reference(
                        x, 32, 1e-5)),
                    library_ms=time_ms(lambda: torch.batch_norm_stats(
                        x.view(1, b * 32, -1), 1e-5)),
                    library_same_function=stats_ok(
                        library[0].view(b, 32), library[1].view(b, 32), rm,
                        rr, mean),
                    **bound(3 * x.numel(), nbytes + 8 * b * 32))
        # mutants of the statistics: rstd x 1.02, and where a group is a
        # cluster, the last rank's piece left out of the fold
        sres["mutants_pass"] = {"rstd_x1.02": stats_ok(m, r * 1.02, rm, rr,
                                                       mean)}
        if tiled is not None and plan["cluster"] > 1:
            dm, dr = tiled(x, 32, 1e-5, ranks=range(plan["cluster"] - 1))
            sres["mutants_pass"]["dropped_rank"] = stats_ok(dm, dr, rm, rr,
                                                            mean)
            if shape == (2, 640, 32, 32):
                # and of GN+SiLU, from those statistics, where a dropped rank
                # is a quarter of each group
                res["mutant_rel_l2"] = {
                    "dropped_rank": must_fail(
                        "GN+SiLU (a dropped cluster rank)",
                        from_stats(x, gamma, beta, dm, dr), ref),
                    "rstd_x1.02": must_fail(
                        "GN+SiLU (rstd x 1.02)",
                        from_stats(x, gamma, beta, rm, rr * 1.02), ref)}
        if mean == 100.0:
            res["mutant_rel_l2"] = {"output_x1.02": must_fail(
                "GroupNorm+SiLU (output x 1.02)", ref.float() * 1.02, ref)}
        phase("kernel_gn_silu", **res)
        phase("kernel_gn_stats", **sres)
        if any(sres["mutants_pass"].values()):
            raise RuntimeError(f"the statistics criterion passes a mutant at "
                               f"{shape}: {sres['mutants_pass']}")
        if not (fused_ok(err) and res["deterministic"]
                and stats_ok(m, r, rm, rr, mean) and sres["deterministic"]):
            raise RuntimeError(f"GroupNorm+SiLU disagrees at {shape}: {res} "
                               f"{stats_err}")
        results["gn_silu"].append(res)
        results["gn_stats"].append(sres)
    mutated = [r["shape"] for r in results["gn_silu"] if "mutant_rel_l2" in r]
    if mutated != ([[2, 640, 32, 32]] if tiled else []) + [[1, 320, 64, 64]]:
        raise RuntimeError(f"GN+SiLU mutants checked at {mutated}")

    # ---- GN+SiLU+conv3x3 at every shape of a flagged 512^2 UNet pass
    # (CONV_SHAPES, batch 1), then the 768^2 and 1024^2 edits' top levels and
    # one at batch 2
    for b, cin, cout, hw, per_pass in (
            [(1, cin, cout, hw, n) for hw, cin, cout, n in CONV_SHAPES]
            + [(2, 640, 640, 32, None), (1, 320, 320, 96, None),
               (1, 320, 320, 128, None), (1, 960, 320, 128, None)]):
        x = randn(b, cin, hw, hw)
        gamma, beta = randn(cin, mean=1.0, std=0.3), randn(cin, std=0.5)
        w = randn(cout, cin, 3, 3, std=(9 * cin) ** -0.5)
        bias = randn(cout, std=0.1)
        packed = pack_conv3x3_weight(w)

        def run():
            return gn_silu_conv3x3(x, gamma, beta, w, bias, 32, 1e-5,
                                   packed=packed)

        def library():
            return F.conv2d(F.silu(F.group_norm(x, 32, gamma, beta, 1e-5)),
                            w, bias, padding=1)

        y = run()
        again = run()
        torch.cuda.synchronize()
        ref = gn_silu_conv3x3_reference(x, gamma, beta, w, bias, 32, 1e-5)
        err = bwd_errors(y, ref, FUSED_HALF_ULPS)
        nbytes = 2 * (x.numel() + w.numel() + y.numel()) + 2 * (2 * cin + cout)
        res = dict(shape=[b, cin, cout, hw, hw], launches_per_pass=per_pass,
                   **err, deterministic=torch.equal(y, again), ms=time_ms(run),
                   plain_ms=time_ms(lambda: gn_silu_conv3x3_reference(
                       x, gamma, beta, w, bias, 32, 1e-5)),
                   library_ms=time_ms(library),
                   **bound(2 * b * hw * hw * cout * 9 * cin, nbytes))
        phase("kernel_conv", **res)
        if not (fused_ok(err) and res["deterministic"]):
            raise RuntimeError(f"GN+SiLU+conv3x3 disagrees at {res}")
        results["conv"].append(res)
        if (b, cin, cout, hw) == (1, 320, 320, 64):
            # mutations: the kernel's output scaled by 0.99; in plain torch a
            # dropped tap, and zero padding applied to x before the affine
            # (the border then sees silu(d_c), not 0)
            w_cut = w.clone()
            w_cut[:, :, 0, 0] = 0
            dropped = gn_silu_conv3x3_reference(x, gamma, beta, w_cut, bias,
                                                32, 1e-5)
            mean, rstd = group_norm_stats_reference(x, 32, 1e-5)
            a = gamma.float() * rstd.repeat_interleave(cin // 32, 1)[0]
            d = beta.float() - mean.repeat_interleave(cin // 32, 1)[0] * a
            xp = F.pad(x.float(), (1, 1, 1, 1))
            hp = F.silu(xp * a[None, :, None, None] + d[None, :, None, None])
            padded = F.conv2d(hp.to(bf16).float(), w.float(), bias.float())
            res["mutant_rel_l2"] = {
                "scaled_0.99": must_fail("conv (output x 0.99)",
                                         y.float() * 0.99, ref),
                "dropped_tap": must_fail("conv (dropped tap)", dropped, ref),
                "pad_before_affine": must_fail("conv (padding before the "
                                               "affine)", padded, ref)}
            phase("kernel_conv_mutants", **res["mutant_rel_l2"])

    # ---- int8-weight matmul at every shape of a flagged 512^2 UNet pass
    # (W8_SHAPES) and of the once-per-edit cross-attention K/V
    # (W8_EDIT_SHAPES), then a 1024^2 edit's widest.  A package without the
    # fused bias (an older checkout under --package-root) is timed and held
    # without it.
    fused_bias = "packed" in inspect.signature(quant_matmul).parameters
    for m, k, n, per_pass in ([s + (c,) for s, c in W8_SHAPES]
                              + [s + (None,) for s, _ in W8_EDIT_SHAPES]
                              + [(16384, 320, 2560, None)]):
        x = randn(m, k)
        q, scale = quantize_per_channel(randn(n, k, dtype=torch.float32,
                                              std=k ** -0.5))
        scale = scale.to(bf16)  # a bf16 model's scale
        bias = randn(n, std=0.1)
        if fused_bias:
            from diffute_tpu_torch.ops.quant import pack_w8_weight

            packed = pack_w8_weight(q)

            def run(bias=None):
                return quant_matmul(x, q, scale, bias, packed=packed)
        else:
            def run(bias=None):
                y = quant_matmul(x, q, scale)
                return y if bias is None else y + bias

        y = run()
        again = run()
        with_bias = run(bias)
        torch.cuda.synchronize()
        ref = quant_matmul_reference(x, q, scale)
        err = bwd_errors(y, ref, FUSED_HALF_ULPS)
        res = dict(shape=[m, k, n], launches_per_pass=per_pass, **err,
                   deterministic=torch.equal(y, again),
                   # the fused bias against the two-step, bit for bit
                   bias_equals_two_step=torch.equal(with_bias, y + bias),
                   ms=time_ms(run), ms_with_bias=time_ms(lambda: run(bias)),
                   plain_ms=time_ms(lambda: quant_matmul_reference(x, q, scale)),
                   library_ms=time_ms(lambda: (x @ q.to(bf16).t()) * scale),
                   **bound(2 * m * n * k, 2 * m * k + n * k + 2 * m * n + 2 * n))
        phase("kernel_w8", fused_bias=fused_bias, **res)
        if not (fused_ok(err) and res["deterministic"]
                and res["bias_equals_two_step"]):
            raise RuntimeError(f"int8 matmul disagrees at {res}")
        results["w8"].append(res)
        if (m, k, n) == (4096, 320, 320):
            unscaled = (x.float() @ q.float().t()).to(bf16)
            res["mutant_rel_l2"] = {
                "scaled_0.99": must_fail("int8 matmul (output x 0.99)",
                                         y.float() * 0.99, ref),
                "scale_left_out": must_fail("int8 matmul (scale left out)",
                                            unscaled, ref)}
            phase("kernel_w8_mutants", **res["mutant_rel_l2"])
    return results


# both forwards against their tile-by-tile plain version
# (flash_fwd_tiled_reference) and against each other, bf16 inputs from a
# unit normal: o is an fp32 result rounded once to bf16 and p is rounded to
# bf16 against the same running max on every side, so max abs error within
# FUSED_HALF_ULPS half-ulps of max |ref| and relative L2 within
# TOL_FUSED_REL_L2 (1.4e-4 to 3.6e-4 read; o scaled by 0.99 gives 1e-2, and
# against the one-pass fp32 version, which rounds no p, the kernels read
# 2.4e-3); the LSE stays fp32 (1.9e-6 read): a base-2 LSE is off by
# ln(T) * 0.44 (over 3 at 4096 keys), a skipped tile by about 1/n_tiles
TOL_FWD_LSE = 1e-4
# (BH, S, T): the flash self-attentions of a 512^2 edit (5 x 4096, 10 x
# 1024), a 768^2 edit (5 x 9216, 10 x 2304), a 1024^2 edit (5 x 16384,
# 10 x 4096, 20 x 1024) and the training step at batch 4 (20 x 4096,
# 40 x 1024): every shape at which PIPELINE_FWD routes a main path's call
PIPELINED_SHAPES = [(5, 4096, 4096), (10, 1024, 1024), (10, 2304, 2304),
                    (5, 9216, 9216), (5, 16384, 16384), (10, 4096, 4096),
                    (20, 1024, 1024), (20, 4096, 4096), (40, 1024, 1024)]


def sdpa(q, k, v):
    """The library's call for the flash forward's function (a yardstick)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                          scale=0.125)[0]


# (BH, S, T): PIPELINED_SHAPES and a ragged one
FORWARD_SHAPES = [(5, 4096, 4096), (10, 1024, 1024), (4, 1000, 577),
                  (20, 4096, 4096), (40, 1024, 1024), (5, 9216, 9216),
                  (10, 2304, 2304), (5, 16384, 16384), (10, 4096, 4096),
                  (20, 1024, 1024)]


def strided_qkv(g, dev, b=2, s=4096, h=5, n=3):
    """q, k, v (and with n = 4 a dO) as (B, S, H, 64) views of one packed
    (B, S, n * H * 64) projection, the serving layout at its least
    contiguous."""
    x = torch.randn((b, s, n * h * 64), generator=g, device=dev,
                    dtype=torch.bfloat16).view(b, s, n, h, 64)
    return tuple(x[:, :, i] for i in range(n))


def fwd_ok(err: dict, lse_err: float) -> bool:
    return fused_ok(err) and lse_err <= TOL_FWD_LSE


def check_forward(dev) -> list:
    """Phase kernel_fwd: the standard forward against its plain tile-by-tile
    version at FORWARD_SHAPES, timed beside the plain one-pass version (what
    the wrapper computes for CPU tensors), SDPA and the bound; mutants (o
    scaled by 0.99, the last kv tile dropped) must fail the criterion; then
    (a port that reads strides) once on strided (B, S, H, 64) views, against
    the plain version of their contiguous 3-D copies.  An older checkout
    (--package-root) without the tiled plain version is held to nothing
    here: its errors against the one-pass version are printed, its times
    are what is compared."""
    from diffute_tpu_torch.ops import _build

    # the module (diffute_tpu_torch.ops exports a function of its name)
    fa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")
    tiled = getattr(fa, "flash_fwd_tiled_reference", None)
    plain = tiled or fa.flash_attention_reference
    phase("ptxas", source="flash_fwd.cu",
          info=_build.ptxas_info("flash_fwd.cu"))
    g = torch.Generator(device=dev).manual_seed(0)
    results = []
    for bh, s, t in FORWARD_SHAPES:
        q, k, v = (torch.randn((bh, n, 64), generator=g, device=dev,
                               dtype=torch.bfloat16) for n in (s, t, t))
        o, lse = fa.flash_fwd_3d(q, k, v, 0.125)
        torch.cuda.synchronize()
        ro, rlse = plain(q, k, v, 0.125)
        lse_err = (lse - rlse).abs().max().item()
        res = dict(shape=[bh, s, t, 64], **bwd_errors(o, ro, FUSED_HALF_ULPS),
                   max_abs_err_lse=lse_err, held=tiled is not None,
                   ms=time_ms(lambda: fa.flash_fwd_3d(q, k, v, 0.125)),
                   plain_ms=time_ms(
                       lambda: fa.flash_attention_reference(q, k, v, 0.125),
                       iters=25 if s < 9216 else 5),
                   library_ms=time_ms(lambda: sdpa(q, k, v)),
                   **bound(4 * s * t * 64 * bh,
                           2 * 64 * bh * (2 * s + 2 * t) + 4 * bh * s))
        if tiled is not None and not results:
            cut = k.shape[1] - 64
            mo, mlse = tiled(q, k[:, :cut], v[:, :cut], 0.125)
            scaled = bwd_errors(ro.float() * 0.99, ro, FUSED_HALF_ULPS)
            dropped = bwd_errors(mo, ro, FUSED_HALF_ULPS)
            m_lse = (mlse - rlse).abs().max().item()
            if fused_ok(scaled) or fwd_ok(dropped, m_lse):
                raise RuntimeError(f"the criterion passes a mutant: o * 0.99 "
                                   f"{scaled}, last kv tile dropped {dropped}")
            res["mutants"] = {"o_scaled_0.99_rel_l2": scaled["rel_l2_err"],
                              "last_tile_dropped_rel_l2": dropped["rel_l2_err"],
                              "last_tile_dropped_lse_abs": m_lse}
        del ro, rlse
        phase("kernel_fwd", **res)
        if tiled is not None and not fwd_ok(res, lse_err):
            raise RuntimeError(f"flash forward disagrees at {res}")
        results.append(res)
    if hasattr(fa, "flash_fwd"):
        q4, k4, v4 = strided_qkv(g, dev)
        o4, lse = fa.flash_fwd(q4, k4, v4, 0.125)
        torch.cuda.synchronize()
        ro, rlse = plain(*(fa._to3d(x) for x in (q4, k4, v4)), 0.125)
        res = dict(shape=list(q4.shape), strides=list(q4.stride()),
                   **bwd_errors(fa._to3d(o4), ro, FUSED_HALF_ULPS),
                   max_abs_err_lse=(lse - rlse).abs().max().item(),
                   out_contiguous=o4.is_contiguous(),
                   ms=time_ms(lambda: fa.flash_fwd(q4, k4, v4, 0.125)))
        phase("kernel_fwd_strided", **res)
        if not (fwd_ok(res, res["max_abs_err_lse"]) and res["out_contiguous"]):
            raise RuntimeError(f"flash forward on strided views disagrees: "
                               f"{res}")
        results.append(res)
    return results


def check_pipelined_forward(dev) -> list:
    """Phase kernel_fwd_pipelined: the deferred-softmax forward against its
    plain (tile by tile, base 2) version and against the standard forward on
    the same inputs; both kernels timed at the same shapes, beside the plain
    version, SDPA and the bound.  Mutants of the plain version (LSE left in
    base 2; the last tile never consumed) must fail the criterion."""
    from diffute_tpu_torch.ops import _build
    from diffute_tpu_torch.ops.flash_attention import (
        PIPELINED_BLOCK_KV, flash_fwd_3d, flash_fwd_3d_pipelined,
        flash_fwd_pipelined_reference)

    fa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")
    phase("ptxas", source="flash_fwd_pipelined.cu",
          info=_build.ptxas_info("flash_fwd_pipelined.cu"))
    g = torch.Generator(device=dev).manual_seed(2)

    results = []
    for bh, s, t in PIPELINED_SHAPES:
        q, k, v = (torch.randn((bh, n, 64), generator=g, device=dev,
                               dtype=torch.bfloat16) for n in (s, t, t))
        o, lse = flash_fwd_3d_pipelined(q, k, v, 0.125)
        so, slse = flash_fwd_3d(q, k, v, 0.125)
        torch.cuda.synchronize()
        ro, rlse = flash_fwd_pipelined_reference(q, k, v, 0.125,
                                                 PIPELINED_BLOCK_KV)
        err = bwd_errors(o, ro, FUSED_HALF_ULPS)
        lse_err = (lse - rlse).abs().max().item()
        vs_std = bwd_errors(o, so, FUSED_HALF_ULPS)
        vs_std_lse = (lse - slse).abs().max().item()
        res = dict(shape=[bh, s, t, 64], **err, max_abs_err_lse=lse_err,
                   vs_standard=dict(vs_std, max_abs_err_lse=vs_std_lse),
                   ms=time_ms(lambda: flash_fwd_3d_pipelined(q, k, v, 0.125)),
                   standard_ms=time_ms(lambda: flash_fwd_3d(q, k, v, 0.125)),
                   plain_ms=time_ms(lambda: flash_fwd_pipelined_reference(
                       q, k, v, 0.125, PIPELINED_BLOCK_KV), iters=5),
                   library_ms=time_ms(lambda: sdpa(q, k, v)),
                   **bound(4 * s * t * 64 * bh,
                           2 * 64 * bh * (2 * s + 2 * t) + 4 * bh * s))
        if not results:
            base2 = (rlse / 0.6931471805599453 - rlse).abs().max().item()
            cut = PIPELINED_BLOCK_KV
            mo, mlse = flash_fwd_pipelined_reference(
                q, k[:, :-cut], v[:, :-cut], 0.125, PIPELINED_BLOCK_KV)
            m_err = bwd_errors(mo, ro, FUSED_HALF_ULPS)
            m_lse = (mlse - rlse).abs().max().item()
            if base2 <= TOL_FWD_LSE or fwd_ok(m_err, m_lse):
                raise RuntimeError(f"the criterion passes a mutant: base-2 "
                                   f"LSE {base2}, dropped tile {m_err}")
            res["mutants"] = {"lse_base2_abs": base2,
                              "last_tile_dropped_rel_l2": m_err["rel_l2_err"],
                              "last_tile_dropped_lse_abs": m_lse}
        phase("kernel_fwd_pipelined", **res)
        if not (fwd_ok(err, lse_err) and fwd_ok(vs_std, vs_std_lse)):
            raise RuntimeError(f"the pipelined forward disagrees at {res}")
        results.append(res)
    if hasattr(fa, "flash_fwd"):  # through the dispatcher, on strided views
        q4, k4, v4 = strided_qkv(g, dev)
        was = fa.set_pipeline_fwd(True)
        try:
            o4, lse = fa.flash_fwd(q4, k4, v4, 0.125)
        finally:
            fa.set_pipeline_fwd(was)
        torch.cuda.synchronize()
        ro, rlse = flash_fwd_pipelined_reference(
            *(fa._to3d(x) for x in (q4, k4, v4)), 0.125, PIPELINED_BLOCK_KV)
        err = bwd_errors(fa._to3d(o4), ro, FUSED_HALF_ULPS)
        res = dict(shape=list(q4.shape), strides=list(q4.stride()), **err,
                   max_abs_err_lse=(lse - rlse).abs().max().item(),
                   out_contiguous=o4.is_contiguous())
        phase("kernel_fwd_pipelined_strided", **res)
        if not (fwd_ok(err, res["max_abs_err_lse"]) and res["out_contiguous"]):
            raise RuntimeError(f"the pipelined forward on strided views "
                               f"disagrees: {res}")
        results.append(res)
    return results


# (BH, S, T): the training step's two shapes at batch 4 and a ragged one
BACKWARD_SHAPES = [(20, 4096, 4096), (40, 1024, 1024), (4, 1000, 577)]


def bwd_ok(err: dict) -> bool:
    return (err["max_abs_err"] <= err["max_abs_tol"]
            and err["rel_l2_err"] <= TOL_BWD_REL_L2)


def sdpa_backward_ms(q, k, v, do) -> float:
    """The library's backward for the pair: one autograd.grad through
    SDPA's saved forward (the forward itself is outside the events)."""
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = sdpa(*leaves)
    return time_ms(lambda: torch.autograd.grad(out, leaves, do,
                                               retain_graph=True))


def check_backward(dev):
    """Phase kernel_bwd: the dq kernel (which also writes delta) and the
    dk/dv kernel against their plain tile-by-tile version
    (flash_bwd_tiled_reference) at BACKWARD_SHAPES, delta against its fp32
    sum; each kernel timed beside the plain one-pass version, the bound of
    its own products, and SDPA's whole backward; the pair (flash_bwd_3d, the
    autograd function's backward) timed beside the function's 5-product
    bound.  Mutants (each gradient x 0.99, dq with its last kv tile dropped,
    dk with delta taken as 0) must fail the criterion.  Then (a port whose
    backward reads strides) a 4-D (B, H) = (4, 5) call and one on strided
    views of a packed projection, against the tiled version of contiguous
    3-D copies.  An older checkout (--package-root) without the tiled plain
    version is held to nothing: its errors against the one-pass version are
    printed, its times are what is compared.  Returns the dq and the dk/dv
    results."""
    from diffute_tpu_torch.ops import _build

    fa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")
    tiled = getattr(fa, "flash_bwd_tiled_reference", None)
    plain = tiled or fa.flash_bwd_reference
    # the Hopper kernels: the dq kernel computes delta, the wrappers are 4-D
    hopper = hasattr(fa, "flash_bwd")
    phase("ptxas", source="flash_bwd.cu",
          info=_build.ptxas_info("flash_bwd.cu"))
    g = torch.Generator(device=dev).manual_seed(0)
    dq_results, dkv_results = [], []
    for bh, s, t in BACKWARD_SHAPES:
        q, k, v, do = (torch.randn((bh, n, 64), generator=g, device=dev,
                                   dtype=torch.bfloat16) for n in (s, t, t, s))
        o, lse = fa.flash_fwd_3d(q, k, v, 0.125)
        if hopper:
            def run_dq():
                return fa.flash_bwd_dq_3d(q, k, v, o, lse, do, 0.125)
            dq, delta = run_dq()
        else:
            delta = fa._delta(o, do)

            def run_dq():
                return fa.flash_bwd_dq_3d(q, k, v, do, lse, delta, 0.125)
            dq = run_dq()

        def run_dkv():
            return fa.flash_bwd_dkv_3d(q, k, v, do, lse, delta, 0.125)
        dk, dv = run_dkv()
        torch.cuda.synchronize()
        rq, rk, rv = plain(q, k, v, o, lse, do, 0.125)
        err = {n: bwd_errors(a, b)
               for n, a, b in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv))}
        delta_err = (delta - fa._delta(o, do)).abs().max().item()
        args = (q, k, v, do, lse, delta, 0.125)
        library_ms = sdpa_backward_ms(q, k, v, do)
        # bytes: q, k, v, o, dO in and lse (dq kernel), q, k, v, dO in and
        # lse, delta (dk/dv kernel); each output written once
        io, st = 2 * 64 * bh, 4 * bh
        common = dict(shape=[bh, s, t, 64], library_ms=library_ms,
                      library_call="autograd.grad through "
                      "scaled_dot_product_attention: dq, dk and dv together",
                      held=tiled is not None)
        res_dq = dict(common, **err["dq"], max_abs_err_delta=delta_err,
                      ms=time_ms(run_dq),
                      plain_ms=time_ms(lambda: fa.flash_bwd_dq_reference(*args)),
                      **bound(6 * s * t * 64 * bh,
                              io * (4 * s + 2 * t) + st * 2 * s))
        res_dkv = dict(common, max_abs_err=max(err["dk"]["max_abs_err"],
                                               err["dv"]["max_abs_err"]),
                       dk=err["dk"], dv=err["dv"], ms=time_ms(run_dkv),
                       plain_ms=time_ms(
                           lambda: fa.flash_bwd_dkv_reference(*args)),
                       **bound(8 * s * t * 64 * bh,
                               io * (2 * s + 4 * t) + st * 2 * s))
        pair = dict(shape=[bh, s, t, 64], library_ms=library_ms,
                    ms=time_ms(lambda: fa.flash_bwd_3d(q, k, v, o, lse, do,
                                                       0.125)),
                    dq_plus_dkv_ms=res_dq["ms"] + res_dkv["ms"],
                    **bound(10 * s * t * 64 * bh,
                            io * (4 * s + 4 * t) + st * s))
        if tiled is not None and not dq_results:
            scaled = {n: bwd_errors(r.float() * 0.99, r)
                      for n, r in (("dq", rq), ("dk", rk), ("dv", rv))}
            dropped = bwd_errors(
                tiled(q, k[:, :-64], v[:, :-64], o, lse, do, 0.125)[0], rq)
            no_delta = bwd_errors(
                tiled(q, k, v, torch.zeros_like(o), lse, do, 0.125)[1], rk)
            mutants = {**{f"{n}_scaled_0.99_rel_l2": e["rel_l2_err"]
                          for n, e in scaled.items()},
                       "dq_last_tile_dropped_rel_l2": dropped["rel_l2_err"],
                       "dk_delta_zero_rel_l2": no_delta["rel_l2_err"]}
            if any(bwd_ok(e) for e in (*scaled.values(), dropped, no_delta)):
                raise RuntimeError(f"the criterion passes a mutant: "
                                   f"{mutants}")
            res_dq["mutants"] = mutants
        del rq, rk, rv
        phase("kernel_bwd_dq", **res_dq)
        phase("kernel_bwd_dkv", **res_dkv)
        phase("kernel_bwd_pair", **pair)
        if tiled is not None and not (all(bwd_ok(e) for e in err.values())
                                      and delta_err <= TOL_DELTA):
            raise RuntimeError(f"flash backward disagrees at {(bh, s, t)}: "
                               f"{err}, delta {delta_err} (relative L2 "
                               f"tolerance {TOL_BWD_REL_L2}, delta "
                               f"{TOL_DELTA})")
        dq_results.append(res_dq)
        dkv_results.append(res_dkv)
    if hopper:
        # (B, H) = (4, 5): the training step's call as the autograd function
        # makes it; then q, k, v, dO as views of one packed projection
        for name, (q4, k4, v4, do4) in (
                ("4d", (torch.randn((4, 4096, 5, 64), generator=g,
                                    device=dev, dtype=torch.bfloat16)
                        for _ in range(4))),
                ("strided", strided_qkv(g, dev, n=4))):
            o4, lse = fa.flash_fwd(q4, k4, v4, 0.125)
            got = fa.flash_bwd(q4, k4, v4, o4, lse, do4, 0.125)
            torch.cuda.synchronize()
            ref = tiled(*(fa._to3d(x) for x in (q4, k4, v4, o4)), lse,
                        fa._to3d(do4), 0.125)
            err = {n: bwd_errors(fa._to3d(a), b)
                   for n, a, b in zip(("dq", "dk", "dv"), got, ref)}
            res = dict(shape=list(q4.shape), strides=list(q4.stride()), **err,
                       max_abs_err=max(e["max_abs_err"] for e in err.values()),
                       out_contiguous=all(x.is_contiguous() for x in got),
                       ms=time_ms(lambda: fa.flash_bwd(q4, k4, v4, o4, lse,
                                                       do4, 0.125)))
            phase(f"kernel_bwd_{name}", **res)
            if not (all(bwd_ok(e) for e in err.values())
                    and res["out_contiguous"]):
                raise RuntimeError(f"flash backward ({name}) disagrees: "
                                   f"{res}")
            dq_results.append(dict(res, max_abs_err=err["dq"]["max_abs_err"]))
            dkv_results.append(dict(res, max_abs_err=max(
                err["dk"]["max_abs_err"], err["dv"]["max_abs_err"])))
    return dq_results, dkv_results


def serving_pipeline(dev, params=None, **unet_flags):
    """Phase 4's pipeline: full width, bf16, flash on, weights from seed 0;
    ``unet_flags`` turn the UNet's opt-in kernels on, ``params`` shares one
    set of fp32 state_dicts between pipelines."""
    from diffute_tpu_torch.config import (DiffUTEConfig, EditConfig,
                                          TrOCRConfig, UNetConfig, VAEConfig)
    from diffute_tpu_torch.pipeline import DiffUTEPipeline
    from diffute_tpu_torch.utils import init_pipeline_params

    bf16 = torch.bfloat16
    cfg = DiffUTEConfig(
        vae=VAEConfig(dtype=bf16),
        unet=UNetConfig(dtype=bf16, use_flash_attention=True, **unet_flags),
        trocr=TrOCRConfig(dtype=bf16),
        edit=EditConfig(resolution=RES, num_inference_steps=STEPS))
    if params is None:
        params = init_pipeline_params(cfg, seed=0, device=dev)
    return cfg, DiffUTEPipeline(cfg, params, device=dev)


ALL_FLAGS = dict(use_fused_groupnorm=True, use_fused_conv=True,
                 use_int8_weights=True)


def counters() -> dict:
    """The launch counts of every kernel wrapper."""
    from diffute_tpu_torch.ops.conv_fused import gn_silu_conv3x3
    from diffute_tpu_torch.ops.flash_attention import flash_attention
    from diffute_tpu_torch.ops.groupnorm import (group_norm_silu,
                                                 group_norm_stats)
    from diffute_tpu_torch.ops.quant import quant_matmul

    return {"flash_fwd": flash_attention.launches,
            "flash_fwd_pipelined": flash_attention.pipelined_launches,
            "flash_bwd_dq": flash_attention.bwd_dq_launches,
            "flash_bwd_dkv": flash_attention.bwd_dkv_launches,
            "gn_stats": group_norm_stats.launches,
            "gn_silu": group_norm_silu.launches,
            "conv": gn_silu_conv3x3.launches,
            "w8": quant_matmul.launches}


@contextlib.contextmanager
def record_shapes(on: bool):
    """While ``on``, count the shapes the UNet's layers call the fused conv
    with ((H, Cin, Cout)) and the int8 matmul with ((M, K, N))."""
    import diffute_tpu_torch.models.layers as layers

    shapes = {"conv": collections.Counter(), "w8": collections.Counter()}
    if not on:
        yield shapes
        return

    def counted(fn, key, shape):
        def wrapper(*args, **kwargs):
            shapes[key][shape(*args)] += 1
            return fn(*args, **kwargs)
        return wrapper

    conv, w8 = layers.gn_silu_conv3x3, layers.quant_matmul
    layers.gn_silu_conv3x3 = counted(
        conv, "conv", lambda x, g, b, w, *a: (x.shape[2], x.shape[1], w.shape[0]))
    layers.quant_matmul = counted(
        w8, "w8", lambda x, q, *a: (x.numel() // q.shape[1], q.shape[1],
                                    q.shape[0]))
    try:
        yield shapes
    finally:
        layers.gn_silu_conv3x3, layers.quant_matmul = conv, w8


def reset_counters() -> None:
    from diffute_tpu_torch.ops.conv_fused import gn_silu_conv3x3
    from diffute_tpu_torch.ops.flash_attention import flash_attention
    from diffute_tpu_torch.ops.groupnorm import (group_norm_silu,
                                                 group_norm_stats)
    from diffute_tpu_torch.ops.quant import quant_matmul

    flash_attention.launches = flash_attention.pipelined_launches = 0
    flash_attention.bwd_dq_launches = flash_attention.bwd_dkv_launches = 0
    for fn in (group_norm_stats, group_norm_silu, gn_silu_conv3x3,
               quant_matmul):
        fn.launches = 0


def timed_edit(pipe, image, box, text, seed, edit_config=None, steps=None):
    """One edit with every counter set to 0 before it: its seconds, peak
    memory and launches; fails unless only the box's pixels changed."""
    resident = torch.cuda.memory_allocated(pipe.device)
    rec = measured(pipe.device, lambda: pipe.edit(
        image, box, text, seed=seed, edit_config=edit_config,
        num_inference_steps=steps)[0])
    changed = only_boxes_changed(rec.pop("out"), image, [box])
    return dict(text=text, memory_allocated_before=resident,
                changed_pixels=changed, **rec)


def expect_launches(rec: dict, **expected) -> None:
    got = {k: rec["launches"][k] for k in expected}
    if got != expected:
        raise RuntimeError(f"launches {got}, expected {expected}")


def flag_timing(rounds: int) -> None:
    """Seconds per 50-step edit with the UNet's flags off, fused conv, int8
    and all three on: four pipelines over one set of weights in one process,
    taking turns ``rounds`` times after one warm-up edit each."""
    from diffute_tpu_torch.config import DiffUTEConfig
    from diffute_tpu_torch.utils import init_pipeline_params

    dev = torch.device("cuda", 0)
    variants = {"off": {}, "fused_conv": dict(use_fused_conv=True),
                "int8": dict(use_int8_weights=True), "all": ALL_FLAGS}
    params = init_pipeline_params(DiffUTEConfig(), seed=0, device=dev)
    pipes = {name: serving_pipeline(dev, params, **flags)[1]
             for name, flags in variants.items()}
    del params
    image, box = scene()
    seconds = {name: [] for name in variants}
    # what an edit adds to the memory resident before it (four pipelines
    # are resident here), and the bytes of each pipeline's UNet
    peak = {}
    unet_bytes = {name: sum(t.numel() * t.element_size() for t in (
        *pipe.unet.parameters(), *pipe.unet.buffers()))
        for name, pipe in pipes.items()}
    for name, pipe in pipes.items():  # warm-up: the build, cuDNN's choices
        timed_edit(pipe, image, box, "warm", 0)
    for i in range(rounds):
        order = list(variants) if i % 2 == 0 else list(variants)[::-1]
        for name in order:
            rec = timed_edit(pipes[name], image, box, "BENCHMARK", i)
            seconds[name].append(rec["seconds"])
            peak[name] = (rec["max_memory_allocated"]
                          - rec["memory_allocated_before"])
    print(json.dumps({"gpu": gpu_line(), "rounds": rounds,
                      "edit_seconds": seconds,
                      "median": {k: statistics.median(v)
                                 for k, v in seconds.items()},
                      "min": {k: min(v) for k, v in seconds.items()},
                      "max": {k: max(v) for k, v in seconds.items()},
                      "edit_peak_over_resident_bytes": peak,
                      "unet_bytes": unet_bytes}), flush=True)


def scene(res: int = RES):
    """bench.py's scene and box at edit resolution ``res``."""
    h, w = int(res * 1.5), res * 2
    image = np.random.RandomState(0).randint(0, 255, (h, w, 3), np.uint8)
    return image, (w // 3, h // 3, w // 3 + res // 4, h // 3 + res // 12)


def set_pipeline_fwd(on: bool) -> None:
    from diffute_tpu_torch.ops.flash_attention import set_pipeline_fwd

    set_pipeline_fwd(on)


def only_boxes_changed(out, image, boxes) -> int:
    """Fail unless ``out`` differs from ``image`` inside every box and
    nowhere else; return the number of changed pixels."""
    if out.dtype != np.uint8 or out.shape != image.shape:
        raise RuntimeError(f"edit output {out.dtype} {out.shape}")
    changed = (out != image).any(-1)
    outside = np.ones(image.shape[:2], bool)
    for x1, y1, x2, y2 in boxes:
        outside[y1:y2, x1:x2] = False
        if not changed[y1:y2, x1:x2].any():
            raise RuntimeError(f"the edit changed no pixel of {(x1, y1, x2, y2)}")
    if changed[outside].any():
        raise RuntimeError("pixels outside the boxes changed")
    return int(changed.sum())


def measured(dev, fn) -> dict:
    """Run ``fn`` with every launch counter set to 0 before it: its result,
    seconds on the host clock (``fn`` ends in a copy to the host), launches
    and peak memory."""
    reset_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = fn()
    return dict(out=out, seconds=time.perf_counter() - t0,
                launches=counters(),
                max_memory_allocated=torch.cuda.max_memory_allocated(dev))


def record(rec: dict, **more) -> dict:
    """A measured run without its output, for printing."""
    return {**{k: v for k, v in rec.items() if k != "out"}, **more}


def check_resolution(pipe, res: int, flash_per_pass: int, fpipe=None) -> dict:
    """Phases edit_768 / edit_1024: after a 2-step warm-up, one 50-step edit
    with the deferred-softmax switch off and one with it on (same seed): the
    two images differ by at most 2 LSB in the box and not at all outside it,
    the switch moves every flash launch of the edit to the pipelined kernel,
    and (``fpipe``) one edit with the UNet's three flags on."""
    dev = pipe.device
    image, box = scene(res)
    ec = dataclasses.replace(pipe.config.edit, resolution=res)
    pipe.edit(image, box, "warm", seed=0, edit_config=ec, num_inference_steps=2)
    recs = {}
    for name, on in (("standard", False), ("pipelined", True)):
        set_pipeline_fwd(on)
        try:
            rec = measured(dev, lambda: pipe.edit(image, box, "BENCHMARK",
                                                  seed=1, edit_config=ec)[0])
        finally:
            set_pipeline_fwd(False)
        rec["changed_pixels"] = only_boxes_changed(rec["out"], image, [box])
        n = flash_per_pass * STEPS
        expect_launches(rec, flash_fwd=0 if on else n,
                        flash_fwd_pipelined=n if on else 0, conv=0, w8=0)
        recs[name] = rec
    diff = np.abs(recs["standard"]["out"].astype(np.int32)
                  - recs["pipelined"]["out"].astype(np.int32))
    if diff.max() > 2:
        raise RuntimeError(f"switch on vs off: {diff.max()} LSB apart")
    result = {name: record(rec) for name, rec in recs.items()}
    result["max_lsb_between"] = int(diff.max())
    if fpipe is not None:
        fpipe.edit(image, box, "warm", seed=0, edit_config=ec,
                   num_inference_steps=2)
        rec = measured(dev, lambda: fpipe.edit(image, box, "BENCHMARK", seed=1,
                                               edit_config=ec)[0])
        rec["changed_pixels"] = only_boxes_changed(rec["out"], image, [box])
        expect_launches(rec, conv=44 * STEPS, gn_silu=STEPS,
                        gn_stats=44 * STEPS, w8=160 * STEPS + 32,
                        flash_fwd=flash_per_pass * STEPS,
                        flash_fwd_pipelined=0)
        result["flags"] = record(rec)
    phase(f"edit_{res}", resolution=res, **result)
    return result


def check_modes(pipe) -> dict:
    """Phases edit_multi, edit_batch, edit_stream, web and edit_profiled on
    the flags-off pipeline at 512^2."""
    import base64
    import io
    import threading
    import urllib.request

    from PIL import Image

    from diffute_tpu_torch.serve import web

    dev = pipe.device
    image, box = scene()
    h, w = image.shape[:2]
    bw, bh = RES // 4, RES // 12
    out = {}

    # ---- edit_multi: three disjoint boxes of the scene in one pass
    boxes = [box, (w // 8, h // 8, w // 8 + bw, h // 8 + bh),
             (w // 2, 3 * h // 4, w // 2 + bw, 3 * h // 4 + bh)]
    rec = measured(dev, lambda: pipe.edit_multi(
        image, list(zip(boxes, ["ONE", "two", "3.00"])), seed=0))
    rec["changed_pixels"] = only_boxes_changed(rec["out"], image, boxes)
    expect_launches(rec, flash_fwd=10 * STEPS)  # one pass carries all three
    out["edit_multi"] = record(rec, regions=3)
    phase("edit_multi", **out["edit_multi"])

    # ---- edit_batch: B independent images in one pass; the batch-1 image
    # equals edit()'s.  A 2-step call first (cuDNN's choices at this batch)
    alone = pipe.edit(image, box, "BENCHMARK", seed=0)[0]
    rng = np.random.RandomState(1)
    images = [image] + [rng.randint(0, 255, image.shape, np.uint8)
                        for _ in range(7)]
    out["edit_batch"] = {}
    for b in (1, 2, 4, 8):
        items = [(img, box, "BENCHMARK") for img in images[:b]]
        pipe.edit_batch(items, seed=0, num_inference_steps=2)
        rec = measured(dev, lambda: pipe.edit_batch(items, seed=0))
        for img, res_img in zip(images, rec["out"]):
            only_boxes_changed(res_img, img, [box])
        expect_launches(rec, flash_fwd=10 * STEPS)
        if b == 1 and not np.array_equal(rec["out"][0], alone):
            raise RuntimeError("edit_batch of one differs from edit()")
        out["edit_batch"][b] = record(rec, batch=b,
                                      seconds_per_image=rec["seconds"] / b)
        phase("edit_batch", **out["edit_batch"][b])

    # ---- edit_stream: 6 items, each output equal to the sequential edit()
    items = [(images[i], box, f"item {i}") for i in range(6)]
    t0 = time.perf_counter()
    seq = [pipe.edit(*item, seed=0)[0] for item in items]
    out["edit_stream"] = {"sequential": {
        "seconds_per_image": (time.perf_counter() - t0) / len(items)}}
    for depth in (2, 1):
        rec = measured(dev, lambda: list(pipe.edit_stream(items, seed=0,
                                                          depth=depth)))
        same = [np.array_equal(a, b) for a, b in zip(rec["out"], seq)]
        expect_launches(rec, flash_fwd=10 * STEPS * len(items))
        out["edit_stream"][f"depth_{depth}"] = record(
            rec, depth=depth, equal_to_sequential=same,
            seconds_per_image=rec["seconds"] / len(items))
        if len(rec["out"]) != len(seq) or not all(same):
            raise RuntimeError(f"edit_stream depth {depth} differs from "
                               f"sequential edit(): {same}")
    phase("edit_stream", **out["edit_stream"])

    # ---- web: the demo server over HTTP, one edit at full width on the card
    server = web.make_server(web.DemoBackend(pipe), port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = "http://%s:%d" % server.server_address[:2]

        def post(path, payload):
            req = urllib.request.Request(
                url + path, data=json.dumps(payload).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                return json.loads(r.read())

        with urllib.request.urlopen(url + "/", timeout=60) as r:
            page = r.read().decode()
        if r.status != 200 or 'id="sampler"' not in page:
            raise RuntimeError("the index page is not the demo")
        first = post("/api/click", {"state": None, "xy": [box[2], box[1]],
                                    "hw": [h, w]})
        second = post("/api/click", {"state": first["state"],
                                     "xy": [box[0], box[3]], "hw": [h, w]})
        if first["ready"] or not second["ready"] \
                or tuple(second["box"]) != tuple(box):
            raise RuntimeError(f"two clicks gave {first} then {second}")
        buf = io.BytesIO()
        Image.fromarray(image).save(buf, format="PNG")
        rec = measured(dev, lambda: post("/api/edit", {
            "image": "data:image/png;base64,"
            + base64.b64encode(buf.getvalue()).decode(),
            "text": "served", "steps": 20, "sampler": "ddim",
            "box": second["box"]}))
        answer = rec.pop("out")
        served = np.asarray(Image.open(io.BytesIO(base64.b64decode(
            answer["image"].split(",", 1)[1]))))
        rec["changed_pixels"] = only_boxes_changed(served, image, [box])
        expect_launches(rec, flash_fwd=10 * 20)
        out["web"] = record(rec, steps=20, server_seconds=answer["seconds"])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    phase("web", **out["web"])

    # ---- edit_profiled: the stage split and the FLOPs per stage
    profiled, _, stats = pipe.edit_profiled(image, box, "BENCHMARK", seed=0)
    if not np.array_equal(profiled, alone):
        raise RuntimeError("edit_profiled's image differs from edit()'s")
    out["edit_profiled"] = stats
    phase("edit_profiled", resolution=RES, **stats)
    need = {"host_prep_s", "prep_s", "loop_s", "decode_s", "paste_s", "flops"}
    if set(stats) != need or not stats["flops"] \
            or not stats["flops"]["loop"] > 0:
        raise RuntimeError(f"edit_profiled returned {stats}")
    return out


def check_streams(fpipe, x_in, t_in, ctx16) -> dict:
    """Phase streams: the flagged UNet forward on two CUDA streams at once,
    each result bit-identical to the same forward run alone.  (The split-K
    int8 matmul merges its blocks' partial results by ticket counters, which
    two streams must never share; the GroupNorm kernels merge inside a
    thread block cluster.)  Both
    streams wait for one event behind a GPU sleep, so the host has queued
    both forwards before either starts and they do run at once."""
    dev = fpipe.device
    inputs = [x_in, torch.roll(x_in, 7, dims=-1) * 0.5]
    with torch.inference_mode():
        alone = [fpipe.unet(x, t_in, ctx16) for x in inputs]
        torch.cuda.synchronize(dev)
        streams = [torch.cuda.Stream(dev) for _ in inputs]
        identical, overlapped = [], []
        for _ in range(3):
            outs, spans = [], []
            torch.cuda._sleep(600_000_000)  # about 0.3 s
            gate = torch.cuda.Event()
            gate.record()
            for s, x in zip(streams, inputs):
                s.wait_event(gate)
                with torch.cuda.stream(s):
                    start, end = (torch.cuda.Event(enable_timing=True)
                                  for _ in range(2))
                    start.record()
                    outs.append(fpipe.unet(x, t_in, ctx16))
                    end.record()
                    spans.append((start, end))
            torch.cuda.synchronize(dev)
            identical.append([torch.equal(a, b) for a, b in zip(outs, alone)])
            # the second stream's forward started before the first one's ended
            overlapped.append(spans[0][0].elapsed_time(spans[1][1]) > 0
                              and spans[1][0].elapsed_time(spans[0][1]) > 0)
    res = dict(identical=identical, overlapped=overlapped)
    phase("streams", **res)
    if not all(all(r) for r in identical):
        raise RuntimeError(f"two streams at once differ from a run alone: {res}")
    if not any(overlapped):
        raise RuntimeError("the two streams' forwards never overlapped")
    return res


def edits_only(n: int, res: int, batch: int, stream: int) -> None:
    """Seconds of ``n`` edits alone at ``res``: sequential ``edit()`` calls,
    or (``batch``) ``n`` calls of ``edit_batch`` over that many images, or
    (``stream``) one ``edit_stream`` over ``n`` items at that depth."""
    import diffute_tpu_torch

    cfg, pipe = serving_pipeline(torch.device("cuda", 0))
    image, box = scene(res)
    # the peak below is the edits' own, not the initialisation's
    torch.cuda.reset_peak_memory_stats()
    kw = {}
    if res != RES:
        kw["edit_config"] = dataclasses.replace(cfg.edit, resolution=res)
    seconds = []
    if stream:
        items = [(image, box, "BENCHMARK")] * n
        list(pipe.edit_stream(items[:2], seed=0, depth=stream, **kw))  # warm-up
        t0 = time.perf_counter()
        for _ in pipe.edit_stream(items, seed=0, depth=stream, **kw):
            seconds.append(time.perf_counter() - t0)  # when each image came
    else:
        for i in range(n):
            t0 = time.perf_counter()
            if batch:
                pipe.edit_batch([(image, box, "BENCHMARK")] * batch, seed=i,
                                **kw)
            else:
                pipe.edit(image, box, "BENCHMARK", seed=i, **kw)
            seconds.append(time.perf_counter() - t0)
    print(json.dumps({"package": diffute_tpu_torch.__file__, "gpu": gpu_line(),
                      "resolution": res, "batch": batch, "stream_depth": stream,
                      "memory_allocated": torch.cuda.memory_allocated(),
                      "max_memory_allocated": torch.cuda.max_memory_allocated(),
                      "edit_seconds": seconds}), flush=True)


def flash_host_timing(rounds: int, calls: int = 100) -> None:
    """Microseconds per serving attention call: the host's time to queue
    ``calls`` calls (CUDA's launch queue holds them all, so nothing waits on
    the card) and the time until the card has run them, median of
    ``rounds`` rounds, at a 512^2 edit's (S, H) = (1024, 10) and
    (4096, 5)."""
    import diffute_tpu_torch
    from diffute_tpu_torch.ops import dot_product_attention

    dev = torch.device("cuda", 0)
    out = []
    for s, h in [(1024, 10), (4096, 5)]:
        # three projections viewed as heads, as Attention.forward has them
        q, k, v = (torch.randn((1, s, h * 64), device=dev,
                               dtype=torch.bfloat16).view(1, s, h, 64)
                   for _ in range(3))

        def call():
            return dot_product_attention(q, k, v, use_flash=True).reshape(
                1, s, h * 64)

        queue_us, wall_us = [], []
        with torch.no_grad():
            for _ in range(rounds + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    call()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                queue_us.append((t1 - t0) / calls * 1e6)
                wall_us.append((t2 - t0) / calls * 1e6)
        out.append({"s": s, "h": h, "calls": calls, "rounds": rounds,
                    # the first round builds and warms up
                    "queue_us_median": statistics.median(queue_us[1:]),
                    "wall_us_median": statistics.median(wall_us[1:]),
                    "queue_us": queue_us[1:]})
    print(json.dumps({"package": diffute_tpu_torch.__file__, "gpu": gpu_line(),
                      "flash_host": out}), flush=True)


def fused_host_timing(rounds: int, calls: int = 100) -> None:
    """Microseconds per call of the flagged UNet's two most launched layers,
    as the UNet calls them: one GN+SiLU+conv3x3 half at (1, 320, 320, 64^2)
    through ResnetBlock2D (its packed weight cached) and one biased int8
    layer at (4096, 320, 320) through QuantLinear; and of one GroupNorm
    statistics call and one GN+SiLU call (GroupNormSiLU) at (1, 320, 64^2);
    the host's time to queue ``calls`` calls and the time until the card has
    run them, median of ``rounds`` rounds."""
    import diffute_tpu_torch
    from diffute_tpu_torch.models.layers import (GroupNormSiLU, QuantLinear,
                                                 ResnetBlock2D)
    from diffute_tpu_torch.ops.groupnorm import group_norm_stats
    from diffute_tpu_torch.ops.quant import quantize_per_channel

    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16
    block = ResnetBlock2D(320, 320, fused_conv=True).to(dev, bf16)
    x = torch.randn((1, 320, 64, 64), device=dev, dtype=bf16)
    linear = QuantLinear(320, 320)
    q, scale = quantize_per_channel(torch.randn(320, 320))
    linear.load_state_dict({"weight_q": q, "weight_scale": scale,
                            "bias": torch.randn(320)})
    linear = linear.to(dev, bf16)
    tokens = torch.randn((1, 4096, 320), device=dev, dtype=bf16)
    norm = GroupNormSiLU(32, 320).to(dev, bf16)
    out = []
    for name, call in [
            ("conv", lambda: block._half("conv1", block.norm1, block.conv1, x)),
            ("w8", lambda: linear(tokens)),
            ("gn_stats", lambda: group_norm_stats(x, 32, 1e-5)),
            ("gn_silu", lambda: norm(x))]:
        queue_us, wall_us = [], []
        with torch.no_grad():
            for _ in range(rounds + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    call()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                queue_us.append((t1 - t0) / calls * 1e6)
                wall_us.append((t2 - t0) / calls * 1e6)
        out.append({"layer": name, "calls": calls, "rounds": rounds,
                    # the first round builds and warms up
                    "queue_us_median": statistics.median(queue_us[1:]),
                    "wall_us_median": statistics.median(wall_us[1:]),
                    "queue_us": queue_us[1:]})
    print(json.dumps({"package": diffute_tpu_torch.__file__, "gpu": gpu_line(),
                      "fused_host": out}), flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--edits-only", type=int, default=0, metavar="N",
                   help="time N edits of phase 4 and nothing else")
    p.add_argument("--res", type=int, default=RES, choices=[512, 768, 1024],
                   help="with --edits-only: the edit resolution")
    p.add_argument("--batch", type=int, default=0, metavar="B",
                   help="with --edits-only: time edit_batch calls of B images")
    p.add_argument("--stream", type=int, default=0, metavar="DEPTH",
                   help="with --edits-only: time one edit_stream over the N "
                   "items at this depth (seconds are arrival times)")
    p.add_argument("--flag-timing", type=int, default=0, metavar="N",
                   help="time N rounds of edits with the UNet's flags off, "
                   "fused conv, int8 and all on, in turns, and nothing else")
    p.add_argument("--kernels-only", action="store_true",
                   help="build and check the flash kernels (phases 3 and "
                   "3a) and those of phase 3b, then stop")
    p.add_argument("--flash-host", type=int, default=0, metavar="ROUNDS",
                   help="time the host's side of the serving attention call "
                   "and nothing else")
    p.add_argument("--fused-only", action="store_true",
                   help="build and check the UNet's opt-in kernels (phase "
                   "3b) alone, then stop")
    p.add_argument("--fused-host", type=int, default=0, metavar="ROUNDS",
                   help="time the host's side of one fused-conv and one "
                   "int8 layer call and nothing else")
    p.add_argument("--package-root", default=None, metavar="DIR",
                   help="import diffute_tpu_torch from this checkout")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    if args.package_root:
        sys.path.insert(0, args.package_root)
    if args.edits_only:
        return edits_only(args.edits_only, args.res, args.batch, args.stream)
    if args.flag_timing:
        return flag_timing(args.flag_timing)
    if args.flash_host:
        return flash_host_timing(args.flash_host)
    if args.fused_host:
        return fused_host_timing(args.fused_host)
    if args.fused_only:
        import diffute_tpu_torch

        print(gpu_line(), diffute_tpu_torch.__file__, flush=True)
        check_fused_kernels(torch.device("cuda", 0))
        return
    if args.kernels_only:
        import diffute_tpu_torch

        print(gpu_line(), diffute_tpu_torch.__file__, flush=True)
        check_forward(torch.device("cuda", 0))
        check_backward(torch.device("cuda", 0))
        check_pipelined_forward(torch.device("cuda", 0))
        check_fused_kernels(torch.device("cuda", 0))
        return
    from diffute_tpu_torch.config import (DiffUTEConfig, TrainConfig,
                                          UNetConfig)
    from diffute_tpu_torch.io.dataset import (SyntheticSceneDataset,
                                              make_unet_batch)
    from diffute_tpu_torch.models import UNet2DCondition, count_params
    from diffute_tpu_torch.models.attention import Attention
    from diffute_tpu_torch.ops import _build
    from diffute_tpu_torch.ops.flash_attention import (flash_attention,
                                                       flash_bwd, flash_fwd)
    from diffute_tpu_torch.text import find_font, trocr_preprocess_host
    from diffute_tpu_torch.train import UNetTrainer, run_unet
    from diffute_tpu_torch.utils import init_pipeline_params
    from diffute_tpu_torch.utils.params import load_module

    # ---- 1. device
    import PIL

    font = find_font(None, 40)  # raises when no TTF font is usable
    gpu = gpu_line()
    phase("device", gpu=gpu, torch=torch.__version__, cuda=torch.version.cuda,
          pillow=PIL.__version__, font=font.path,
          count=torch.cuda.device_count())
    dev = torch.device("cuda", 0)

    # ---- 2. build
    t0 = time.perf_counter()
    _build.load()
    phase("build", seconds=time.perf_counter() - t0)

    # ---- 3. kernels against their plain versions, bf16: the forward at the
    # main paths' shapes, then the backward kernels.  Shapes (BH, S, T): the
    # edit's (batch 1), the training step's (batch 4) and a ragged one.
    fwd_results = check_forward(dev)
    dq_results, dkv_results = check_backward(dev)

    # the autograd function's backward is the backward wrapper, on the 4-D
    # views it was given, with no copy in either direction
    g = torch.Generator(device=dev).manual_seed(1)
    q4, k4, v4, g4 = (torch.randn((2, 1024, 5, 64), generator=g, device=dev,
                                  dtype=torch.bfloat16) for _ in range(4))
    leaves = [x.clone().requires_grad_() for x in (q4, k4, v4)]
    flash_attention(*leaves).backward(g4)
    o4, lse4 = flash_fwd(q4, k4, v4, 0.125)
    same = all(torch.equal(leaf.grad, ref) for leaf, ref in zip(
        leaves, flash_bwd(q4, k4, v4, o4, lse4, g4, 0.125)))
    contiguous = all(leaf.grad.is_contiguous() for leaf in leaves)
    phase("autograd_function", backward_equals_wrapper=same,
          grads_contiguous=contiguous)
    if not (same and contiguous):
        raise RuntimeError("FlashAttentionFn.backward differs from flash_bwd")
    del leaves, q4, k4, v4, g4, o4, lse4

    # ---- 3a. the deferred-softmax forward against its plain version and
    # against the standard forward
    pipelined_results = check_pipelined_forward(dev)

    # ---- 3b. the three opt-in kernels against their plain versions
    fused = check_fused_kernels(dev)

    # ---- 4. serving path: full width, bf16, flash on, two edits
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    params = init_pipeline_params(DiffUTEConfig(), seed=0, device=dev)
    cfg, pipe = serving_pipeline(dev, params)
    n_unet, n_vae = count_params(pipe.unet), count_params(pipe.vae)
    phase("init", seconds=time.perf_counter() - t0, unet_params=n_unet,
          vae_params=n_vae, trocr_params=count_params(pipe.trocr))
    if (n_unet, n_vae) != (865_925_124, 83_653_863):
        raise RuntimeError(f"parameter counts {n_unet}, {n_vae}")

    image, box = scene()
    edits = []
    for i, text in enumerate(["BENCHMARK", "DiffUTE edit"]):
        rec = timed_edit(pipe, image, box, text, i)
        phase("edit", edit=i, **rec)
        expect_launches(rec, flash_fwd=10 * STEPS, conv=0, gn_silu=0, w8=0)
        edits.append(rec)
    edit_launches = sum(e["launches"]["flash_fwd"] for e in edits)

    # ---- 5. what came out: finite latents, and flash vs dense at full size
    region, _ = pipe._prepare_region(image, box, "check", RES, None)
    gen = torch.Generator(device=dev).manual_seed(7)
    r = RES // cfg.vae.scale_factor
    noise = [torch.randn((1, 4, r, r), generator=gen, device=dev)
             for _ in range(2)]
    with torch.inference_mode():
        ctx, mask_lat, masked_lat, lat0, _, _ = pipe._device_prep(
            torch.from_numpy(region["mask512"][None]).to(dev),
            torch.from_numpy(region["masked512"][None]).to(dev),
            torch.from_numpy(trocr_preprocess_host([region["glyph"]],
                                                   cfg.trocr)).to(dev),
            *noise)
        lat = pipe._device_loop(STEPS, ctx, mask_lat, masked_lat, lat0)
        finite = bool(torch.isfinite(lat).all())
        x_in = torch.cat([lat0, mask_lat, masked_lat], 1).to(bf16)
        t_in = torch.tensor(981, device=dev)
        ctx16 = ctx.to(bf16)
        eps_flash = pipe.unet(x_in, t_in, ctx16).float()
        attns = [m for m in pipe.unet.modules() if isinstance(m, Attention)]
        for m in attns:
            m.use_flash = False
        eps_dense = pipe.unet(x_in, t_in, ctx16).float()
        for m in attns:
            m.use_flash = True
    rel = ((eps_flash - eps_dense).abs().max()
           / eps_dense.abs().max()).item()
    phase("check", latents_finite=finite, latent_shape=list(lat.shape),
          unet_flash_vs_dense_rel_err=rel, tolerance=TOL_UNET_REL)
    if not finite or not rel <= TOL_UNET_REL:
        raise RuntimeError("main-path check failed")

    # ---- 5a. the other serving modes and resolutions, flags off: 768^2
    # (9216 x 5 and 2304 x 10 tokens x heads reach the flash kernel: 10
    # launches a pass), edit_multi, edit_batch, edit_stream, the web server,
    # edit_profiled.  1024^2 follows in 5d, with the flagged pipeline.
    res_edits = {768: check_resolution(pipe, 768, 10)}
    modes = check_modes(pipe)

    # ---- 5b. one full-width UNet forward, same weights and inputs: each
    # opt-in kernel alone and all three against the unfused float UNet
    flag_sets = {"fused_gn": dict(use_fused_groupnorm=True),
                 "fused_conv": dict(use_fused_conv=True),
                 "int8": dict(use_int8_weights=True), "all": ALL_FLAGS}
    unet_check = {}
    for name, flags in flag_sets.items():
        ucfg = dataclasses.replace(cfg.unet, **flags)
        unet = load_module(UNet2DCondition, ucfg, params["unet"], dev, bf16)
        reset_counters()
        with torch.inference_mode(), record_shapes(name == "all") as shapes:
            eps = unet(x_in, t_in, ctx16).float()
        d = eps - eps_flash
        unet_check[name] = dict(
            rel_max=(d.abs().max() / eps_flash.abs().max()).item(),
            mean_rel=(d.abs().mean() / eps_flash.abs().mean()).item(),
            cosine=((eps * eps_flash).sum()
                    / (eps.norm() * eps_flash.norm())).item(),
            launches=counters())
        del unet, eps, d
    # phase 3b's tables are the flagged pass's shapes: this forward computes
    # the cross-attention K/V inside, so the once-per-edit shapes are in it
    expected = {"conv": {(hw, cin, cout): n for hw, cin, cout, n in CONV_SHAPES},
                "w8": dict(W8_SHAPES + W8_EDIT_SHAPES)}
    phase("unet_shapes", **{k: {str(list(s)): n for s, n in v.items()}
                            for k, v in shapes.items()})
    if {k: dict(v) for k, v in shapes.items()} != expected:
        raise RuntimeError(f"the flagged UNet pass launched {shapes}, phase "
                           f"3b's tables hold {expected}")
    phase("unet_flags", **unet_check, tolerance_rel_max=TOL_UNET_FUSED_REL,
          tolerance_int8_mean_rel=TOL_INT8_MEAN_REL,
          tolerance_int8_cosine=TOL_INT8_COS)
    for name in ("fused_gn", "fused_conv"):
        if not unet_check[name]["rel_max"] <= TOL_UNET_FUSED_REL:
            raise RuntimeError(f"UNet with {name} differs from the unfused")
    for name in ("int8", "all"):
        if not (unet_check[name]["mean_rel"] <= TOL_INT8_MEAN_REL
                and unet_check[name]["cosine"] >= TOL_INT8_COS):
            raise RuntimeError(f"UNet with {name} differs from float weights")
    # per UNet pass: 44 resnet halves (each with its statistics launch), 45
    # norms (one GN+SiLU launch each), 160 int8 linear layers
    for name, expected in (("fused_gn", dict(conv=0, gn_silu=45, gn_stats=0,
                                             w8=0)),
                           ("fused_conv", dict(conv=44, gn_silu=0,
                                               gn_stats=44, w8=0)),
                           ("int8", dict(conv=0, gn_silu=0, gn_stats=0,
                                         w8=192)),
                           ("all", dict(conv=44, gn_silu=1, gn_stats=44,
                                        w8=192))):
        expect_launches(unet_check[name], **expected)

    # ---- 5c. the flagged serving path: all four flags on, two 50-step DDIM
    # edits, then DPM-Solver++ with guidance, blend and encoder reuse, and
    # DDPM.  Per UNet pass: 44 conv (16 in the encoder), each with its
    # statistics launch, 1 GN+SiLU (one launch), 160 int8
    # matmuls (60 in the encoder) and 10 flash forwards (4 in the encoder);
    # once per edit and context 32 int8 matmuls for the hoisted K/V.
    del eps_flash, eps_dense, attns
    _, fpipe = serving_pipeline(dev, params, **ALL_FLAGS)
    del params
    flag_edits = []
    for i, text in enumerate(["BENCHMARK", "DiffUTE edit"]):
        rec = timed_edit(fpipe, image, box, text, i)
        phase("edit_flags", edit=i, **rec)
        expect_launches(rec, conv=44 * STEPS, gn_silu=STEPS,
                        gn_stats=44 * STEPS, w8=160 * STEPS + 32,
                        flash_fwd=10 * STEPS)
        flag_edits.append(rec)
    ec = dataclasses.replace(cfg.edit, sampler="dpmpp", guidance_scale=3.0,
                             masked_latent_blend=True,
                             encoder_reuse_interval=2)
    rec = timed_edit(fpipe, image, box, "CFG blend", 2, ec, steps=20)
    phase("edit_dpmpp_cfg_blend_reuse2", steps=20, **rec)
    # 10 full passes and 10 decoder-only ones; K/V of both contexts hoisted
    expect_launches(rec, conv=10 * 44 + 10 * 28, gn_silu=20,
                    gn_stats=10 * 44 + 10 * 28,
                    w8=10 * 160 + 10 * 100 + 64, flash_fwd=10 * 10 + 10 * 6)
    mode_edits = {"dpmpp_cfg_blend_reuse2": rec}
    rec = timed_edit(fpipe, image, box, "ancestral", 3,
                     dataclasses.replace(cfg.edit, sampler="ddpm"), steps=20)
    phase("edit_ddpm", steps=20, **rec)
    expect_launches(rec, conv=20 * 44, gn_silu=20, gn_stats=20 * 44,
                    w8=20 * 160 + 32, flash_fwd=20 * 10)
    mode_edits["ddpm"] = rec
    flag_launches = {k: sum(e["launches"][k] for e in flag_edits)
                     for k in flag_edits[0]["launches"]}

    # ---- 5d. two streams at once on the flagged UNet, then 1024^2 (16384 x
    # 5, 4096 x 10 and 1024 x 20 reach the flash kernel: 15 launches a pass)
    # with the flags off, the switch off and on, and with the flags on
    streams = check_streams(fpipe, x_in, t_in, ctx16)
    res_edits[1024] = check_resolution(pipe, 1024, 15, fpipe)
    del pipe

    # ---- 6. training path: free the pipeline, then three optimizer steps
    # through the trainer's entry point
    del fpipe, lat, lat0, ctx, ctx16, mask_lat, masked_lat, x_in, noise
    gc.collect()
    torch.cuda.empty_cache()
    reset_counters()
    history = run_unet.main([
        "--model_scale", "full", "--train_batch_size", str(TRAIN_BATCH),
        "--mixed_precision", "bf16", "--gradient_checkpointing",
        "--max_train_steps", str(TRAIN_STEPS), "--seed", "0"])
    train_launches = dict(fwd=flash_attention.launches,
                          dq=flash_attention.bwd_dq_launches,
                          dkv=flash_attention.bwd_dkv_launches)
    if any(counters()[k] for k in ("gn_stats", "gn_silu", "conv", "w8")):
        raise RuntimeError(f"the unflagged trainer launched {counters()}")
    phase("train", steps=history, launches=train_launches)
    # per step: 5 self-attentions at 4096 tokens and 5 at 1024 run the
    # forward twice (once in the forward, once recomputed by the gradient
    # checkpoint) and each backward kernel once
    expect = dict(fwd=20 * TRAIN_STEPS, dq=10 * TRAIN_STEPS,
                  dkv=10 * TRAIN_STEPS)
    if len(history) != TRAIN_STEPS or train_launches != expect:
        raise RuntimeError(f"{len(history)} steps, launches {train_launches}, "
                           f"expected {TRAIN_STEPS} and {expect}")
    if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               and h["grad_norm"] > 0 for h in history):
        raise RuntimeError(f"training metrics not finite: {history}")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 7. the trainer itself at full width: parameter count, a step
    # changes the parameters, and the loss gradient with flash on vs off
    tcfg = DiffUTEConfig(
        unet=UNetConfig(use_flash_attention=True, remat=True),
        train=TrainConfig(train_batch_size=2, mixed_precision="bf16",
                          gradient_checkpointing=True, max_train_steps=1))
    params = init_pipeline_params(tcfg, seed=0, device=dev)
    trainer = UNetTrainer(tcfg, params["unet"],
                          {"vae": params["vae"], "trocr": params["trocr"]},
                          device=dev)
    del params
    n_train = sum(p.numel() for p in trainer.state.params)
    data = SyntheticSceneDataset(tcfg, seed=0)
    batch = make_unet_batch([data[i] for i in range(2)], tcfg)
    draws = trainer.draw(2)
    probes = ["conv_in.weight",
              "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight",
              "up_blocks.3.attentions.2.transformer_blocks.0.attn1.to_v.weight",
              "conv_out.weight"]
    masters = trainer.state.state_dict()
    loss_flash = trainer.accumulate_grads(batch, draws).item()
    grads_flash = {n: masters[n].grad.clone() for n in probes}
    attns = [m for m in trainer.unet.modules() if isinstance(m, Attention)]
    for m in attns:
        m.use_flash = False
    loss_dense = trainer.accumulate_grads(batch, draws).item()
    rel = {n: ((grads_flash[n] - masters[n].grad).norm()
               / masters[n].grad.norm()).item() for n in probes}
    for m in attns:
        m.use_flash = True
    before = masters[probes[0]].clone()
    grad_norm = trainer.apply_grads().item()
    changed = not torch.equal(before, masters[probes[0]])
    phase("train_check", unet_params=n_train, loss_flash=loss_flash,
          loss_dense=loss_dense, grad_rel_l2_err=rel, tolerance=TOL_GRAD_REL,
          loss_tolerance=TOL_LOSS_REL,
          grad_norm=grad_norm, params_changed=changed)
    if (n_train != 865_925_124 or not changed or not np.isfinite(grad_norm)
            or not max(rel.values()) <= TOL_GRAD_REL
            or not abs(loss_flash - loss_dense) <= TOL_LOSS_REL * loss_dense):
        raise RuntimeError("training check failed")

    def entry(name, source, replaces, results, launches):
        main = results[0]
        return {"name": name, "route": "cuda",
                "source": f"diffute_tpu_torch/csrc/{source}",
                "replaces": f"diffute_tpu/ops/{replaces}",
                "launches": sum(launches.values()),
                "launches_by_path": launches,
                "max_abs_err": max(x["max_abs_err"] for x in results),
                **{key: main[key] for key in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")},
                "shapes": results}

    def path_launches(key):
        """``key``'s launches on each of this PR's paths, from the counters
        read right after each path ran."""
        by_path = {f"edit_{res}_{name}": rec["launches"][key]
                   for res, recs in res_edits.items()
                   for name, rec in recs.items() if isinstance(rec, dict)}
        by_path["edit_multi"] = modes["edit_multi"]["launches"][key]
        by_path["edit_batch"] = sum(r["launches"][key]
                                    for r in modes["edit_batch"].values())
        by_path["edit_stream"] = sum(
            r["launches"][key] for name, r in modes["edit_stream"].items()
            if name.startswith("depth"))
        by_path["web"] = modes["web"]["launches"][key]
        return {k: v for k, v in by_path.items() if v}

    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": [
        entry("flash_fwd_bf16", "flash_fwd.cu", "flash_attention.py:275",
              fwd_results, {"edit": edit_launches,
                            "edit_flags": flag_launches["flash_fwd"],
                            "train": train_launches["fwd"],
                            **path_launches("flash_fwd")}),
        entry("flash_fwd_pipelined_bf16", "flash_fwd_pipelined.cu",
              "flash_attention.py:149", pipelined_results,
              path_launches("flash_fwd_pipelined")),
        entry("flash_bwd_dq_bf16", "flash_bwd.cu", "flash_attention.py:396",
              dq_results, {"train": train_launches["dq"]}),
        entry("flash_bwd_dkv_bf16", "flash_bwd.cu", "flash_attention.py:437",
              dkv_results, {"train": train_launches["dkv"]}),
        # the TPU kernel is one launch here (GN+SiLU); its statistics alone
        # are a second kernel, which the fused conv launches
        entry("gn_stats_bf16", "groupnorm.cu", "groupnorm.py:31",
              fused["gn_stats"], {"edit_flags": flag_launches["gn_stats"],
                                  **path_launches("gn_stats")}),
        entry("gn_silu_bf16", "groupnorm.cu", "groupnorm.py:31",
              fused["gn_silu"], {"edit_flags": flag_launches["gn_silu"],
                                 **path_launches("gn_silu")}),
        entry("gn_silu_conv3x3_bf16", "conv_fused.cu", "conv_fused.py:40",
              fused["conv"], {"edit_flags": flag_launches["conv"],
                              **path_launches("conv")}),
        entry("w8_matmul_bf16", "quant.cu", "quant.py:51", fused["w8"],
              {"edit_flags": flag_launches["w8"], **path_launches("w8")}),
    ], "edit_seconds": [e["seconds"] for e in edits],
        "edit_flags_seconds": [e["seconds"] for e in flag_edits],
        "edit_flags_max_memory_allocated": [e["max_memory_allocated"]
                                            for e in flag_edits],
        "edit_modes": {k: {"seconds": v["seconds"], "launches": v["launches"]}
                       for k, v in mode_edits.items()},
        "unet_flags": unet_check,
        "edit_resolutions": {
            str(res): {name: ({"seconds": rec["seconds"],
                               "max_memory_allocated":
                                   rec["max_memory_allocated"]}
                              if isinstance(rec, dict) else rec)
                       for name, rec in recs.items()}
            for res, recs in res_edits.items()},
        "edit_multi_seconds": modes["edit_multi"]["seconds"],
        "edit_batch": {str(b): {k: r[k] for k in (
            "seconds", "seconds_per_image", "max_memory_allocated")}
            for b, r in modes["edit_batch"].items()},
        "edit_stream_seconds_per_image": {
            k: r["seconds_per_image"]
            for k, r in modes["edit_stream"].items()},
        "web_edit_seconds": modes["web"]["seconds"],
        "edit_profiled": modes["edit_profiled"],
        "streams": streams,
        "train_step_seconds": [h["seconds"] for h in history],
        "train_max_memory_allocated": [h["max_memory_allocated"]
                                       for h in history]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
