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
  3c. the head_dim-512 kernels (the VAE mid-block's single head,
     csrc/flash_wide.cu): the forward at (B, S, T) = (1, 4096, 4096),
     (4, 4096, 4096), (1, 16384, 16384) and a ragged (2, 1000, 1500), dq
     (with delta), dk/dv and the pair at (4, 4096, 4096) and the ragged
     shape, each against its tiled plain version at the kernels' 32-row kv
     tile at the head_dim-64 criteria, the same bits twice, mutants of the
     plain versions (the LSE left in base 2, the last kv tile never
     consumed, dk x 1.02) failing, and strided (B, S, 1, 512) views of a
     packed projection read bit for bit as the contiguous route; each timed
     beside its plain one-pass version, its bound and SDPA (whose backend is
     recorded); what ptxas says of the source's six kernels;
  3d. the same at head_dim 256 (small_config's VAE mid-block: the
     forward csrc/flash_d256_sm90.cu on TMA and wgmma at its own 64-row kv
     tile, also in each block layout, one and two consumer warpgroups,
     each the launcher's bits; dq and dk/dv csrc/flash_d256_bwd_sm90.cu,
     TMA and wgmma on 64-row tiles, held at that tile; what ptxas says of
     both sources): the forward at (1, 4096, 4096), (16, 4096, 4096) and
     (2, 1000, 1500), the backward at the last two;
  3e. the deferred-softmax forward at both wide head_dims (behind
     PIPELINE_FWD: the same source's fwd_deferred_kernel at 512,
     csrc/flash_d256_sm90.cu's deferred schedule at 256, in both block
     layouts) at 3c's and 3d's forward shapes that its dispatch rule
     takes (T a multiple of its kv tile, two tiles or more), against its
     plain version at the head_dim-64
     criteria and against the standard wide forward (the same bits), the
     same bits twice, mutants of the plain version (the LSE left in base
     2, the last kv tile never consumed, tile j's softmax on tile j - 1's
     scores) failing; strided views through the switch bit for bit as
     the contiguous call, and the ragged (2, 1000, 1500) sent to the
     standard kernel; each timed beside the standard forward, the plain
     one-pass version, its bound and SDPA;
  3f. the fp32 kernels (3xTF32 products: the forward and the deferred
     forward at head_dim 64 csrc/flash_fp32.cu; dq with delta and dk/dv at
     64 on tf32 wgmma, csrc/flash_fp32_d64_bwd_sm90.cu; all four at 256 on
     tf32 wgmma, csrc/flash_fp32_d256_sm90.cu and
     csrc/flash_fp32_d256_bwd_sm90.cu; all four at 512) against their
     plain fp32 versions at the same domain (natural;
     the deferred forward base 2 on prescaled q): o, dq, dk, dv within
     relative L2 1e-5, the LSE and delta within 1e-5, the same bits twice;
     the forwards at the edit's, the training step's and the VAE's shapes
     and a ragged one, the backward at the training shapes and the ragged
     one; mutants (operands rounded to TF32, the LSE in base 2, the last kv
     tile dropped, dk x (1 + 1e-4), natural exp on prescaled q) must FAIL;
     strided views bit for bit as the contiguous route, the switch on too;
     each timed beside its plain one-pass version, SDPA on fp32 with TF32
     off (its backend recorded) and the bound at 164.9 TFLOP/s (the TF32
     rate over three products); what ptxas says of the source;
  3g. the fp32 entries of GroupNorm+SiLU and its statistics
     (csrc/groupnorm.cu) and the int8 matmul on fp32 x
     (csrc/quant_fp32_sm90.cu, two TF32 products on wgmma, K split where
     the tiles leave SMs idle) against their plain fp32 versions, TF32 off:
     GN+SiLU within relative L2 1e-5, the statistics as 3b holds the bf16
     ones and within 1e-6 of their tiled plain version at the fp32 plan,
     the int8 matmul within relative L2 1e-5 (and its distance from fp64
     and from the plain emulation of its order of sums), each the same bits
     twice, the fused bias bit for bit; GroupNorm at 3b's shapes, the int8
     matmul at 3b's and a ragged one; mutants (the GN output rounded
     through bf16, the one-pass variance at mean 100, a dropped cluster
     rank, x rounded to TF32 alone, the scale applied to one feature twice,
     one K split's partial dropped) must FAIL; each timed beside its bound,
     its plain version and its library call;
  3h. GN+SiLU+conv3x3 on fp32 inputs (csrc/conv_fused_fp32.cu, 3xTF32
     products, the OIHW weight read as the layer keeps it) against its
     plain fp32 version, TF32 off, at every shape of 3b's conv table, a
     ragged one (Cout 96, 24^2) too: within relative L2 1e-5, the same bits
     twice, the kernel's and the plain version's distance from fp64;
     mutants (the normalised operand rounded through bf16, TF32 alone, the
     border padded with silu(d), a dropped 16-channel chunk) must FAIL;
     each timed beside its bound at the 3xTF32 rate, its plain version and
     F.conv2d(F.silu(F.group_norm)) in fp32; the pass's sums;
  3i. the narrow head_dims (csrc/flash_narrow.cu: every multiple of 8 up
     to 128 but 64, at tile widths 16, 32, 64 and 128, bf16 and fp32; all
     four bf16 kernels at width 16 csrc/flash_narrow_w16_sm90.cu): the four
     kernels at D = 8, 16, 32, 40, 80 and 128 against their plain
     tiled versions at the kernels' kv tile and their dtype's criteria
     (bf16 as phase 3's, fp32 as 3f's and within 1e-5 of fp64), at the tiny
     model's shapes (B*H, S, T) = (2, 65536, 65536) and (4, 16384, 16384)
     at D = 8 and (1, 65536, 65536) at 16, 4,096-token shapes elsewhere and
     a ragged one each; the plain versions never hold (B*H, S, T) scores;
     the same bits twice, the bf16 deferred forward the standard one's
     bits; mutants (the tile width's scale, pad columns of 1.0, a dropped
     kv tile, TF32 alone) must FAIL; strided views the contiguous bits,
     the switch on too; each timed beside its plain one-pass version, SDPA
     (its backend recorded) and a bound whose third term is the
     exponentials over the special-function units' rate, the width-16
     bf16 kernels with their blocks an SM (and, on the progress line
     only, their rows a block, blocks and waves);
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
     synthetic scenes), counting the launches of all three flash kernels,
     and saves its checkpoint into a temporary directory;
  7. checks: parameter count, parameters changed by a step, and the loss
     gradient of four UNet weights with flash on vs off at full width;
  8. stage 1: a manifest of 8 synthetic 384 x 512 document pages (PNG, with
     an OCR JSON each); train.run_vae on the full SD2 VAE (83,653,863
     parameters, asserted) at 512^2, bf16, gradient checkpointing, batch 4,
     3 steps with a checkpoint at 2 and at the end (seconds per step and
     peak memory); every weight tensor changed; a resume from the latest
     checkpoint restores masters, moments, counts and generator bit for bit
     and takes one step;
  8a. the VAE with VAEConfig.use_flash_attention at full width: an encode
     and a decode at 512^2 and 1024^2 flag on against off (the same
     weights; relative max error and peak memory); a 20-step 512^2 and
     1024^2 edit with the flag (2 head_dim-512 forwards each, only the box
     changed, the gap to the flag-off edit in LSB); one stage-2 step with
     the flagged frozen VAE (2 head_dim-512 forwards, the UNet's 20/10/10);
     the loss gradient of four weights flag on against off and against the
     fp32 step; three stage-1 steps at batch 4 flag off and on (2 forward,
     2 dq, 2 dk/dv launches a step; seconds and peak memory);
  8b. the same for small_config's VAE (one head of 256 over 4,096 tokens
     at 256^2), bf16, weights from seed 0: an encode and a decode at 256^2
     flag on against off; 20-step 256^2 edits flag on and off (2
     head_dim-256 forwards with the flag) and one with the masked-latent
     blend (3); one small stage-2 step at batch 16 (2 forwards, the small
     UNet's 20/10/10); the gradient check; three stage-1 steps at batch 16
     flag off and on (2 forward, 2 dq, 2 dk/dv a step); in 8a and 8b each
     flagged path also with PIPELINE_FWD on (the wide forwards deferred,
     the UNet's head_dim-64 ones too): encodes and decodes equal to the
     switch off bit for bit, edits within 2 LSB, the stage-2 loss within
     1e-2, the stage-1 steps and the gradient check's probes bit for bit,
     the flash route of the switch-on step; every flash counter asserted on
     each path of 8a and 8b;
  8c. the fp32 paths with the fp32 kernels, full width, weights from seed
     0: a 20-step 512^2 edit with UNet, VAE and TrOCR in fp32 and both
     flash flags (200 head_dim-64 and 2 head_dim-512 fp32 forwards),
     against the same edit dense and with PIPELINE_FWD on (200 + 2
     deferred), each within 1 LSB; train.run_unet --mixed_precision no
     (batch 4, checkpointing, 2 steps; 20/10/10 fp32 launches a step); one
     UNetTrainer step with the VAE's flag too (2 head_dim-512 forwards)
     against flash off (the loss within 1e-5, four probes' gradients within
     1e-4 relative L2); three fp32 stage-1 steps on the SD2 VAE at 512^2,
     batch 4, flag on and off (2/2/2 at head_dim 512 a step, the losses
     within 1e-5), then one more flagged step whose two flash calls are
     held at their own boundary (dq, dk, dv within relative L2 1e-5 of the
     tiled plain fp32 backward on the step's q, k, v and dO, or within
     twice its distance from fp64; mutants fail); small_config's VAE: an
     encode and a decode at 256^2 flag on (switch off and on) against off,
     three fp32 stage-1 steps at batch 16 (2/2/2 at 256);
  8d. the fp32 paths through GN+SiLU and the int8 matmul on fp32, full
     width, both flash flags: a 20-step 512^2 edit with use_fused_groupnorm
     and use_int8_weights (900 GN+SiLU, 3,232 int8, 200 + 2 fp32 flash
     launches) within 1 LSB of the same edit with the GroupNorm flag off
     and of one whose transformer layers hold the dequantised int8 weights
     as float weights; one UNetTrainer step at batch 4 with gradient
     checkpointing and use_fused_groupnorm (89 GN+SiLU launches: 45, then
     44 recomputed) against the flag off (the loss within 1e-5, four
     probes' gradients within 1e-4); seconds and peak memory beside 8c's
     flash-only edit and step;
  8e. the fp32 paths through the fp32 GN+SiLU+conv3x3, full width, both
     flash flags: a 20-step 512^2 edit with use_fused_conv (880 conv, 880
     statistics, 200 + 2 fp32 flash launches) within 1 LSB of 8c's
     flash-only edit, and one with all three flags (880 / 880 / 20 GN+SiLU
     / 3,232 int8 / 202) within 1 LSB of 8d's --fused-gn --int8 edit, the
     four edits in turns; one UNetTrainer step at batch 4 with gradient
     checkpointing and use_fused_conv (88 conv and 88 statistics
     launches: 44, then 44 recomputed) against the flag off (the loss
     within 1e-5, four probes' gradients within 1e-4); seconds and peaks;
  8f. the tiny model (tiny_test_config, head_dim 8 in the UNet, 16 in the
     VAE's mid-block) at 512^2 through the width-16 kernels
     (csrc/flash_narrow_w16_sm90.cu's bf16 four, csrc/flash_narrow.cu's
     fp32 four): serve.cli --tiny --res 512 as a subprocess,
     switch off and on (200 launches, only the box changed); a 50-step
     bf16 edit with the VAE's flag (202), switch on (0 LSB) and on the
     dense route (within 2 LSB), a UNet forward and the codec against dense; a 20-step fp32 edit
     (82) against the switch and dense within 1 LSB; a stage-2 step (10 /
     4 / 4) and a stage-1 step (2 / 2 / 2) in bf16 and fp32 against the
     dense route and, past its tolerance, against a step with fp64
     attention; the bf16 flash steps timed (the median of 3 after a
     warm-up);
  9. stage 2 from stage 1: train.run_unet --pretrained <the stage-1
     checkpoint> --manifest at full width (batch 4, bf16, flash, gradient
     checkpointing), 2 steps, --checkpoints_total_limit 1: its frozen VAE
     equals stage 1's exported vae/ in bf16 bit for bit; a resume to step 3
     restores the whole state bit for bit (20 forward, 10 dq, 10 dk/dv
     launches in the resumed step, asserted); the checkpoint's bytes and the
     seconds to snapshot, write, export and restore it;
  10. serving from the checkpoint: a pipeline built through
     load_diffusers_layout from stage 2's final export and one from the
     trainer's in-memory state_dicts run the same 20-step 512^2 edit (200
     flash launches each; outputs within 1 LSB, equal so far), and
     serve.cli --checkpoint completes the same edit;
  11. OCR verifier training: train.run_ocr at the small scale on synthetic
     glyphs (batch 64, targets of 16 ids, 50 steps with 10 of warmup, a
     checkpoint at 25 and at the end): finite loss and gradient norm, the
     mean loss of the last 10 steps below the first 10's, a resume from
     the latest restores the whole state bit for bit and takes a step
     (seconds per step, peak memory);
  12. eval: eval.run at full width (the serving pipeline, bf16 with the
     flash kernel; the TrOCR-large encoder and 12-layer decoder, vocabulary
     50,265, random-init, fp32, as the verifier) over 4 synthetic scenes at
     20 steps: 200 flash launches an example, background SSIM 1.0, a
     changed box, every field finite but the PSNRs; greedy_decode_cached
     equal to greedy_decode token for token on the edited regions (both
     timed); then at the small scale with phase 11's checkpoint as
     --pretrained and --tokenizer char (200 launches an example, the text
     match rate reported);
  13. acceptance: eval.acceptance --model_scale full on phase 9's stage-2
     export, fp32 with dense attention: --make_reference writes a bundle,
     then the layout is held against it; both exit 0 with the pinned
     parameter counts and stages 3-5 passing (seconds of each).
Then one JSON line of kernel results, and last the device JSON line.
Exits non-zero, with no result, when no CUDA device is available.

    python3 chip_smoke.py --fp32-only

builds the kernels and runs phases 3f, 3g, 3h, 8c, 8d and 8e (the fp32
kernels and the fp32 paths) alone and prints their kernels line.

    python3 chip_smoke.py --fp32-d512-only [--package-root DIR]

builds the kernels and runs phase 3f at head_dim 512 (the fp32 forwards of
csrc/flash_fp32.cu and the backward pair of
csrc/flash_fp32_d512_bwd_sm90.cu) and 8c's SD2 stage-1 steps (fp32, the
VAE's flag off and on, and the flash route held inside a flagged step)
alone and prints their kernels line; with --package-root from another
checkout's package, so change, parent, parent, change in one call times
two commits' kernels and steps in turns.  --save-route PATH saves the
PIPELINE_FWD step's mid-block calls (q, k, v, dO) for
python -m diffute_tpu_torch.tools.fp32_d512_bwd_variants --chain-study PATH.

    python3 chip_smoke.py --fp32-d64-only [--package-root DIR]

builds the kernels and runs phase 3f at head_dim 64 (both fp32 forwards of
csrc/flash_fp32.cu and the backward pair of
csrc/flash_fp32_d64_bwd_sm90.cu) and 8c's flagged fp32 stage-2 step (the
loss and four gradients against flash off, the head_dim-64 flash route
held inside it with PIPELINE_FWD off and on, full steps timed) alone and
prints their kernels line; with --package-root from another checkout's
package, so change, parent, parent, change in one call times two commits'
kernels and steps in turns.

    python3 chip_smoke.py --fp32-d256-only [--package-root DIR]

builds the kernels and runs phase 3f at head_dim 256 (both fp32 forwards of
csrc/flash_fp32_d256_sm90.cu and the backward pair of
csrc/flash_fp32_d256_bwd_sm90.cu, the pair also on the tiled plain
forward's o and LSE) and 8c's small_config fp32 stage-1 steps
(batch 16 at 256^2, each timed; the head_dim-256 flash route held inside
a flagged step with PIPELINE_FWD off and on, its distances from fp64
beside the plain version's) alone and prints their kernels line; with
--package-root from another checkout's package, so change, parent,
parent, change in one call times two commits' kernels and steps in
turns.

    python3 chip_smoke.py --w8-fp32-only [--package-root DIR]

builds the kernels and runs phase 3g's int8 matmul on fp32 x
(csrc/quant_fp32_sm90.cu) and phase 8d's 20-step fp32 --fused-gn --int8
edit, its two references and 8e's all-flags edit, in turns, alone and
prints their kernels line; with --package-root from another checkout's
package, so change, parent, parent, change in one call times two commits'
kernels and edits in turns.

    python3 chip_smoke.py --narrow-only [--package-root DIR]

builds the kernels and runs phases 3i and 8f (the narrow head_dims' kernels
and the tiny model's paths) alone (about 4 minutes) and prints their
kernels line; with --package-root from another checkout's package (each
width-16 bf16 kernel is timed from the source that defines it, in a
package from before flash_narrow.cu), so change, parent, parent, change in
one call times two commits' narrow kernels, cuDNN beside them, the tiny
edits with the switch off and on and the tiny bf16 steps, in turns.

    python3 chip_smoke.py --workflow-only

builds the kernels and runs phases 8-10 alone (about 2 minutes).

    python3 chip_smoke.py --d512-only [--package-root DIR]
    python3 chip_smoke.py --d256-only [--package-root DIR]

build the kernels and run phases 3c, 3e and 8a, or 3d, 3e and 8b, alone
(a few minutes) and print their kernels line; with --package-root from
another checkout's package, so change, parent, parent, change in one call
times two commits' wide kernels in turns on one card (a checkout from
before the head_dim-256 forwards took their own tile is held at its one
32-row tile, in its one block layout).

    python3 chip_smoke.py --eval-only

builds the kernels and runs phases 11-13 alone; phase 13 then certifies a
full-width random-init layout exported by export_diffusers_layout.

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
3a, 3b, 3c-3e, 3f-3h and 3i alone (those the package has); with
--package-root another checkout's kernels, so two commits' kernels can be
compared and timed in turns on one card.

    python3 chip_smoke.py --fused-only [--package-root DIR]

builds the kernels and runs phase 3b alone (about a minute).

    python3 chip_smoke.py --fused-host 20 [--package-root DIR]

times the host's side of one fused-conv half (ResnetBlock2D) and one biased
int8 layer (QuantLinear) at the most launched shapes of a flagged pass, and
of one GroupNorm statistics call and one GN+SiLU call at (1, 320, 64^2).

    python3 chip_smoke.py --flash-host 20 [--package-root DIR]

times the host's side of the serving path's attention call (no-grad
dot_product_attention on (1, S, H, D) projections, then the caller's
reshape to (1, S, H*D)) at a 512^2 edit's two flash shapes and the small
VAE mid-block's at 256^2 (D = 256): 20 rounds of 100 calls, the host's
seconds to queue them and the seconds until the card is done, per call.
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
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> dict:
    """The least time the card could take: operations over the peak (bf16
    by default) or bytes (inputs read once, outputs written once) over the
    memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
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


# (BH, S, T): PIPELINED_SHAPES, a ragged one, and the small-scale eval's
# 256^2 edits (small_config: 2 heads at 4096 tokens, 4 at 1024)
FORWARD_SHAPES = [(5, 4096, 4096), (10, 1024, 1024), (4, 1000, 577),
                  (20, 4096, 4096), (40, 1024, 1024), (5, 9216, 9216),
                  (10, 2304, 2304), (5, 16384, 16384), (10, 4096, 4096),
                  (20, 1024, 1024), (2, 4096, 4096), (4, 1024, 1024)]


def strided_qkv(g, dev, b=2, s=4096, h=5, n=3, d=64):
    """q, k, v (and with n = 4 a dO) as (B, S, H, d) views of one packed
    (B, S, n * H * d) projection, the serving layout at its least
    contiguous."""
    x = torch.randn((b, s, n * h * d), generator=g, device=dev,
                    dtype=torch.bfloat16).view(b, s, n, h, d)
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


# (B*H, S, T) at the wide head_dims, the VAE mid-block's single head.  At
# 512 (SD2 width): a 512^2 encode or decode (batch 1), stage 1's step
# (batch 4), a 1024^2 decode, and a ragged shape.  At 256 (small_config): a
# 256^2 encode or decode (batch 1), stage 1's step (batch 16), and a ragged
# shape.
WIDE_FORWARD_SHAPES = {
    512: [(1, 4096, 4096), (4, 4096, 4096), (1, 16384, 16384),
          (2, 1000, 1500)],
    256: [(1, 4096, 4096), (16, 4096, 4096), (2, 1000, 1500)]}
WIDE_BACKWARD_SHAPES = {512: [(4, 4096, 4096), (2, 1000, 1500)],
                        256: [(16, 4096, 4096), (2, 1000, 1500)]}


def sdpa_wide(q, k, v):
    """The library's call for a wide head_dim forward's function (a
    yardstick), on (BH, L, D) tensors as one head each."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None],
                                          scale=q.shape[-1] ** -0.5)[:, 0]


def sdpa_backends(q, k, v) -> dict:
    """Which backend scaled_dot_product_attention picks for these inputs,
    and which of its fused backends take them at all."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    names = {m.value: name for name, m in SDPBackend.__members__.items()}
    args = (q[:, None], k[:, None], v[:, None])
    try:
        picked = names.get(int(torch._fused_sdp_choice(
            *args, scale=q.shape[-1] ** -0.5)), "unknown")
    except Exception as exc:  # a private function: its absence is reported
        picked = f"unknown ({type(exc).__name__})"
    takes = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION"):
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                sdpa_wide(q, k, v)
            takes[name] = True
        except RuntimeError:
            takes[name] = False
    return {"picked": picked, "takes": takes}


def wide_source(d: int, backward: bool = False) -> str:
    """The source of the head_dim-``d`` forwards (or, ``backward``, of dq
    and dk/dv) in the checkout run: at 256 csrc/flash_d256_sm90.cu and
    csrc/flash_d256_bwd_sm90.cu, where the checkout has them (a checkout
    from before the backward's own source runs it from flash_wide.cu)."""
    from diffute_tpu_torch.ops import _build

    source = "flash_wide.cu"
    if d == 256:
        source = "flash_d256_bwd_sm90.cu" if backward else "flash_d256_sm90.cu"
    if not os.path.exists(os.path.join(_build.CSRC, source)):
        source = "flash_wide.cu"
    return source


def fwd_layouts(d: int) -> tuple:
    """The block layouts (consumer warpgroups a block) in which phases 3d
    and 3e hold the head_dim-``d`` forwards besides the launcher's route:
    1 and 2 at 256 (csrc/flash_d256_sm90.cu), none at 512."""
    return (1, 2) if d == 256 else ()


def check_layouts(fa, layouts, q, k, v, sc, pipelined, ro, rlse, o, lse,
                  time_it=True) -> dict:
    """Each block layout of the head_dim-256 forward (the deferred one with
    ``pipelined``) on (B, L, H, 256) q, k, v: within the kernel criteria of
    the plain version (``ro``, ``rlse``, (BH, S, 256)), the same bits twice,
    and the bits of the launcher's route (``o``, ``lse``); timed.  Raises
    on a layout that fails."""
    out = {}
    for c in layouts:
        def run(c=c):
            return fa.flash_fwd_layout(q, k, v, sc, c, pipelined)
        lo, llse = run()
        lo2, llse2 = run()
        torch.cuda.synchronize()
        lse_err = (llse - rlse).abs().max().item()
        rec = dict(**bwd_errors(fa._to3d(lo), ro, FUSED_HALF_ULPS),
                   max_abs_err_lse=lse_err,
                   same_bits_twice=(torch.equal(lo, lo2)
                                    and torch.equal(llse, llse2)),
                   route_bits=torch.equal(lo, o) and torch.equal(llse, lse))
        if time_it:
            rec["ms"] = time_ms(run)
        del lo, lo2, llse, llse2
        if not (fwd_ok(rec, lse_err) and rec["same_bits_twice"]
                and rec["route_bits"]):
            kind = "deferred" if pipelined else "standard"
            raise RuntimeError(f"the head_dim-256 {kind} forward with {c} "
                               f"consumer warpgroup(s) a block disagrees: "
                               f"{rec}")
        out[str(c)] = rec
    return out


_PTXAS_SHOWN = set()


def show_ptxas(source: str) -> None:
    """Print what ptxas says of ``source`` once a run (the first phase that
    checks one of its kernels prints it)."""
    from diffute_tpu_torch.ops import _build

    if source not in _PTXAS_SHOWN:
        _PTXAS_SHOWN.add(source)
        phase("ptxas", source=source, info=_build.ptxas_info(source))


def check_wide(dev, d: int) -> dict:
    """Phase 3c (d = 512) or 3d (d = 256): the wide head_dim kernels
    (csrc/flash_wide.cu; at 256 the forwards csrc/flash_d256_sm90.cu, dq
    and dk/dv csrc/flash_d256_bwd_sm90.cu) against their tiled plain
    versions at each kernel's kv tile (kernel_block_kv), at the head_dim-64
    criteria: the forward at
    WIDE_FORWARD_SHAPES (3 half-ulps, relative L2 2e-3, LSE 1e-4), dq (with
    delta), dk/dv and the pair at WIDE_BACKWARD_SHAPES (3 half-ulps,
    relative L2 1e-3, delta 1e-5; fed the tiled plain forward's o and
    LSE); the same bits twice; mutants of the plain
    versions (the LSE left in base 2, the last kv tile never consumed, dk x
    1.02) must fail; strided (B, S, 1, d) views of a packed projection read
    without a copy, bit for bit the contiguous route.  At 256 the forward
    is also held in both block layouts (check_layouts: one and two consumer
    warpgroups a block), each the launcher's bits, the strided views too.
    Each timed beside its plain one-pass version, its bound and SDPA (whose
    backend is recorded).  Returns {"fwd" | "dq" | "dkv": [result per
    shape]}."""
    fa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")
    bkv, fwd_bkv = (fa.kernel_block_kv(d, torch.bfloat16, kind)
                    for kind in ("bwd_dq", "fwd"))
    layouts = fwd_layouts(d)
    sc = d ** -0.5
    for source in dict.fromkeys((wide_source(d), wide_source(d, True),
                                 wide_source(512))):
        show_ptxas(source)
    g = torch.Generator(device=dev).manual_seed(5)
    out = {"fwd": [], "dq": [], "dkv": []}

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    for bh, s, t in WIDE_FORWARD_SHAPES[d]:
        q, k, v = randn(bh, s, d), randn(bh, t, d), randn(bh, t, d)
        o, lse = fa.flash_fwd_3d(q, k, v, sc)
        o2, lse2 = fa.flash_fwd_3d(q, k, v, sc)
        torch.cuda.synchronize()
        ro, rlse = fa.flash_fwd_tiled_reference(q, k, v, sc, fwd_bkv)
        lse_err = (lse - rlse).abs().max().item()
        big = bh * s * t >= 2 ** 28
        res = dict(shape=[bh, s, t, d], block_kv=fwd_bkv,
                   **bwd_errors(o, ro, FUSED_HALF_ULPS),
                   max_abs_err_lse=lse_err,
                   same_bits_twice=(torch.equal(o, o2)
                                    and torch.equal(lse, lse2)),
                   ms=time_ms(lambda: fa.flash_fwd_3d(q, k, v, sc)),
                   plain_ms=time_ms(
                       lambda: fa.flash_attention_reference(q, k, v, sc),
                       iters=5 if big else 25),
                   library_ms=time_ms(lambda: sdpa_wide(q, k, v),
                                      iters=5 if big else 25),
                   library_call="scaled_dot_product_attention",
                   sdpa=sdpa_backends(q, k, v),
                   **bound(4 * s * t * d * bh,
                           2 * d * bh * (2 * s + 2 * t) + 4 * bh * s))
        res["share_of_bound"] = res["bound_ms"] / res["ms"]
        if layouts:
            res["consumers"] = fa.d256_consumers(bh, s)
            res["layouts"] = check_layouts(
                fa, layouts, *(x[:, :, None] for x in (q, k, v)), sc, False,
                ro, rlse, o[:, :, None], lse)
        if not out["fwd"]:
            base2 = (rlse / 0.6931471805599453 - rlse).abs().max().item()
            mo, mlse = fa.flash_fwd_tiled_reference(
                q, k[:, :-fwd_bkv], v[:, :-fwd_bkv], sc, fwd_bkv)
            dropped = bwd_errors(mo, ro, FUSED_HALF_ULPS)
            m_lse = (mlse - rlse).abs().max().item()
            if base2 <= TOL_FWD_LSE or fwd_ok(dropped, m_lse):
                raise RuntimeError(f"the criterion passes a mutant: base-2 "
                                   f"LSE {base2}, last tile dropped {dropped}")
            res["mutants"] = {
                "lse_base2_abs": base2,
                "last_tile_dropped_rel_l2": dropped["rel_l2_err"],
                "last_tile_dropped_lse_abs": m_lse}
        del ro, rlse, o2, lse2
        phase(f"kernel_fwd_d{d}", **res)
        if not (fwd_ok(res, lse_err) and res["same_bits_twice"]):
            raise RuntimeError(f"the head_dim-{d} forward disagrees: {res}")
        out["fwd"].append(res)

    for bh, s, t in WIDE_BACKWARD_SHAPES[d]:
        q, k, v, do = (randn(bh, n, d) for n in (s, t, t, s))
        # o and the LSE of the tiled plain forward at the forwards' tile:
        # the backward kernels' inputs whatever forward kernel the checkout
        # has, so two checkouts' backward rows compare on the same inputs
        o, lse = fa.flash_fwd_tiled_reference(q, k, v, sc, fwd_bkv)

        def run_dq():
            return fa.flash_bwd_dq_3d(q, k, v, o, lse, do, sc)
        dq, delta = run_dq()

        def run_dkv():
            return fa.flash_bwd_dkv_3d(q, k, v, do, lse, delta, sc)
        dk, dv = run_dkv()
        again = (*run_dq(), *run_dkv())
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip((dq, delta, dk, dv),
                                                     again))
        rq, rk, rv = fa.flash_bwd_tiled_reference(q, k, v, o, lse, do, sc, bkv)
        err = {n: bwd_errors(a, b)
               for n, a, b in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv))}
        delta_err = (delta - fa._delta(o, do)).abs().max().item()
        args = (q, k, v, do, lse, delta, sc)
        try:
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            lib_out = sdpa_wide(*leaves)
            library_ms = time_ms(lambda: torch.autograd.grad(
                lib_out, leaves, do, retain_graph=True), iters=5)
            del lib_out, leaves
        except RuntimeError as exc:  # the library may refuse the width
            library_ms = None
            phase(f"sdpa_backward_d{d}", error=str(exc)[:200])
        io, st = 2 * d * bh, 4 * bh
        common = dict(shape=[bh, s, t, d], library_ms=library_ms,
                      library_call="autograd.grad through "
                      "scaled_dot_product_attention: dq, dk and dv together",
                      same_bits_twice=same)
        res_dq = dict(common, **err["dq"], max_abs_err_delta=delta_err,
                      ms=time_ms(run_dq),
                      plain_ms=time_ms(
                          lambda: fa.flash_bwd_dq_reference(*args), iters=5),
                      **bound(6 * s * t * d * bh,
                              io * (4 * s + 2 * t) + st * 2 * s))
        res_dkv = dict(common, max_abs_err=max(err["dk"]["max_abs_err"],
                                               err["dv"]["max_abs_err"]),
                       dk=err["dk"], dv=err["dv"], ms=time_ms(run_dkv),
                       plain_ms=time_ms(
                           lambda: fa.flash_bwd_dkv_reference(*args), iters=5),
                       **bound(8 * s * t * d * bh,
                               io * (2 * s + 4 * t) + st * 2 * s))
        pair = dict(shape=[bh, s, t, d], library_ms=library_ms,
                    ms=time_ms(lambda: fa.flash_bwd_3d(q, k, v, o, lse, do,
                                                       sc)),
                    dq_plus_dkv_ms=res_dq["ms"] + res_dkv["ms"],
                    **bound(10 * s * t * d * bh,
                            io * (4 * s + 4 * t) + st * s))
        for r in (res_dq, res_dkv, pair):
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
        if not out["dq"]:
            scaled = bwd_errors(rk.float() * 1.02, rk)
            if bwd_ok(scaled):
                raise RuntimeError(f"the criterion passes dk x 1.02: {scaled}")
            res_dkv["mutants"] = {
                "dk_scaled_1.02_rel_l2": scaled["rel_l2_err"]}
        del rq, rk, rv, again
        phase(f"kernel_bwd_dq_d{d}", **res_dq)
        phase(f"kernel_bwd_dkv_d{d}", **res_dkv)
        phase(f"kernel_bwd_pair_d{d}", **pair)
        if not (all(bwd_ok(e) for e in err.values()) and delta_err <= TOL_DELTA
                and same):
            raise RuntimeError(f"the head_dim-{d} backward disagrees at "
                               f"{(bh, s, t)}: {err}, delta {delta_err}, "
                               f"same bits twice {same}")
        out["dq"].append(res_dq)
        out["dkv"].append(res_dkv)

    # q, k, v, dO as (B, S, 1, d) views of one packed (B, S, 4 * d)
    # projection: no copy, and the contiguous route's bits
    q4, k4, v4, do4 = strided_qkv(g, dev, b=2, s=4096, h=1, n=4, d=d)
    o4, lse4 = fa.flash_fwd(q4, k4, v4, sc)
    grads = fa.flash_bwd(q4, k4, v4, o4, lse4, do4, sc)
    flat = [x.contiguous() for x in (q4, k4, v4, do4)]
    fo, flse = fa.flash_fwd(*flat[:3], sc)
    fgrads = fa.flash_bwd(*flat[:3], fo, flse, flat[3], sc)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_fwd_tiled_reference(
        *(fa._to3d(x) for x in (q4, k4, v4)), sc, fwd_bkv)
    ref = fa.flash_bwd_tiled_reference(
        *(fa._to3d(x) for x in (q4, k4, v4, o4)), lse4, fa._to3d(do4), sc, bkv)
    err = {n: bwd_errors(fa._to3d(a), b)
           for n, a, b in zip(("dq", "dk", "dv"), grads, ref)}
    # each block layout on the strided views: the contiguous route's bits
    layout_res = check_layouts(fa, layouts, q4, k4, v4, sc, False, ro, rlse,
                               fo, flse, time_it=False)
    res = dict(shape=list(q4.shape), strides=list(q4.stride()),
               **bwd_errors(fa._to3d(o4), ro, FUSED_HALF_ULPS),
               max_abs_err_lse=(lse4 - rlse).abs().max().item(), grads=err,
               out_contiguous=all(x.is_contiguous() for x in (o4, *grads)),
               contiguous_route_bits=torch.equal(o4, fo) and all(
                   torch.equal(a, b) for a, b in zip(grads, fgrads)),
               **({"layouts": layout_res} if layouts else {}))
    phase(f"kernel_d{d}_strided", **res)
    if not (fwd_ok(res, res["max_abs_err_lse"])
            and all(bwd_ok(e) for e in err.values())
            and res["out_contiguous"] and res["contiguous_route_bits"]):
        raise RuntimeError(f"the head_dim-{d} kernels on strided views "
                           f"disagree: {res}")
    out["fwd"].append(res)
    out["dq"].append(dict(res, max_abs_err=err["dq"]["max_abs_err"]))
    out["dkv"].append(dict(res, max_abs_err=max(err["dk"]["max_abs_err"],
                                                err["dv"]["max_abs_err"])))
    return out


def wrong_parity(fa, q, k, v, sc, bkv):
    """A mutant of the deferred forward's plain version: tile j's softmax
    takes tile j - 1's scores (the partial buffer of the wrong parity), with
    v_j."""
    shifted = torch.cat([k[:, :bkv], k[:, :-bkv]], 1)
    return fa.flash_fwd_tiled_reference(q, shifted, v, sc, bkv)


def check_wide_pipelined(dev, d: int) -> list:
    """Phase 3e: the deferred-softmax forward at head_dim ``d``
    (csrc/flash_wide.cu's fwd_deferred_kernel at 512,
    csrc/flash_d256_sm90.cu's deferred schedule at 256) at the
    WIDE_FORWARD_SHAPES the dispatch rule takes, against its plain version
    at the kernel's kv tile (pipelined_block_kv) at the kernel criteria (3
    half-ulps, relative L2 2e-3, LSE 1e-4) and against the standard wide
    forward on the same inputs: the same arithmetic in another order, so
    the same bits; the same bits twice; mutants of the plain version (the
    LSE left in base 2, the last kv tile never consumed, tile j's softmax
    on tile j - 1's scores) must fail.  Strided (B, S, 1, d) views read
    through the PIPELINE_FWD dispatch bit for bit as the contiguous call,
    and the ragged (2, 1000, 1500), which the rule refuses, goes to the
    standard kernel and is counted there.  At 256 all of it holds in both
    block layouts too (check_layouts), each the standard forward's bits.
    Each shape timed beside the standard forward, the plain one-pass
    version, the bound and SDPA."""
    fa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")
    bkv, sc = fa.pipelined_block_kv(d), d ** -0.5
    layouts = fwd_layouts(d)
    show_ptxas(wide_source(d))
    g = torch.Generator(device=dev).manual_seed(6)
    out = []

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    def pipelined(q, k, v):
        return fa.flash_fwd_3d_pipelined(q, k, v, sc)

    for bh, s, t in WIDE_FORWARD_SHAPES[d]:
        if not fa._pipelined_takes(t, d):
            continue
        q, k, v = randn(bh, s, d), randn(bh, t, d), randn(bh, t, d)
        reset_counters()
        o, lse = pipelined(q, k, v)
        o2, lse2 = pipelined(q, k, v)
        so, slse = fa.flash_fwd_3d(q, k, v, sc)
        torch.cuda.synchronize()
        launches = counters()
        ro, rlse = fa.flash_fwd_pipelined_reference(q, k, v, sc, bkv)
        lse_err = (lse - rlse).abs().max().item()
        big = bh * s * t >= 2 ** 28
        res = dict(shape=[bh, s, t, d], block_kv=bkv,
                   **bwd_errors(o, ro, FUSED_HALF_ULPS),
                   max_abs_err_lse=lse_err,
                   same_bits_twice=(torch.equal(o, o2)
                                    and torch.equal(lse, lse2)),
                   equals_standard=(torch.equal(o, so)
                                    and torch.equal(lse, slse)),
                   vs_standard=dict(bwd_errors(o, so, FUSED_HALF_ULPS),
                                    max_abs_err_lse=(lse - slse).abs().max()
                                    .item()),
                   ms=time_ms(lambda: pipelined(q, k, v)),
                   standard_ms=time_ms(lambda: fa.flash_fwd_3d(q, k, v, sc)),
                   plain_ms=time_ms(
                       lambda: fa.flash_attention_reference(q, k, v, sc),
                       iters=5 if big else 25),
                   library_ms=time_ms(lambda: sdpa_wide(q, k, v),
                                      iters=5 if big else 25),
                   library_call="scaled_dot_product_attention",
                   sdpa=sdpa_backends(q, k, v),
                   **bound(4 * s * t * d * bh,
                           2 * d * bh * (2 * s + 2 * t) + 4 * bh * s))
        res["share_of_bound"] = res["bound_ms"] / res["ms"]
        if layouts:
            res["consumers"] = fa.d256_consumers(bh, s)
            res["layouts"] = check_layouts(
                fa, layouts, *(x[:, :, None] for x in (q, k, v)), sc, True,
                ro, rlse, so[:, :, None], slse)
        if not out:
            base2 = (rlse / 0.6931471805599453 - rlse).abs().max().item()
            mo, mlse = fa.flash_fwd_tiled_reference(q, k[:, :-bkv],
                                                    v[:, :-bkv], sc, bkv)
            dropped = bwd_errors(mo, ro, FUSED_HALF_ULPS)
            m_lse = (mlse - rlse).abs().max().item()
            wo, wlse = wrong_parity(fa, q, k, v, sc, bkv)
            parity = bwd_errors(wo, ro, FUSED_HALF_ULPS)
            w_lse = (wlse - rlse).abs().max().item()
            if (base2 <= TOL_FWD_LSE or fwd_ok(dropped, m_lse)
                    or fwd_ok(parity, w_lse)):
                raise RuntimeError(f"the criterion passes a mutant: base-2 "
                                   f"LSE {base2}, last tile dropped "
                                   f"{dropped}, wrong parity {parity}")
            res["mutants"] = {
                "lse_base2_abs": base2,
                "last_tile_dropped_rel_l2": dropped["rel_l2_err"],
                "last_tile_dropped_lse_abs": m_lse,
                "wrong_parity_rel_l2": parity["rel_l2_err"],
                "wrong_parity_lse_abs": w_lse}
        del ro, rlse, o2, lse2, so, slse
        phase(f"kernel_fwd_pipelined_d{d}", **res)
        expect_flash({"launches": launches},
                     **{f"flash_fwd_pipelined_d{d}": 2, f"flash_fwd_d{d}": 1})
        if not (fwd_ok(res, lse_err) and res["same_bits_twice"]
                and res["equals_standard"]):
            raise RuntimeError(f"the head_dim-{d} deferred forward disagrees: "
                               f"{res}")
        out.append(res)

    # q, k, v as (B, S, 1, d) views of one packed (B, S, 3 * d) projection,
    # through the dispatch with the switch on: no copy, the contiguous
    # call's bits; then the ragged shape, which the rule sends to the
    # standard kernel
    q4, k4, v4 = strided_qkv(g, dev, b=2, s=4096, h=1, n=3, d=d)
    qr, kr, vr = randn(2, 1000, d), randn(2, 1500, d), randn(2, 1500, d)
    with pipeline_fwd(True):
        reset_counters()
        o4, lse4 = fa.flash_fwd(q4, k4, v4, sc)
        fo, flse = fa.flash_fwd(*(x.contiguous() for x in (q4, k4, v4)), sc)
        torch.cuda.synchronize()
        strided_launches = counters()
        reset_counters()
        ragged = fa.flash_fwd_3d(qr, kr, vr, sc)
        torch.cuda.synchronize()
        ragged_launches = counters()
    ragged_std = fa.flash_fwd_3d(qr, kr, vr, sc)
    ro, rlse = fa.flash_fwd_pipelined_reference(
        *(fa._to3d(x) for x in (q4, k4, v4)), sc, bkv)
    # each block layout on the strided views: the contiguous call's bits
    layout_res = check_layouts(fa, layouts, q4, k4, v4, sc, True, ro, rlse,
                               fo, flse, time_it=False)
    res = dict(shape=list(q4.shape), strides=list(q4.stride()),
               **bwd_errors(fa._to3d(o4), ro, FUSED_HALF_ULPS),
               max_abs_err_lse=(lse4 - rlse).abs().max().item(),
               out_contiguous=o4.is_contiguous(),
               contiguous_route_bits=(torch.equal(o4, fo)
                                      and torch.equal(lse4, flse)),
               ragged_shape=[2, 1000, 1500, d],
               ragged_equals_standard=all(
                   torch.equal(a, b) for a, b in zip(ragged, ragged_std)),
               **({"layouts": layout_res} if layouts else {}))
    phase(f"kernel_fwd_pipelined_d{d}_strided", **res)
    expect_flash({"launches": strided_launches},
                 **{f"flash_fwd_pipelined_d{d}": 2})
    expect_flash({"launches": ragged_launches}, **{f"flash_fwd_d{d}": 1})
    if not (fwd_ok(res, res["max_abs_err_lse"]) and res["out_contiguous"]
            and res["contiguous_route_bits"]
            and res["ragged_equals_standard"]):
        raise RuntimeError(f"the head_dim-{d} deferred forward on strided "
                           f"views or the ragged dispatch disagrees: {res}")
    out.append(res)
    return out


# ---- phase 3f: the fp32 kernels (csrc/flash_fp32.cu and the sources at 64
# and 512 that fp32_source names)
# (B*H, S, T) by head_dim: the forwards at the 512^2 edit's and the training
# step's shapes (64: batch 1 and 4, 5 heads at 4096 tokens, 10 at 1024), the
# VAE mid-block's (512: encode/decode at 512^2, stage 1 at batch 4, 1024^2;
# 256: small_config at 256^2, batch 16) and a ragged one; the backward at
# the training steps' shapes and the ragged one.  The deferred forward runs
# at the forward shapes its dispatch rule takes.
FP32_FORWARD_SHAPES = {
    64: [(5, 4096, 4096), (10, 1024, 1024), (20, 4096, 4096),
         (40, 1024, 1024), (4, 1000, 577)],
    256: [(1, 4096, 4096), (16, 4096, 4096), (2, 1000, 1500)],
    512: [(1, 4096, 4096), (4, 4096, 4096), (1, 16384, 16384),
          (2, 1000, 1500)]}
FP32_BACKWARD_SHAPES = {64: [(20, 4096, 4096), (40, 1024, 1024),
                             (4, 1000, 577)],
                        256: [(16, 4096, 4096), (2, 1000, 1500)],
                        512: [(4, 4096, 4096), (2, 1000, 1500)]}
# the precision contract of csrc/flash_fp32.cu: o, dq, dk, dv within
# relative L2 TOL_FP32_REL_L2 of the plain fp32 version at the same domain,
# the LSE (and delta) within TOL_FP32_ABS; TF32 alone reads about 1e-3
TOL_FP32_REL_L2, TOL_FP32_ABS = 1e-5, 1e-5
# the H100 SXM's dense TF32 rate over the three products fp32 accuracy
# takes (3xTF32): the fp32 kernels' operations bound
PEAK_FP32_FLOPS = 494.7e12 / 3
FP32_KINDS = ("fwd", "fwd_pipelined", "bwd_dq", "bwd_dkv")
FP32_WIDTHS = (64, 256, 512)
# the TPU kernel each kind replaces (diffute_tpu/ops/flash_attention.py)
FP32_REPLACES = {"fwd": 275, "fwd_pipelined": 149, "bwd_dq": 396,
                 "bwd_dkv": 437}
# the fp32 backward pairs and the two fp32 forwards at head_dims 512 and
# 256, and the fp32 backward pair at 64 (a package from before has them in
# flash_fp32.cu)
FP32_D512_BWD_SOURCE = "flash_fp32_d512_bwd_sm90.cu"
FP32_D512_FWD_SOURCE = "flash_fp32_d512_sm90.cu"
FP32_D64_BWD_SOURCE = "flash_fp32_d64_bwd_sm90.cu"
FP32_D256_BWD_SOURCE = "flash_fp32_d256_bwd_sm90.cu"
FP32_D256_FWD_SOURCE = "flash_fp32_d256_sm90.cu"


def fp32_source(kind: str, d: int) -> str:
    """The source under csrc/ of the imported package that holds an fp32
    kernel."""
    from diffute_tpu_torch.ops import _build

    bwd = kind.startswith("bwd")
    source = {512: FP32_D512_BWD_SOURCE if bwd else FP32_D512_FWD_SOURCE,
              256: FP32_D256_BWD_SOURCE if bwd else FP32_D256_FWD_SOURCE,
              64: FP32_D64_BWD_SOURCE if bwd else None}.get(d)
    if source and os.path.exists(os.path.join(_build.CSRC, source)):
        return source
    return "flash_fp32.cu"


def fp32_errors(got: torch.Tensor, ref: torch.Tensor) -> dict:
    diff = got.float() - ref.float()
    return {"max_abs_err": diff.abs().max().item(),
            "rel_l2_err": (diff.norm() / ref.float().norm()).item()}


def fp32_held(err: dict) -> bool:
    return err["rel_l2_err"] <= TOL_FP32_REL_L2


def fp32_entry(kind: str, d: int) -> str:
    """The C entry (and counters() key) of an fp32 kernel."""
    return f"flash_{kind}" + ("" if d == 64 else f"_d{d}") + "_fp32"


def fp32_counter(kind: str, d: int) -> str:
    """The flash_attention attribute that counts fp32_entry's launches."""
    return ("fp32_" + ("" if d == 64 else f"d{d}_")
            + {"fwd": "", "fwd_pipelined": "pipelined_"}.get(kind, kind + "_")
            + "launches")


def check_fp32(dev, widths=FP32_WIDTHS) -> dict:
    """Phase 3f: the fp32 flash kernels (3xTF32: at 64 the forwards
    csrc/flash_fp32.cu and the backward pair csrc/flash_fp32_d64_bwd_sm90.cu;
    at 256 and 512 the forwards csrc/flash_fp32_d{256,512}_sm90.cu and the
    backward pairs csrc/flash_fp32_d{256,512}_bwd_sm90.cu; fp32_source
    names each) at head_dims
    ``widths`` (64, 256 and 512) against their plain fp32 versions at each
    kernel's kv tile (kernel_block_kv by kind) and at the same domain (the
    standard forward and the backward natural, the deferred forward base 2
    on prescaled q), to the precision contract (TOL_FP32_REL_L2, TOL_FP32_ABS
    on the LSE and delta), the same bits twice, at FP32_FORWARD_SHAPES and
    FP32_BACKWARD_SHAPES; the mutants (every product's operands rounded to
    TF32, the LSE left in base 2, the last kv tile never consumed by a
    forward or by dq, dk x (1 + 1e-4), the deferred forward's scores taken
    in the natural domain) must fail; strided (B, S, H, d) views of a packed projection give the
    contiguous route's bits, the switch on too.  Each timed (CUDA-event
    medians of 25; 5 for the largest) beside its plain one-pass version,
    SDPA on the same fp32 inputs with TF32 off (its backend recorded) and
    the bound at PEAK_FP32_FLOPS; at 256 and 512 each kernel's clusters
    the card runs at once (cudaOccupancyMaxActiveClusters) and the backward
    pair also on the tiled plain forward's o and LSE at the pair's tile (no
    forward kernel moves those errors), held to the same contract.  Returns
    {entry name: [result per shape]}."""
    from diffute_tpu_torch.ops import _build

    fa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for source in sorted({fp32_source(kind, d) for d in widths
                          for kind in FP32_KINDS}):
        show_ptxas(source)
    lib = _build.load()
    clusters = {d: {"dq": getattr(lib, q)(0), "dkv": getattr(lib, q)(1)}
                for d, q in ((512, "flash_bwd_d512_fp32_max_clusters"),
                             (256, "flash_bwd_d256_fp32_max_clusters"))
                if hasattr(lib, q)}
    fwd_clusters = {d: {kind: getattr(lib, q)(i)
                        for i, kind in enumerate(("fwd", "fwd_pipelined"))}
                    for d, q in ((512, "flash_fwd_d512_fp32_max_clusters"),
                                 (256, "flash_fwd_d256_fp32_max_clusters"))
                    if hasattr(lib, q)}
    g = torch.Generator(device=dev).manual_seed(8)
    out = {fp32_entry(kind, d): [] for d in widths for kind in FP32_KINDS}

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def must_fail(name, err, lse_err=0.0):
        if fp32_held(err) and lse_err <= TOL_FP32_ABS:
            raise RuntimeError(f"the fp32 criterion passes the mutant "
                               f"{name}: {err}, LSE {lse_err}")
        return err["rel_l2_err"]

    for d in widths:
        # each kernel at its own tile (kernel_block_kv by kind)
        sc = d ** -0.5
        bkv, bwd_bkv = (fa.kernel_block_kv(d, torch.float32, kind)
                        for kind in ("fwd", "bwd_dq"))
        for bh, s, t in FP32_FORWARD_SHAPES[d]:
            q, k, v = randn(bh, s, d), randn(bh, t, d), randn(bh, t, d)
            big = bh * s * t >= 2 ** 28
            common = dict(
                shape=[bh, s, t, d],
                plain_ms=time_ms(
                    lambda: fa.flash_attention_reference(q, k, v, sc),
                    iters=5 if big else 25),
                library_ms=time_ms(lambda: sdpa_wide(q, k, v),
                                   iters=5 if big else 25),
                library_call="scaled_dot_product_attention, fp32, TF32 off",
                sdpa=sdpa_backends(q, k, v),
                **bound(4 * s * t * d * bh,
                        4 * d * bh * (2 * s + 2 * t) + 4 * bh * s,
                        PEAK_FP32_FLOPS))
            for kind in ("fwd", "fwd_pipelined"):
                pipelined = kind == "fwd_pipelined"
                if pipelined and not fa._pipelined_takes(t, d):
                    continue
                name = fp32_entry(kind, d)

                def run():
                    if pipelined:
                        return fa.flash_fwd_3d_pipelined(q, k, v, sc)
                    return fa.flash_fwd_3d(q, k, v, sc)
                reset_counters()
                o, lse = run()
                o2, lse2 = run()
                torch.cuda.synchronize()
                launches = counters()
                domain = "prescaled" if pipelined else "natural"
                ro, rlse = fa.flash_fwd_tiled_reference(q, k, v, sc, bkv,
                                                        domain)
                lse_err = (lse - rlse).abs().max().item()
                res = dict(common, **fp32_errors(o, ro),
                           max_abs_err_lse=lse_err,
                           same_bits_twice=(torch.equal(o, o2)
                                            and torch.equal(lse, lse2)),
                           ms=time_ms(run), domain=domain)
                res["share_of_bound"] = res["bound_ms"] / res["ms"]
                if d in fwd_clusters:
                    res["max_active_clusters"] = fwd_clusters[d][kind]
                if not out[name]:
                    mo, mlse = fa.flash_fwd_tiled_reference(
                        q, k, v, sc, bkv, domain, tf32=True)
                    res["mutants"] = {"tf32_rel_l2": must_fail(
                        "tf32", fp32_errors(mo, ro),
                        (mlse - rlse).abs().max().item())}
                    res["mutants"]["lse_base2_abs"] = (
                        rlse / 0.6931471805599453 - rlse).abs().max().item()
                    if res["mutants"]["lse_base2_abs"] <= TOL_FP32_ABS:
                        raise RuntimeError("the criterion passes a base-2 LSE")
                    mo, mlse = fa.flash_fwd_tiled_reference(
                        q, k[:, :-bkv], v[:, :-bkv], sc, bkv, domain)
                    res["mutants"]["last_tile_dropped_rel_l2"] = must_fail(
                        "last tile dropped", fp32_errors(mo, ro),
                        (mlse - rlse).abs().max().item())
                    if pipelined:
                        mo, mlse = fa.flash_fwd_tiled_reference(
                            q * (sc * 1.4426950408889634), k, v, 1.0, bkv,
                            "natural")
                        res["mutants"]["natural_on_prescaled_rel_l2"] = (
                            must_fail("natural domain on prescaled q",
                                      fp32_errors(mo, ro),
                                      (mlse - rlse).abs().max().item()))
                del ro, rlse, o2, lse2
                phase(f"kernel_{name}", **res)
                expect_flash({"launches": launches}, **{name: 2})
                if not (fp32_held(res) and lse_err <= TOL_FP32_ABS
                        and res["same_bits_twice"]):
                    raise RuntimeError(f"{name} disagrees at {(bh, s, t)}: "
                                       f"{res}")
                out[name].append(res)
            del q, k, v

        dq_name, dkv_name = fp32_entry("bwd_dq", d), fp32_entry("bwd_dkv", d)
        for bh, s, t in FP32_BACKWARD_SHAPES[d]:
            q, k, v, do = (randn(bh, n, d) for n in (s, t, t, s))
            o, lse = fa.flash_fwd_3d(q, k, v, sc)

            def run_dq():
                return fa.flash_bwd_dq_3d(q, k, v, o, lse, do, sc)
            reset_counters()
            dq, delta = run_dq()

            def run_dkv():
                return fa.flash_bwd_dkv_3d(q, k, v, do, lse, delta, sc)
            dk, dv = run_dkv()
            again = (*run_dq(), *run_dkv())
            torch.cuda.synchronize()
            launches = counters()
            same = all(torch.equal(a, b)
                       for a, b in zip((dq, delta, dk, dv), again))
            ref = fa.flash_bwd_tiled_reference(q, k, v, o, lse, do, sc,
                                               bwd_bkv)
            err = {n: fp32_errors(a, b)
                   for n, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), ref)}
            delta_err = (delta - fa._delta(o, do)).abs().max().item()
            on_plain = {}
            if d in (256, 512):
                # the pair on the tiled plain forward's o and LSE at the
                # pair's tile, which no forward kernel's bits move
                po, plse = fa.flash_fwd_tiled_reference(q, k, v, sc, bwd_bkv)
                pdq, pdelta = fa.flash_bwd_dq_3d(q, k, v, po, plse, do, sc)
                pgrads = (pdq, *fa.flash_bwd_dkv_3d(q, k, v, do, plse, pdelta,
                                                    sc))
                pref = fa.flash_bwd_tiled_reference(q, k, v, po, plse, do, sc,
                                                    bwd_bkv)
                on_plain = {n: fp32_errors(a, b) for n, a, b in
                            zip(("dq", "dk", "dv"), pgrads, pref)}
                on_plain["max_abs_err_delta"] = (
                    pdelta - fa._delta(po, do)).abs().max().item()
                del po, plse, pdq, pdelta, pgrads, pref
            args = (q, k, v, do, lse, delta, sc)
            try:
                leaves = [x.detach().requires_grad_() for x in (q, k, v)]
                lib_out = sdpa_wide(*leaves)
                library_ms = time_ms(lambda: torch.autograd.grad(
                    lib_out, leaves, do, retain_graph=True), iters=5)
                del lib_out, leaves
            except RuntimeError as exc:  # the library may refuse the width
                library_ms = None
                phase(f"sdpa_backward_fp32_d{d}", error=str(exc)[:200])
            io, st = 4 * d * bh, 4 * bh
            common = dict(shape=[bh, s, t, d], block_kv=bwd_bkv,
                          library_ms=library_ms,
                          library_call="autograd.grad through "
                          "scaled_dot_product_attention, fp32, TF32 off: dq, "
                          "dk and dv together", same_bits_twice=same)
            if d in clusters:
                common["max_active_clusters"] = clusters[d]
            if on_plain:
                common["on_plain_forward"] = on_plain
            res_dq = dict(common, **err["dq"], max_abs_err_delta=delta_err,
                          ms=time_ms(run_dq),
                          plain_ms=time_ms(
                              lambda: fa.flash_bwd_dq_reference(*args),
                              iters=5),
                          **bound(6 * s * t * d * bh,
                                  io * (4 * s + 2 * t) + st * 2 * s,
                                  PEAK_FP32_FLOPS))
            res_dkv = dict(common, max_abs_err=max(err["dk"]["max_abs_err"],
                                                   err["dv"]["max_abs_err"]),
                           dk=err["dk"], dv=err["dv"], ms=time_ms(run_dkv),
                           plain_ms=time_ms(
                               lambda: fa.flash_bwd_dkv_reference(*args),
                               iters=5),
                           **bound(8 * s * t * d * bh,
                                   io * (2 * s + 4 * t) + st * 2 * s,
                                   PEAK_FP32_FLOPS))
            for r in (res_dq, res_dkv):
                r["share_of_bound"] = r["bound_ms"] / r["ms"]
            if not out[dq_name]:
                mref = fa.flash_bwd_tiled_reference(q, k, v, o, lse, do, sc,
                                                    bwd_bkv, tf32=True)
                cut = (t - 1) // bwd_bkv * bwd_bkv
                mdq = fa.flash_bwd_tiled_reference(
                    q, k[:, :cut], v[:, :cut], o, lse, do, sc, bwd_bkv)[0]
                res_dq["mutants"] = {
                    "tf32_rel_l2": must_fail(
                        "tf32 dq", fp32_errors(mref[0], ref[0])),
                    "last_tile_dropped_rel_l2": must_fail(
                        "dq without the last kv tile",
                        fp32_errors(mdq, ref[0]))}
                res_dkv["mutants"] = {
                    "tf32_dk_rel_l2": must_fail(
                        "tf32 dk", fp32_errors(mref[1], ref[1])),
                    "tf32_dv_rel_l2": must_fail(
                        "tf32 dv", fp32_errors(mref[2], ref[2])),
                    "dk_scaled_rel_l2": must_fail(
                        "dk x (1 + 1e-4)",
                        fp32_errors(ref[1] * (1 + 1e-4), ref[1]))}
                del mref, mdq
            del ref, again
            phase(f"kernel_{dq_name}", **res_dq)
            phase(f"kernel_{dkv_name}", **res_dkv)
            expect_flash({"launches": launches},
                         **{dq_name: 2, dkv_name: 2})
            if not (all(fp32_held(e) for e in (*err.values(), *(
                    on_plain[n] for n in on_plain if n in err)))
                    and delta_err <= TOL_FP32_ABS and same
                    and on_plain.get("max_abs_err_delta", 0.0)
                    <= TOL_FP32_ABS):
                raise RuntimeError(f"the fp32 head_dim-{d} backward "
                                   f"disagrees at {(bh, s, t)}: {err}, delta "
                                   f"{delta_err}, same bits twice {same}")
            out[dq_name].append(res_dq)
            out[dkv_name].append(res_dkv)
            del q, k, v, do, o, lse, dq, dk, dv, delta

        # q, k, v, dO as (B, S, H, d) views of one packed (B, S, 4, H, d)
        # projection: no copy, the contiguous route's bits, the switch off
        # and on
        h = 5 if d == 64 else 1
        x = randn(2, 4096, 4, h, d)
        q4, k4, v4, do4 = (x[:, :, i] for i in range(4))
        flat = [y.contiguous() for y in (q4, k4, v4, do4)]
        o4, lse4 = fa.flash_fwd(q4, k4, v4, sc)
        grads = fa.flash_bwd(q4, k4, v4, o4, lse4, do4, sc)
        fo, flse = fa.flash_fwd(*flat[:3], sc)
        fgrads = fa.flash_bwd(*flat[:3], fo, flse, flat[3], sc)
        with pipeline_fwd(True):
            reset_counters()
            po, plse = fa.flash_fwd(q4, k4, v4, sc)
            pfo, pflse = fa.flash_fwd(*flat[:3], sc)
            torch.cuda.synchronize()
            switch_launches = counters()
        torch.cuda.synchronize()
        ro, rlse = fa.flash_fwd_tiled_reference(
            *(fa._to3d(y) for y in (q4, k4, v4)), sc, bkv)
        rgrads = fa.flash_bwd_tiled_reference(
            *(fa._to3d(y) for y in (q4, k4, v4, o4)), lse4, fa._to3d(do4), sc,
            bwd_bkv)
        err = {n: fp32_errors(fa._to3d(a), b)
               for n, a, b in zip(("dq", "dk", "dv"), grads, rgrads)}
        res = dict(shape=list(q4.shape), strides=list(q4.stride()),
                   **fp32_errors(fa._to3d(o4), ro),
                   max_abs_err_lse=(lse4 - rlse).abs().max().item(),
                   grads=err,
                   out_contiguous=all(y.is_contiguous()
                                      for y in (o4, po, *grads)),
                   contiguous_route_bits=(
                       torch.equal(o4, fo) and torch.equal(lse4, flse)
                       and all(torch.equal(a, b)
                               for a, b in zip(grads, fgrads))),
                   pipelined_contiguous_route_bits=(
                       torch.equal(po, pfo) and torch.equal(plse, pflse)))
        phase(f"kernel_fp32_d{d}_strided", **res)
        expect_flash({"launches": switch_launches},
                     **{fp32_entry("fwd_pipelined", d): 2})
        if not (fp32_held(res) and res["max_abs_err_lse"] <= TOL_FP32_ABS
                and all(fp32_held(e) for e in err.values())
                and res["out_contiguous"] and res["contiguous_route_bits"]
                and res["pipelined_contiguous_route_bits"]):
            raise RuntimeError(f"the fp32 head_dim-{d} kernels on strided "
                               f"views disagree: {res}")
        for kind in FP32_KINDS:
            out[fp32_entry(kind, d)].append(dict(
                res, max_abs_err=(res["max_abs_err"] if kind.startswith("fwd")
                                  else max(e["max_abs_err"]
                                           for e in err.values()))))
        del x, q4, k4, v4, do4, flat, o4, grads, fo, fgrads, po, pfo
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---- phase 3i: the narrow head_dims (csrc/flash_narrow.cu, and the bf16
# kernels at width 16 csrc/flash_narrow_w16_sm90.cu): every multiple of 8
# up to 128 but 64, bf16 and fp32, at tile widths 16 to 128
NARROW_WIDTHS = (16, 32, 64, 128)
NARROW_SOURCE = "flash_narrow.cu"
NARROW_W16_SOURCE = "flash_narrow_w16_sm90.cu"
NARROW_DIMS = (8, 16, 32, 40, 80, 128)
# (B*H, S, T) by head_dim, the main paths' first: at 8 the tiny UNet's
# self-attentions of a 512^2 pass (3 at 65,536 tokens and 2 heads, 1 at
# 16,384 and 4), at 16 its VAE mid-block's single head at 512^2 (one a
# codec with VAEConfig.use_flash_attention); then a ragged one.  No
# configuration reaches 32 to 128: a 4,096-token shape there.
NARROW_SHAPES = {8: [(2, 65536, 65536), (4, 16384, 16384), (2, 1000, 1500)],
                 16: [(1, 65536, 65536), (2, 1000, 1500)],
                 **{d: [(2, 4096, 4096), (2, 1000, 1500)]
                    for d in (32, 40, 80, 128)}}
# the special-function unit's exponentials a clock an SM on sm_90 (the CUDA
# C++ Programming Guide's arithmetic-instruction throughput table: ex2 on
# compute capability 9.0); with the SM count and the card's maximum SM
# clock (nvidia-smi clocks.max.sm) the exp term of a flash kernel's bound
EXP_PER_CLOCK_SM = 16


def narrow_entry(kind: str, w: int, fp32: bool) -> str:
    """The C entry (and counters() key) of a narrow kernel."""
    return f"flash_{kind}_w{w}_" + ("fp32" if fp32 else "bf16")


def narrow_source(kind: str, w: int, fp32: bool) -> str:
    """The source under csrc/ of the imported package that defines a narrow
    kernel's entry: NARROW_W16_SOURCE where its text defines it (every
    bf16 width-16 entry now; a package from before has the forwards there,
    or none), NARROW_SOURCE otherwise."""
    from diffute_tpu_torch.ops import _build

    path = os.path.join(_build.CSRC, NARROW_W16_SOURCE)
    if w == 16 and not fp32 and os.path.exists(path):
        with open(path) as f:
            if f"int {narrow_entry(kind, w, fp32)}(" in f.read():
                return NARROW_W16_SOURCE
    return NARROW_SOURCE


def w16_waves(fa, kind: str, bh: int, rows: int, d: int) -> dict:
    """The grid of a bf16 width-16 kernel at (B*H, D) over ``rows`` (S for
    the forwards and dq, T for dk/dv), for phase 3i's progress line: rows
    a block and blocks (the launcher's rule), the blocks an SM runs at once
    (the source's occupancy query; None for a package from before it, or
    whose width-16 pair is flash_narrow.cu's) and the waves they take on
    the card's SMs.  Only the occupancy query is measured, so only
    blocks_per_sm goes into the kernels line."""
    from diffute_tpu_torch.ops import _build

    fwd = kind.startswith("fwd")
    rows_a_block = getattr(fa, "NARROW_W16_FWD_ROWS" if fwd
                           else "NARROW_W16_BWD_ROWS", fa.NARROW_BLOCK_KV[16])
    blocks = -(-rows // rows_a_block) * bh
    lib = _build.load()
    query = ("flash_fwd_w16_bf16_blocks_per_sm" if fwd
             else "flash_bwd_w16_bf16_blocks_per_sm")
    per_sm = (getattr(lib, query)(int(kind in ("fwd_pipelined", "bwd_dkv")),
                                  d)
              if hasattr(lib, query) and narrow_source(kind, 16, False)
              == NARROW_W16_SOURCE else None)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"rows_a_block": rows_a_block, "blocks": blocks,
            "blocks_per_sm": per_sm,
            "waves": blocks / (per_sm * sms) if per_sm else None}


def narrow_counter(kind: str, w: int, fp32: bool) -> str:
    """The flash_attention attribute that counts narrow_entry's launches."""
    return (("fp32_" if fp32 else "") + f"w{w}_"
            + {"fwd": "", "fwd_pipelined": "pipelined_"}.get(kind, kind + "_")
            + "launches")


def narrow_keys() -> list:
    return [(narrow_entry(kind, w, fp32), narrow_counter(kind, w, fp32))
            for kind in FP32_KINDS for w in NARROW_WIDTHS
            for fp32 in (False, True)]


_EXP_RATE = []


def exp_rate() -> float:
    """Exponentials a second the card's special-function units give:
    EXP_PER_CLOCK_SM x SMs x the maximum SM clock."""
    if not _EXP_RATE:
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True, text=True,
            check=True, timeout=60).stdout.split()[0])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        _EXP_RATE.append(EXP_PER_CLOCK_SM * sms * mhz * 1e6)
    return _EXP_RATE[0]


def flash_bound(flops: float, nbytes: float, n_exp: float,
                peak: float = PEAK_BF16_FLOPS) -> dict:
    """bound() with a third term, the exponentials over exp_rate(): at
    narrow head_dims they, not the products or the bytes, set the least
    time.  ``bound_term`` says which of products, exp and bytes it is."""
    b = bound(flops, nbytes, peak)
    t_exp = n_exp / exp_rate() * 1e3
    terms = {"products": b["bound_ops_ms"], "exp": t_exp,
             "bytes": b["bound_bytes_ms"]}
    term = max(terms, key=terms.get)
    return dict(b, bound_exp_ms=t_exp, bound_ms=terms[term],
                bound_by="bytes" if term == "bytes" else "operations",
                bound_term=term)


def by_rows(fn, rowed, shared, rows: int):
    """``fn(*row blocks of rowed, *shared)`` over blocks of ``rows`` query
    rows (dim 1 of each of ``rowed``), the blocks' outputs joined on dim 1:
    a plain version whose (B*H, S, T) scores would not fit, one block of
    them at a time (query rows are independent in o, the LSE and dq)."""
    outs = [fn(*(x[:, i:i + rows] for x in rowed), *shared)
            for i in range(0, rowed[0].shape[1], rows)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, 1) for parts in zip(*outs))
    return torch.cat(outs, 1)


def score_rows(bh: int, t: int) -> int:
    """Query rows a block of by_rows so that one fp32 score block is 1 GiB
    at most."""
    return max(1, (1 << 28) // (bh * t))


def plain_dkv_by_rows(fa, q, k, v, do, lse, delta, sc, rows):
    """The plain dk/dv, summed over blocks of query rows in fp32."""
    dk = torch.zeros(k.shape, device=k.device)
    dv = torch.zeros(v.shape, device=v.device)
    for i in range(0, q.shape[1], rows):
        part = fa.flash_bwd_dkv_reference(
            q[:, i:i + rows].float(), k.float(), v.float(),
            do[:, i:i + rows].float(), lse[:, i:i + rows],
            delta[:, i:i + rows], sc)
        dk += part[0]
        dv += part[1]
    return dk.to(k.dtype), dv.to(v.dtype)


def fp64_rows(q, k, v, do, sc, rows: int) -> dict:
    """o, the LSE and dq of query rows [0, rows) in fp64 (autograd through
    plain attention on those rows), and at S * T <= 2^24 dk and dv over all
    of them."""
    full = q.shape[1] * k.shape[1] <= 1 << 24
    rows = q.shape[1] if full else rows
    leaves = [x[:, :rows].double().requires_grad_() if i == 0
              else x.double().requires_grad_()
              for i, x in enumerate((q, k, v))]
    s = torch.einsum("bsd,btd->bst", leaves[0], leaves[1]) * sc
    o = torch.einsum("bst,btd->bsd", torch.softmax(s, -1), leaves[2])
    grads = torch.autograd.grad(o, leaves, do[:, :rows].double())
    out = {"rows": rows, "o": o.detach(),
           "lse": torch.logsumexp(s.detach(), -1), "dq": grads[0]}
    if full:
        out.update(dk=grads[1], dv=grads[2])
    return out


def check_narrow(dev) -> dict:
    """Phase 3i: the four narrow kernels (narrow_source) at head_dims
    NARROW_DIMS, bf16 and fp32, at NARROW_SHAPES, against their plain tiled
    versions at the kernels' kv tile (kernel_block_kv) and their dtype's
    domain: bf16 at the other bf16 entries' criteria (forwards 3 half-ulps,
    relative L2 2e-3, LSE 1e-4; dq, dk, dv 3 half-ulps and 1e-3, delta
    1e-5), fp32 at flash_fp32.cu's (relative L2 1e-5, the LSE and delta
    within 1e-5), and fp32 also within 1e-5 of fp64 (o and dq on a block of
    rows, dk and dv at the small shapes; the plain fp32 version's distance
    beside it).  The plain versions at 65,536 keys never hold the
    (B*H, S, T) scores: the tiled ones walk kv tiles, the one-pass ones
    timed here take blocks of query rows.  Each kernel the same bits twice;
    the bf16 deferred forward the standard one's bits.  Mutants of the
    plain versions on the ragged shape must fail: the scale of the tile
    width (W^-0.5 instead of D^-0.5, where they differ), the pad columns
    filled with 1.0 instead of 0 (where D < W), the last kv tile dropped,
    and on fp32 every product's operands rounded to TF32.  Strided
    (B, S, 2, D) views of a packed projection give the contiguous route's
    bits, PIPELINE_FWD on too.  Each timed (CUDA-event medians) beside its
    plain one-pass version, SDPA (and autograd.grad through it; its backend
    recorded) and flash_bound (products, exponentials, bytes).  Returns
    {entry name: [result per shape]}."""
    fa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for source in sorted({narrow_source(kind, w, fp32) for kind in FP32_KINDS
                          for w in NARROW_WIDTHS for fp32 in (False, True)}):
        show_ptxas(source)
    g = torch.Generator(device=dev).manual_seed(18)
    out = {key: [] for key, _ in narrow_keys()}

    for fp32 in (False, True):
        dtype = torch.float32 if fp32 else torch.bfloat16
        esize, peak = (4, PEAK_FP32_FLOPS) if fp32 else (2, PEAK_BF16_FLOPS)
        for d in NARROW_DIMS:
            w, sc = fa.narrow_width(d), d ** -0.5
            bkv = fa.kernel_block_kv(d, dtype)
            names = {kind: narrow_entry(kind, w, fp32) for kind in FP32_KINDS}
            for bh, s, t in NARROW_SHAPES[d]:
                out_shape = check_narrow_shape(fa, g, dev, dtype, d, bh, s, t,
                                               bkv, esize, peak, names)
                for kind, res in out_shape.items():
                    out[names[kind]].append(res)
            strided = check_narrow_strided(fa, g, dev, dtype, d, bkv)
            for kind in FP32_KINDS:
                out[names[kind]].append(strided)
            gc.collect()
            torch.cuda.empty_cache()
    return out


def narrow_errors(fp32: bool, got: torch.Tensor, ref: torch.Tensor,
                  half_ulps: int = BWD_HALF_ULPS) -> dict:
    """fp32_errors on fp32 outputs, bwd_errors (with its half-ulp bound)
    on bf16 ones."""
    return (fp32_errors(got, ref) if fp32
            else bwd_errors(got, ref, half_ulps))


def narrow_held(fp32: bool, err: dict, lse_err: float = 0.0,
                fwd: bool = True) -> bool:
    """The criterion of a narrow kernel's output against its plain version:
    bf16 as the other bf16 entries (fwd_ok / bwd_ok), fp32 as
    flash_fp32.cu's."""
    if fp32:
        return fp32_held(err) and lse_err <= TOL_FP32_ABS
    return fwd_ok(err, lse_err) if fwd else bwd_ok(err)


def check_narrow_shape(fa, g, dev, dtype, d, bh, s, t, bkv, esize, peak,
                       names) -> dict:
    """Phase 3i at one (dtype, head_dim, shape); see check_narrow."""
    fp32 = dtype == torch.float32
    sc = d ** -0.5
    big = bh * s * t >= 2 ** 30
    iters, plain_iters = (10, 3) if big else (25, 5)
    rows = score_rows(bh, t)
    q, k, v, do = (torch.randn((bh, n, d), generator=g, device=dev,
                               dtype=dtype) for n in (s, t, t, s))

    def errors(got, ref, half_ulps=BWD_HALF_ULPS):
        return narrow_errors(fp32, got, ref, half_ulps)

    def lse_abs(a, b):
        return (a - b).abs().max().item()

    res = {}
    f64 = fp64_rows(q, k, v, do, sc, 512) if fp32 else None
    library = dict(library_ms=time_ms(lambda: sdpa_wide(q, k, v),
                                      iters=iters),
                   library_call="scaled_dot_product_attention" + (
                       ", fp32, TF32 off" if fp32 else ""),
                   sdpa=sdpa_backends(q, k, v))
    fwd_plain_ms = time_ms(lambda: by_rows(fa.flash_attention_reference,
                                           (q,), (k, v, sc), rows),
                           iters=plain_iters)
    fwd_bound = flash_bound(4 * bh * s * t * d,
                            esize * d * bh * (2 * s + 2 * t) + 4 * bh * s,
                            bh * s * t, peak)
    std = None
    for kind in ("fwd", "fwd_pipelined"):
        pipelined = kind == "fwd_pipelined"
        if pipelined and not fa._pipelined_takes(t, d):
            continue

        def run():
            if pipelined:
                return fa.flash_fwd_3d_pipelined(q, k, v, sc)
            return fa.flash_fwd_3d(q, k, v, sc)
        reset_counters()
        o, lse = run()
        o2, lse2 = run()
        torch.cuda.synchronize()
        launches = counters()
        domain = ("prescaled" if pipelined else "natural") if fp32 else "base2"
        ro, rlse = fa.flash_fwd_tiled_reference(q, k, v, sc, bkv, domain)
        err, lse_err = errors(o, ro, FUSED_HALF_ULPS), lse_abs(lse, rlse)
        r = dict(shape=[bh, s, t, d], **err, max_abs_err_lse=lse_err,
                 same_bits_twice=torch.equal(o, o2) and torch.equal(lse, lse2),
                 ms=time_ms(run, iters=iters), plain_ms=fwd_plain_ms,
                 domain=domain, kv_tile=bkv, **library, **fwd_bound)
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        grid = {}
        if not fp32 and fa.narrow_width(d) == 16:
            grid = w16_waves(fa, kind, bh, s, d)
            r["blocks_per_sm"] = grid["blocks_per_sm"]
        if f64 is not None:
            n = f64["rows"]
            r["vs_fp64"] = {"kernel": rel_l2_64(o[:, :n], f64["o"]),
                            "plain": rel_l2_64(ro[:, :n], f64["o"]),
                            "kernel_lse_abs": lse_abs(lse[:, :n].double(),
                                                      f64["lse"]),
                            "rows": n}
        if pipelined and not fp32:
            r["standard_bits"] = (torch.equal(o, std[0])
                                  and torch.equal(lse, std[1]))
        if t % bkv and not pipelined:
            r["mutants"] = narrow_mutants(fa, q, k, v, do, sc, bkv, fp32, ro,
                                          rlse)
        del ro, rlse, o2, lse2
        phase(f"kernel_{names[kind]}", **{**r, **grid})
        expect_flash({"launches": launches}, **{names[kind]: 2})
        ok = (narrow_held(fp32, err, lse_err) and r["same_bits_twice"]
              and r.get("standard_bits", True)
              and (f64 is None or r["vs_fp64"]["kernel"] <= TOL_FP32_REL_L2))
        if not ok:
            raise RuntimeError(f"{names[kind]} disagrees at {(bh, s, t, d)}: "
                               f"{r}")
        res[kind] = r
        if not pipelined:
            std = (o, lse)

    o, lse = std

    def run_dq():
        return fa.flash_bwd_dq_3d(q, k, v, o, lse, do, sc)

    reset_counters()
    dq, delta = run_dq()

    def run_dkv():
        return fa.flash_bwd_dkv_3d(q, k, v, do, lse, delta, sc)

    dk, dv = run_dkv()
    again = (*run_dq(), *run_dkv())
    torch.cuda.synchronize()
    launches = counters()
    same = all(torch.equal(a, b) for a, b in zip((dq, delta, dk, dv), again))
    del again
    ref = fa.flash_bwd_tiled_reference(q, k, v, o, lse, do, sc, bkv)
    err = {n: errors(a, b) for n, a, b in zip(("dq", "dk", "dv"),
                                              (dq, dk, dv), ref)}
    delta_err = lse_abs(delta, fa._delta(o, do))
    try:
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        lib_out = sdpa_wide(*leaves)
        library_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, leaves, do, retain_graph=True), iters=plain_iters)
        del lib_out, leaves
    except RuntimeError as exc:  # the library may refuse the width
        library_ms = None
        phase(f"sdpa_backward_{names['bwd_dq']}", error=str(exc)[:200])
    io, st = esize * d * bh, 4 * bh
    common = dict(shape=[bh, s, t, d], library_ms=library_ms,
                  library_call="autograd.grad through "
                  "scaled_dot_product_attention" + (
                      ", fp32, TF32 off" if fp32 else "")
                  + ": dq, dk and dv together", same_bits_twice=same,
                  kv_tile=bkv)
    res_dq = dict(common, **err["dq"], max_abs_err_delta=delta_err,
                  ms=time_ms(run_dq, iters=iters),
                  plain_ms=time_ms(lambda: by_rows(
                      lambda qb, dob, lb, db: fa.flash_bwd_dq_reference(
                          qb, k, v, dob, lb, db, sc),
                      (q, do, lse, delta), (), rows), iters=plain_iters),
                  **flash_bound(6 * bh * s * t * d,
                                io * (4 * s + 2 * t) + st * 2 * s,
                                bh * s * t, peak))
    res_dkv = dict(common, max_abs_err=max(err["dk"]["max_abs_err"],
                                           err["dv"]["max_abs_err"]),
                   dk=err["dk"], dv=err["dv"],
                   ms=time_ms(run_dkv, iters=iters),
                   plain_ms=time_ms(lambda: plain_dkv_by_rows(
                       fa, q, k, v, do, lse, delta, sc, rows),
                       iters=plain_iters),
                   **flash_bound(8 * bh * s * t * d,
                                 io * (2 * s + 4 * t) + st * 2 * s,
                                 bh * s * t, peak))
    for r in (res_dq, res_dkv):
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
    if f64 is not None:
        n = f64["rows"]
        res_dq["vs_fp64"] = {"kernel": rel_l2_64(dq[:, :n], f64["dq"]),
                             "plain": rel_l2_64(ref[0][:, :n], f64["dq"]),
                             "rows": n}
        if "dk" in f64:
            res_dkv["vs_fp64"] = {
                n: {"kernel": rel_l2_64(a, f64[n]),
                    "plain": rel_l2_64(b, f64[n])}
                for n, a, b in (("dk", dk, ref[1]), ("dv", dv, ref[2]))}
    if t % bkv:
        # the scale of the tile width, where it differs, and TF32 alone
        mutants = {}
        if fa.narrow_width(d) != d:
            wrong = fa.flash_bwd_tiled_reference(
                q, k, v, o, lse, do, fa.narrow_width(d) ** -0.5, bkv)
            mutants["scale_of_w_dq_rel_l2"] = errors(wrong[0],
                                                     ref[0])["rel_l2_err"]
            if narrow_held(fp32, errors(wrong[0], ref[0]), fwd=False):
                raise RuntimeError(f"the criterion passes dq at the tile "
                                   f"width's scale: {mutants}")
        if fp32:
            wrong = fa.flash_bwd_tiled_reference(q, k, v, o, lse, do, sc, bkv,
                                                 tf32=True)
            for i, n in enumerate(("dq", "dk", "dv")):
                e = errors(wrong[i], ref[i])
                mutants[f"tf32_{n}_rel_l2"] = e["rel_l2_err"]
                if narrow_held(fp32, e, fwd=False):
                    raise RuntimeError(f"the criterion passes TF32 alone "
                                       f"({n}): {mutants}")
        res_dq["mutants"] = mutants
    del ref
    grids = {}
    if not fp32 and fa.narrow_width(d) == 16:
        for kind, r, n in (("bwd_dq", res_dq, s), ("bwd_dkv", res_dkv, t)):
            grids[kind] = w16_waves(fa, kind, bh, n, d)
            r["blocks_per_sm"] = grids[kind]["blocks_per_sm"]
    phase(f"kernel_{names['bwd_dq']}", **{**res_dq, **grids.get("bwd_dq", {})})
    phase(f"kernel_{names['bwd_dkv']}",
          **{**res_dkv, **grids.get("bwd_dkv", {})})
    expect_flash({"launches": launches},
                 **{names["bwd_dq"]: 2, names["bwd_dkv"]: 2})
    fp64_ok = f64 is None or (
        res_dq["vs_fp64"]["kernel"] <= TOL_FP32_REL_L2
        and all(v["kernel"] <= TOL_FP32_REL_L2
                for v in res_dkv.get("vs_fp64", {}).values()))
    if not (all(narrow_held(fp32, e, fwd=False) for e in err.values())
            and delta_err <= (TOL_FP32_ABS if fp32 else TOL_DELTA) and same
            and fp64_ok):
        raise RuntimeError(f"the head_dim-{d} {dtype} backward disagrees at "
                           f"{(bh, s, t)}: {err}, delta {delta_err}, same "
                           f"bits twice {same}, {res_dq.get('vs_fp64')}, "
                           f"{res_dkv.get('vs_fp64')}")
    res["bwd_dq"], res["bwd_dkv"] = res_dq, res_dkv
    return res


def narrow_mutants(fa, q, k, v, do, sc, bkv, fp32, ro, rlse) -> dict:
    """Mutants of the narrow forward's plain version, each of which must
    fail the criterion: the scale of the tile width W (where W != D), the
    pad columns up to W filled with 1.0 (where D < W: every score of a row
    moves by (W - D) * scale, which the LSE shows), the last kv tile
    dropped, and (fp32) every product's operands rounded to TF32."""
    d = q.shape[-1]
    w = fa.narrow_width(d)
    domain = "natural" if fp32 else "base2"

    def held(mo, mlse):
        err = narrow_errors(fp32, mo, ro, FUSED_HALF_ULPS)
        lse_err = (mlse - rlse).abs().max().item()
        return narrow_held(fp32, err, lse_err), err["rel_l2_err"], lse_err

    cases = {"last_tile_dropped": lambda: fa.flash_fwd_tiled_reference(
        q, k[:, :-bkv], v[:, :-bkv], sc, bkv, domain)}
    if w != d:
        cases["scale_of_w"] = lambda: fa.flash_fwd_tiled_reference(
            q, k, v, w ** -0.5, bkv, domain)

        def padded():
            pad = [torch.cat([x, torch.ones(x.shape[:-1] + (w - d,),
                                            device=x.device, dtype=x.dtype)],
                             -1) for x in (q, k, v)]
            mo, mlse = fa.flash_fwd_tiled_reference(*pad, sc, bkv, domain)
            return mo[..., :d], mlse
        cases["pad_filled_1.0"] = padded
    if fp32:
        cases["tf32"] = lambda: fa.flash_fwd_tiled_reference(
            q, k, v, sc, bkv, domain, tf32=True)
    out = {}
    for name, make in cases.items():
        passed, rel, lse_err = held(*make())
        out[name] = {"rel_l2": rel, "lse_abs": lse_err}
        if passed:
            raise RuntimeError(f"the criterion passes the mutant {name}: "
                               f"{out[name]}")
    return out


def check_narrow_strided(fa, g, dev, dtype, d, bkv) -> dict:
    """q, k, v, dO as (B, S, 2, D) views of one packed (B, S, 4, 2, D)
    projection (the tiny UNet's heads): the forward, the backward and the
    forward with PIPELINE_FWD on read them without a copy and give the
    contiguous route's bits; held to the tiled plain versions too."""
    fp32 = dtype == torch.float32
    sc = d ** -0.5
    x = torch.randn((2, 4096, 4, 2, d), generator=g, device=dev, dtype=dtype)
    q4, k4, v4, do4 = (x[:, :, i] for i in range(4))
    flat = [y.contiguous() for y in (q4, k4, v4, do4)]
    o4, lse4 = fa.flash_fwd(q4, k4, v4, sc)
    grads = fa.flash_bwd(q4, k4, v4, o4, lse4, do4, sc)
    fo, flse = fa.flash_fwd(*flat[:3], sc)
    fgrads = fa.flash_bwd(*flat[:3], fo, flse, flat[3], sc)
    with pipeline_fwd(True):
        reset_counters()
        po, plse = fa.flash_fwd(q4, k4, v4, sc)
        pfo, pflse = fa.flash_fwd(*flat[:3], sc)
        torch.cuda.synchronize()
        switch_launches = counters()
    torch.cuda.synchronize()
    ro, rlse = fa.flash_fwd_tiled_reference(
        *(fa._to3d(y) for y in (q4, k4, v4)), sc, bkv)
    rgrads = fa.flash_bwd_tiled_reference(
        *(fa._to3d(y) for y in (q4, k4, v4, o4)), lse4, fa._to3d(do4), sc,
        bkv)

    def errors(got, ref, half_ulps=BWD_HALF_ULPS):
        return narrow_errors(fp32, got, ref, half_ulps)

    err = {n: errors(fa._to3d(a), b)
           for n, a, b in zip(("dq", "dk", "dv"), grads, rgrads)}
    res = dict(shape=list(q4.shape), strides=list(q4.stride()),
               **errors(fa._to3d(o4), ro, FUSED_HALF_ULPS),
               max_abs_err_lse=(lse4 - rlse).abs().max().item(), grads=err,
               out_contiguous=all(y.is_contiguous()
                                  for y in (o4, po, *grads)),
               contiguous_route_bits=(
                   torch.equal(o4, fo) and torch.equal(lse4, flse)
                   and all(torch.equal(a, b) for a, b in zip(grads, fgrads))),
               pipelined_contiguous_route_bits=(
                   torch.equal(po, pfo) and torch.equal(plse, pflse)))
    name = narrow_entry("fwd", fa.narrow_width(d), fp32)
    phase(f"kernel_{name}_d{d}_strided", **res)
    expect_flash({"launches": switch_launches},
                 **{narrow_entry("fwd_pipelined", fa.narrow_width(d),
                                 fp32): 2})
    if not (narrow_held(fp32, res, res["max_abs_err_lse"])
            and all(narrow_held(fp32, e, fwd=False) for e in err.values())
            and res["out_contiguous"] and res["contiguous_route_bits"]
            and res["pipelined_contiguous_route_bits"]):
        raise RuntimeError(f"the head_dim-{d} {dtype} kernels on strided "
                           f"views disagree: {res}")
    res["max_abs_err"] = max(res["max_abs_err"],
                             *(e["max_abs_err"] for e in err.values()))
    return res


def narrow_entries(results: dict, launches: dict) -> list:
    """The 32 narrow entries' kernel lines (phase 3i) with the tiny paths'
    launches by path (phase 8f: path -> counters read right after it ran);
    an entry no configuration reaches (tile widths 32 to 128) has none."""
    def by_path(key):
        return {path: rec[key] for path, rec in launches.items()
                if rec.get(key)}

    return [dict(kernel_entry(key, narrow_source(kind, w, fp32),
                              f"flash_attention.py:{FP32_REPLACES[kind]}",
                              results[key], by_path(key)),
                 on_a_path=w == 16)
            for kind in FP32_KINDS for w in NARROW_WIDTHS
            for fp32 in (False, True)
            for key in (narrow_entry(kind, w, fp32),)]


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
            "flash_fwd_d512": flash_attention.d512_launches,
            "flash_bwd_dq_d512": flash_attention.d512_bwd_dq_launches,
            "flash_bwd_dkv_d512": flash_attention.d512_bwd_dkv_launches,
            # (a checkout from before head_dim 256, or before the wide
            # deferred forward, has no such counters)
            **{key: getattr(flash_attention, name, 0) for key, name in (
                ("flash_fwd_d256", "d256_launches"),
                ("flash_bwd_dq_d256", "d256_bwd_dq_launches"),
                ("flash_bwd_dkv_d256", "d256_bwd_dkv_launches"),
                ("flash_fwd_pipelined_d512", "d512_pipelined_launches"),
                ("flash_fwd_pipelined_d256", "d256_pipelined_launches"),
                # the fp32 kernels (a checkout from before them has none)
                *((fp32_entry(kind, d), fp32_counter(kind, d))
                  for kind in FP32_KINDS for d in (64, 256, 512)),
                # the narrow kernels, bf16 and fp32 (nor these)
                *narrow_keys())},
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
    flash_attention.d512_launches = 0
    flash_attention.d512_bwd_dq_launches = 0
    flash_attention.d512_bwd_dkv_launches = 0
    flash_attention.d256_launches = 0
    flash_attention.d256_bwd_dq_launches = 0
    flash_attention.d256_bwd_dkv_launches = 0
    flash_attention.d512_pipelined_launches = 0
    flash_attention.d256_pipelined_launches = 0
    for kind in FP32_KINDS:
        for d in (64, 256, 512):
            if hasattr(flash_attention, fp32_counter(kind, d)):
                setattr(flash_attention, fp32_counter(kind, d), 0)
    for _, name in narrow_keys():
        if hasattr(flash_attention, name):
            setattr(flash_attention, name, 0)
    for fn in (group_norm_stats, group_norm_silu, gn_silu_conv3x3,
               quant_matmul):
        fn.launches = 0


def timed_edit(pipe, image, box, text, seed, edit_config=None, steps=None):
    """One edit with every counter set to 0 before it: its seconds, peak
    memory and launches; fails unless only the box's pixels changed."""
    rec = measured(pipe.device, lambda: pipe.edit(
        image, box, text, seed=seed, edit_config=edit_config,
        num_inference_steps=steps)[0])
    changed = only_boxes_changed(rec.pop("out"), image, [box])
    return dict(text=text, changed_pixels=changed, **rec)


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
    seconds on the host clock to the card's end of it (synchronised),
    launches, the peak memory and the memory allocated before it."""
    torch.cuda.synchronize()
    reset_counters()
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return dict(out=out, seconds=time.perf_counter() - t0,
                launches=counters(),
                max_memory_allocated=torch.cuda.max_memory_allocated(dev),
                memory_allocated_before=resident)


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
    ``rounds`` rounds, at a 512^2 edit's (S, H, D) = (1024, 10, 64) and
    (4096, 5, 64), and at the small VAE mid-block's in a 256^2 encode or
    decode, (4096, 1, 256)."""
    import diffute_tpu_torch
    from diffute_tpu_torch.ops import dot_product_attention

    dev = torch.device("cuda", 0)
    out = []
    for s, h, d in [(1024, 10, 64), (4096, 5, 64), (4096, 1, 256)]:
        # three projections viewed as heads, as Attention.forward has them
        q, k, v = (torch.randn((1, s, h * d), device=dev,
                               dtype=torch.bfloat16).view(1, s, h, d)
                   for _ in range(3))

        def call():
            return dot_product_attention(q, k, v, use_flash=True).reshape(
                1, s, h * d)

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
        out.append({"s": s, "h": h, "d": d, "calls": calls, "rounds": rounds,
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


# ---- phases 8-10: the two-stage workflow
WORKFLOW_PAGES = 8        # synthetic 384 x 512 document pages in the manifest
WORKFLOW_BATCH = 4
VAE_PARAMS = 83_653_863   # the SD2 VAE


def write_manifests(root: str, config) -> tuple:
    """8 synthetic 384 x 512 pages as PNGs with an OCR JSON each; the
    stage-1 manifest (``path``) and the stage-2 one (``image_path``,
    ``ocr_path``)."""
    from PIL import Image

    from diffute_tpu_torch.io.dataset import SyntheticSceneDataset

    data = SyntheticSceneDataset(config, image_hw=(384, 512), seed=0)
    rows = []
    for i in range(WORKFLOW_PAGES):
        image, (x1, y1, x2, y2), text = data.page(i)
        png = os.path.join(root, f"page{i}.png")
        Image.fromarray(image).save(png)
        ocr = os.path.join(root, f"page{i}.json")
        with open(ocr, "w") as f:
            json.dump({"document": [{"text": text, "score": 0.95, "box": [
                [int(x1), int(y1)], [int(x2), int(y1)], [int(x2), int(y2)],
                [int(x1), int(y2)]]}]}, f)
        rows.append((png, ocr))
    pages, docs = (os.path.join(root, n) for n in ("pages.csv", "docs.csv"))
    with open(pages, "w") as f:
        f.write("path\n" + "".join(f"{png}\n" for png, _ in rows))
    with open(docs, "w") as f:
        f.write("image_path,ocr_path\n"
                + "".join(f"{png},{ocr}\n" for png, ocr in rows))
    return pages, docs


def states_equal(a, b, path="") -> list:
    """The paths at which two trainer ``state_dict()``s differ (bit for
    bit; tensors compared on one device)."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return [path or "/"]
        return [d for k in a for d in states_equal(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, torch.Tensor):
        same = (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b.to(a.device)))
        return [] if same else [path]
    return [] if a == b else [path]


def dir_bytes(path: str) -> dict:
    """Bytes under each entry of ``path`` and in all."""
    out = {}
    for entry in sorted(os.listdir(path)):
        total = 0
        for root, _, files in os.walk(os.path.join(path, entry)):
            total += sum(os.path.getsize(os.path.join(root, f)) for f in files)
        out[entry] = total
    out["total"] = sum(out.values())
    return out


def check_workflow(dev, root: str):
    """Phases 8-10 on the card: stage 1 (run_vae on a manifest), stage 2
    from its checkpoint (run_unet --pretrained), both resumed, then serving
    from the stage-2 checkpoint, all at full width, 512^2, bf16 with
    gradient checkpointing, under ``root`` (the caller removes it).
    Returns the launches by path and the numbers, and the stage-2
    checkpoint, whose export phase 13 certifies."""
    from PIL import Image

    from diffute_tpu_torch.config import DiffUTEConfig, card_serving_config
    from diffute_tpu_torch.compat.diffusers import load_safetensors
    from diffute_tpu_torch.pipeline import DiffUTEPipeline
    from diffute_tpu_torch.serve import cli
    from diffute_tpu_torch.serve.loading import load_diffusers_layout
    from diffute_tpu_torch.train import run_unet, run_vae
    from diffute_tpu_torch.train.checkpoint import list_checkpoints

    base = DiffUTEConfig()
    scale = ["--model_scale", "full", "--train_batch_size", str(WORKFLOW_BATCH),
             "--mixed_precision", "bf16", "--gradient_checkpointing",
             "--device", "cuda", "--seed", "0"]
    out = {"launches": {}}
    usage = shutil.disk_usage(root)
    pages, docs = write_manifests(root, base)
    d1, d2 = os.path.join(root, "stage1"), os.path.join(root, "stage2")

    # ---- 8. stage 1: three steps, a checkpoint at 2 and at the end,
    # then a resume from the latest that takes one step
    run = run_vae.prepare([*scale, "--manifest", pages, "--output_dir", d1,
                           "--max_train_steps", "3",
                           "--checkpointing_steps", "2"])
    n_vae = sum(p.numel() for p in run.trainer.state.params)
    n_tensors = len(run.trainer.state.params)
    before = [p.detach().clone() for p in run.trainer.state.params]
    history = run.train()
    changed = sum(not torch.equal(a, b) for a, b in
                  zip(before, run.trainer.state.params))
    del before
    saved = run.trainer.state_dict()
    del run
    resumed = run_vae.prepare([*scale, "--manifest", pages,
                               "--output_dir", d1,
                               "--resume_from_checkpoint", "latest",
                               "--max_train_steps", "4",
                               "--checkpointing_steps", "2"])
    diff = states_equal(saved, resumed.trainer.state_dict())
    history2 = resumed.train()
    del saved, resumed
    stage1 = dict(vae_params=n_vae, tensors_changed=changed,
                  tensors=n_tensors, steps=history,
                  resumed_steps=history2, restored_differs_at=diff[:5],
                  checkpoints=list_checkpoints(d1),
                  free_bytes_at_start=usage.free)
    phase("stage1", **stage1)
    if n_vae != VAE_PARAMS or changed < n_tensors or diff:
        raise RuntimeError(f"stage 1 failed: {n_vae} parameters, "
                           f"{changed} of {n_tensors} tensors changed, "
                           f"restore differs at {diff[:5]}")
    if (len(history) != 3 or [h["step"] for h in history2] != [4]
            or not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                       for h in history + history2)):
        raise RuntimeError(f"stage 1 steps: {history} {history2}")
    out["stage1_step_seconds"] = [h["seconds"] for h in history + history2]
    out["stage1_max_memory_allocated"] = [h["max_memory_allocated"]
                                          for h in history + history2]
    gc.collect()

    # ---- 9. stage 2 from stage 1's checkpoint: the VAE from its vae/,
    # the UNet and TrOCR random-init; two steps, then a resume to 3
    stage1_dir = os.path.join(d1, "checkpoint-4")
    flags = [*scale, "--manifest", docs, "--pretrained", stage1_dir,
             "--output_dir", d2, "--checkpointing_steps", "2",
             "--checkpoints_total_limit", "1"]
    run = run_unet.prepare([*flags, "--max_train_steps", "2"])
    trainer = run.trainer
    vae_file = load_safetensors(os.path.join(
        stage1_dir, "vae", "diffusion_pytorch_model.safetensors"))
    frozen = trainer.vae.state_dict()
    vae_diff = [k for k, v in vae_file.items()
                if not torch.equal(v.to(dev, trainer.dtype), frozen[k])]
    if set(vae_file) != set(frozen) or vae_diff:
        raise RuntimeError(f"stage 2's VAE is not stage 1's: {vae_diff[:5]}")
    del vae_file, frozen
    reset_counters()
    history = run.train()
    first_launches = counters()
    saved = trainer.state_dict()
    del run, trainer
    gc.collect()
    torch.cuda.empty_cache()
    run = run_unet.prepare([*flags, "--max_train_steps", "3",
                            "--resume_from_checkpoint", "latest"])
    diff = states_equal(saved, run.trainer.state_dict())
    del saved
    reset_counters()
    history2 = run.train()
    resume_launches = counters()
    ckpt = os.path.join(d2, "checkpoint-3")
    stage2 = dict(steps=history, resumed_steps=history2,
                  restored_from=run.restored_from,
                  restore_seconds=run.restore_seconds,
                  save_seconds=run.manager.times,
                  checkpoint_bytes=dir_bytes(ckpt),
                  checkpoints=list_checkpoints(d2),
                  restored_differs_at=diff[:5],
                  launches_first_run=first_launches,
                  launches_resumed_step=resume_launches)
    phase("stage2", **stage2)
    if diff or stage2["checkpoints"] != ["checkpoint-3"]:
        raise RuntimeError(f"stage 2 restore differs at {diff[:5]}; "
                           f"checkpoints {stage2['checkpoints']}")
    if (len(history) != 2 or [h["step"] for h in history2] != [3]
            or not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                       for h in history + history2)):
        raise RuntimeError(f"stage 2 steps: {history} {history2}")
    # each step: 10 self-attentions run the forward twice (the
    # gradient checkpoint recomputes it) and each backward once
    expect_launches({"launches": first_launches}, flash_fwd=40,
                    flash_bwd_dq=20, flash_bwd_dkv=20)
    expect_launches({"launches": resume_launches}, flash_fwd=20,
                    flash_bwd_dq=10, flash_bwd_dkv=10)
    out["launches"].update(train_pretrained=first_launches,
                           train_resume=resume_launches)
    out["stage2_step_seconds"] = [h["seconds"] for h in history + history2]
    out["stage2_checkpoint"] = dict(
        bytes=stage2["checkpoint_bytes"], restore_seconds=run.restore_seconds,
        **run.manager.times)

    # ---- 10. serving: a pipeline from the checkpoint's export and one
    # from the trainer's state_dicts, the same 20-step edit on each
    config = dataclasses.replace(
        card_serving_config(base),
        edit=dataclasses.replace(base.edit, num_inference_steps=20))
    trainer = run.trainer
    in_memory = {"unet": trainer.state.params_dict(),
                 "vae": trainer.vae.state_dict(),
                 "trocr": trainer.trocr.state_dict()}
    del run
    pipes = {"checkpoint": DiffUTEPipeline(
                 config, load_diffusers_layout(ckpt, config, dev), dev),
             "trainer_state": DiffUTEPipeline(config, in_memory, dev)}
    del trainer, in_memory
    gc.collect()
    res = config.edit.resolution
    image, box = scene(res)
    edits = {}
    for name, pipe in pipes.items():
        reset_counters()
        t0 = time.perf_counter()
        edited = pipe.edit(image, box, "CHECKPOINT", seed=3)[0]
        edits[name] = dict(out=edited, seconds=time.perf_counter() - t0,
                           launches=counters())
        only_boxes_changed(edited, image, [box])
    del pipes
    lsb = int(np.abs(edits["checkpoint"]["out"].astype(np.int16)
                     - edits["trainer_state"]["out"]).max())
    png = os.path.join(root, "scene.png")
    Image.fromarray(image).save(png)
    reset_counters()
    t0 = time.perf_counter()
    cli.main(["--checkpoint", ckpt, "--image", png, "--text", "CHECKPOINT",
              "--box", ",".join(map(str, box)), "--steps", "20",
              "--seed", "3",
              "--out", os.path.join(root, "cli.png")])
    cli_rec = dict(seconds=time.perf_counter() - t0, launches=counters())
    cli_out = np.asarray(Image.open(os.path.join(root, "cli.png")))
    cli_lsb = int(np.abs(cli_out.astype(np.int16)
                         - edits["checkpoint"]["out"]).max())
    serving = dict(checkpoint_vs_trainer_state_max_lsb=lsb,
                   cli_vs_checkpoint_max_lsb=cli_lsb, cli=cli_rec,
                   **{k: {"seconds": v["seconds"], "launches": v["launches"]}
                      for k, v in edits.items()})
    phase("serve_checkpoint", **serving)
    if lsb > 1 or cli_out.shape != image.shape:
        raise RuntimeError(f"the checkpoint's edit differs from the "
                           f"trainer state's by {lsb} LSB")
    for rec in (*edits.values(), cli_rec):
        expect_launches(rec, flash_fwd=200)
    out["launches"].update(edit_checkpoint=edits["checkpoint"]["launches"],
                           edit_trainer_state=edits["trainer_state"]["launches"],
                           cli_checkpoint=cli_rec["launches"])
    out["serve_seconds"] = {k: v["seconds"] for k, v in edits.items()}
    out["serve_seconds"]["cli"] = cli_rec["seconds"]
    out["checkpoint_vs_trainer_state_max_lsb"] = lsb
    return out, ckpt


VAE_FLASH_STEPS, STAGE1_STEPS = 20, 3
# full-width VAE, bf16, same weights and inputs: the mid-blocks through the
# head_dim-512 kernels against dense attention, relative max error over max
# |out| as phase 5 bounds the UNet (a wrong kernel gives O(1))
TOL_VAE_FLASH_REL = TOL_UNET_REL


def wide_launches(rec: dict, d: int) -> dict:
    return {k: rec["launches"][k]
            for k in (f"flash_fwd_d{d}", f"flash_fwd_pipelined_d{d}",
                      f"flash_bwd_dq_d{d}", f"flash_bwd_dkv_d{d}")}


# a 20-step edit with the deferred-softmax switch on against the same edit
# with it off: at most this many LSB apart, as phase 5a bounds the switch
# (the UNet's head_dim-64 forwards change kernel; the VAE's give the same
# bits)
PIPELINE_EDIT_LSB = 2


@contextlib.contextmanager
def pipeline_fwd(on: bool):
    """PIPELINE_FWD set to ``on`` while the block runs, off after it."""
    set_pipeline_fwd(on)
    try:
        yield
    finally:
        set_pipeline_fwd(False)


# the loss gradient of these weights, stage 1 flag on against off
STAGE1_PROBES = ["encoder.mid_block.attentions.0.to_q.weight",
                 "decoder.mid_block.attentions.0.to_q.weight",
                 "encoder.conv_in.weight", "decoder.conv_out.weight"]
# flash's gradient against the fp32 dense one may be at most this many
# times as far as the bf16 dense gradient is (both are bf16 computations)
GRAD_VS_FP32_RATIO = 1.5


@contextlib.contextmanager
def flash_route_spy(records: list):
    """Keep, for each call the model makes of the flash route
    (ops.attention.flash_attention), its q, k, v and o, and for a call that
    takes part in the backward (not a frozen model's, as a stage-2 step's
    VAE encodes) the gradient that reaches o and the gradients the route
    returns for q, k and v."""
    att = importlib.import_module("diffute_tpu_torch.ops.attention")
    real = att.flash_attention

    def spy(q, k, v, scale=None):
        rec = {"q": q.detach().clone(), "k": k.detach().clone(),
               "v": v.detach().clone()}
        records.append(rec)

        def keep(name):
            def hook(grad):
                rec[name] = grad.detach().clone()
            return hook
        for name, x in (("dq", q), ("dk", k), ("dv", v)):
            if x.requires_grad:
                x.register_hook(keep(name))
        o = real(q, k, v, scale=scale)
        rec["o"] = o.detach().clone()
        if o.requires_grad:
            o.register_hook(keep("do"))
        return o

    att.flash_attention = spy
    try:
        yield records
    finally:
        att.flash_attention = real


@contextlib.contextmanager
def latent_grad_spy(grads: list):
    """Keep the loss gradient that reaches the stage-1 trainer's latent
    sample z (everything the encoder's weights learn passes through it)."""
    vt = importlib.import_module("diffute_tpu_torch.train.vae_train")
    real = vt.sample_latent

    def spy(*args):
        z = real(*args)
        z.register_hook(lambda g: grads.append(g.detach().float().clone()))
        return z

    vt.sample_latent = spy
    try:
        yield grads
    finally:
        vt.sample_latent = real


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def flash_route_check(records: list, d: int, pipelined: bool = False,
                      shapes=None) -> list:
    """The flash route held at its own boundary inside a stage-1 step: for
    each mid-block call the flagged step made (``shapes``: for the first
    call at each of these q shapes (B, S, H, D) that took a backward,
    as a stage-2 step's UNet self-attentions, some of them recomputed under
    remat with no backward of their own; without it exactly two calls,
    each with its backward), on the q, k, v and dO the step gave it, o against the tiled plain forward and the dq, dk and dv
    the step's backward produced against the tiled plain backward (fed the
    route's o and the plain LSE), at the kernel criteria (3 half-ulps of
    max |ref|; relative L2 2e-3 for o, 1e-3 for the gradients).  Mutants of
    the route's gradients (dk x 1.02, dq and dk swapped, dq and dk at the
    scale of twice the width) must fail.  For scale, the route's and the
    dense bf16 route's gradients are also read against fp32 dense attention
    on the same inputs.  Unlike the weight probes these see no rounding of
    the layers around the attention, so they separate at every scale.  An
    fp32 step's records go to fp32_route_check (``pipelined``: the step ran
    with PIPELINE_FWD on)."""
    from diffute_tpu_torch.ops.attention import dense_attention

    fa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")
    sc = d ** -0.5
    bkv, fwd_bkv = (fa.kernel_block_kv(d, torch.bfloat16, kind)
                    for kind in ("bwd_dq", "fwd"))
    grads = ("dq", "dk", "dv", "do")
    if shapes is None:
        if len(records) != 2 or any(n not in r for r in records
                                    for n in grads):
            raise RuntimeError(f"the flagged step did not take two mid-block "
                               f"calls through the flash route, forward and "
                               f"backward: {[sorted(r) for r in records]}")
    else:
        done = [r for r in records if all(n in r for n in grads)]
        picked = [next((r for r in done if tuple(r["q"].shape) == tuple(x)),
                       None) for x in shapes]
        if any(r is None for r in picked):
            raise RuntimeError(f"the flagged step took no flash call with its "
                               f"backward at each of {shapes}: "
                               f"{[tuple(r['q'].shape) for r in done]}")
        records = picked
    if records[0]["q"].dtype == torch.float32:
        return fp32_route_check(records, d, pipelined)
    out = []
    for rec in records:
        q, k, v, o, do = (fa._heads_first(rec[n])
                          for n in ("q", "k", "v", "o", "do"))
        ro, lse = fa.flash_fwd_tiled_reference(q, k, v, sc, fwd_bkv)
        ref = dict(zip(("dq", "dk", "dv"), fa.flash_bwd_tiled_reference(
            q, k, v, o, lse, do, sc, bkv)))
        got = {n: fa._heads_first(rec[n]) for n in ref}
        err = {n: bwd_errors(got[n], ref[n]) for n in ref}
        res = dict(shape=list(rec["q"].shape),
                   o=bwd_errors(o, ro, FUSED_HALF_ULPS), **err)
        ok = fused_ok(res["o"]) and all(bwd_ok(err[n]) for n in ref)
        mutants = {
            "dk_x1.02": dict(got, dk=got["dk"] * 1.02),
            "dq_dk_swapped": dict(got, dq=got["dk"], dk=got["dq"]),
            "scale_of_2d": dict(got, dq=got["dq"] * 2 ** -0.5,
                                dk=got["dk"] * 2 ** -0.5)}
        res["mutants_rel_l2"] = {
            m: max(rel_l2(g[n], ref[n]) for n in ref)
            for m, g in mutants.items()}
        passed = [m for m, g in mutants.items()
                  if all(bwd_ok(bwd_errors(g[n], ref[n])) for n in ref)]
        vs_fp32 = {}
        for route, dtype in (("dense_bf16", torch.bfloat16),
                             ("fp32", torch.float32)):
            leaves = [rec[n].detach().to(dtype).requires_grad_()
                      for n in ("q", "k", "v")]
            vs_fp32[route] = torch.autograd.grad(
                dense_attention(*leaves, sc), leaves, rec["do"].to(dtype))
            del leaves
        exact = dict(zip(("dq", "dk", "dv"), vs_fp32.pop("fp32")))
        dense = dict(zip(("dq", "dk", "dv"), vs_fp32.pop("dense_bf16")))
        res["flash_vs_fp32"] = {n: rel_l2(rec[n], exact[n]) for n in exact}
        res["dense_vs_fp32"] = {n: rel_l2(dense[n], exact[n]) for n in exact}
        del ro, lse, ref, got, mutants, exact, dense
        torch.cuda.empty_cache()
        if not ok or passed:
            raise RuntimeError(f"the flash route inside the stage-1 step "
                               f"disagrees with its plain version, or the "
                               f"criterion passes the mutants {passed}: "
                               f"{res}")
        out.append(res)
    return out


# the fp32 route inside an fp32 stage-1 step (fp32_route_check): a gradient
# passes within TOL_FP32_REL_L2 of the tiled plain fp32 version or, where
# that version is itself further from fp64 than the contract's bound, no
# further from fp64 than FP32_ROUTE_FP64_RATIO times it is
FP32_ROUTE_FP64_RATIO = 2.0


def bwd_fp64(q, k, v, o, lse, do, scale) -> tuple:
    """The flash backward's function in fp64 on given o and LSE (BH, L, D)
    / (BH, S): p = exp(s * scale - lse), ds = p (dO v^T - rowsum(dO o)),
    dq = ds k * scale, dk = ds^T q * scale, dv = p^T dO."""
    q, k, v, o, do = (x.double() for x in (q, k, v, o, do))
    p = torch.exp(torch.einsum("bsd,btd->bst", q, k) * scale
                  - lse.double()[..., None])
    ds = p * (torch.einsum("bsd,btd->bst", do, v)
              - (do * o).sum(-1, keepdim=True))
    return (torch.einsum("bst,btd->bsd", ds, k) * scale,
            torch.einsum("bst,bsd->btd", ds, q) * scale,
            torch.einsum("bst,bsd->btd", p, do))


def fp32_route_check(records: list, d: int, pipelined: bool = False
                     ) -> list:
    """flash_route_check on an fp32 step's calls (a stage-1 step's two
    mid-block calls, a stage-2 step's UNet self-attention at each of its
    two shapes): the o and
    LSE of the route's forward (launched again on the recorded q, k, v,
    with PIPELINE_FWD as the step had it, ``pipelined``; it must give the
    step's o to the bit) against the tiled plain fp32 forward at the
    forward kernel's own tile and domain (kernel_block_kv(d, fp32, kind);
    natural, or prescaled base 2 for the deferred forward), and the dq, dk
    and dv the step's backward produced against the tiled plain fp32
    backward at the backward kernels' own tile (kernel_block_kv(d, fp32,
    "bwd_dq")), on the step's own q, k, v and dO and the route's o and
    LSE; each also against fp64 attention on the same inputs (the
    gradients, with the switch on, also against the backward's own
    function in fp64 on the route's o and LSE, bwd_fp64).  Stage-1
    scores reach about 100-150 after the scale, where dP sits close to
    delta and ds = p (dP - delta) cancels: there the plain fp32 version is
    itself some 7e-5 (dq) and 1.3e-5 (dk, dv) from fp64 on an H100, so two
    fp32 computations of it differ by more than the contract's
    TOL_FP32_REL_L2, which the contract shapes' random inputs do not show.
    o and each gradient pass within TOL_FP32_REL_L2 of the plain version
    (the LSE within TOL_FP32_ABS), or no further from fp64 than
    FP32_ROUTE_FP64_RATIO times the plain version is (a tensor-core chain
    that truncates shows there, as flash_route_check saw at head_dim 256).
    Mutants that must fail: the plain forward and backward with every
    product's operands rounded to TF32, the LSE left in base 2, dk x (1 +
    1e-4), dq and dk swapped.  o, the LSE, dq, dk and dv are held, and
    every mutant must fail, with the switch off and on.  Recorded: each
    output's distance from the plain version and from fp64, the plain
    version's from fp64, the largest |score| after the scale."""
    fa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")
    sc = d ** -0.5
    bkv = fa.kernel_block_kv(d, torch.float32, "bwd_dq")
    fwd_kind = "fwd_pipelined" if pipelined else "fwd"
    fwd_bkv = fa.kernel_block_kv(d, torch.float32, fwd_kind)
    domain = "prescaled" if pipelined else "natural"
    names = ("dq", "dk", "dv")
    out = []
    for rec in records:
        with pipeline_fwd(pipelined):
            o4, lse = fa.flash_fwd(rec["q"], rec["k"], rec["v"], sc)
        q, k, v, o, do = (fa._heads_first(x) for x in (
            rec["q"], rec["k"], rec["v"], o4, rec["do"]))
        ro, rlse = fa.flash_fwd_tiled_reference(q, k, v, sc, fwd_bkv, domain)
        mo, mlse = fa.flash_fwd_tiled_reference(q, k, v, sc, fwd_bkv, domain,
                                                tf32=True)
        ref = dict(zip(names, fa.flash_bwd_tiled_reference(
            q, k, v, o, lse, do, sc, bkv)))
        got = {n: fa._heads_first(rec[n]) for n in names}
        res = dict(shape=list(rec["q"].shape), block_kv=bkv,
                   forward=fwd_kind, forward_block_kv=fwd_bkv, domain=domain,
                   o_same_bits=torch.equal(o4, rec["o"]),
                   o=fp32_errors(o, ro),
                   max_abs_err_lse=(lse - rlse).abs().max().item(),
                   **{n: fp32_errors(got[n], ref[n]) for n in names})
        mutants = {
            "tf32": dict(zip(names, fa.flash_bwd_tiled_reference(
                q, k, v, o, lse, do, sc, bkv, tf32=True))),
            "dk_x(1+1e-4)": dict(got, dk=got["dk"] * (1 + 1e-4)),
            "dq_dk_swapped": dict(got, dq=got["dk"], dk=got["dq"])}
        del o4
        leaves = [rec[n].double().requires_grad_() for n in ("q", "k", "v")]
        logits = torch.einsum("bshd,bthd->bhst", leaves[0], leaves[1]) * sc
        res["max_abs_score"] = logits.detach().abs().max().item()
        lse64 = torch.logsumexp(logits.detach(), -1).flatten(0, 1)
        o64 = torch.einsum("bhst,bthd->bshd", torch.softmax(logits, -1),
                           leaves[2])
        grads64 = torch.autograd.grad(o64, leaves, rec["do"].double())
        exact = {n: fa._heads_first(g) for n, g in zip(names, grads64)}
        o64 = fa._heads_first(o64.detach())
        del leaves, logits, grads64
        if pipelined:
            # the gradients also against the backward's own function in
            # fp64 on the route's o and LSE (the deferred forward's LSE is
            # base 2, 1-3e-5 from the natural one)
            own = dict(zip(names, bwd_fp64(q, k, v, o, lse, do, sc)))
            res["vs_fp64_backward"] = {n: rel_l2_64(got[n], own[n])
                                       for n in names}
            res["plain_vs_fp64_backward"] = {n: rel_l2_64(ref[n], own[n])
                                             for n in names}
            del own
        plain64 = {n: rel_l2_64(ref[n], exact[n]) for n in names}
        plain_o64 = rel_l2_64(ro, o64)
        plain_lse64 = (rlse.double() - lse64).abs().max().item()

        def held(g):
            return {n: (fp32_held(fp32_errors(g[n], ref[n]))
                        or rel_l2_64(g[n], exact[n])
                        <= FP32_ROUTE_FP64_RATIO * plain64[n])
                    for n in names}

        def fwd_held(fo, flse):
            return {"o": (fp32_held(fp32_errors(fo, ro))
                          or rel_l2_64(fo, o64)
                          <= FP32_ROUTE_FP64_RATIO * plain_o64),
                    "lse": ((flse - rlse).abs().max().item() <= TOL_FP32_ABS
                            or (flse.double() - lse64).abs().max().item()
                            <= FP32_ROUTE_FP64_RATIO * plain_lse64)}

        res["flash_vs_fp64"] = {n: rel_l2_64(got[n], exact[n]) for n in names}
        res["flash_vs_fp64"]["o"] = rel_l2_64(o, o64)
        res["flash_vs_fp64"]["lse_abs"] = (lse.double()
                                           - lse64).abs().max().item()
        res["plain_vs_fp64"] = dict(plain64, o=plain_o64, lse_abs=plain_lse64)
        res["within_tol_of_plain"] = {
            n: fp32_held(res[n]) for n in ("o", *names)}
        res["held"] = dict(held(got), **fwd_held(o, lse))
        fwd_mutants = {"tf32": (mo, mlse),
                       "lse_base2": (o, lse / 0.6931471805599453)}
        res["mutants"] = {m: {"rel_l2": max(rel_l2(g[n], ref[n])
                                           for n in names),
                              "vs_fp64": {n: rel_l2_64(g[n], exact[n])
                                          for n in names}}
                          for m, g in mutants.items()}
        res["forward_mutants"] = {
            m: {"o_rel_l2": rel_l2(fo, ro),
                "lse_abs": (flse - rlse).abs().max().item()}
            for m, (fo, flse) in fwd_mutants.items()}
        passed = ([m for m, g in mutants.items() if all(held(g).values())]
                  + [f"forward {m}" for m, (fo, flse) in fwd_mutants.items()
                     if all(fwd_held(fo, flse).values())])
        del ref, got, exact, mutants, fwd_mutants, q, k, v, do, o, lse, ro
        del rlse, mo, mlse, o64, lse64
        torch.cuda.empty_cache()
        if not (res["o_same_bits"] and all(res["held"].values())) or passed:
            raise RuntimeError(f"the fp32 flash route inside the stage-1 step "
                               f"disagrees with its plain version and with "
                               f"fp64, or the criterion passes the mutants "
                               f"{passed}: {res}")
        out.append(res)
    return out


def stage1_grad_check(dev, vae_params, stage1_config, batch, d) -> dict:
    """The loss and the loss gradient of STAGE1_PROBES on the initial
    weights, one posterior draw: the bf16 trainer with the flag on, with it
    off, and the fp32 trainer with it off (the reference both bf16 ones are
    held to).  Each probe passes when flash is within TOL_GRAD_REL of dense
    in relative L2, or no further than GRAD_VS_FP32_RATIO times dense's
    distance from the fp32 gradient.  The flagged step's flash route is
    also held at its own boundary (flash_route_check); and the gradient
    reaching the latent sample is read in each run, which says how far the
    bf16 runs' rounding alone moves what the encoder's probes receive.  The
    flagged step runs again with PIPELINE_FWD on (the deferred-softmax
    forward), held by the same rule and at its own boundary, and read
    against the switch-off flagged step."""
    from diffute_tpu_torch.train import VAETrainer

    runs, records, dz = {}, {"flash": [], "flash_pipelined": []}, {}
    draws = None
    for name, on, precision in (("flash", True, "bf16"),
                                ("flash_pipelined", True, "bf16"),
                                ("dense", False, "bf16"),
                                ("fp32_dense", False, "no")):
        cfg = stage1_config(on)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, mixed_precision=precision))
        trainer = VAETrainer(cfg, vae_params, device=dev, total_steps=1)
        if draws is None:
            draws = trainer.draw(cfg.train.train_batch_size).float()
        spy = (flash_route_spy(records[name]) if on
               else contextlib.nullcontext())
        with spy, latent_grad_spy(dz.setdefault(name, [])), \
                pipeline_fwd(name == "flash_pipelined"):
            reset_counters()
            loss = trainer.accumulate_grads(batch, draws).item()
            if name == "flash_pipelined":
                expect_flash({"launches": counters()},
                             **{f"flash_fwd_pipelined_d{d}": 2,
                                f"flash_bwd_dq_d{d}": 2,
                                f"flash_bwd_dkv_d{d}": 2})
        masters = trainer.state.params_dict()
        runs[name] = (loss, {n: masters[n].grad.float().clone()
                             for n in STAGE1_PROBES})
        del trainer, masters
        gc.collect()
        torch.cuda.empty_cache()

    def rel(a, b):
        return {n: rel_l2(runs[a][1][n], runs[b][1][n])
                for n in STAGE1_PROBES}

    res = dict(loss={k: v[0] for k, v in runs.items()},
               grad_rel_l2_err=rel("flash", "dense"),
               pipelined_vs_flash=rel("flash_pipelined", "flash"),
               pipelined_equals_flash=all(
                   torch.equal(runs["flash_pipelined"][1][n],
                               runs["flash"][1][n]) for n in STAGE1_PROBES)
               and runs["flash_pipelined"][0] == runs["flash"][0],
               pipelined_vs_fp32=rel("flash_pipelined", "fp32_dense"),
               flash_vs_fp32=rel("flash", "fp32_dense"),
               dense_vs_fp32=rel("dense", "fp32_dense"),
               grad_norm_fp32={n: runs["fp32_dense"][1][n].norm().item()
                               for n in STAGE1_PROBES},
               latent_grad=dict(
                   dense_vs_fp32=rel_l2(dz["dense"][0], dz["fp32_dense"][0]),
                   flash_vs_dense=rel_l2(dz["flash"][0], dz["dense"][0]),
                   norm_fp32=dz["fp32_dense"][0].norm().item()),
               tolerance=TOL_GRAD_REL, ratio_to_dense=GRAD_VS_FP32_RATIO,
               loss_tolerance=TOL_LOSS_REL)
    flash_dense = rel("flash_pipelined", "dense")
    bad = [(run, n) for run, vs_dense in (("flash", res["grad_rel_l2_err"]),
                                          ("flash_pipelined", flash_dense))
           for n in STAGE1_PROBES
           if not (vs_dense[n] <= TOL_GRAD_REL
                   or res[("pipelined" if run != "flash" else run)
                          + "_vs_fp32"][n]
                   <= GRAD_VS_FP32_RATIO * res["dense_vs_fp32"][n])]
    loss_dense = res["loss"]["dense"]
    if bad or not res["pipelined_equals_flash"] or not all(
            abs(res["loss"][run] - loss_dense) <= TOL_LOSS_REL * loss_dense
            for run in ("flash", "flash_pipelined")):
        raise RuntimeError(f"stage-1 gradient with flash differs at {bad}: "
                           f"{res}")
    res["flash_route"] = flash_route_check(records["flash"], d)
    res["flash_route_pipelined"] = flash_route_check(
        records["flash_pipelined"], d)
    return res


def expect_flash(rec: dict, **nonzero) -> None:
    """Every flash counter of ``rec``: those named as given, the others 0
    (the head_dim-64, -256 and -512 kernels alike)."""
    expect_launches(rec, **{k: nonzero.get(k, 0) for k in rec["launches"]
                            if k.startswith("flash_")})


# The VAE's flash paths by scale: phase 8a (full, SD2 width: head_dim 512)
# and 8b (small, small_config: head_dim 256).  ``per_pass``: the UNet's flash
# self-attentions a pass at each resolution (full: 10 at 512^2, 15 at
# 1024^2; small: 10 at 256^2); ``blend``: also a 20-step edit with the
# masked-latent blend (three encodes and decodes).
VAE_FLASH_SCALES = {
    "full": dict(d=512, resolutions=(RES, 1024), per_pass=(10, 15),
                 batch=WORKFLOW_BATCH, blend=False, prefix=""),
    "small": dict(d=256, resolutions=(256,), per_pass=(10,), batch=16,
                  blend=True, prefix="small_")}


def check_vae_flash(dev, scale: str = "full") -> dict:
    """Phase 8a (``scale`` "full": the SD2 VAE, head_dim 512) or 8b
    ("small": small_config's VAE, block_out_channels (64, 128, 256), one
    head of 256 over 4,096 tokens at 256^2) with
    VAEConfig.use_flash_attention on every path that runs it, at the
    scale's full width, bf16, weights from seed 0 (VAE_FLASH_SCALES).  One
    encode and one decode at each resolution, flag on against flag off with
    the same weights (each output within TOL_VAE_FLASH_REL; peak memory of
    each; 1 wide forward each); a 20-step edit at each resolution with the
    flag (2 wide forwards; only the box changes; the gap to the same seed
    with the flag off in LSB), at the small scale also one with the blend
    (3); one stage-2 step with the flagged frozen VAE (2 wide forwards, the
    UNet's 20/10/10); then, with the VAE's weights alone resident, the loss
    gradient of four weights flag on against off (stage1_grad_check) and
    three stage-1 steps through VAETrainer (batch 4 full, 16 small; the
    first resolution; bf16, remat), flag off and on (seconds and peak
    memory; 2 forward, 2 dq and 2 dk/dv launches a step).  Every flagged
    path runs again with PIPELINE_FWD on: the wide forwards move to the
    deferred-softmax kernel and the UNet's head_dim-64 ones to its own; the
    encodes and decodes give the switch-off flagged run's bits, the edits
    are within PIPELINE_EDIT_LSB of it (the UNet's forwards change kernel
    too), the stage-2 step's loss within TOL_LOSS_REL, the stage-1 steps'
    losses and gradient norms and the gradient check's probes equal to the
    bit, and the gradient check holds the switch-on step's flash route at
    its boundary.
    Every flash counter is asserted on each path.  Returns the numbers and
    the launches by path."""
    from diffute_tpu_torch.config import (DiffUTEConfig, TrainConfig,
                                          card_serving_config, small_config)
    from diffute_tpu_torch.io.dataset import (SyntheticSceneDataset,
                                              make_unet_batch, make_vae_batch)
    from diffute_tpu_torch.models import AutoencoderKL
    from diffute_tpu_torch.pipeline import DiffUTEPipeline
    from diffute_tpu_torch.train import UNetTrainer, VAETrainer
    from diffute_tpu_torch.utils import init_pipeline_params
    from diffute_tpu_torch.utils.params import load_module

    sc = VAE_FLASH_SCALES[scale]
    d, resolutions, batch_size = sc["d"], sc["resolutions"], sc["batch"]
    pre, fwd_key = sc["prefix"], f"flash_fwd_d{d}"
    pipe_key = f"flash_fwd_pipelined_d{d}"
    bf16 = torch.bfloat16
    base = DiffUTEConfig() if scale == "full" else small_config()
    out = {"launches": {}}
    params = init_pipeline_params(base, seed=0, device=dev)
    flags = (False, True)

    def vae_config(on, **more):
        return dataclasses.replace(base.vae, use_flash_attention=on, **more)

    # ---- encode and decode, flag off and on
    vaes = {on: load_module(AutoencoderKL, vae_config(on, dtype=bf16),
                            params["vae"], dev, bf16)
            for on in flags}
    g = torch.Generator(device=dev).manual_seed(11)
    codec = {}
    for res in resolutions:
        x = torch.rand((1, 3, res, res), generator=g, device=dev) * 2 - 1
        x = x.to(bf16)
        with torch.inference_mode():
            z = vaes[False].encode(x)[0]
            runs = {}
            for what in ("encode", "decode"):
                for on in (False, True, "pipelined"):
                    with pipeline_fwd(on == "pipelined"):
                        runs[(what, on)] = measured(dev, lambda: (
                            vaes[bool(on)].encode(x)[0] if what == "encode"
                            else vaes[bool(on)].decode(z)).float())
        rec = {}
        for what in ("encode", "decode"):
            r_off, r_on = runs[(what, False)], runs[(what, True)]
            r_pipe = runs[(what, "pipelined")]
            ref = r_off["out"]
            rel = ((r_on["out"] - ref).abs().max() / ref.abs().max()).item()
            finite = bool(torch.isfinite(r_on["out"]).all()
                          and torch.isfinite(ref).all())
            rec[what] = dict(
                rel_max_err=rel, finite=finite,
                **{("flash" if k else "dense"): dict(
                    seconds=r["seconds"], launches=wide_launches(r, d),
                    max_memory_allocated=r["max_memory_allocated"],
                    peak_above_resident=(r["max_memory_allocated"]
                                         - r["memory_allocated_before"]))
                   for k, r in ((False, r_off), (True, r_on))})
            rec[what]["flash_pipelined"] = dict(
                seconds=r_pipe["seconds"], launches=wide_launches(r_pipe, d),
                max_memory_allocated=r_pipe["max_memory_allocated"],
                peak_above_resident=(r_pipe["max_memory_allocated"]
                                     - r_pipe["memory_allocated_before"]),
                equals_flash=torch.equal(r_pipe["out"], r_on["out"]))
            expect_flash(r_on, **{fwd_key: 1})
            expect_flash(r_off)
            expect_flash(r_pipe, **{pipe_key: 1})
            if not (finite and rel <= TOL_VAE_FLASH_REL):
                raise RuntimeError(f"VAE {what} at {res}^2 with flash "
                                   f"differs from dense: {rec[what]}")
            if not rec[what]["flash_pipelined"]["equals_flash"]:
                raise RuntimeError(f"VAE {what} at {res}^2 with PIPELINE_FWD "
                                   f"differs from the switch off: "
                                   f"{rec[what]}")
            out["launches"][f"{pre}vae_{what}_{res}"] = r_on["launches"]
            out["launches"][f"{pre}vae_{what}_{res}_pipelined"] = (
                r_pipe["launches"])
        codec[res] = rec
        del runs, z, x
    phase(f"{pre}vae_flash_codec", tolerance_rel_max=TOL_VAE_FLASH_REL,
          **{str(r): v for r, v in codec.items()})
    out["codec"] = codec
    del vaes

    # ---- 20-step edits at each resolution, flag off and on, same seed
    serving = dataclasses.replace(
        card_serving_config(base),
        edit=dataclasses.replace(base.edit,
                                 num_inference_steps=VAE_FLASH_STEPS))
    pipes = {on: DiffUTEPipeline(dataclasses.replace(
                 serving, vae=vae_config(on, dtype=bf16)), params, dev)
             for on in flags}
    edits = {}
    for res, per_pass in zip(resolutions, sc["per_pass"]):
        image, box = scene(res)
        ec = dataclasses.replace(serving.edit, resolution=res)
        for pipe in pipes.values():
            pipe.edit(image, box, "warm", seed=0, edit_config=ec,
                      num_inference_steps=2)
        runs = {on: measured(dev, lambda: pipes[on].edit(
                    image, box, "VAE FLASH", seed=5, edit_config=ec)[0])
                for on in flags}
        for on in flags:
            only_boxes_changed(runs[on]["out"], image, [box])
            expect_flash(runs[on], flash_fwd=per_pass * VAE_FLASH_STEPS,
                         **{fwd_key: 2 if on else 0})
        lsb = int(np.abs(runs[True]["out"].astype(np.int16)
                         - runs[False]["out"]).max())
        edits[res] = dict(max_lsb_flash_vs_dense=lsb, **{
            ("flash" if on else "dense"): dict(
                seconds=r["seconds"], launches=wide_launches(r, d),
                max_memory_allocated=r["max_memory_allocated"])
            for on, r in runs.items()})
        out["launches"][f"{pre}edit_{res}_vae_flash"] = runs[True]["launches"]
        variants = [("", ec, 2, runs[True]["out"])]
        if sc["blend"]:
            # the crop is encoded too: three encodes and decodes
            bec = dataclasses.replace(ec, masked_latent_blend=True)
            r = measured(dev, lambda: pipes[True].edit(
                image, box, "VAE FLASH", seed=5, edit_config=bec)[0])
            only_boxes_changed(r["out"], image, [box])
            expect_flash(r, flash_fwd=per_pass * VAE_FLASH_STEPS,
                         **{fwd_key: 3})
            edits[res]["flash_blend"] = dict(
                seconds=r["seconds"], launches=wide_launches(r, d),
                max_memory_allocated=r["max_memory_allocated"])
            out["launches"][f"{pre}edit_{res}_vae_flash_blend"] = (
                r["launches"])
            variants.append(("_blend", bec, 3, r["out"]))
        # the same edits with the switch on: every flash forward deferred
        with pipeline_fwd(True):
            pipes[True].edit(image, box, "warm", seed=0, edit_config=ec,
                             num_inference_steps=2)
            for suffix, cfg, n_wide, ref in variants:
                r = measured(dev, lambda: pipes[True].edit(
                    image, box, "VAE FLASH", seed=5, edit_config=cfg)[0])
                only_boxes_changed(r["out"], image, [box])
                expect_flash(r, flash_fwd_pipelined=per_pass * VAE_FLASH_STEPS,
                             **{pipe_key: n_wide})
                gap = int(np.abs(r["out"].astype(np.int16) - ref).max())
                edits[res][f"flash{suffix}_pipelined"] = dict(
                    seconds=r["seconds"], launches=wide_launches(r, d),
                    max_memory_allocated=r["max_memory_allocated"],
                    max_lsb_vs_switch_off=gap)
                out["launches"][
                    f"{pre}edit_{res}_vae_flash{suffix}_pipelined"] = (
                        r["launches"])
                if gap > PIPELINE_EDIT_LSB:
                    raise RuntimeError(f"the {res}^2 edit{suffix} with "
                                       f"PIPELINE_FWD is {gap} LSB from the "
                                       f"switch off")
        phase(f"{pre}vae_flash_edit", resolution=res, steps=VAE_FLASH_STEPS,
              **edits[res])
    out["edits"] = edits
    del pipes, runs
    gc.collect()
    torch.cuda.empty_cache()

    # ---- stage 2: one step with the flagged frozen VAE
    s2cfg = dataclasses.replace(
        base, unet=dataclasses.replace(base.unet, use_flash_attention=True,
                                       remat=True),
        vae=vae_config(True),
        edit=dataclasses.replace(base.edit, resolution=resolutions[0]),
        train=TrainConfig(train_batch_size=batch_size,
                          mixed_precision="bf16", gradient_checkpointing=True,
                          max_train_steps=1))
    data = SyntheticSceneDataset(s2cfg, seed=0)
    batch = make_unet_batch([data[i] for i in range(batch_size)], s2cfg)
    stage2 = {}
    for name in ("flash", "flash_pipelined"):
        trainer = UNetTrainer(s2cfg, params["unet"],
                              {"vae": params["vae"],
                               "trocr": params["trocr"]},
                              device=dev, total_steps=1)
        with pipeline_fwd(name == "flash_pipelined"):
            r = measured(dev, lambda: {k: v.item() for k, v in
                                         trainer.step(batch).items()})
        stage2[name] = dict(r.pop("out"), batch=batch_size,
                            seconds=r["seconds"], launches=r["launches"],
                            max_memory_allocated=r["max_memory_allocated"])
        # the masked and the target image encoded, no gradient: two wide
        # forwards; the UNet's flash counts as in phase 6
        expect_flash(r, **{(pipe_key if name == "flash_pipelined"
                            else fwd_key): 2},
                     **{("flash_fwd_pipelined" if name == "flash_pipelined"
                         else "flash_fwd"): 20},
                     flash_bwd_dq=10, flash_bwd_dkv=10)
        out["launches"][f"{pre}stage2_vae_{name}"] = r["launches"]
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    loss_on, loss_off = (stage2[n]["loss"] for n in ("flash_pipelined",
                                                     "flash"))
    stage2["pipelined_loss_rel_diff"] = abs(loss_on - loss_off) / loss_off
    phase(f"{pre}vae_flash_stage2", **stage2)
    if not (all(np.isfinite(stage2[n][k]) for n in ("flash", "flash_pipelined")
                for k in ("loss", "grad_norm"))
            and stage2["pipelined_loss_rel_diff"] <= TOL_LOSS_REL):
        raise RuntimeError(f"stage-2 step with the flagged VAE: {stage2}")
    out["stage2"] = stage2
    del batch, data
    # stage 1 holds the VAE's weights alone, as phase 8 does
    del params["unet"], params["trocr"]
    gc.collect()
    torch.cuda.empty_cache()

    # ---- stage 1: three steps flag off, three flag on; the gradient of
    # four weights flag on against off
    def stage1_config(on):
        return dataclasses.replace(
            base, vae=vae_config(on, remat=True),
            edit=dataclasses.replace(base.edit, resolution=resolutions[0]),
            train=TrainConfig(train_batch_size=batch_size,
                              mixed_precision="bf16",
                              gradient_checkpointing=True,
                              max_train_steps=STAGE1_STEPS))

    data = SyntheticSceneDataset(stage1_config(False), seed=0)
    batches = [make_vae_batch([data[batch_size * i + j]
                               for j in range(batch_size)])
               for i in range(STAGE1_STEPS)]
    stage1 = {"grad_check": stage1_grad_check(
        dev, params["vae"], stage1_config, batches[0], d)}
    for name, on, switch in (("dense", False, False), ("flash", True, False),
                             ("flash_pipelined", True, True)):
        trainer = VAETrainer(stage1_config(on), params["vae"], device=dev,
                             total_steps=STAGE1_STEPS)
        steps = []
        for batch in batches:
            with pipeline_fwd(switch):
                r = measured(dev, lambda: {k: v.item() for k, v in
                                             trainer.step(batch).items()})
            steps.append(dict(r.pop("out"), seconds=r["seconds"],
                              max_memory_allocated=r["max_memory_allocated"],
                              memory_allocated_before=r[
                                  "memory_allocated_before"],
                              launches=wide_launches(r, d)))
            fwd = pipe_key if switch else f"flash_fwd_d{d}"
            expect_flash(r, **({fwd: 2, f"flash_bwd_dq_d{d}": 2,
                                f"flash_bwd_dkv_d{d}": 2} if on else {}))
            if on:
                out["launches"][f"{pre}stage1_vae_{name}_step{len(steps)}"] = (
                    r["launches"])
        if not all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])
                   for s in steps):
            raise RuntimeError(f"stage 1 steps not finite: {steps}")
        stage1[name] = steps
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    pairs = list(zip(stage1["flash_pipelined"], stage1["flash"]))
    stage1["pipelined_vs_flash"] = dict(
        same_bits=[a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
                   for a, b in pairs])
    # only the wide forward changes kernel, and it gives the standard one's
    # bits (phase 3e), so the steps' losses and gradient norms are equal
    if not all(stage1["pipelined_vs_flash"]["same_bits"]):
        raise RuntimeError(f"stage 1 with PIPELINE_FWD differs: "
                           f"{stage1['pipelined_vs_flash']}")
    phase(f"{pre}vae_flash_stage1", batch=batch_size,
          resolution=resolutions[0], **stage1)
    out["stage1"] = stage1
    del batches, data, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def kernel_entry(name, source, replaces, results, launches) -> dict:
    """One kernel's entry of the final ``kernels`` line: its launches by
    path, and the main shape's (the first result's) times and bound."""
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


def wide_entries(results: dict, launches: dict, d: int) -> list:
    """The three head_dim-``d`` kernels' entries (phase 3c or 3d), with the
    VAE's flash paths' launches by path (``launches``: path -> counters read
    right after it ran)."""
    def by_path(key):
        return {path: rec[key] for path, rec in launches.items() if rec[key]}

    return [kernel_entry(f"{name}_d{d}_bf16",
                         wide_source(d, not part.startswith("fwd")),
                         f"flash_attention.py:{line}", results[part],
                         by_path(f"{name}_d{d}"))
            for name, part, line in (("flash_fwd", "fwd", 275),
                                     ("flash_fwd_pipelined", "fwd_pipelined",
                                      149),
                                     ("flash_bwd_dq", "dq", 396),
                                     ("flash_bwd_dkv", "dkv", 437))]


def vae_flash_summary(vae_flash: dict) -> dict:
    return {k: v for k, v in vae_flash.items() if k != "launches"}


# ---- phase 8c: the fp32 paths at full width with flash
# a 20-step fp32 edit with flash against the same edit dense, and with the
# deferred-softmax switch on against off: at most this many LSB apart (both
# fp32, the kernels within relative L2 1e-5 of fp32 attention)
FP32_EDIT_LSB = 1
# one fp32 stage-2 step and three stage-1 steps, flash on against off, the
# same weights and draws: the loss within TOL_FP32_LOSS_REL, the loss
# gradient of each probe within TOL_FP32_GRAD_REL (relative L2)
TOL_FP32_LOSS_REL, TOL_FP32_GRAD_REL = 1e-5, 1e-4
FP32_TRAIN_STEPS = 2


def fp32_launches(rec: dict, widths=(64, 256, 512)) -> dict:
    """The fp32 flash counters of a measured run, by entry."""
    return {fp32_entry(kind, d): rec["launches"][fp32_entry(kind, d)]
            for kind in FP32_KINDS for d in widths}


def fp32_run_record(r, **more):
    """A measured fp32 path's seconds, peaks and fp32 flash launches."""
    return dict(seconds=r["seconds"],
                max_memory_allocated=r["max_memory_allocated"],
                peak_above_resident=(r["max_memory_allocated"]
                                     - r["memory_allocated_before"]),
                launches=fp32_launches(r), **more)


def fp32_stage1_config(cfg, on, batch_size, res):
    """``cfg`` for fp32 stage-1 steps: the VAE's flag ``on``, remat,
    ``batch_size`` at ``res``^2, gradient checkpointing."""
    from diffute_tpu_torch.config import TrainConfig

    return dataclasses.replace(
        cfg, vae=dataclasses.replace(cfg.vae, use_flash_attention=on,
                                     remat=True),
        edit=dataclasses.replace(cfg.edit, resolution=res),
        train=TrainConfig(train_batch_size=batch_size, mixed_precision="no",
                          gradient_checkpointing=True,
                          max_train_steps=STAGE1_STEPS))


def fp32_stage1_steps(dev, cfg_of, vae_params, batch_size, d, runs, prefix,
                      out, route=None, route_pipelined=None) -> dict:
    """STAGE1_STEPS fp32 VAETrainer steps for each (name, flag) of
    ``runs`` on the same synthetic batches: each step's loss, grad norm,
    seconds, peaks and launches (2 forwards, 2 dq and 2 dk/dv at head_dim
    ``d`` a flagged step), the flagged steps' launches into
    ``out["launches"]``.  ``route``: after the timed steps, one more
    flagged step (untimed) keeps its flash calls there
    (flash_route_spy); ``route_pipelined``: one more with PIPELINE_FWD on
    (2 deferred forwards, 2 dq, 2 dk/dv)."""
    from diffute_tpu_torch.io.dataset import (SyntheticSceneDataset,
                                              make_vae_batch)
    from diffute_tpu_torch.train import VAETrainer

    data = SyntheticSceneDataset(cfg_of(False), seed=0)
    batches = [make_vae_batch([data[batch_size * i + j]
                               for j in range(batch_size)])
               for i in range(STAGE1_STEPS)]
    flagged = {fp32_entry(kind, d): 2 for kind in ("fwd", "bwd_dq", "bwd_dkv")}
    res = {}
    for name, on in runs:
        trainer = VAETrainer(cfg_of(on), vae_params, device=dev,
                             total_steps=STAGE1_STEPS)
        steps = []
        for b in batches:
            r = measured(dev, lambda: {k: v.item() for k, v in
                                         trainer.step(b).items()})
            expect_flash(r, **(flagged if on else {}))
            steps.append(dict(r.pop("out"), **fp32_run_record(
                r, memory_allocated_before=r["memory_allocated_before"])))
            if on:
                out["launches"][f"{prefix}stage1_vae_{name}_step"
                                f"{len(steps)}"] = r["launches"]
        if not all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])
                   for s in steps):
            raise RuntimeError(f"fp32 stage-1 steps not finite: {steps}")
        if on and route is not None:
            with flash_route_spy(route):
                r = measured(dev, lambda: trainer.step(batches[0]))
            expect_flash(r, **flagged)
        if on and route_pipelined is not None:
            with flash_route_spy(route_pipelined), pipeline_fwd(True):
                r = measured(dev, lambda: trainer.step(batches[0]))
            expect_flash(r, **{fp32_entry("fwd_pipelined", d): 2,
                               fp32_entry("bwd_dq", d): 2,
                               fp32_entry("bwd_dkv", d): 2})
        res[name] = steps
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    return res


# the UNet self-attentions whose flash calls fp32_stage2_step holds at
# their own boundary, q (B, S, H, D) at TRAIN_BATCH: 5 heads at 4096 tokens
# (64^2 latents at 512^2), 10 at 1024 (32^2)
FP32_STAGE2_ROUTE_SHAPES = [(TRAIN_BATCH, 4096, 5, 64),
                            (TRAIN_BATCH, 1024, 10, 64)]
# full optimizer steps fp32_stage2_step times after its checks
FP32_STAGE2_TIMED = 3


def fp32_stage2_step(dev, params, out) -> dict:
    """8c's flagged fp32 stage-2 step: one UNetTrainer loss evaluation at
    batch TRAIN_BATCH with both flash flags, remat and gradient
    checkpointing (20 fp32 forwards, 10 dq and 10 dk/dv at head_dim 64, 2
    forwards at 512 in the frozen encodes) against the same with flash off
    (the loss within TOL_FP32_LOSS_REL, the loss gradient of four UNet
    weights within TOL_FP32_GRAD_REL); one more with the flash route
    recorded (flash_route_spy) and one with PIPELINE_FWD on too (the 20
    forwards and the 2 at 512 deferred); the route held at its own boundary
    (flash_route_check, fp32: o, the LSE, dq, dk and dv of the first call
    at each of FP32_STAGE2_ROUTE_SHAPES, with the switch off and on); then
    FP32_STAGE2_TIMED full optimizer steps (UNetTrainer.step) with flash
    on, timed.  ``params``: the pipeline's weights from seed 0, fp32.
    Returns the step's numbers; its launches go into out["launches"]."""
    from diffute_tpu_torch.config import DiffUTEConfig, TrainConfig
    from diffute_tpu_torch.io.dataset import (SyntheticSceneDataset,
                                              make_unet_batch)
    from diffute_tpu_torch.models.attention import Attention
    from diffute_tpu_torch.train import UNetTrainer

    s2cfg = dataclasses.replace(
        fp32_flags(DiffUTEConfig(), remat=True),
        train=TrainConfig(train_batch_size=TRAIN_BATCH, mixed_precision="no",
                          gradient_checkpointing=True, max_train_steps=1))
    trainer = UNetTrainer(s2cfg, params["unet"],
                          {"vae": params["vae"], "trocr": params["trocr"]},
                          device=dev, total_steps=1)
    data = SyntheticSceneDataset(s2cfg, seed=0)
    batch = make_unet_batch([data[i] for i in range(TRAIN_BATCH)], s2cfg)
    draws = trainer.draw(TRAIN_BATCH)
    probes = ["conv_in.weight",
              "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight",
              "up_blocks.3.attentions.2.transformer_blocks.0.attn1.to_v.weight",
              "conv_out.weight"]
    masters = trainer.state.params_dict()
    r_on = measured(dev, lambda: trainer.accumulate_grads(batch, draws).item())
    grads_on = {n: masters[n].grad.clone() for n in probes}
    expect_flash(r_on, **{fp32_entry("fwd", 64): 20,
                          fp32_entry("bwd_dq", 64): 10,
                          fp32_entry("bwd_dkv", 64): 10,
                          fp32_entry("fwd", 512): 2})
    route, route_pipelined = [], []
    with flash_route_spy(route):
        r = measured(dev, lambda: trainer.accumulate_grads(batch, draws))
    expect_flash(r, **{fp32_entry("fwd", 64): 20,
                       fp32_entry("bwd_dq", 64): 10,
                       fp32_entry("bwd_dkv", 64): 10,
                       fp32_entry("fwd", 512): 2})
    with flash_route_spy(route_pipelined), pipeline_fwd(True):
        r = measured(dev, lambda: trainer.accumulate_grads(batch, draws))
    expect_flash(r, **{fp32_entry("fwd_pipelined", 64): 20,
                       fp32_entry("bwd_dq", 64): 10,
                       fp32_entry("bwd_dkv", 64): 10,
                       fp32_entry("fwd_pipelined", 512): 2})
    attns = [m for model in (trainer.unet, trainer.vae)
             for m in model.modules() if isinstance(m, Attention)]
    for m in attns:
        m.use_flash = False
    r_off = measured(dev, lambda: trainer.accumulate_grads(batch,
                                                           draws).item())
    expect_flash(r_off)
    rel = {n: rel_l2(grads_on[n], masters[n].grad) for n in probes}
    loss_on, loss_off = r_on.pop("out"), r_off.pop("out")
    step = dict(batch=TRAIN_BATCH, loss_flash=loss_on, loss_dense=loss_off,
                loss_rel_diff=abs(loss_on - loss_off) / abs(loss_off),
                grad_rel_l2_err=rel, loss_tolerance=TOL_FP32_LOSS_REL,
                grad_tolerance=TOL_FP32_GRAD_REL,
                flash=fp32_run_record(r_on), dense=fp32_run_record(r_off))
    out["launches"]["fp32_stage2_vae_flash"] = r_on["launches"]
    phase("fp32_stage2_step", **step)
    if not (step["loss_rel_diff"] <= TOL_FP32_LOSS_REL
            and max(rel.values()) <= TOL_FP32_GRAD_REL):
        raise RuntimeError(f"the fp32 stage-2 step with flash differs: "
                           f"{step}")
    for m in attns:
        m.use_flash = True
    steps = []
    for _ in range(FP32_STAGE2_TIMED):
        r = measured(dev, lambda: {k: v.item() for k, v in
                                     trainer.step(batch).items()})
        expect_flash(r, **{fp32_entry("fwd", 64): 20,
                           fp32_entry("bwd_dq", 64): 10,
                           fp32_entry("bwd_dkv", 64): 10,
                           fp32_entry("fwd", 512): 2})
        steps.append(dict(r.pop("out"), **fp32_run_record(r)))
    step["timed_steps"] = steps
    phase("fp32_stage2_timed_steps", batch=TRAIN_BATCH, steps=steps)
    del trainer, masters, grads_on, attns, batch, data, draws, r
    gc.collect()
    torch.cuda.empty_cache()
    step["flash_route"] = flash_route_check(
        route, 64, shapes=FP32_STAGE2_ROUTE_SHAPES)
    phase("fp32_stage2_flash_route", routes=step["flash_route"])
    del route
    step["flash_route_pipelined"] = flash_route_check(
        route_pipelined, 64, pipelined=True, shapes=FP32_STAGE2_ROUTE_SHAPES)
    phase("fp32_stage2_flash_route_pipelined",
          routes=step["flash_route_pipelined"])
    del route_pipelined
    gc.collect()
    torch.cuda.empty_cache()
    return step


def check_fp32_sd2_stage1(dev, vae_params, out, save_route=None) -> dict:
    """8c's SD2 stage 1: VAETrainer on the SD2 VAE at 512^2 in fp32 (the
    JAX trainer's default precision), batch 4, gradient checkpointing,
    STAGE1_STEPS steps flag off and on (2 forwards, 2 dq, 2 dk/dv at
    head_dim 512 a flagged step; the losses within TOL_FP32_LOSS_REL), each
    step's seconds and peak memory; then the flash route held at its own
    boundary inside one more flagged step, and one more with PIPELINE_FWD
    on (flash_route_check, fp32: the forward's o and LSE, dq, dk, dv).
    ``save_route``: a path where the PIPELINE_FWD step's mid-block calls
    (q, k, v, dO) are saved first, for tools.fp32_d512_bwd_variants
    --chain-study."""
    from diffute_tpu_torch.config import DiffUTEConfig

    base, route, route_pipelined = DiffUTEConfig(), [], []
    s1 = fp32_stage1_steps(
        dev, lambda on: fp32_stage1_config(base, on, WORKFLOW_BATCH, RES),
        vae_params, WORKFLOW_BATCH, 512, (("dense", False), ("flash", True)),
        "fp32_", out, route, route_pipelined)
    s1["loss_rel_diff"] = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                           for a, b in zip(s1["flash"], s1["dense"])]
    phase("fp32_stage1", batch=WORKFLOW_BATCH, resolution=RES,
          loss_tolerance=TOL_FP32_LOSS_REL, **s1)
    if not max(s1["loss_rel_diff"]) <= TOL_FP32_LOSS_REL:
        raise RuntimeError(f"fp32 stage 1 with flash differs: {s1}")
    if save_route:
        torch.save([{n: rec[n] for n in ("q", "k", "v", "do")}
                    for rec in route_pipelined], save_route)
    s1["flash_route"] = flash_route_check(route, 512)
    phase("fp32_stage1_flash_route", routes=s1["flash_route"])
    s1["flash_route_pipelined"] = flash_route_check(route_pipelined, 512,
                                                    pipelined=True)
    phase("fp32_stage1_flash_route_pipelined",
          routes=s1["flash_route_pipelined"])
    return s1


# the small_config stage-1 batch (VAEConfig with the flag: the mid-block's
# (16, 4096, 1, 256) calls at 256^2)
SMALL_STAGE1_BATCH = 16


def check_fp32_small_stage1(dev, vae_params, out) -> dict:
    """8c's small_config stage 1: STAGE1_STEPS fp32 VAETrainer steps on the
    small VAE at 256^2 and batch SMALL_STAGE1_BATCH with the flag and
    gradient checkpointing (2 forwards, 2 dq, 2 dk/dv at head_dim 256 a
    step), each timed; then the flash route held at its own boundary inside
    one more flagged step and one with PIPELINE_FWD on (flash_route_check,
    fp32: the forward's o and LSE, dq, dk, dv against the tiled plain
    versions or fp64, every mutant failing)."""
    from diffute_tpu_torch.config import small_config

    small, route, route_pipelined = small_config(), [], []
    s1 = fp32_stage1_steps(
        dev, lambda on: fp32_stage1_config(small, on, SMALL_STAGE1_BATCH,
                                           256),
        vae_params, SMALL_STAGE1_BATCH, 256, (("flash", True),),
        "fp32_small_", out, route, route_pipelined)
    phase("fp32_small_stage1", batch=SMALL_STAGE1_BATCH, resolution=256,
          **s1)
    s1["flash_route"] = flash_route_check(route, 256)
    phase("fp32_small_stage1_flash_route", routes=s1["flash_route"])
    del route
    s1["flash_route_pipelined"] = flash_route_check(
        route_pipelined, 256, pipelined=True)
    phase("fp32_small_stage1_flash_route_pipelined",
          routes=s1["flash_route_pipelined"])
    del route_pipelined
    gc.collect()
    torch.cuda.empty_cache()
    return s1


def route_summary(routes: list) -> list:
    """What a route check's calls read, for the final line: each output's
    distance from fp64 beside the plain version's."""
    return [{k: r[k] for k in ("shape", "forward", "flash_vs_fp64",
                               "plain_vs_fp64", "max_abs_score")}
            for r in routes]


def check_fp32_paths(dev) -> dict:
    """Phase 8c: the fp32 paths at full width with the fp32 flash kernels,
    weights from seed 0.  Serving (bench.py --dtype fp32's configuration
    with the VAE's flag, as benchmarks/vae_bench.py --flash): one 20-step
    512^2 edit through DiffUTEPipeline with UNet, VAE and TrOCR in fp32 and
    both flash flags on (200 head_dim-64 and 2 head_dim-512 fp32 forwards),
    the same edit with both flags off (dense fp32) and with PIPELINE_FWD on
    (200 + 2 deferred launches): only the box changes, each within
    FP32_EDIT_LSB of the flagged switch-off edit.  Stage 2:
    train.run_unet --mixed_precision no at full width (batch 4, gradient
    checkpointing, AdamW, synthetic scenes, FP32_TRAIN_STEPS steps; 20 fp32
    forwards, 10 dq, 10 dk/dv a step), then one UNetTrainer step with the
    VAE's flag too (2 head_dim-512 forwards in the frozen encodes) against
    the same step with flash off (the loss within TOL_FP32_LOSS_REL, the
    loss gradient of four UNet weights within TOL_FP32_GRAD_REL), the
    head_dim-64 flash route held inside it with PIPELINE_FWD off and on and
    full steps timed (fp32_stage2_step).  Stage 1:
    VAETrainer on the SD2 VAE at 512^2 in fp32 (the JAX trainer's default
    precision), batch 4, gradient checkpointing, 3 steps flag on and 3 off
    (2 forwards, 2 dq, 2 dk/dv at head_dim 512 a step; the losses within
    TOL_FP32_LOSS_REL), and the flash route inside one more flagged step
    (check_fp32_sd2_stage1).  small_config: an encode and a decode at 256^2
    flag on, and with PIPELINE_FWD on too, against off, and 3 stage-1 steps at
    batch 16 (2, 2, 2 at head_dim 256 a step) with the head_dim-256 flash
    route held inside a flagged step, PIPELINE_FWD off and on
    (check_fp32_small_stage1).  Seconds and peak memory of each; every flash counter
    asserted on each path.  Returns the numbers and the launches by path."""
    from diffute_tpu_torch.config import DiffUTEConfig, small_config
    from diffute_tpu_torch.models import AutoencoderKL
    from diffute_tpu_torch.pipeline import DiffUTEPipeline
    from diffute_tpu_torch.train import run_unet
    from diffute_tpu_torch.utils import init_pipeline_params
    from diffute_tpu_torch.utils.params import load_module

    f32 = torch.float32
    base = DiffUTEConfig()
    out = {"launches": {}}

    def flags(cfg, on, **unet):
        return dataclasses.replace(
            cfg, unet=dataclasses.replace(cfg.unet, use_flash_attention=on,
                                          **unet),
            vae=dataclasses.replace(cfg.vae, use_flash_attention=on))

    # ---- serving: a 20-step 512^2 edit, flash, dense, switch on
    params = init_pipeline_params(base, seed=0, device=dev)
    image, box = scene()
    edits, outs = {}, {}
    serving = dataclasses.replace(base, edit=dataclasses.replace(
        base.edit, resolution=RES, num_inference_steps=VAE_FLASH_STEPS))
    for name, on, switch in (("flash", True, False), ("dense", False, False),
                             ("flash_pipelined", True, True)):
        pipe = DiffUTEPipeline(flags(serving, on), params, dev)
        with pipeline_fwd(switch):
            pipe.edit(image, box, "warm", seed=0, num_inference_steps=2)
            r = measured(dev, lambda: pipe.edit(image, box, "FP32 FLASH",
                                                seed=5)[0])
        only_boxes_changed(r["out"], image, [box])
        expect_flash(r, **({} if not on else {
            fp32_entry("fwd_pipelined" if switch else "fwd", 64):
                10 * VAE_FLASH_STEPS,
            fp32_entry("fwd_pipelined" if switch else "fwd", 512): 2}))
        outs[name] = r.pop("out")
        edits[name] = fp32_run_record(r)
        if on:
            out["launches"][f"fp32_edit_{name}"] = r["launches"]
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    for name in ("dense", "flash_pipelined"):
        edits[name]["max_lsb_vs_flash"] = int(np.abs(
            outs[name].astype(np.int16) - outs["flash"]).max())
    phase("fp32_edit", steps=VAE_FLASH_STEPS, tolerance_lsb=FP32_EDIT_LSB,
          **edits)
    if any(edits[n]["max_lsb_vs_flash"] > FP32_EDIT_LSB
           for n in ("dense", "flash_pipelined")):
        raise RuntimeError(f"the fp32 edits differ: {edits}")
    out["edit"] = edits
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- stage 2 through run_unet's entry point, fp32
    train_dir = tempfile.mkdtemp(prefix="diffute_fp32_train_")
    reset_counters()
    try:
        history = run_unet.main([
            "--model_scale", "full", "--train_batch_size", str(TRAIN_BATCH),
            "--mixed_precision", "no", "--gradient_checkpointing",
            "--max_train_steps", str(FP32_TRAIN_STEPS), "--seed", "0",
            "--report_to", "none", "--output_dir", train_dir])
    finally:
        shutil.rmtree(train_dir, ignore_errors=True)
    rec = {"launches": counters()}
    expect_flash(rec, **{fp32_entry("fwd", 64): 20 * FP32_TRAIN_STEPS,
                         fp32_entry("bwd_dq", 64): 10 * FP32_TRAIN_STEPS,
                         fp32_entry("bwd_dkv", 64): 10 * FP32_TRAIN_STEPS})
    if len(history) != FP32_TRAIN_STEPS or not all(
            np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
            and h["grad_norm"] > 0 for h in history):
        raise RuntimeError(f"fp32 training metrics: {history}")
    out["launches"]["fp32_train"] = rec["launches"]
    out["train"] = dict(steps=history, launches=fp32_launches(rec))
    phase("fp32_train", **out["train"])
    gc.collect()
    torch.cuda.empty_cache()

    # ---- one UNetTrainer step with both flags, against flash off, and
    # the head_dim-64 flash route held inside it
    params = init_pipeline_params(fp32_flags(base), seed=0, device=dev)
    out["stage2"] = fp32_stage2_step(dev, params, out)
    del params["unet"], params["trocr"]
    gc.collect()
    torch.cuda.empty_cache()

    # ---- stage 1 on the SD2 VAE at 512^2, fp32, flag on and off
    out["stage1"] = check_fp32_sd2_stage1(dev, params["vae"], out)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- small_config: encode and decode at 256^2, 3 stage-1 steps
    small = small_config()
    sparams = init_pipeline_params(small, seed=0, device=dev)
    vaes = {on: load_module(AutoencoderKL, dataclasses.replace(
                small.vae, use_flash_attention=on), sparams["vae"], dev, f32)
            for on in (False, True)}
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.rand((1, 3, 256, 256), generator=g, device=dev) * 2 - 1
    codec = {}
    with torch.inference_mode():
        z = vaes[False].encode(x)[0]
        for what in ("encode", "decode"):
            runs = {}
            for name, on in (("dense", False), ("flash", True),
                             ("flash_pipelined", True)):
                with pipeline_fwd(name == "flash_pipelined"):
                    runs[name] = measured(dev, lambda: (
                        vaes[on].encode(x)[0] if what == "encode"
                        else vaes[on].decode(z)))
            expect_flash(runs["dense"])
            expect_flash(runs["flash"], **{fp32_entry("fwd", 256): 1})
            expect_flash(runs["flash_pipelined"],
                         **{fp32_entry("fwd_pipelined", 256): 1})
            ref = runs["dense"].pop("out")
            codec[what] = {}
            for name in ("flash", "flash_pipelined"):
                rel = ((runs[name].pop("out") - ref).abs().max()
                       / ref.abs().max()).item()
                codec[what][name] = fp32_run_record(runs[name],
                                                    rel_max_err=rel)
                out["launches"][f"fp32_small_vae_{what}_256" + (
                    "_pipelined" if name == "flash_pipelined" else "")] = (
                        runs[name]["launches"])
            codec[what]["dense"] = fp32_run_record(runs["dense"])
            if not all(codec[what][n]["rel_max_err"] <= TOL_VAE_FLASH_REL
                       for n in ("flash", "flash_pipelined")):
                raise RuntimeError(f"fp32 small VAE {what} with flash "
                                   f"differs: {codec[what]}")
    del vaes, z, x
    phase("fp32_small", codec=codec)
    small_s1 = check_fp32_small_stage1(dev, sparams["vae"], out)
    out["small"] = dict(codec=codec, stage1=small_s1)
    del sparams
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---- phase 8f: the tiny model's paths at 512^2 through the narrow kernels
# the tiny model (tiny_test_config: UNet channels (16, 32), heads (2, 4):
# head_dim 8; VAE channels (8, 16), one down step: a 256^2 latent at 512^2
# and a mid-block of one 16-wide head) at the card's serving resolution
TINY_RES = 512
# the tiny UNet's flash self-attentions a pass at 512^2: 3 at 65,536 tokens
# (2 heads), 1 at 16,384 (4 heads); the cross-attention's 5 glyph tokens
# and the deep block's are dense
TINY_FLASH_PER_PASS = 4
TINY_BATCH = 2  # tiny_test_config's train batch
# a stage-2 step with gradient checkpointing: the pass's forwards, run again
# by the checkpoint, and one dq and one dk/dv each; the frozen VAE's two
# encodes with its flag (pixels and masked image, no gradient); a stage-1
# step with the flag: the encoder's and the decoder's mid-block, each one
# forward, one dq and one dk/dv (as phase 8a counts them)
TINY_STAGE2 = {"fwd": 2 * TINY_FLASH_PER_PASS + 2, "bwd_dq": 4, "bwd_dkv": 4}
TINY_STAGE1 = {"fwd": 2, "bwd_dq": 2, "bwd_dkv": 2}
# the bf16 flash steps of 8f (d) and (e) timed after a warm-up: the median
# of this many
TINY_STEP_RUNS = 3
# the tiny UNet's gradient probes (stage 2) and the VAE's (stage 1)
TINY_UNET_PROBES = [
    "conv_in.weight",
    "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight",
    "up_blocks.1.attentions.1.transformer_blocks.0.attn1.to_v.weight",
    "conv_out.weight"]
# serve.cli run as ``python -m`` does, then the launch counters of the
# process that ran it (chip_smoke.counters()), one line
CLI_WITH_LAUNCHES = (
    "import json, runpy\n"
    "runpy.run_module('diffute_tpu_torch.serve.cli', run_name='__main__', "
    "alter_sys=True)\n"
    "import chip_smoke\n"
    "print('LAUNCHES ' + json.dumps(chip_smoke.counters()), flush=True)\n")


class _RowBlockedDense(torch.autograd.Function):
    """ops.attention.dense_attention, forward and backward, over blocks of
    query rows: each block's fp32 logits, softmax and products as the dense
    route computes them (its backward autograd's through that block), so
    that a 65,536-token self-attention never holds its (B, H, S, T)
    logits.  Rows are independent; dk and dv sum the blocks' parts in
    fp32."""

    @staticmethod
    def forward(ctx, q, k, v, scale, rows, dense):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.rows, ctx.dense = scale, rows, dense
        return torch.cat([dense(q[:, i:i + rows], k, v, scale)
                          for i in range(0, q.shape[1], rows)], 1)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = [], torch.zeros(k.shape, device=k.device), torch.zeros(
            v.shape, device=v.device)
        for i in range(0, q.shape[1], ctx.rows):
            with torch.enable_grad():
                leaves = [q[:, i:i + ctx.rows].detach().requires_grad_(),
                          k.detach().requires_grad_(),
                          v.detach().requires_grad_()]
                parts = torch.autograd.grad(
                    ctx.dense(*leaves, ctx.scale), leaves,
                    g[:, i:i + ctx.rows])
            dq.append(parts[0])
            dk += parts[1].float()
            dv += parts[2].float()
        return torch.cat(dq, 1), dk.to(k.dtype), dv.to(v.dtype), None, None, \
            None


def attention_fp64(q, k, v, scale, mask=None):
    """The dense route's function in fp64 (logits, softmax and product),
    returned in q's dtype: the higher-precision reference an fp32 route's
    rounding is read against."""
    logits = torch.einsum("bshd,bthd->bhst", q.double(), k.double()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    out = torch.einsum("bhst,bthd->bshd", torch.softmax(logits, -1),
                       v.double())
    return out.to(q.dtype)


@contextlib.contextmanager
def row_blocked_dense(fp64: bool = False):
    """While the block runs, the dense route (ops.attention.dense_attention)
    of a self-attention over 4,096 keys or more is _RowBlockedDense, in
    blocks whose logits take 1 GiB at most (fp32; half the rows in fp64);
    with ``fp64`` its arithmetic is attention_fp64's."""
    att = importlib.import_module("diffute_tpu_torch.ops.attention")
    real = att.dense_attention
    dense = attention_fp64 if fp64 else real

    def blocked(q, k, v, scale, mask=None):
        if mask is not None or k.shape[1] < 4096:
            return dense(q, k, v, scale, mask)
        rows = max(1, (1 << 28) // (q.shape[0] * q.shape[2] * k.shape[1]))
        return _RowBlockedDense.apply(q, k, v, scale,
                                      rows // 2 if fp64 else rows, dense)

    att.dense_attention = blocked
    try:
        yield
    finally:
        att.dense_attention = real


def set_flash(modules, on: bool) -> None:
    """use_flash of every Attention module of ``modules``."""
    from diffute_tpu_torch.models.attention import Attention

    for model in modules:
        for m in model.modules():
            if isinstance(m, Attention):
                m.use_flash = on


def narrow_launches(rec: dict) -> dict:
    """The tile-width-16 counters of a measured run, by entry."""
    return {narrow_entry(kind, 16, fp32): rec["launches"][
        narrow_entry(kind, 16, fp32)]
        for kind in FP32_KINDS for fp32 in (False, True)}


def cast_draws(draws, dtype):
    """A UNet trainer's draws (TrainDraws) with its normals in ``dtype``."""
    return dataclasses.replace(draws, **{
        f.name: getattr(draws, f.name).to(dtype)
        for f in dataclasses.fields(draws)
        if getattr(draws, f.name) is not None
        and getattr(draws, f.name).is_floating_point()})


def check_tiny_paths(dev) -> dict:
    """Phase 8f: the tiny model (tiny_test_config, weights from seed 0) on
    its card paths at TINY_RES (512^2: head_dim-8 self-attentions of 65,536
    and 16,384 tokens, a head_dim-16 VAE mid-block of 65,536), through
    the tile-width-16 kernels (narrow_source), every flash counter
    asserted on each path:
      (a) ``python -m diffute_tpu_torch.serve.cli --tiny --res 512`` as a
          subprocess, and again with --pipeline-fwd: exit 0, only the box's
          pixels changed, TINY_FLASH_PER_PASS forwards a step;
      (b) the bf16 STEPS-step edit in process with the VAE's flag too
          (2 head_dim-16 forwards more), with PIPELINE_FWD on (within
          PIPELINE_EDIT_LSB of it, as phase 8a holds the switch) and the
          same edit on the dense route (its gap in LSB, and at most
          PIPELINE_EDIT_LSB); one UNet forward flash against dense within
          TOL_UNET_REL (phase 5's criterion), an encode and a decode flag
          on against off within TOL_VAE_FLASH_REL (8a's);
      (c) the same edit in fp32 (VAE_FLASH_STEPS steps, as 8c), flash,
          switch on and dense, each within FP32_EDIT_LSB;
      (d) one stage-2 step (UNetTrainer, batch TINY_BATCH, gradient
          checkpointing, both flash flags) in bf16 and in fp32, against
          the same step on the dense route, as 8c holds it: fp32, the loss
          within TOL_FP32_LOSS_REL and TINY_UNET_PROBES within
          TOL_FP32_GRAD_REL, bf16 TOL_LOSS_REL and TOL_GRAD_REL; a
          quantity outside passes when the flash step is no further than
          GRAD_VS_FP32_RATIO times the dense step from a step of higher
          precision (bf16: the fp32 dense step, as stage1_grad_check
          reads it; fp32: the fp32 step with its attention in fp64).  At
          65,536 keys the fp32 dense route's VAE mid-block moves the
          probes about 2e-4 from the fp64 attention, the flash route far
          less (read on an H100), so the flash route passes that way;
      (e) one stage-1 step (VAETrainer, the VAE's flag, remat) the same
          way, STAGE1_PROBES.
    The dense route of a 65,536-token attention runs in blocks of query
    rows (row_blocked_dense): whole, its fp32 logits would not fit.
    Returns the numbers and the launches by path."""
    from PIL import Image

    import diffute_tpu_torch
    from diffute_tpu_torch.config import card_serving_config, tiny_test_config
    from diffute_tpu_torch.pipeline import DiffUTEPipeline
    from diffute_tpu_torch.utils import init_pipeline_params

    bf16, f32 = torch.bfloat16, torch.float32
    res, steps = TINY_RES, STEPS
    base = tiny_test_config()
    base = dataclasses.replace(base, edit=dataclasses.replace(
        base.edit, resolution=res, num_inference_steps=steps))
    out = {"launches": {}}
    image, box = scene(res)

    def w16(kind, fp32=False):
        return narrow_entry(kind, 16, fp32)

    def keep(r, **more):
        return dict(seconds=r["seconds"],
                    max_memory_allocated=r["max_memory_allocated"],
                    launches=narrow_launches(r), **more)

    def lsb(a, b):
        return int(np.abs(a.astype(np.int16) - b).max())

    # ---- (a) serve.cli --tiny --res 512, switch off and on
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="diffute_tiny_cli_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(diffute_tpu_torch.__file__)),
         os.path.dirname(os.path.abspath(__file__)),
         os.environ.get("PYTHONPATH", "")]))
    cli = {}
    try:
        src = os.path.join(tmp, "in.png")
        Image.fromarray(image).save(src)
        for name, extra in (("cli", []),
                            ("cli_pipelined", ["--pipeline-fwd"])):
            dst = os.path.join(tmp, f"{name}.png")
            t0 = time.perf_counter()
            run = subprocess.run(
                [sys.executable, "-c", CLI_WITH_LAUNCHES, "--tiny", "--res",
                 str(res), "--image", src, "--box", ",".join(map(str, box)),
                 "--text", "TINY", "--steps", str(steps), "--out", dst,
                 *extra],
                capture_output=True, text=True, env=env, timeout=900)
            seconds = time.perf_counter() - t0
            if run.returncode != 0:
                raise RuntimeError(f"serve.cli --tiny --res {res} {extra} "
                                   f"exited {run.returncode}: "
                                   f"{run.stderr[-3000:]}")
            launches = json.loads(next(
                line for line in run.stdout.splitlines()[::-1]
                if line.startswith("LAUNCHES "))[len("LAUNCHES "):])
            changed = only_boxes_changed(
                np.asarray(Image.open(dst).convert("RGB")), image, [box])
            rec = {"launches": launches}
            expect_flash(rec, **{w16("fwd_pipelined" if extra else "fwd"):
                                 TINY_FLASH_PER_PASS * steps})
            cli[name] = dict(seconds=seconds, changed_pixels=changed,
                             launches=narrow_launches(rec))
            out["launches"][f"tiny_{name}"] = launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase("tiny_cli", resolution=res, steps=steps, **cli)
    out["cli"] = cli

    # ---- (b), (c) the edit in process: bf16 (the card's serving config)
    # and fp32, flash (both flags), the switch on, and dense
    params = init_pipeline_params(base, seed=0, device=dev)

    def config(dtype, on):
        cfg = card_serving_config(base) if dtype == bf16 else base
        return dataclasses.replace(
            cfg, unet=dataclasses.replace(cfg.unet, use_flash_attention=on),
            vae=dataclasses.replace(cfg.vae, use_flash_attention=on))

    edits = {}
    for dtype, n_steps, tol in ((bf16, steps, PIPELINE_EDIT_LSB),
                                (f32, VAE_FLASH_STEPS, FP32_EDIT_LSB)):
        fp32, tag = dtype == f32, "fp32" if dtype == f32 else "bf16"
        runs, outs = {}, {}
        for name, on, switch in (("flash", True, False),
                                 ("flash_pipelined", True, True),
                                 ("dense", False, False)):
            pipe = DiffUTEPipeline(config(dtype, on), params, dev)
            with pipeline_fwd(switch), row_blocked_dense():
                pipe.edit(image, box, "warm", seed=0, num_inference_steps=2)
                r = measured(dev, lambda: pipe.edit(
                    image, box, "TINY FLASH", seed=5,
                    num_inference_steps=n_steps)[0])
            only_boxes_changed(r["out"], image, [box])
            kind = "fwd_pipelined" if switch else "fwd"
            expect_flash(r, **({w16(kind, fp32):
                                TINY_FLASH_PER_PASS * n_steps + 2}
                               if on else {}))
            outs[name] = r.pop("out")
            runs[name] = keep(r)
            if on:
                out["launches"][f"tiny_edit_{tag}_{name}"] = r["launches"]
            if dtype == bf16 and name == "flash":
                checks = tiny_model_checks(dev, pipe, res)
            del pipe
            gc.collect()
            torch.cuda.empty_cache()
        for name in ("flash_pipelined", "dense"):
            runs[name]["max_lsb_vs_flash"] = lsb(outs[name], outs["flash"])
        edits[tag] = dict(steps=n_steps, tolerance_lsb=tol, **runs)
        if dtype == bf16:
            edits[tag]["model_checks"] = checks
        phase(f"tiny_edit_{tag}", resolution=res, **edits[tag])
        del outs
    out["edits"] = edits

    # ---- (d), (e) one stage-2 and one stage-1 step, bf16 and fp32, flash
    # against the dense route
    steps_out = {}
    for stage in ("stage2", "stage1"):
        steps_out[stage] = tiny_step_check(dev, base, params, stage, out)
        phase(f"tiny_{stage}_step", batch=TINY_BATCH, resolution=res,
              **steps_out[stage])
    out["steps"] = steps_out
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # the edit-level bounds last, so that every number above is printed
    bad = [f"{tag} {name}: {edits[tag][name]['max_lsb_vs_flash']} LSB"
           for tag in edits for name in ("flash_pipelined", "dense")
           if edits[tag][name]["max_lsb_vs_flash"]
           > edits[tag]["tolerance_lsb"]]
    if bad:
        raise RuntimeError(f"the tiny edits differ beyond their bounds: {bad}")
    return out


def tiny_model_checks(dev, pipe, res: int) -> dict:
    """Phase 8f (b)'s model-level checks on the flagged bf16 pipeline: one
    UNet forward at the ``res`` latent, flash against the dense route (the
    same weights and inputs; relative max error within TOL_UNET_REL, phase
    5's), and an encode and a decode with the VAE's flag against it off
    (within TOL_VAE_FLASH_REL, phase 8a's)."""
    cfg = pipe.config
    g = torch.Generator(device=dev).manual_seed(7)
    r = res // cfg.vae.scale_factor
    bf16 = torch.bfloat16
    x_in = torch.randn((1, cfg.unet.in_channels, r, r), generator=g,
                       device=dev).to(bf16)
    t_in = torch.tensor(981, device=dev)
    ctx = torch.randn((1, 5, cfg.unet.cross_attention_dim), generator=g,
                      device=dev).to(bf16)
    image = (torch.rand((1, 3, res, res), generator=g, device=dev) * 2
             - 1).to(bf16)
    out = {}
    with torch.inference_mode(), row_blocked_dense():
        z = pipe.vae.encode(image)[0]
        got = {}
        for on in (True, False):
            set_flash([pipe.unet, pipe.vae], on)
            reset_counters()
            got[on] = (pipe.unet(x_in, t_in, ctx).float(),
                       pipe.vae.encode(image)[0].float(),
                       pipe.vae.decode(z).float())
            torch.cuda.synchronize()
            if on:
                expect_flash({"launches": counters()},
                             **{narrow_entry("fwd", 16, False):
                                TINY_FLASH_PER_PASS + 2})
        set_flash([pipe.unet, pipe.vae], True)
    for i, name in enumerate(("unet", "encode", "decode")):
        ref = got[False][i]
        out[f"{name}_rel_max_err"] = ((got[True][i] - ref).abs().max()
                                      / ref.abs().max()).item()
    out.update(tolerance_unet=TOL_UNET_REL,
               tolerance_codec=TOL_VAE_FLASH_REL)
    if not (out["unet_rel_max_err"] <= TOL_UNET_REL
            and out["encode_rel_max_err"] <= TOL_VAE_FLASH_REL
            and out["decode_rel_max_err"] <= TOL_VAE_FLASH_REL):
        raise RuntimeError(f"the tiny model with flash differs from dense: "
                           f"{out}")
    return out


def median_seconds(fn, runs: int = TINY_STEP_RUNS) -> dict:
    """``fn()`` once to warm up, then ``runs`` times, each on the host clock
    to the card's end of it (synchronised): the median and every run."""
    fn()
    torch.cuda.synchronize()
    seconds = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return {"median_seconds": statistics.median(seconds), "seconds": seconds}


def tiny_step_check(dev, base, params, stage: str, out: dict) -> dict:
    """Phase 8f (d) (``stage`` "stage2") or (e) ("stage1"): one loss and
    gradient evaluation with flash on (both flags; stage 1 the VAE's), then
    with every Attention module on the dense route, in fp32 (and once more
    with the dense route's attention in fp64) and in bf16, the same
    weights, batch and draws; see check_tiny_paths for the bounds.  The
    flash steps' launches go into ``out["launches"]``; the bf16 flash step
    is timed again, the median of TINY_STEP_RUNS after a warm-up."""
    from diffute_tpu_torch.config import TrainConfig
    from diffute_tpu_torch.io.dataset import (SyntheticSceneDataset,
                                              make_unet_batch, make_vae_batch)
    from diffute_tpu_torch.train import UNetTrainer, VAETrainer

    stage2 = stage == "stage2"
    expected = TINY_STAGE2 if stage2 else TINY_STAGE1
    probes = TINY_UNET_PROBES if stage2 else STAGE1_PROBES
    cfg = dataclasses.replace(
        base,
        unet=dataclasses.replace(base.unet, use_flash_attention=stage2,
                                 remat=True),
        vae=dataclasses.replace(base.vae, use_flash_attention=True,
                                remat=not stage2),
        train=TrainConfig(train_batch_size=TINY_BATCH, mixed_precision="no",
                          gradient_checkpointing=True, max_train_steps=1))
    data = SyntheticSceneDataset(cfg, seed=0)
    items = [data[i] for i in range(TINY_BATCH)]
    batch = make_unet_batch(items, cfg) if stage2 else make_vae_batch(items)
    runs, draws = {}, None
    for precision in ("no", "bf16"):
        pcfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, mixed_precision=precision))
        trainer = (UNetTrainer(pcfg, params["unet"],
                               {"vae": params["vae"],
                                "trocr": params["trocr"]},
                               device=dev, total_steps=1)
                   if stage2 else
                   VAETrainer(pcfg, params["vae"], device=dev, total_steps=1))
        if draws is None:
            draws = trainer.draw(TINY_BATCH)
        d = (cast_draws(draws, trainer.dtype) if stage2
             else draws.to(trainer.dtype))
        models = [trainer.unet, trainer.vae] if stage2 else [trainer.vae]
        masters = trainer.state.params_dict()
        fp32 = precision == "no"
        tag = "fp32" if fp32 else "bf16"
        for route in ("flash", "dense", "dense_fp64")[:3 if fp32 else 2]:
            set_flash(models, route == "flash")
            with row_blocked_dense(fp64=route == "dense_fp64"):
                r = measured(dev, lambda: trainer.accumulate_grads(
                    batch, d).item())
            expect_flash(r, **({narrow_entry(kind, 16, fp32): n
                                for kind, n in expected.items()}
                               if route == "flash" else {}))
            key = f"{tag}_{route}"
            runs[key] = (r.pop("out"),
                         {n: masters[n].grad.double().clone()
                          for n in probes},
                         dict(seconds=r["seconds"],
                              max_memory_allocated=r["max_memory_allocated"],
                              launches=narrow_launches(r)))
            if route == "flash":
                out["launches"][f"tiny_{stage}_{key}"] = r["launches"]
                if not fp32:
                    runs[key][2]["timed"] = median_seconds(
                        lambda: trainer.accumulate_grads(batch, d).item())
        del trainer, masters, models
        gc.collect()
        torch.cuda.empty_cache()

    def rel(a, b):
        return {n: rel_l2_64(runs[a][1][n], runs[b][1][n]) for n in probes}

    def loss_rel(a, b):
        return abs(runs[a][0] - runs[b][0]) / abs(runs[b][0])

    res = {k: dict(v[2], loss=v[0]) for k, v in runs.items()}
    res.update(
        bf16_flash_step_seconds_median=runs["bf16_flash"][2]["timed"][
            "median_seconds"],
        fp32_loss_rel_diff=loss_rel("fp32_flash", "fp32_dense"),
        fp32_grad_rel_l2_err=rel("fp32_flash", "fp32_dense"),
        fp32_flash_vs_fp64_attention=dict(
            rel("fp32_flash", "fp32_dense_fp64"),
            loss=loss_rel("fp32_flash", "fp32_dense_fp64")),
        fp32_dense_vs_fp64_attention=dict(
            rel("fp32_dense", "fp32_dense_fp64"),
            loss=loss_rel("fp32_dense", "fp32_dense_fp64")),
        bf16_loss_rel_diff=loss_rel("bf16_flash", "bf16_dense"),
        bf16_grad_rel_l2_err=rel("bf16_flash", "bf16_dense"),
        bf16_flash_vs_fp32=rel("bf16_flash", "fp32_dense"),
        bf16_dense_vs_fp32=rel("bf16_dense", "fp32_dense"),
        tolerances=dict(fp32_loss=TOL_FP32_LOSS_REL,
                        fp32_grad=TOL_FP32_GRAD_REL, bf16_loss=TOL_LOSS_REL,
                        bf16_grad=TOL_GRAD_REL,
                        ratio_to_dense=GRAD_VS_FP32_RATIO))
    # a quantity passes within its tolerance of the dense route, or when the
    # flash route is no further from the reference of higher precision (bf16:
    # the fp32 dense step; fp32: the step with fp64 attention) than
    # GRAD_VS_FP32_RATIO times the dense route is
    near64 = {n: res["fp32_flash_vs_fp64_attention"][n]
              <= GRAD_VS_FP32_RATIO * res["fp32_dense_vs_fp64_attention"][n]
              for n in (*probes, "loss")}
    bad = ([f"bf16 {n}" for n in probes
            if not (res["bf16_grad_rel_l2_err"][n] <= TOL_GRAD_REL
                    or res["bf16_flash_vs_fp32"][n]
                    <= GRAD_VS_FP32_RATIO * res["bf16_dense_vs_fp32"][n])]
           + [f"fp32 {n}" for n in probes
              if not (res["fp32_grad_rel_l2_err"][n] <= TOL_FP32_GRAD_REL
                      or near64[n])])
    if (res["bf16_loss_rel_diff"] > TOL_LOSS_REL
            or not (res["fp32_loss_rel_diff"] <= TOL_FP32_LOSS_REL
                    or near64["loss"])):
        bad.append("loss")
    if bad or not all(np.isfinite(v[0]) for v in runs.values()):
        raise RuntimeError(f"the tiny {stage} step with flash differs from "
                           f"the dense route ({bad}): {res}")
    return res


def fp32_entries(results: dict, launches: dict, widths=FP32_WIDTHS) -> list:
    """The fp32 kernels' entries at head_dims ``widths`` (phase 3f; twelve
    at all three) with the fp32 paths' launches by path (phase 8c: path ->
    counters read right after it ran)."""
    def by_path(key):
        return {path: rec[key] for path, rec in launches.items() if rec[key]}

    return [kernel_entry(fp32_entry(kind, d), fp32_source(kind, d),
                         f"flash_attention.py:{FP32_REPLACES[kind]}",
                         results[fp32_entry(kind, d)],
                         by_path(fp32_entry(kind, d)))
            for d in widths for kind in FP32_KINDS]


# ---- phase 3g: GroupNorm+SiLU, its statistics and the int8 matmul on fp32
# inputs (csrc/groupnorm.cu's fp32 entries, csrc/quant_fp32_sm90.cu), held
# to the fp32 contract (TOL_FP32_REL_L2) of phase 3f
# the int8 matmul's shapes: every one of a flagged 512^2 pass, the hoisted
# K/V, the 1024^2 edit's widest and a ragged one (M not a multiple of the
# 64-row tile, N not a multiple of 128)
W8_FP32_SHAPES = ([s + (c,) for s, c in W8_SHAPES]
                  + [s + (None,) for s, _ in W8_EDIT_SHAPES]
                  + [(16384, 320, 2560, None), (1000, 640, 200, None)])
W8_FP32_SOURCE = "quant_fp32_sm90.cu"
# the H100 SXM's dense TF32 rate over the two products the int8 matmul on
# fp32 x takes (x = hi + lo, the int8 values exact in TF32), and its fp32
# rate outside the tensor cores (GroupNorm's few operations an element)
PEAK_W8_FP32_FLOPS, PEAK_FP32_SIMT_FLOPS = 494.7e12 / 2, 67e12
# the fp32 statistics against their tiled plain version (the same fold of
# the same pieces): the mean within this of max(1, |mean|), rstd relative
TOL_FP32_STATS = 1e-6


def check_fp32_fused(dev) -> dict:
    """Phase 3g: the fp32 entries gn_silu_fp32, gn_stats_fp32 and
    w8_matmul_fp32 against their plain fp32 versions on the card, TF32 off,
    to the fp32 contract: GN+SiLU within relative L2 TOL_FP32_REL_L2 of
    group_norm_silu_reference; the statistics held as phase 3b holds the
    bf16 ones and within TOL_FP32_STATS of group_norm_stats_tiled_reference
    at the fp32 plan; each the same bits twice.  GroupNorm at every shape
    of phase 3b; the int8 matmul as check_w8_fp32 holds it.  Mutants that
    must fail: the GN output rounded through bf16, the one-pass variance
    E[x^2] - mean^2 at the mean-100 input, one cluster rank dropped from
    the merge.  Each timed beside its bound, its plain version and its
    library call (F.silu(F.group_norm), torch.batch_norm_stats).  Returns
    {entry name: [result per shape]}."""
    import torch.nn.functional as F

    from diffute_tpu_torch.ops.groupnorm import (
        gn_plan, group_norm_silu, group_norm_silu_from_stats,
        group_norm_silu_reference, group_norm_stats,
        group_norm_stats_reference, group_norm_stats_tiled_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    show_ptxas("groupnorm.cu")
    f32 = torch.float32
    g = torch.Generator(device=dev).manual_seed(16)

    def randn(*shape, mean=0.0, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std + mean

    def rel(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

    def must_fail(name, err):
        if err <= TOL_FP32_REL_L2:
            raise RuntimeError(f"the fp32 criterion passes the mutant {name}: "
                               f"{err}")
        return err

    def gn_silu_fp64(x, gamma, beta):
        xd = x.double().reshape(x.shape[0], 32, -1)
        mu = xd.mean(dim=2, keepdim=True)
        var = (xd - mu).square().mean(dim=2, keepdim=True)
        y = ((xd - mu) * torch.rsqrt(var + 1e-5)).reshape(x.shape)
        y = (y * gamma.double().view(1, -1, 1, 1)
             + beta.double().view(1, -1, 1, 1))
        return y * torch.sigmoid(y)

    def stats_close(m, r, rm, rr, mean, tol):
        return ((m - rm).abs().max().item() <= tol * max(1.0, abs(mean))
                and ((r - rr).abs() / rr).max().item() <= tol)

    out = {"gn_silu_fp32": [], "gn_stats_fp32": []}
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
        tm, tr = group_norm_stats_tiled_reference(x, 32, 1e-5)
        plan = {k: v for k, v in gn_plan(b, c, h, w, 32, 4).items()
                if k in ("cluster", "threads", "silu_threads", "one_read")}
        nbytes = 4 * x.numel()
        ref64 = gn_silu_fp64(x, gamma, beta)
        res = dict(shape=list(shape), input_mean=mean,
                   launches_per_pass=n_gn, plan=plan,
                   **fp32_errors(y, ref),
                   rel_l2_from_fp64=rel(y, ref64),
                   plain_rel_l2_from_fp64=rel(ref, ref64),
                   same_bits_twice=torch.equal(y, y2),
                   ms=time_ms(lambda: group_norm_silu(x, gamma, beta, 32,
                                                      1e-5)),
                   plain_ms=time_ms(lambda: group_norm_silu_reference(
                       x, gamma, beta, 32, 1e-5)),
                   library_ms=time_ms(lambda: F.silu(F.group_norm(
                       x, 32, gamma, beta, 1e-5))),
                   **bound(10 * x.numel(), 2 * nbytes + 8 * c,
                           PEAK_FP32_SIMT_FLOPS))
        stats_err = {"mean_max_abs_err": (m - rm).abs().max().item(),
                     "rstd_max_rel_err": ((r - rr).abs() / rr).max().item(),
                     "tiled_mean_max_abs_err": (m - tm).abs().max().item(),
                     "tiled_rstd_max_rel_err": ((r - tr).abs()
                                                / tr).max().item()}
        sres = dict(shape=list(shape), input_mean=mean,
                    launches_per_pass=n_stats, plan=plan,
                    max_abs_err=stats_err["mean_max_abs_err"], **stats_err,
                    same_bits_twice=torch.equal(m, m2) and torch.equal(r, r2),
                    ms=time_ms(lambda: group_norm_stats(x, 32, 1e-5)),
                    plain_ms=time_ms(lambda: group_norm_stats_reference(
                        x, 32, 1e-5)),
                    library_ms=time_ms(lambda: torch.batch_norm_stats(
                        x.view(1, b * 32, -1), 1e-5)),
                    **bound(3 * x.numel(), nbytes + 8 * b * 32,
                            PEAK_FP32_SIMT_FLOPS))
        for r_ in (res, sres):
            r_["share_of_bound"] = r_["bound_ms"] / r_["ms"]
        mutants = {}
        if shape == (1, 320, 64, 64) and mean == 0.0:
            mutants["output_via_bf16_rel_l2"] = must_fail(
                "GN+SiLU rounded through bf16", rel(ref.bfloat16(), ref))
        if shape == (2, 640, 32, 32):
            dm, dr = group_norm_stats_tiled_reference(
                x, 32, 1e-5, ranks=range(plan["cluster"] - 1))
            if stats_close(dm, dr, tm, tr, mean, TOL_FP32_STATS):
                raise RuntimeError("the statistics criterion passes a "
                                   "dropped cluster rank")
            mutants["dropped_rank_rel_l2"] = must_fail(
                "a dropped cluster rank",
                rel(group_norm_silu_from_stats(x, gamma, beta, dm, dr), ref))
        if mean == 100.0:
            xg = x.reshape(b, 32, -1)
            om = xg.mean(dim=2)
            orstd = torch.rsqrt((xg * xg).mean(dim=2) - om * om + 1e-5)
            if stats_close(om, orstd, tm, tr, mean, TOL_FP32_STATS):
                raise RuntimeError("the statistics criterion passes the "
                                   "one-pass variance")
            mutants["one_pass_variance_rel_l2"] = must_fail(
                "the one-pass variance",
                rel(group_norm_silu_from_stats(x, gamma, beta, om, orstd),
                    ref))
        if mutants:
            res["mutants"] = mutants
        phase("kernel_gn_silu_fp32", **res)
        phase("kernel_gn_stats_fp32", **sres)
        if not (fp32_held(res) and res["same_bits_twice"]
                and stats_close(m, r, rm, rr, mean, 1e-5)
                and ((r - rr).abs() / rr).max().item() <= 1e-4
                and stats_close(m, r, tm, tr, mean, TOL_FP32_STATS)
                and sres["same_bits_twice"]):
            raise RuntimeError(f"the fp32 GroupNorm disagrees at {shape}: "
                               f"{res} {stats_err}")
        out["gn_silu_fp32"].append(res)
        out["gn_stats_fp32"].append(sres)
        del x, y, y2, ref, ref64
    mutated = [r["shape"] for r in out["gn_silu_fp32"] if "mutants" in r]
    if mutated != [[1, 320, 64, 64], [2, 640, 32, 32], [1, 320, 64, 64]]:
        raise RuntimeError(f"fp32 GroupNorm mutants checked at {mutated}")

    out["w8_matmul_fp32"] = check_w8_fp32(dev)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def w8_fp32_source() -> str:
    """The source under csrc/ of the imported package that holds the fp32
    int8 matmul (an older checkout: csrc/quant_fp32.cu)."""
    from diffute_tpu_torch.ops import _build

    return (W8_FP32_SOURCE if os.path.exists(os.path.join(_build.CSRC,
                                                          W8_FP32_SOURCE))
            else "quant_fp32.cu")


def check_w8_fp32(dev) -> list:
    """Phase 3g's int8 matmul on fp32 x: w8_matmul_fp32 at every shape of
    W8_FP32_SHAPES against quant_matmul_reference (TF32 off) within
    TOL_FP32_REL_L2, its distance and the plain version's from fp64 and
    from the plain emulation of the kernel's order of sums
    (quant_matmul_tf32_reference at the plan's k tile and splits), the same
    bits twice, the fused bias bit for bit as the two-step.  Mutants that
    must fail: x rounded to TF32 alone, the scale applied to one feature
    twice (the first shape), one K split's partial dropped (the first shape
    the plan splits).  Each timed beside its bound, its plain version and
    its library call, (x @ q.float().T) * scale.  An older checkout
    (--package-root) without K splits is held and timed, with no split
    mutant.  Returns the result per shape."""
    from diffute_tpu_torch.ops.quant import (quant_matmul,
                                             quant_matmul_reference,
                                             quant_matmul_tf32_reference,
                                             quantize_per_channel,
                                             w8_fp32_plan)

    torch.backends.cuda.matmul.allow_tf32 = False
    show_ptxas(w8_fp32_source())
    g = torch.Generator(device=dev).manual_seed(16)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    def rel(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

    def must_fail(name, err):
        if err <= TOL_FP32_REL_L2:
            raise RuntimeError(f"the fp32 criterion passes the mutant {name}: "
                               f"{err}")
        return err

    # an older checkout's plan has no K split (and its emulation no order)
    splits_k = "tiles_per_split" in w8_fp32_plan(64, 1280, 5120)
    out = []
    split_mutant = False
    for m_, k, n, per_pass in W8_FP32_SHAPES:
        x = randn(m_, k)
        q, scale = quantize_per_channel(randn(n, k, std=k ** -0.5))
        bias = randn(n, std=0.1)
        plan = w8_fp32_plan(m_, n, k)
        y = quant_matmul(x, q, scale)
        again = quant_matmul(x, q, scale)
        with_bias = quant_matmul(x, q, scale, bias)
        torch.cuda.synchronize()
        ref = quant_matmul_reference(x, q, scale)
        ref64 = (x.double() @ q.double().t()) * scale.double()[None, :]
        splits = plan["splits"]
        order = (dict(k_tile=plan["block_k"], splits=splits) if splits_k
                 else {})
        emulated = quant_matmul_tf32_reference(x, q, scale, **order)
        res = dict(shape=[m_, k, n], launches_per_pass=per_pass,
                   blocks=plan["blocks"], splits=splits,
                   **fp32_errors(y, ref),
                   rel_l2_from_fp64=rel(y, ref64),
                   plain_rel_l2_from_fp64=rel(ref, ref64),
                   rel_l2_from_emulation=rel(y, emulated),
                   emulation_rel_l2_from_fp64=rel(emulated, ref64),
                   same_bits_twice=torch.equal(y, again),
                   bias_equals_two_step=torch.equal(with_bias, y + bias),
                   ms=time_ms(lambda: quant_matmul(x, q, scale)),
                   ms_with_bias=time_ms(lambda: quant_matmul(x, q, scale,
                                                             bias)),
                   plain_ms=time_ms(lambda: quant_matmul_reference(x, q,
                                                                   scale)),
                   library_ms=time_ms(lambda: (x @ q.float().t()) * scale),
                   library_call="(x @ q.float().T) * scale, TF32 off",
                   **bound(2 * m_ * n * k, 4 * m_ * k + n * k + 4 * m_ * n
                           + 4 * n, PEAK_W8_FP32_FLOPS))
        res["share_of_bound"] = res["bound_ms"] / res["ms"]
        mutants = {}
        if not out:
            twice = ref.clone()
            twice[:, 0] *= scale[0]
            mutants["tf32_only_rel_l2"] = must_fail(
                "x rounded to TF32 alone",
                rel(quant_matmul_tf32_reference(x, q, scale, products=1),
                    ref))
            mutants["scale_twice_rel_l2"] = must_fail(
                "the scale applied to one feature twice", rel(twice, ref))
        if splits > 1 and not split_mutant:
            split_mutant = True
            mutants["split_dropped_rel_l2"] = must_fail(
                "one K split's partial dropped",
                rel(quant_matmul_tf32_reference(x, q, scale, **order,
                                                drop_split=splits - 1), ref))
        if mutants:
            res["mutants"] = mutants
        phase("kernel_w8_matmul_fp32", **res)
        if not (fp32_held(res) and res["same_bits_twice"]
                and res["bias_equals_two_step"]):
            raise RuntimeError(f"the fp32 int8 matmul disagrees at "
                               f"{(m_, k, n)}: {res}")
        out.append(res)
        del x, y, again, with_bias, ref, ref64, emulated
    if splits_k and not split_mutant:
        raise RuntimeError("no shape of W8_FP32_SHAPES splits K: the dropped "
                           "split mutant was not checked")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---- phase 3h: GN+SiLU+conv3x3 on fp32 inputs (csrc/conv_fused_fp32.cu,
# 3xTF32), held to the fp32 contract (TOL_FP32_REL_L2) of phase 3f: every
# shape of a flagged 512^2 pass (CONV_SHAPES), then batch 2, the 768^2 and
# 1024^2 edits' top levels and a ragged one (Cout 96: not a multiple of the
# 64-channel tile; 24^2: not of the 8 x 8 pixel tile)
CONV_FP32_SHAPES = ([(1, cin, cout, hw, n) for hw, cin, cout, n in CONV_SHAPES]
                    + [(2, 640, 640, 32, None), (1, 320, 320, 96, None),
                       (1, 320, 320, 128, None), (1, 960, 320, 128, None),
                       (1, 64, 96, 24, None)])


def check_fp32_conv(dev) -> list:
    """Phase 3h: gn_silu_conv3x3_fp32 against gn_silu_conv3x3_reference in
    fp32 with TF32 off, at CONV_FP32_SHAPES: within relative L2
    TOL_FP32_REL_L2, the same bits twice, the distance of the kernel and of
    the plain version from fp64.  Mutants that must fail, at (1, 320, 320,
    64^2): the normalised operand rounded through bf16, TF32 alone (one
    product, gn_silu_conv3x3_tf32_reference), the border padded with
    silu(d_c) in place of 0, one 16-channel chunk of Cin dropped.  Each
    shape timed beside its bound (18 B H W Cin Cout FLOPs at the 3xTF32
    rate, or the fp32 bytes of x, w and out, the larger), its plain version
    and its library call (F.conv2d(F.silu(F.group_norm(x))) in fp32, TF32
    off), with its grid (conv_fp32_plan).  Returns the result per shape."""
    import torch.nn.functional as F

    from diffute_tpu_torch.ops.conv_fused import (
        conv_fp32_plan, gn_silu_conv3x3, gn_silu_conv3x3_reference,
        gn_silu_conv3x3_tf32_reference)
    from diffute_tpu_torch.ops.groupnorm import (group_norm_silu_reference,
                                                 group_norm_stats_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    show_ptxas("conv_fused_fp32.cu")
    g = torch.Generator(device=dev).manual_seed(17)

    def randn(*shape, mean=0.0, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std + mean

    def must_fail(name, err):
        if err <= TOL_FP32_REL_L2:
            raise RuntimeError(f"the fp32 criterion passes the mutant {name}: "
                               f"{err}")
        return err

    out = []
    for b, cin, cout, hw, per_pass in CONV_FP32_SHAPES:
        x = randn(b, cin, hw, hw)
        gamma, beta = randn(cin, mean=1.0, std=0.3), randn(cin, std=0.5)
        w = randn(cout, cin, 3, 3, std=(9 * cin) ** -0.5)
        bias = randn(cout, std=0.1)
        args = (x, gamma, beta, w, bias, 32, 1e-5)
        y = gn_silu_conv3x3(*args)
        again = gn_silu_conv3x3(*args)
        torch.cuda.synchronize()
        ref = gn_silu_conv3x3_reference(*args)
        ref64 = gn_silu_conv3x3_fp64(x, gamma, beta, w, bias)
        plan = conv_fp32_plan(b, cin, cout, hw, hw)
        res = dict(shape=[b, cin, cout, hw, hw], launches_per_pass=per_pass,
                   plan={k: plan[k] for k in ("blocks", "splits",
                                              "chunks_per_split")},
                   **fp32_errors(y, ref),
                   rel_l2_from_fp64=rel_l2_64(y, ref64),
                   plain_rel_l2_from_fp64=rel_l2_64(ref, ref64),
                   same_bits_twice=torch.equal(y, again),
                   ms=time_ms(lambda: gn_silu_conv3x3(*args)),
                   plain_ms=time_ms(lambda: gn_silu_conv3x3_reference(*args)),
                   library_ms=time_ms(lambda: F.conv2d(F.silu(F.group_norm(
                       x, 32, gamma, beta, 1e-5)), w, bias, padding=1)),
                   library_call="F.conv2d(F.silu(F.group_norm(x))), fp32, "
                                "TF32 off",
                   **bound(18 * b * hw * hw * cin * cout,
                           4 * (x.numel() + w.numel() + b * cout * hw * hw
                                + 2 * cin + cout), PEAK_FP32_FLOPS))
        res["share_of_bound"] = res["bound_ms"] / res["ms"]
        if (b, cin, cout, hw) == (1, 320, 320, 64):
            mean, rstd = group_norm_stats_reference(x, 32, 1e-5)
            a = gamma * rstd.repeat_interleave(cin // 32, 1)[0]
            d = beta - mean.repeat_interleave(cin // 32, 1)[0] * a
            xp = F.pad(x, (1, 1, 1, 1))
            n32 = group_norm_silu_reference(x, gamma, beta, 32, 1e-5)
            w_cut = w.clone()
            w_cut[:, 16:32] = 0
            res["mutants"] = {
                "normalised_via_bf16_rel_l2": must_fail(
                    "the normalised operand rounded through bf16",
                    rel_l2_64(F.conv2d(n32.bfloat16().float(), w, bias,
                                       padding=1), ref)),
                "tf32_only_rel_l2": must_fail(
                    "TF32 alone", rel_l2_64(gn_silu_conv3x3_tf32_reference(
                        *args, products=1), ref)),
                "border_silu_d_rel_l2": must_fail(
                    "the border padded with silu(d)",
                    rel_l2_64(F.conv2d(F.silu(xp * a[None, :, None, None]
                                              + d[None, :, None, None]),
                                       w, bias), ref)),
                "dropped_chunk_rel_l2": must_fail(
                    "a dropped 16-channel chunk",
                    rel_l2_64(gn_silu_conv3x3_reference(
                        x, gamma, beta, w_cut, bias, 32, 1e-5), ref))}
        phase("kernel_conv_fp32", **res)
        if not (fp32_held(res) and res["same_bits_twice"]):
            raise RuntimeError(f"the fp32 GN+SiLU+conv3x3 disagrees at "
                               f"{(b, cin, cout, hw)}: {res}")
        out.append(res)
        del x, y, again, ref, ref64
    if [r["shape"] for r in out if "mutants" in r] != [[1, 320, 320, 64, 64]]:
        raise RuntimeError("the fp32 conv's mutants were not checked")
    per_pass = [r for r in out if r["launches_per_pass"]]
    phase("conv_fp32_pass", launches=sum(r["launches_per_pass"]
                                         for r in per_pass),
          gflop=sum(r["launches_per_pass"] * 18 * r["shape"][1]
                    * r["shape"][2] * r["shape"][3] ** 2
                    for r in per_pass) / 1e9,
          ms=sum(r["launches_per_pass"] * r["ms"] for r in per_pass),
          bound_ms=sum(r["launches_per_pass"] * r["bound_ms"]
                       for r in per_pass),
          plain_ms=sum(r["launches_per_pass"] * r["plain_ms"]
                       for r in per_pass),
          library_ms=sum(r["launches_per_pass"] * r["library_ms"]
                         for r in per_pass))
    gc.collect()
    torch.cuda.empty_cache()
    return out


def gn_silu_conv3x3_fp64(x, gamma, beta, w, bias, groups=32, eps=1e-5):
    """GroupNorm, SiLU, the zero-padded 3x3 convolution and the bias, all in
    fp64."""
    xd = x.double().reshape(x.shape[0], groups, -1)
    mu = xd.mean(dim=2, keepdim=True)
    var = (xd - mu).square().mean(dim=2, keepdim=True)
    y = ((xd - mu) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * gamma.double().view(1, -1, 1, 1) + beta.double().view(1, -1, 1, 1)
    return torch.nn.functional.conv2d(y * torch.sigmoid(y), w.double(),
                                      bias.double(), padding=1)


def rel_l2_64(a: torch.Tensor, b: torch.Tensor) -> float:
    """Relative L2 distance of ``a`` from ``b``, summed in fp64."""
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def fp32_flags(cfg, **unet):
    """``cfg`` with both flash flags on and the UNet's ``unet`` flags."""
    return dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, use_flash_attention=True,
                                      **unet),
        vae=dataclasses.replace(cfg.vae, use_flash_attention=True))


def fp32_keep(r, **more):
    """A measured fp32 run's seconds, peaks and the flagged kernels'
    launches."""
    return dict(dict(
        seconds=r["seconds"],
        max_memory_allocated=r["max_memory_allocated"],
        peak_above_resident=(r["max_memory_allocated"]
                             - r["memory_allocated_before"]),
        launches={k: r["launches"][k] for k in (
            "gn_silu", "gn_stats", "conv", "w8", fp32_entry("fwd", 64),
            fp32_entry("fwd", 512))}), **more)


# the weights whose loss gradients fp32_flag_step holds: the first conv, a
# resnet's norm and conv (the flagged kernels' inputs) and the last conv
FP32_STEP_PROBES = ["conv_in.weight", "down_blocks.0.resnets.0.norm1.weight",
                    "up_blocks.3.resnets.2.conv1.weight", "conv_out.weight"]


def fp32_flag_step(dev, params, flag: str, names: tuple, launches_on: dict,
                   phase_name: str, **more) -> tuple:
    """One fp32 UNetTrainer step at batch TRAIN_BATCH with gradient
    checkpointing, both flash flags and the UNet's ``flag`` on (``names[0]``)
    against off (``names[1]``): one trainer after the other on the same
    weights, batch and draws, each warmed by one step, then two timed (the
    peaks of one trainer alone).  The flagged kernels' launches asserted
    (``launches_on`` with the flag, none without).  Returns the step's
    numbers (losses, the four probes' gradients' relative L2 gap, seconds,
    peaks) and the flagged run's launches, after printing them with
    ``more`` as phase ``phase_name``; raises unless the loss is within
    TOL_FP32_LOSS_REL and every probe within TOL_FP32_GRAD_REL."""
    from diffute_tpu_torch.config import DiffUTEConfig, TrainConfig
    from diffute_tpu_torch.io.dataset import (SyntheticSceneDataset,
                                              make_unet_batch)
    from diffute_tpu_torch.train import UNetTrainer

    base = DiffUTEConfig()
    probes = FP32_STEP_PROBES
    steps, losses, grads = {}, {}, {}
    batch = draws = None
    for name, on in zip(names, (True, False)):
        s2cfg = dataclasses.replace(
            fp32_flags(base, remat=True, **{flag: on}),
            train=TrainConfig(train_batch_size=TRAIN_BATCH,
                              mixed_precision="no",
                              gradient_checkpointing=True, max_train_steps=1))
        trainer = UNetTrainer(s2cfg, params["unet"],
                              {"vae": params["vae"], "trocr": params["trocr"]},
                              device=dev, total_steps=1)
        if batch is None:
            data = SyntheticSceneDataset(s2cfg, seed=0)
            batch = make_unet_batch([data[i] for i in range(TRAIN_BATCH)],
                                    s2cfg)
            draws = trainer.draw(TRAIN_BATCH)
        trainer.accumulate_grads(batch, draws)
        steps[name] = dict(seconds=[])
        for _ in range(2):
            r = measured(dev, lambda: trainer.accumulate_grads(batch,
                                                               draws).item())
            expect_launches(r, **{k: launches_on.get(k, 0) if on else 0
                                  for k in ("gn_silu", "gn_stats", "conv",
                                            "w8")})
            expect_flash(r, **{fp32_entry("fwd", 64): 20,
                               fp32_entry("bwd_dq", 64): 10,
                               fp32_entry("bwd_dkv", 64): 10,
                               fp32_entry("fwd", 512): 2})
            losses[name] = r.pop("out")
            steps[name]["seconds"].append(r["seconds"])
            steps[name].update(fp32_keep(r, seconds=steps[name]["seconds"]))
        masters = trainer.state.params_dict()
        grads[name] = {n: masters[n].grad.clone() for n in probes}
        if on:
            launches = r["launches"]
        del trainer, masters
        gc.collect()
        torch.cuda.empty_cache()
    on, off = names
    rel = {n: rel_l2(grads[on][n], grads[off][n]) for n in probes}
    step = dict(batch=TRAIN_BATCH, **{f"loss_{n}": losses[n] for n in names},
                loss_rel_diff=abs(losses[on] - losses[off]) / abs(losses[off]),
                grad_rel_l2_err=rel, loss_tolerance=TOL_FP32_LOSS_REL,
                grad_tolerance=TOL_FP32_GRAD_REL, **steps, **more)
    phase(phase_name, **step)
    if not (step["loss_rel_diff"] <= TOL_FP32_LOSS_REL
            and max(rel.values()) <= TOL_FP32_GRAD_REL):
        raise RuntimeError(f"the fp32 stage-2 step with {flag} differs: "
                           f"{step}")
    return step, launches


# ---- phase 8d: the fp32 paths with GN+SiLU and the int8 matmul on fp32
# a 20-step fp32 edit with use_fused_groupnorm and use_int8_weights (and
# flash): per pass 45 GN+SiLU launches and 160 int8, once per edit the 32
# hoisted cross-attention K/V
GN_PER_PASS, W8_PER_PASS, W8_PER_EDIT = 45, 160, 32
# an fp32 stage-2 step with use_fused_groupnorm under gradient
# checkpointing: the 45 norms of the forward, then the 44 resnet norms
# again when their resnets are recomputed (conv_norm_out is not); the
# backward differentiates the plain version (no launch)
GN_PER_REMAT_STEP = 45 + 44


def check_fp32_fused_paths(dev, flash_only: dict) -> dict:
    """Phase 8d: the fp32 paths through gn_silu_fp32 and w8_matmul_fp32 at
    full width, weights from seed 0, UNet, VAE and TrOCR in fp32, both flash
    flags on as in phase 8c.  (a) fp32_int8_edits: a 20-step 512^2 edit
    with use_fused_groupnorm and use_int8_weights against the GN flag off
    and against the dequantised weights.  (b) One UNetTrainer step at batch 4
    with gradient checkpointing and use_fused_groupnorm against the same
    step with the flag off, the same weights, batch and draws: the loss
    within TOL_FP32_LOSS_REL, the four probes' gradients within
    TOL_FP32_GRAD_REL, GN_PER_REMAT_STEP GN+SiLU launches.  Seconds and peak
    memory of each, beside ``flash_only`` (phase 8c's flash-only fp32 edit
    and stage-2 step, the same run).  Returns the numbers and the launches
    by path."""
    from diffute_tpu_torch.config import DiffUTEConfig
    from diffute_tpu_torch.utils import init_pipeline_params

    out = {"launches": {}}

    # ---- (a) the 20-step fp32 edit, all on, and its two references
    params = init_pipeline_params(DiffUTEConfig(), seed=0, device=dev)
    edits, out["launches"] = fp32_int8_edits(dev, params)
    edits["flash_only_8c"] = {k: flash_only["edit"]["flash"][k] for k in (
        "seconds", "max_memory_allocated", "peak_above_resident")}
    phase("fp32_fused_edit", steps=VAE_FLASH_STEPS,
          tolerance_lsb=FP32_EDIT_LSB, **edits)
    out["edit"] = edits

    # ---- (b) one stage-2 step with use_fused_groupnorm, against the flag
    # off
    out["stage2"], out["launches"]["fp32_stage2_fused_gn"] = fp32_flag_step(
        dev, params, "use_fused_groupnorm", ("fused_gn", "plain_gn"),
        {"gn_silu": GN_PER_REMAT_STEP}, "fp32_fused_stage2_step",
        gn_silu_per_step=GN_PER_REMAT_STEP,
        flash_only_8c={k: flash_only["stage2"]["flash"][k] for k in (
            "seconds", "max_memory_allocated", "peak_above_resident")})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fp32_int8_edits(dev, params, all_flags: bool = False) -> tuple:
    """Phase 8d (a): 20-step 512^2 fp32 edits through DiffUTEPipeline.edit
    with both flash flags, weights ``params``: use_fused_groupnorm and
    use_int8_weights (bench.py --dtype fp32 --fused-gn --int8's
    configuration with flash: 900 GN+SiLU, 3,232 int8 and 200 + 2 fp32
    flash launches), only the box changed, within FP32_EDIT_LSB of the same
    edit with use_fused_groupnorm off (nn.GroupNorm and SiLU in fp32) and of
    the same edit whose transformer layers hold the dequantised int8
    weights (q * s) as float weights with use_int8_weights off.  With
    ``all_flags``, phase 8e (b)'s edit with all three flags too (880 conv,
    880 statistics, 20 GN+SiLU, 3,232 int8 and 202 flash launches), within
    FP32_EDIT_LSB of the first.  The pipelines side by side, each warmed,
    the edits in turns (forward order, then back).  Returns (each edit's
    seconds, peaks, launches and distance in LSB, the launches by path);
    raises past the tolerance."""
    from diffute_tpu_torch.config import DiffUTEConfig
    from diffute_tpu_torch.models import UNet2DCondition
    from diffute_tpu_torch.models.layers import QuantLinear
    from diffute_tpu_torch.ops.quant import dequantize, quantize_per_channel
    from diffute_tpu_torch.pipeline import DiffUTEPipeline
    from diffute_tpu_torch.utils.params import build_meta

    base = DiffUTEConfig()
    serving = dataclasses.replace(base, edit=dataclasses.replace(
        base.edit, resolution=RES, num_inference_steps=VAE_FLASH_STEPS))
    int8_cfg = fp32_flags(serving, use_int8_weights=True).unet
    dequantised = dict(params["unet"])
    for name, m in build_meta(UNet2DCondition, int8_cfg).named_modules():
        if isinstance(m, QuantLinear):
            dequantised[f"{name}.weight"] = dequantize(*quantize_per_channel(
                params["unet"][f"{name}.weight"]))
    image, box = scene()
    variants = {"fused_gn_int8": (dict(use_fused_groupnorm=True,
                                       use_int8_weights=True), params["unet"]),
                "int8": (dict(use_int8_weights=True), params["unet"]),
                "fused_gn_dequantised": (dict(use_fused_groupnorm=True),
                                         dequantised)}
    if all_flags:
        variants["all_flags"] = (ALL_FLAGS, params["unet"])
    pipes = {name: DiffUTEPipeline(fp32_flags(serving, **unet_flags),
                                   dict(params, unet=unet_params), dev)
             for name, (unet_flags, unet_params) in variants.items()}
    for pipe in pipes.values():
        pipe.edit(image, box, "warm", seed=0, num_inference_steps=2)
    edits = {name: dict(seconds=[], unet_bytes=sum(
        t.numel() * t.element_size() for t in (*pipe.unet.parameters(),
                                               *pipe.unet.buffers())))
             for name, pipe in pipes.items()}
    outs, launches = {}, {}
    steps = VAE_FLASH_STEPS
    order = list(pipes)
    for name in order + order[::-1]:
        unet_flags = variants[name][0]
        r = measured(dev, lambda: pipes[name].edit(image, box, "FP32 FUSED",
                                                   seed=5)[0])
        only_boxes_changed(r["out"], image, [box])
        conv = CONV_PER_PASS * steps if unet_flags.get("use_fused_conv") else 0
        gn = unet_flags.get("use_fused_groupnorm")
        expect_launches(r, conv=conv, gn_stats=conv,
                        gn_silu=(0 if not gn else steps if conv
                                 else GN_PER_PASS * steps),
                        w8=(W8_PER_PASS * steps + W8_PER_EDIT
                            if unet_flags.get("use_int8_weights") else 0))
        expect_flash(r, **{fp32_entry("fwd", 64): 10 * steps,
                           fp32_entry("fwd", 512): 2})
        outs.setdefault(name, r["out"])
        edits[name]["seconds"].append(r["seconds"])
        edits[name].update(fp32_keep(r, seconds=edits[name]["seconds"]))
        launches[f"fp32_edit_{name}"] = r["launches"]
    for name in order[1:]:
        edits[name]["max_lsb_vs_fused_gn_int8"] = int(np.abs(
            outs[name].astype(np.int16) - outs["fused_gn_int8"]).max())
    if any(edits[n]["max_lsb_vs_fused_gn_int8"] > FP32_EDIT_LSB
           for n in order[1:]):
        raise RuntimeError(f"the fp32 fused-GN / int8 edit differs from its "
                           f"references: {edits}")
    del pipes, pipe, dequantised, outs
    gc.collect()
    torch.cuda.empty_cache()
    return edits, launches


# ---- phase 8e: the fp32 paths through the fp32 GN+SiLU+conv3x3
# a 20-step fp32 edit with use_fused_conv: per pass 44 conv launches, each
# behind its statistics launch; with all three flags conv_norm_out's
# GN+SiLU too (1 a pass) and the int8 matmul
CONV_PER_PASS = 44
# an fp32 stage-2 step with use_fused_conv under gradient checkpointing:
# the 44 resnet halves of the forward, then again when their resnets are
# recomputed; the backward differentiates the plain version (no launch)
CONV_PER_REMAT_STEP = 44 + 44


def check_fp32_conv_paths(dev) -> dict:
    """Phase 8e: the fp32 paths through gn_silu_conv3x3_fp32 (and
    gn_stats_fp32 before each launch) at full width, weights from seed 0,
    UNet, VAE and TrOCR in fp32, both flash flags on as in 8c and 8d.  (a)
    A 20-step 512^2 edit through DiffUTEPipeline.edit with use_fused_conv
    (bench.py --dtype fp32 --fused-conv's configuration with flash): 880
    conv, 880 statistics and 200 + 2 fp32 flash launches, only the box
    changed, within FP32_EDIT_LSB of 8c's flash-only edit (the same
    weights, scene and seed).  (b) The same edit with all three flags
    (--fused-gn --fused-conv --int8): 880 conv, 880 statistics, 20
    GN+SiLU, 3,232 int8 and 202 flash launches, within FP32_EDIT_LSB of
    8d's --fused-gn --int8 edit.  The four pipelines side by side, each
    warmed, the edits in turns (a, 8c, b, 8d, then back); seconds and the
    peak above the resident weights.  (c) One UNetTrainer step at batch 4
    with gradient checkpointing and use_fused_conv against the same step
    with the flag off, the same weights, batch and draws (one trainer after
    the other, each warmed, two steps timed): the loss within
    TOL_FP32_LOSS_REL, the four probes' gradients within TOL_FP32_GRAD_REL,
    CONV_PER_REMAT_STEP conv and statistics launches.  Returns the numbers
    and the launches by path."""
    from diffute_tpu_torch.config import DiffUTEConfig
    from diffute_tpu_torch.pipeline import DiffUTEPipeline
    from diffute_tpu_torch.utils import init_pipeline_params

    base = DiffUTEConfig()
    out = {"launches": {}}

    # ---- (a) and (b): the two flagged edits and their references, in turns
    params = init_pipeline_params(base, seed=0, device=dev)
    serving = dataclasses.replace(base, edit=dataclasses.replace(
        base.edit, resolution=RES, num_inference_steps=VAE_FLASH_STEPS))
    variants = {"fused_conv": dict(use_fused_conv=True),
                "flash_only_8c": {},
                "all_flags": ALL_FLAGS,
                "fused_gn_int8_8d": dict(use_fused_groupnorm=True,
                                         use_int8_weights=True)}
    references = {"fused_conv": "flash_only_8c",
                  "all_flags": "fused_gn_int8_8d"}
    pipes = {name: DiffUTEPipeline(fp32_flags(serving, **unet_flags), params,
                                   dev)
             for name, unet_flags in variants.items()}
    del params
    image, box = scene()
    for pipe in pipes.values():
        pipe.edit(image, box, "warm", seed=0, num_inference_steps=2)
    edits = {name: dict(seconds=[]) for name in pipes}
    outs = {}
    steps = VAE_FLASH_STEPS
    order = list(pipes)
    for name in order + order[::-1]:
        unet_flags = variants[name]
        r = measured(dev, lambda: pipes[name].edit(image, box, "FP32 FUSED",
                                                   seed=5)[0])
        only_boxes_changed(r["out"], image, [box])
        conv = CONV_PER_PASS * steps if unet_flags.get("use_fused_conv") else 0
        gn = unet_flags.get("use_fused_groupnorm")
        expect_launches(r, conv=conv, gn_stats=conv,
                        gn_silu=(0 if not gn else steps if conv
                                 else GN_PER_PASS * steps),
                        w8=(W8_PER_PASS * steps + W8_PER_EDIT
                            if unet_flags.get("use_int8_weights") else 0))
        expect_flash(r, **{fp32_entry("fwd", 64): 10 * steps,
                           fp32_entry("fwd", 512): 2})
        outs.setdefault(name, r["out"])
        edits[name]["seconds"].append(r["seconds"])
        edits[name].update(fp32_keep(r, seconds=edits[name]["seconds"]))
        if name in references:
            out["launches"][f"fp32_edit_{name}"] = r["launches"]
    for name, ref in references.items():
        edits[name][f"max_lsb_vs_{ref}"] = int(np.abs(
            outs[name].astype(np.int16) - outs[ref]).max())
    phase("fp32_conv_edit", steps=steps, tolerance_lsb=FP32_EDIT_LSB, **edits)
    if any(edits[n][f"max_lsb_vs_{ref}"] > FP32_EDIT_LSB
           for n, ref in references.items()):
        raise RuntimeError(f"the fp32 fused-conv edits differ from their "
                           f"references: {edits}")
    out["edit"] = edits
    del pipes, pipe, outs
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) one stage-2 step with use_fused_conv, against the flag off
    params = init_pipeline_params(base, seed=0, device=dev)
    out["stage2"], out["launches"]["fp32_stage2_fused_conv"] = fp32_flag_step(
        dev, params, "use_fused_conv", ("fused_conv", "plain_conv"),
        {"conv": CONV_PER_REMAT_STEP, "gn_stats": CONV_PER_REMAT_STEP},
        "fp32_conv_stage2_step", conv_per_step=CONV_PER_REMAT_STEP)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fp32_fused_entries(results: dict, launches: dict) -> list:
    """The four fp32 entries of groupnorm.cu, quant_fp32_sm90.cu and
    conv_fused_fp32.cu (phases 3g and 3h: entry name -> result per shape)
    with phases 8d's and 8e's launches by path (path -> counters read right
    after it ran)."""
    def by_path(key):
        return {path: rec[key] for path, rec in launches.items() if rec[key]}

    return [kernel_entry(name, source, replaces, results[name], by_path(key))
            for name, source, replaces, key in (
                ("gn_stats_fp32", "groupnorm.cu", "groupnorm.py:31",
                 "gn_stats"),
                ("gn_silu_fp32", "groupnorm.cu", "groupnorm.py:31",
                 "gn_silu"),
                ("w8_matmul_fp32", w8_fp32_source(), "quant.py:51", "w8"),
                ("gn_silu_conv3x3_fp32", "conv_fused_fp32.cu",
                 "conv_fused.py:40", "conv"))]


OCR_BATCH, OCR_STEPS, OCR_MAX_LEN = 64, 50, 16
EVAL_EXAMPLES, EVAL_STEPS = 4, 20
# flash self-attentions of one UNet pass: full width at 512^2 (5 at 4096
# tokens, 5 at 1024), small_config at 256^2 (64^2 latents: 2 down and 3 up
# at 4096 tokens, 2 down and 3 up at 1024; the 256-token mid block is dense)
FLASH_PER_PASS = {"full": 10, "small": 10}


def finite_fields(report, path="report") -> list:
    """Paths of the report's numbers that are not finite; a PSNR may be
    inf (paste-back leaves the background as it was)."""
    if isinstance(report, dict):
        return [p for k, v in report.items()
                for p in finite_fields(v, f"{path}.{k}")]
    if isinstance(report, list):
        return [p for i, v in enumerate(report)
                for p in finite_fields(v, f"{path}[{i}]")]
    if isinstance(report, float) and not np.isfinite(report):
        leaf = path.rsplit(".", 1)[-1]
        return [] if leaf.startswith("psnr") and report == float("inf") else [path]
    return []


def check_ocr_training(dev, root: str) -> tuple:
    """Phase 11: train.run_ocr at the small scale on synthetic glyphs (batch
    64, targets of 16 ids, warmup 10), a checkpoint midway and at the end,
    then a resume from the latest that restores the whole state bit for
    bit and takes one step.  Returns the numbers and the final checkpoint."""
    from diffute_tpu_torch.train import run_ocr
    from diffute_tpu_torch.train.checkpoint import list_checkpoints

    out_dir = os.path.join(root, "ocr")
    flags = ["--model_scale", "small", "--train_batch_size", str(OCR_BATCH),
             "--max_len", str(OCR_MAX_LEN), "--lr_warmup_steps", "10",
             "--checkpointing_steps", str(OCR_STEPS // 2), "--seed", "0",
             "--output_dir", out_dir, "--report_to", "none",
             "--device", "cuda"]
    run = run_ocr.prepare([*flags, "--max_train_steps", str(OCR_STEPS)])
    n_params = sum(p.numel() for p in run.trainer.state.params)
    history = run.train()
    saved = run.trainer.state_dict()
    del run
    resumed = run_ocr.prepare([*flags, "--max_train_steps", str(OCR_STEPS + 1),
                               "--resume_from_checkpoint", "latest"])
    diff = states_equal(saved, resumed.trainer.state_dict())
    history2 = resumed.train()
    del saved, resumed
    gc.collect()
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in history]
    res = dict(params=n_params, steps=len(history),
               loss_first10=float(np.mean(losses[:10])),
               loss_last10=float(np.mean(losses[-10:])),
               token_accuracy_last=history[-1]["token_accuracy"],
               step_seconds=[h["seconds"] for h in history + history2],
               max_memory_allocated=[h["max_memory_allocated"]
                                     for h in history + history2],
               resumed_steps=[h["step"] for h in history2],
               restored_differs_at=diff[:5],
               checkpoints=list_checkpoints(out_dir))
    phase("ocr_train", **res)
    if (len(history) != OCR_STEPS or res["resumed_steps"] != [OCR_STEPS + 1]
            or diff or not all(np.isfinite(h["loss"])
                               and np.isfinite(h["grad_norm"])
                               for h in history + history2)
            or not res["loss_last10"] < res["loss_first10"]):
        raise RuntimeError(f"OCR training failed: {res}")
    return res, os.path.join(out_dir, f"checkpoint-{OCR_STEPS + 1}")


@contextlib.contextmanager
def eval_probes():
    """While eval.run runs: each DiffUTEPipeline.edit's seconds, flash
    launches and edited box, each OCRVerifier.read's seconds, and the
    (pipeline, verifier, config) that build_models made."""
    from diffute_tpu_torch.eval import OCRVerifier
    from diffute_tpu_torch.eval import run as eval_run
    from diffute_tpu_torch.pipeline import DiffUTEPipeline

    probes = {"edits": [], "reads": [], "models": None}
    edit, read, build = (DiffUTEPipeline.edit, OCRVerifier.read,
                         eval_run.build_models)

    def timed_edit(self, image, box, *a, **kw):
        before = counters()["flash_fwd"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = edit(self, image, box, *a, **kw)
        x1, y1, x2, y2 = box
        probes["edits"].append(dict(
            seconds=time.perf_counter() - t0,
            flash_fwd=counters()["flash_fwd"] - before,
            region=result[0][y1:y2, x1:x2]))
        return result

    def timed_read(self, images):
        t0 = time.perf_counter()
        ids = read(self, images)  # ends in a copy to the host
        probes["reads"].append(time.perf_counter() - t0)
        return ids

    def kept(args):
        probes["models"] = build(args)
        return probes["models"]

    DiffUTEPipeline.edit, OCRVerifier.read = timed_edit, timed_read
    eval_run.build_models = kept
    try:
        yield probes
    finally:
        DiffUTEPipeline.edit, OCRVerifier.read = edit, read
        eval_run.build_models = build


def compare_decodes(verifier, regions) -> dict:
    """greedy_decode_cached against greedy_decode on the verifier's reading
    of ``regions``: token for token, each timed once (after a warm-up of
    the cached one); on a difference, the first position and its top-2
    margin."""
    from diffute_tpu_torch.models.trocr_decoder import (greedy_decode,
                                                        greedy_decode_cached)
    from diffute_tpu_torch.text import trocr_normalize, trocr_preprocess_host

    dev, n = verifier.device, verifier.max_len
    with torch.inference_mode():
        pixels = torch.from_numpy(trocr_preprocess_host(
            regions, verifier.encoder_config)).to(dev)
        enc = verifier.encoder(trocr_normalize(pixels).permute(0, 3, 1, 2))
        greedy_decode_cached(verifier.decoder, enc, n)
        out = {}
        for name, fn in (("cached", greedy_decode_cached),
                         ("uncached", greedy_decode)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name] = fn(verifier.decoder, enc, n)
            torch.cuda.synchronize()
            out[f"{name}_seconds"] = time.perf_counter() - t0
        cached, plain = out.pop("cached"), out.pop("uncached")
        out["equal"] = bool(torch.equal(cached, plain))
        out["ids"] = cached.cpu().tolist()
        if not out["equal"]:
            row, pos = (cached != plain).nonzero()[0].tolist()
            cfg = verifier.decoder.config
            prefix = torch.cat([torch.full((1, 1), cfg.decoder_start_token_id,
                                           device=dev), plain[row:row + 1, :pos]],
                               dim=1)
            top2 = verifier.decoder(prefix, enc[row:row + 1])[0, -1].topk(2)
            out["first_difference"] = dict(
                row=row, position=pos, cached=int(cached[row, pos]),
                uncached=int(plain[row, pos]),
                top2_margin=float(top2.values[0] - top2.values[1]))
    return out


def eval_one(scale: str, extra: list, root: str) -> dict:
    """One eval.run at ``scale`` over EVAL_EXAMPLES synthetic scenes at
    EVAL_STEPS steps, every counter set to 0 before it, with the checks of
    phase 12."""
    from diffute_tpu_torch.eval import run as eval_run

    report_path = os.path.join(root, f"eval_{scale}.json")
    reset_counters()
    t0 = time.perf_counter()
    with eval_probes() as probes:
        report = eval_run.main(["--model_scale", scale, "--synthetic",
                                str(EVAL_EXAMPLES), "--steps", str(EVAL_STEPS),
                                "--seed", "0", "--device", "cuda", *extra,
                                "--out", report_path])
    seconds = time.perf_counter() - t0
    launches = counters()
    pipe, verifier, _ = probes["models"]
    edits = probes["edits"]
    dcfg = verifier.decoder.config
    res = dict(seconds=seconds, edit_seconds=[e["seconds"] for e in edits],
               flash_fwd_per_example=[e["flash_fwd"] for e in edits],
               read_seconds=probes["reads"], launches=launches,
               decoder_layers=dcfg.decoder_layers, vocab_size=dcfg.vocab_size,
               verifier_dtype=str(verifier.decoder.embed_tokens.weight.dtype),
               report={k: v for k, v in report.items() if k != "examples"})
    if scale == "full":
        res["decodes"] = compare_decodes(verifier, [e["region"] for e in edits])
    del pipe, verifier, probes, edits
    gc.collect()
    torch.cuda.empty_cache()
    phase(f"eval_{scale}", **res)
    per_example = FLASH_PER_PASS[scale] * EVAL_STEPS
    bad = finite_fields(report)
    if (report["num_examples"] != EVAL_EXAMPLES
            or res["flash_fwd_per_example"] != [per_example] * EVAL_EXAMPLES
            or launches["flash_fwd"] != per_example * EVAL_EXAMPLES
            or report["ssim_background_mean"] != 1.0
            or not report["region_mean_abs_delta_mean"] > 0 or bad):
        raise RuntimeError(f"eval at {scale} scale failed: {res}; "
                           f"not finite: {bad}")
    if res["verifier_dtype"] != "torch.float32" or (
            "decodes" in res and not res["decodes"]["equal"]):
        raise RuntimeError(f"the verifier at {scale} scale: {res}")
    return res


def check_eval(ocr_ckpt: str, root: str) -> dict:
    """Phase 12: eval.run at full width (SD2-inpainting UNet and VAE, the
    TrOCR-large encoder and decoder as the verifier, random-init from the
    seed); then at the small scale with phase 11's verifier (--pretrained,
    --tokenizer char)."""
    full = eval_one("full", [], root)
    if (full["decoder_layers"], full["vocab_size"]) != (12, 50265):
        raise RuntimeError(f"the full-width verifier is not TrOCR-large's "
                           f"decoder: {full['decoder_layers']} layers, "
                           f"vocabulary {full['vocab_size']}")
    small = eval_one("small", ["--pretrained", ocr_ckpt, "--tokenizer", "char"],
                     root)
    if "ocr_text_match_rate" not in small["report"]:
        raise RuntimeError("the char tokenizer's text match is missing")
    return {"full": full, "small": small,
            "launches": {"eval_full": full["launches"],
                         "eval_small": small["launches"]}}


def check_acceptance(dev, layout: str, root: str) -> dict:
    """Phase 13: eval.acceptance at full width on ``layout`` (fp32, dense
    attention): --make_reference writes a bundle, then a second run holds
    the layout against it.  Both exit 0 with the pinned parameter counts
    and stages 3-5 passing."""
    from diffute_tpu_torch.eval import acceptance

    bundle = os.path.join(root, "bundle")
    runs = {}
    for name, flag in (("make_reference", "--make_reference"),
                       ("check", "--reference_outputs")):
        report_path = os.path.join(root, f"acceptance_{name}.json")
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        rc = acceptance.main(["--pretrained", layout, "--model_scale", "full",
                              flag, bundle, "--device", "cuda",
                              "--out", report_path])
        with open(report_path) as f:
            report = json.load(f)
        runs[name] = dict(rc=rc, seconds=time.perf_counter() - t0,
                          max_memory_allocated=torch.cuda.max_memory_allocated(dev),
                          stages={k: v["status"]
                                  for k, v in report["stages"].items()},
                          counts=report["stages"]["param_pins"].get("counts"))
        if name == "check":
            runs[name]["details"] = {k: report["stages"][k] for k in
                                     ("goldens", "latents", "image")}
        gc.collect()
        torch.cuda.empty_cache()
    phase("acceptance", **runs)
    check = runs["check"]
    if (any(r["rc"] != 0 for r in runs.values())
            or check["counts"]["unet"] != 865_925_124
            or check["counts"]["vae"] != VAE_PARAMS
            or any(check["stages"][k] != "pass"
                   for k in ("layout", "param_pins", "goldens", "latents",
                             "image"))):
        raise RuntimeError(f"acceptance failed: {runs}")
    return runs


def export_random_layout(dev, path: str) -> None:
    """A full-width random-init diffusers layout (seed 0), for --eval-only."""
    from diffute_tpu_torch.compat.diffusers import (diffusers_unet_config_json,
                                                    diffusers_vae_config_json,
                                                    vit_config_json)
    from diffute_tpu_torch.config import DiffUTEConfig
    from diffute_tpu_torch.train.checkpoint import export_diffusers_layout
    from diffute_tpu_torch.utils import init_pipeline_params

    cfg = DiffUTEConfig()
    params = init_pipeline_params(cfg, seed=0, device=dev)
    export_diffusers_layout(
        path, unet_params=params["unet"], vae_params=params["vae"],
        trocr_params=params["trocr"],
        unet_config=diffusers_unet_config_json(cfg.unet),
        vae_config=diffusers_vae_config_json(cfg.vae),
        trocr_config=vit_config_json(cfg.trocr))
    del params
    gc.collect()
    torch.cuda.empty_cache()


def check_verifier_paths(dev, root: str, layout: str) -> dict:
    """Phases 11-13: OCR verifier training, eval at full width and at the
    small scale from its checkpoint, acceptance at full width on
    ``layout``."""
    ocr, ocr_ckpt = check_ocr_training(dev, root)
    evals = check_eval(ocr_ckpt, root)
    return {"ocr_train": ocr, "eval": evals,
            "acceptance": check_acceptance(dev, layout, root)}


def verifier_summary(res: dict) -> dict:
    """Phases 11-13's numbers for the result line."""
    ocr, ev, acc = res["ocr_train"], res["eval"], res["acceptance"]
    out = {"ocr_train": {k: ocr[k] for k in (
               "params", "loss_first10", "loss_last10", "token_accuracy_last",
               "step_seconds", "max_memory_allocated")},
           "acceptance_seconds": {k: r["seconds"] for k, r in acc.items()},
           "acceptance_max_memory_allocated": {
               k: r["max_memory_allocated"] for k, r in acc.items()}}
    for scale in ("full", "small"):
        e = ev[scale]
        out[f"eval_{scale}"] = {k: e[k] for k in (
            "seconds", "edit_seconds", "read_seconds", "flash_fwd_per_example")}
    d = ev["full"]["decodes"]
    out["eval_full"].update(cached_seconds=d["cached_seconds"],
                            uncached_seconds=d["uncached_seconds"])
    return out


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
                   help="build and check the kernels of phases 3 to 3i "
                   "(those the package has), then stop")
    p.add_argument("--flash-host", type=int, default=0, metavar="ROUNDS",
                   help="time the host's side of the serving attention call "
                   "and nothing else")
    p.add_argument("--fused-only", action="store_true",
                   help="build and check the UNet's opt-in kernels (phase "
                   "3b) alone, then stop")
    p.add_argument("--fused-host", type=int, default=0, metavar="ROUNDS",
                   help="time the host's side of one fused-conv and one "
                   "int8 layer call and nothing else")
    p.add_argument("--workflow-only", action="store_true",
                   help="build the kernels and run phases 8-10 (the "
                   "two-stage workflow) alone")
    p.add_argument("--d512-only", action="store_true",
                   help="build the kernels and run phases 3c, 3e and 8a "
                   "(the head_dim-512 kernels and the VAE's flash paths) "
                   "alone")
    p.add_argument("--d256-only", action="store_true",
                   help="build the kernels and run phases 3d, 3e and 8b (the "
                   "head_dim-256 kernels and the small VAE's flash paths) "
                   "alone")
    p.add_argument("--fp32-only", action="store_true",
                   help="build the kernels and run phases 3f, 3g, 3h, 8c, "
                   "8d and 8e (the fp32 kernels and the fp32 paths) alone")
    p.add_argument("--fp32-d512-only", action="store_true",
                   help="build the kernels and run phase 3f at head_dim 512 "
                   "and 8c's SD2 stage-1 steps (the fp32 head_dim-512 "
                   "kernels and the step that trains through them) alone")
    p.add_argument("--fp32-d64-only", action="store_true",
                   help="build the kernels and run phase 3f at head_dim 64 "
                   "and 8c's flagged fp32 stage-2 step (the fp32 head_dim-64 "
                   "kernels, their route held inside the step, full steps "
                   "timed) alone")
    p.add_argument("--fp32-d256-only", action="store_true",
                   help="build the kernels and run phase 3f at head_dim 256 "
                   "and 8c's small_config fp32 stage-1 steps (the fp32 "
                   "head_dim-256 kernels, their route held inside the step "
                   "with PIPELINE_FWD off and on, the steps timed) alone")
    p.add_argument("--w8-fp32-only", action="store_true",
                   help="build the kernels and run phase 3g's int8 matmul "
                   "and phase 8d's fp32 --fused-gn --int8 edits beside 8e's "
                   "all-flags edit alone")
    p.add_argument("--narrow-only", action="store_true",
                   help="build the kernels and run phases 3i and 8f (the "
                   "narrow head_dims' kernels and the tiny model's paths) "
                   "alone")
    p.add_argument("--eval-only", action="store_true",
                   help="build the kernels and run phases 11-13 (OCR "
                   "verifier training, eval, acceptance of a random-init "
                   "full-width layout) alone")
    p.add_argument("--save-route", default=None, metavar="PATH",
                   help="with --fp32-d512-only: save the PIPELINE_FWD stage-1 "
                   "step's mid-block flash calls (q, k, v, dO) to PATH for "
                   "tools.fp32_d512_bwd_variants --chain-study")
    p.add_argument("--package-root", default=None, metavar="DIR",
                   help="import diffute_tpu_torch from this checkout")
    args = p.parse_args(argv)
    t_run = time.perf_counter()
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
    if args.d512_only or args.d256_only:
        from diffute_tpu_torch.ops import _build

        print(gpu_line(), flush=True)
        _build.load()
        dev = torch.device("cuda", 0)
        d, scale = (512, "full") if args.d512_only else (256, "small")
        seconds = {}
        for name, fn in (("wide", lambda: check_wide(dev, d)),
                         ("wide_pipelined",
                          lambda: check_wide_pipelined(dev, d)),
                         ("vae_flash", lambda: check_vae_flash(dev, scale))):
            t0 = time.perf_counter()
            seconds[name] = (fn(), time.perf_counter() - t0)
        phase("seconds", **{k: v[1] for k, v in seconds.items()},
              run=time.perf_counter() - t_run)
        wide, vae_flash = seconds["wide"][0], seconds["vae_flash"][0]
        wide["fwd_pipelined"] = seconds["wide_pipelined"][0]
        print(json.dumps({"kernels": wide_entries(wide, vae_flash["launches"],
                                                  d),
                          "vae_flash": vae_flash_summary(vae_flash)}),
              flush=True)
        return
    if args.fp32_only:
        from diffute_tpu_torch.ops import _build

        print(gpu_line(), flush=True)
        _build.load()
        dev = torch.device("cuda", 0)
        seconds = {}
        for name, fn in (
                ("phase_3f", lambda: check_fp32(dev)),
                ("phase_3g", lambda: check_fp32_fused(dev)),
                ("phase_3h", lambda: check_fp32_conv(dev)),
                ("phase_8c", lambda: check_fp32_paths(dev)),
                ("phase_8d", lambda: check_fp32_fused_paths(
                    dev, seconds["phase_8c"][0])),
                ("phase_8e", lambda: check_fp32_conv_paths(dev))):
            t0 = time.perf_counter()
            seconds[name] = (fn(), time.perf_counter() - t0)
        phase("seconds", **{k: v[1] for k, v in seconds.items()},
              run=time.perf_counter() - t_run)
        fp32, fp32_paths = seconds["phase_3f"][0], seconds["phase_8c"][0]
        fused32 = dict(seconds["phase_3g"][0],
                       gn_silu_conv3x3_fp32=seconds["phase_3h"][0])
        fused32_paths, conv32_paths = (seconds["phase_8d"][0],
                                       seconds["phase_8e"][0])
        print(gpu_line(), flush=True)
        print(json.dumps({
            "kernels": (fp32_entries(fp32, fp32_paths["launches"])
                        + fp32_fused_entries(
                            fused32, {**fused32_paths["launches"],
                                      **conv32_paths["launches"]})),
            "fp32_paths": vae_flash_summary(fp32_paths),
            "fp32_fused_paths": vae_flash_summary(fused32_paths),
            "fp32_conv_paths": vae_flash_summary(conv32_paths)}),
            flush=True)
        return
    if args.w8_fp32_only:
        import diffute_tpu_torch
        from diffute_tpu_torch.config import DiffUTEConfig
        from diffute_tpu_torch.ops import _build
        from diffute_tpu_torch.utils import init_pipeline_params

        print(gpu_line(), diffute_tpu_torch.__file__, flush=True)
        _build.load()
        dev = torch.device("cuda", 0)
        seconds = {}
        t0 = time.perf_counter()
        w8 = check_w8_fp32(dev)
        seconds["phase_3g_w8"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        params = init_pipeline_params(DiffUTEConfig(), seed=0, device=dev)
        edits, launches = fp32_int8_edits(dev, params, all_flags=True)
        del params
        phase("fp32_int8_edits", steps=VAE_FLASH_STEPS,
              tolerance_lsb=FP32_EDIT_LSB, **edits)
        seconds["phase_8d_8e_edits"] = time.perf_counter() - t0
        phase("seconds", **seconds, run=time.perf_counter() - t_run)
        by_path = {path: rec["w8"] for path, rec in launches.items()
                   if rec["w8"]}
        print(gpu_line(), flush=True)
        print(json.dumps({"kernels": [kernel_entry(
            "w8_matmul_fp32", w8_fp32_source(), "quant.py:51", w8, by_path)],
            "fp32_int8_edits": {n: {k: e[k] for k in (
                "seconds", "peak_above_resident")} for n, e in edits.items()}}),
            flush=True)
        return
    if args.fp32_d512_only:
        import diffute_tpu_torch
        from diffute_tpu_torch.config import DiffUTEConfig
        from diffute_tpu_torch.ops import _build
        from diffute_tpu_torch.utils import init_pipeline_params

        print(gpu_line(), diffute_tpu_torch.__file__, flush=True)
        _build.load()
        dev = torch.device("cuda", 0)
        seconds, paths = {}, {"launches": {}}
        t0 = time.perf_counter()
        fp32 = check_fp32(dev, (512,))
        seconds["phase_3f_d512"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        vae = init_pipeline_params(DiffUTEConfig(), seed=0, device=dev,
                                   components=("vae",))["vae"]
        stage1 = check_fp32_sd2_stage1(dev, vae, paths, args.save_route)
        seconds["phase_8c_sd2_stage1"] = time.perf_counter() - t0
        phase("seconds", **seconds, run=time.perf_counter() - t_run)
        print(gpu_line(), flush=True)
        print(json.dumps({"kernels": fp32_entries(fp32, paths["launches"],
                                                  (512,)),
                          "fp32_stage1": stage1}), flush=True)
        return
    if args.fp32_d64_only:
        import diffute_tpu_torch
        from diffute_tpu_torch.config import DiffUTEConfig
        from diffute_tpu_torch.ops import _build
        from diffute_tpu_torch.utils import init_pipeline_params

        print(gpu_line(), diffute_tpu_torch.__file__, flush=True)
        _build.load()
        dev = torch.device("cuda", 0)
        seconds, paths = {}, {"launches": {}}
        t0 = time.perf_counter()
        fp32 = check_fp32(dev, (64,))
        seconds["phase_3f_d64"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        params = init_pipeline_params(fp32_flags(DiffUTEConfig()), seed=0,
                                      device=dev)
        stage2 = fp32_stage2_step(dev, params, paths)
        del params
        seconds["phase_8c_stage2"] = time.perf_counter() - t0
        phase("seconds", **seconds, run=time.perf_counter() - t_run)
        print(gpu_line(), flush=True)
        print(json.dumps({
            "kernels": fp32_entries(fp32, paths["launches"], (64,)),
            "fp32_stage2": {
                "loss_rel_diff": stage2["loss_rel_diff"],
                "step_seconds": [x["seconds"] for x in stage2["timed_steps"]],
                "route_held": [r["held"] for r in stage2["flash_route"]
                               + stage2["flash_route_pipelined"]]}}),
            flush=True)
        return
    if args.fp32_d256_only:
        import diffute_tpu_torch
        from diffute_tpu_torch.config import small_config
        from diffute_tpu_torch.ops import _build
        from diffute_tpu_torch.utils import init_pipeline_params

        print(gpu_line(), diffute_tpu_torch.__file__, flush=True)
        _build.load()
        dev = torch.device("cuda", 0)
        seconds, paths = {}, {"launches": {}}
        t0 = time.perf_counter()
        fp32 = check_fp32(dev, (256,))
        seconds["phase_3f_d256"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        vae = init_pipeline_params(small_config(), seed=0, device=dev,
                                   components=("vae",))["vae"]
        stage1 = check_fp32_small_stage1(dev, vae, paths)
        del vae
        seconds["phase_8c_small_stage1"] = time.perf_counter() - t0
        phase("seconds", **seconds, run=time.perf_counter() - t_run)
        print(gpu_line(), flush=True)
        print(json.dumps({
            "kernels": fp32_entries(fp32, paths["launches"], (256,)),
            "fp32_small_stage1": {
                "step_seconds": [x["seconds"] for x in stage1["flash"]],
                "route": route_summary(stage1["flash_route"]),
                "route_pipelined": route_summary(
                    stage1["flash_route_pipelined"])}}), flush=True)
        return
    if args.narrow_only:
        import diffute_tpu_torch
        from diffute_tpu_torch.ops import _build

        print(gpu_line(), diffute_tpu_torch.__file__, flush=True)
        _build.load()
        dev = torch.device("cuda", 0)
        seconds = {}
        for name, fn in (("phase_3i", lambda: check_narrow(dev)),
                         ("phase_8f", lambda: check_tiny_paths(dev))):
            t0 = time.perf_counter()
            seconds[name] = (fn(), time.perf_counter() - t0)
        phase("seconds", **{k: v[1] for k, v in seconds.items()},
              run=time.perf_counter() - t_run)
        tiny = seconds["phase_8f"][0]
        print(gpu_line(), flush=True)
        print(json.dumps({"kernels": narrow_entries(seconds["phase_3i"][0],
                                                    tiny["launches"]),
                          "tiny_paths": vae_flash_summary(tiny)}),
              flush=True)
        return
    if args.workflow_only or args.eval_only:
        from diffute_tpu_torch.ops import _build

        print(gpu_line(), flush=True)
        _build.load()
        dev = torch.device("cuda", 0)
        root = tempfile.mkdtemp(prefix="diffute_workflow_")
        try:
            if args.workflow_only:
                out = check_workflow(dev, root)[0]
            else:
                layout = os.path.join(root, "layout")
                export_random_layout(dev, layout)
                out = verifier_summary(check_verifier_paths(dev, root, layout))
        finally:
            shutil.rmtree(root, ignore_errors=True)
        print(json.dumps(out), flush=True)
        return
    if args.kernels_only:
        import diffute_tpu_torch

        print(gpu_line(), diffute_tpu_torch.__file__, flush=True)
        check_forward(torch.device("cuda", 0))
        check_backward(torch.device("cuda", 0))
        check_pipelined_forward(torch.device("cuda", 0))
        check_fused_kernels(torch.device("cuda", 0))
        fa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")
        if hasattr(fa, "D512_BLOCK_KV"):
            check_wide(torch.device("cuda", 0), 512)
        if 256 in fa.HEAD_DIMS:
            check_wide(torch.device("cuda", 0), 256)
        if hasattr(fa, "pipelined_block_kv"):
            for d in (512, 256):
                check_wide_pipelined(torch.device("cuda", 0), d)
        if hasattr(fa, "FP32_BLOCK_KV"):
            check_fp32(torch.device("cuda", 0))
            check_fp32_fused(torch.device("cuda", 0))
            check_fp32_conv(torch.device("cuda", 0))
        if hasattr(fa, "narrow_width"):
            check_narrow(torch.device("cuda", 0))
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

    # ---- 3c. the head_dim-512 kernels against their plain versions
    d512 = check_wide(dev, 512)

    # ---- 3d. the head_dim-256 kernels against their plain versions
    d256 = check_wide(dev, 256)

    # ---- 3e. the deferred-softmax forward at both wide head_dims, against
    # its plain version and the standard wide forward
    t0 = time.perf_counter()
    d512["fwd_pipelined"] = check_wide_pipelined(dev, 512)
    d256["fwd_pipelined"] = check_wide_pipelined(dev, 256)
    phase("phase_3e", seconds=time.perf_counter() - t0)

    # ---- 3f. the fp32 kernels at head_dims 64, 256 and 512 against their
    # plain fp32 versions
    t0 = time.perf_counter()
    fp32 = check_fp32(dev)
    phase("phase_3f", seconds=time.perf_counter() - t0)

    # ---- 3g. GN+SiLU, its statistics and the int8 matmul on fp32 inputs
    # against their plain fp32 versions
    t0 = time.perf_counter()
    fused32 = check_fp32_fused(dev)
    phase("phase_3g", seconds=time.perf_counter() - t0)

    # ---- 3h. GN+SiLU+conv3x3 on fp32 inputs against its plain fp32
    # version
    t0 = time.perf_counter()
    fused32["gn_silu_conv3x3_fp32"] = check_fp32_conv(dev)
    phase("phase_3h", seconds=time.perf_counter() - t0)

    # ---- 3i. the narrow head_dims' kernels, bf16 and fp32, against their
    # plain versions
    t0 = time.perf_counter()
    narrow = check_narrow(dev)
    phase("phase_3i", seconds=time.perf_counter() - t0)

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
    train_dir = tempfile.mkdtemp(prefix="diffute_train_")
    history = run_unet.main([
        "--model_scale", "full", "--train_batch_size", str(TRAIN_BATCH),
        "--mixed_precision", "bf16", "--gradient_checkpointing",
        "--max_train_steps", str(TRAIN_STEPS), "--seed", "0",
        "--output_dir", train_dir])
    shutil.rmtree(train_dir)
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
    masters = trainer.state.params_dict()
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
    del trainer, masters, grads_flash, attns, batch, data, draws, before
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 8-10. the two-stage workflow: stage 1 on a manifest, stage 2
    # from its checkpoint, both resumed, and serving from the checkpoint;
    # 11-13. the OCR verifier's training, eval at full width and at the
    # small scale with that verifier, acceptance of stage 2's export
    root = tempfile.mkdtemp(prefix="diffute_workflow_")
    try:
        workflow, stage2_export = check_workflow(dev, root)
        # ---- 8a. the VAE's flash paths at full width; 8b. those of
        # small_config's VAE; each flagged path also with PIPELINE_FWD
        t0 = time.perf_counter()
        vae_flash = check_vae_flash(dev)
        phase("phase_8a", seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        small_vae_flash = check_vae_flash(dev, "small")
        phase("phase_8b", seconds=time.perf_counter() - t0)
        # ---- 8c. the fp32 paths with the fp32 flash kernels
        t0 = time.perf_counter()
        fp32_paths = check_fp32_paths(dev)
        phase("phase_8c", seconds=time.perf_counter() - t0)
        # ---- 8d. the fp32 edit with GN+SiLU and int8 weights, and an fp32
        # stage-2 step with GN+SiLU
        t0 = time.perf_counter()
        fused32_paths = check_fp32_fused_paths(dev, fp32_paths)
        phase("phase_8d", seconds=time.perf_counter() - t0)
        # ---- 8e. the fp32 edits with the fused conv (alone and with all
        # three flags), and an fp32 stage-2 step with it
        t0 = time.perf_counter()
        conv32_paths = check_fp32_conv_paths(dev)
        phase("phase_8e", seconds=time.perf_counter() - t0)
        # ---- 8f. the tiny model's 512^2 paths through the narrow kernels
        t0 = time.perf_counter()
        tiny_paths = check_tiny_paths(dev)
        phase("phase_8f", seconds=time.perf_counter() - t0)
        verifier_paths = check_verifier_paths(dev, root, stage2_export)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wl = {**workflow["launches"], **verifier_paths["eval"]["launches"],
          **vae_flash["launches"], **small_vae_flash["launches"],
          **fp32_paths["launches"]}

    def path_launches(key):
        """``key``'s launches on each path, from the counters read right
        after each path ran."""
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
        by_path.update({name: rec[key] for name, rec in wl.items()})
        return {k: v for k, v in by_path.items() if v}

    kernels = [
        kernel_entry("flash_fwd_bf16", "flash_fwd.cu",
                     "flash_attention.py:275", fwd_results,
                     {"edit": edit_launches,
                      "edit_flags": flag_launches["flash_fwd"],
                      "train": train_launches["fwd"],
                      **path_launches("flash_fwd")}),
        kernel_entry("flash_fwd_pipelined_bf16", "flash_fwd_pipelined.cu",
                     "flash_attention.py:149", pipelined_results,
                     path_launches("flash_fwd_pipelined")),
        kernel_entry("flash_bwd_dq_bf16", "flash_bwd.cu",
                     "flash_attention.py:396", dq_results,
                     {"train": train_launches["dq"],
                      **path_launches("flash_bwd_dq")}),
        kernel_entry("flash_bwd_dkv_bf16", "flash_bwd.cu",
                     "flash_attention.py:437", dkv_results,
                     {"train": train_launches["dkv"],
                      **path_launches("flash_bwd_dkv")}),
        # the TPU kernel is one launch here (GN+SiLU); its statistics alone
        # are a second kernel, which the fused conv launches
        kernel_entry("gn_stats_bf16", "groupnorm.cu", "groupnorm.py:31",
                     fused["gn_stats"],
                     {"edit_flags": flag_launches["gn_stats"],
                      **path_launches("gn_stats")}),
        kernel_entry("gn_silu_bf16", "groupnorm.cu", "groupnorm.py:31",
                     fused["gn_silu"],
                     {"edit_flags": flag_launches["gn_silu"],
                      **path_launches("gn_silu")}),
        kernel_entry("gn_silu_conv3x3_bf16", "conv_fused.cu",
                     "conv_fused.py:40", fused["conv"],
                     {"edit_flags": flag_launches["conv"],
                      **path_launches("conv")}),
        kernel_entry("w8_matmul_bf16", "quant.cu", "quant.py:51", fused["w8"],
                     {"edit_flags": flag_launches["w8"],
                      **path_launches("w8")}),
        *wide_entries(d512, vae_flash["launches"], 512),
        *wide_entries(d256, small_vae_flash["launches"], 256),
        *fp32_entries(fp32, fp32_paths["launches"]),
        *fp32_fused_entries(fused32, {**fused32_paths["launches"],
                                      **conv32_paths["launches"]}),
        *narrow_entries(narrow, tiny_paths["launches"]),
    ]
    # every kernel of a path ran on it (the comparison launches of phase 3
    # are not counted there); no configuration reaches the narrow tile
    # widths above 16 (phase 3i holds those kernels)
    idle = [e["name"] for e in kernels
            if not e["launches"] and e.get("on_a_path", True)]
    if idle:
        raise RuntimeError(f"no path launched {idle}")
    phase("run", seconds=time.perf_counter() - t_run)
    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": kernels,
        "edit_seconds": [e["seconds"] for e in edits],
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
                                       for h in history],
        "workflow": {k: v for k, v in workflow.items() if k != "launches"},
        "vae_flash": vae_flash_summary(vae_flash),
        "small_vae_flash": vae_flash_summary(small_vae_flash),
        "fp32_paths": vae_flash_summary(fp32_paths),
        "fp32_fused_paths": vae_flash_summary(fused32_paths),
        "fp32_conv_paths": vae_flash_summary(conv32_paths),
        "tiny_paths": vae_flash_summary(tiny_paths),
        "verifier_paths": verifier_summary(verifier_paths)}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
