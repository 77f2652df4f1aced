"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):
  1. device: the card, torch/CUDA versions, Pillow and a TTF font;
  2. build: nvcc builds the port's CUDA kernels from diffute_tpu_torch/csrc;
  3. kernels: the flash-attention forward, and the two backward kernels
     (dq, dk/dv), each against its plain fp32 version in bf16 at the main
     paths' shapes plus a ragged one; kernel, plain version and one PyTorch
     library call (scaled_dot_product_attention, a yardstick the port never
     calls) timed, beside the card's bound for the same work; and
     FlashAttentionFn's backward against the backward wrapper;
  4. serving path: the full-width SD2-inpainting pipeline (bf16, flash on,
     random weights from a seed) runs three 50-step 512^2 single-region
     edits through DiffUTEPipeline.edit, counting kernel launches;
  5. checks: finite latents and a flash-vs-dense UNet forward at full size;
  6. training path: train.run_unet.main takes three optimizer steps at full
     width (batch 4, 512^2, bf16, flash, gradient checkpointing, AdamW,
     synthetic scenes), counting the launches of all three kernels;
  7. checks: parameter count, parameters changed by a step, and the loss
     gradient of four UNet weights with flash on vs off at full width.
Then one JSON line of kernel results, and last the device JSON line.
Exits non-zero, with no result, when no CUDA device is available.

    python3 chip_smoke.py --edits-only 6 [--package-root DIR]

times phase 4's edits alone (same pipeline, scene and box) and prints their
seconds as one JSON line; with --package-root the port is imported from
another checkout, so two commits can be timed in turns on one card.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

STEPS = 50
RES = 512
# kernel vs plain fp32 version, bf16 inputs from a unit normal: the kernel's
# output is rounded to bf16 (half an ulp of values up to ~4 is ~1e-2) and
# its P is rounded to bf16 before PV; the LSE stays fp32
TOL_O, TOL_LSE = 2e-2, 1e-3
# full-size UNet forward with flash vs dense attention, both bf16: relative
# max error over max |eps| (a wrong kernel gives O(1))
TOL_UNET_REL = 5e-2
# backward kernels vs the plain fp32 algorithm on the same bf16 inputs.  dq,
# dk, dv are rounded to bf16 (half an ulp of x is at most |x| * 2^-8) and p,
# ds are rounded to bf16 before the second products, so the bound follows the
# size of the gradients at each shape (max |ref| is 0.3 to 0.4 at 4096 keys):
# max abs error within BWD_HALF_ULPS half-ulps of max |ref| (1 to 2 measured),
# and relative L2 error of each of dq, dk, dv within TOL_BWD_REL_L2 (output
# rounding alone gives about 2e-3; a kv tile skipped out of 64, or a dropped
# delta term, gives over 2e-2)
BWD_HALF_ULPS, TOL_BWD_REL_L2 = 3, 1e-2
# full-size loss and loss gradient of single weights, flash on vs off, both
# bf16 with the same draws: relative L2 error of each gradient (a wrong
# backward kernel gives O(1); bf16 rounding gave 5e-3 at worst) and relative
# difference of the loss (2e-4 measured)
TOL_GRAD_REL, TOL_LOSS_REL = 3e-2, 1e-2
TRAIN_BATCH, TRAIN_STEPS = 4, 3
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


def bwd_errors(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """Max abs and relative L2 error of a backward kernel's output against
    its plain version, and the max abs bound that ``ref``'s size gives."""
    diff, ref = got.float() - ref.float(), ref.float()
    return {"max_abs_err": diff.abs().max().item(),
            "rel_l2_err": (diff.norm() / ref.norm()).item(),
            "max_abs_tol": BWD_HALF_ULPS * ref.abs().max().item() * 2.0 ** -8}


def serving_pipeline(dev):
    """Phase 4's pipeline: full width, bf16, flash on, weights from seed 0."""
    from diffute_tpu_torch.config import (DiffUTEConfig, EditConfig,
                                          TrOCRConfig, UNetConfig, VAEConfig)
    from diffute_tpu_torch.pipeline import DiffUTEPipeline
    from diffute_tpu_torch.utils import init_pipeline_params

    bf16 = torch.bfloat16
    cfg = DiffUTEConfig(
        vae=VAEConfig(dtype=bf16),
        unet=UNetConfig(dtype=bf16, use_flash_attention=True),
        trocr=TrOCRConfig(dtype=bf16),
        edit=EditConfig(resolution=RES, num_inference_steps=STEPS))
    return cfg, DiffUTEPipeline(
        cfg, init_pipeline_params(cfg, seed=0, device=dev), device=dev)


def scene():
    """bench.py's scene and box."""
    h, w = int(RES * 1.5), RES * 2
    image = np.random.RandomState(0).randint(0, 255, (h, w, 3), np.uint8)
    return image, (w // 3, h // 3, w // 3 + RES // 4, h // 3 + RES // 12)


def edits_only(n: int) -> None:
    import diffute_tpu_torch

    _, pipe = serving_pipeline(torch.device("cuda", 0))
    image, box = scene()
    seconds = []
    for i in range(n):
        t0 = time.perf_counter()
        pipe.edit(image, box, "BENCHMARK", seed=i)
        seconds.append(time.perf_counter() - t0)
    print(json.dumps({"package": diffute_tpu_torch.__file__, "gpu": gpu_line(),
                      "edit_seconds": seconds}), flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--edits-only", type=int, default=0, metavar="N",
                   help="time N edits of phase 4 and nothing else")
    p.add_argument("--package-root", default=None, metavar="DIR",
                   help="import diffute_tpu_torch from this checkout")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    if args.package_root:
        sys.path.insert(0, args.package_root)
    if args.edits_only:
        return edits_only(args.edits_only)
    import torch.nn.functional as F

    from diffute_tpu_torch.config import (DiffUTEConfig, TrainConfig,
                                          UNetConfig)
    from diffute_tpu_torch.io.dataset import (SyntheticSceneDataset,
                                              make_unet_batch)
    from diffute_tpu_torch.models import count_params
    from diffute_tpu_torch.models.attention import Attention
    from diffute_tpu_torch.ops import _build
    from diffute_tpu_torch.ops.flash_attention import (
        _delta, _to3d, flash_attention, flash_attention_reference,
        flash_bwd_3d, flash_bwd_dkv_3d, flash_bwd_dkv_reference,
        flash_bwd_dq_3d, flash_bwd_dq_reference, flash_fwd_3d)
    from diffute_tpu_torch.text import find_font, trocr_preprocess_host
    from diffute_tpu_torch.train import UNetTrainer, run_unet
    from diffute_tpu_torch.utils import init_pipeline_params

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

    # ---- 3. kernels against their plain versions, bf16.  Shapes (BH, S, T):
    # the edit's (batch 1), the training step's (batch 4) and a ragged one.
    g = torch.Generator(device=dev).manual_seed(0)

    def inputs(bh, s, t):
        return (torch.randn((bh, n, 64), generator=g, device=dev,
                            dtype=torch.bfloat16) for n in (s, t, t, s))

    def sdpa(q, k, v):  # the library's call for the same function
        return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                              scale=0.125)[0]

    fwd_results, dq_results, dkv_results = [], [], []
    for bh, s, t in [(5, 4096, 4096), (10, 1024, 1024), (4, 1000, 577),
                     (20, 4096, 4096), (40, 1024, 1024)]:
        q, k, v, _ = inputs(bh, s, t)
        o, lse = flash_fwd_3d(q, k, v, 0.125)
        torch.cuda.synchronize()
        ro, rlse = flash_attention_reference(q, k, v, 0.125)
        res = dict(shape=[bh, s, t, 64],
                   max_abs_err=(o.float() - ro.float()).abs().max().item(),
                   max_abs_err_lse=(lse - rlse).abs().max().item(),
                   ms=time_ms(lambda: flash_fwd_3d(q, k, v, 0.125)),
                   plain_ms=time_ms(
                       lambda: flash_attention_reference(q, k, v, 0.125)),
                   library_ms=time_ms(lambda: sdpa(q, k, v)),
                   **bound(4 * s * t * 64 * bh,
                           2 * 64 * bh * (2 * s + 2 * t) + 4 * bh * s))
        del ro, rlse
        phase("kernel_fwd", **res)
        if not (res["max_abs_err"] <= TOL_O
                and res["max_abs_err_lse"] <= TOL_LSE):
            raise RuntimeError(f"flash forward disagrees at {res} "
                               f"(tolerance o {TOL_O}, lse {TOL_LSE})")
        fwd_results.append(res)

    for bh, s, t in [(20, 4096, 4096), (40, 1024, 1024), (4, 1000, 577)]:
        q, k, v, do = inputs(bh, s, t)
        o, lse = flash_fwd_3d(q, k, v, 0.125)
        delta = _delta(o, do)
        dq = flash_bwd_dq_3d(q, k, v, do, lse, delta, 0.125)
        dk, dv = flash_bwd_dkv_3d(q, k, v, do, lse, delta, 0.125)
        torch.cuda.synchronize()
        args = (q, k, v, do, lse, delta, 0.125)
        rq = flash_bwd_dq_reference(*args)
        rk, rv = flash_bwd_dkv_reference(*args)
        err = {n: bwd_errors(a, b)
               for n, a, b in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv))}
        del rq, rk, rv
        # the library's backward for the pair: one autograd.grad through
        # SDPA's saved forward (the forward itself is outside the events)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        lib_out = sdpa(*leaves)
        library_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, leaves, do, retain_graph=True))
        del lib_out, leaves
        in_bytes = 2 * 64 * bh * (2 * s + 2 * t) + 2 * 4 * bh * s
        common = dict(shape=[bh, s, t, 64], library_ms=library_ms,
                      library_call="autograd.grad through "
                      "scaled_dot_product_attention: dq, dk and dv together")
        res_dq = dict(common, **err["dq"],
                      ms=time_ms(lambda: flash_bwd_dq_3d(*args)),
                      plain_ms=time_ms(lambda: flash_bwd_dq_reference(*args)),
                      **bound(6 * s * t * 64 * bh, in_bytes + 2 * 64 * bh * s))
        res_dkv = dict(common, max_abs_err=max(err["dk"]["max_abs_err"],
                                               err["dv"]["max_abs_err"]),
                       dk=err["dk"], dv=err["dv"],
                       ms=time_ms(lambda: flash_bwd_dkv_3d(*args)),
                       plain_ms=time_ms(lambda: flash_bwd_dkv_reference(*args)),
                       **bound(8 * s * t * 64 * bh,
                               in_bytes + 2 * 2 * 64 * bh * t))
        phase("kernel_bwd_dq", **res_dq)
        phase("kernel_bwd_dkv", **res_dkv)
        if not all(e["max_abs_err"] <= e["max_abs_tol"]
                   and e["rel_l2_err"] <= TOL_BWD_REL_L2 for e in err.values()):
            raise RuntimeError(f"flash backward disagrees at {(bh, s, t)}: "
                               f"{err} (relative L2 tolerance "
                               f"{TOL_BWD_REL_L2})")
        dq_results.append(res_dq)
        dkv_results.append(res_dkv)
    del q, k, v, do, o, lse, delta, dq, dk, dv, args

    # the autograd function's backward is the backward wrapper
    q4, k4, v4, g4 = (torch.randn((2, 1024, 5, 64), generator=g, device=dev,
                                  dtype=torch.bfloat16) for _ in range(4))
    leaves = [x.clone().requires_grad_() for x in (q4, k4, v4)]
    flash_attention(*leaves).backward(g4)
    q3, k3, v3 = _to3d(q4), _to3d(k4), _to3d(v4)
    o3, lse3 = flash_fwd_3d(q3, k3, v3, 0.125)
    same = all(torch.equal(_to3d(leaf.grad), ref) for leaf, ref in zip(
        leaves, flash_bwd_3d(q3, k3, v3, o3, lse3, _to3d(g4), 0.125)))
    phase("autograd_function", backward_equals_wrapper=same)
    if not same:
        raise RuntimeError("FlashAttentionFn.backward differs from flash_bwd_3d")
    del leaves, q4, k4, v4, g4, q3, k3, v3, o3, lse3

    # ---- 4. serving path: full width, bf16, flash on, three edits
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    cfg, pipe = serving_pipeline(dev)
    n_unet, n_vae = count_params(pipe.unet), count_params(pipe.vae)
    phase("init", seconds=time.perf_counter() - t0, unet_params=n_unet,
          vae_params=n_vae, trocr_params=count_params(pipe.trocr))
    if (n_unet, n_vae) != (865_925_124, 83_653_863):
        raise RuntimeError(f"parameter counts {n_unet}, {n_vae}")

    image, box = scene()
    outside = np.ones(image.shape[:2], bool)
    outside[box[1]:box[3], box[0]:box[2]] = False

    flash_attention.launches = 0
    edits = []
    for i, text in enumerate(["BENCHMARK", "DiffUTE edit", "H100 2026"]):
        before = flash_attention.launches
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out, mask = pipe.edit(image, box, text, seed=i)
        seconds = time.perf_counter() - t0
        launched = flash_attention.launches - before
        rec = dict(edit=i, text=text, seconds=seconds, launches=launched,
                   max_memory_allocated=torch.cuda.max_memory_allocated(dev),
                   changed_pixels=int((out != image).any(-1).sum()))
        phase("edit", **rec)
        if out.dtype != np.uint8 or out.shape != image.shape:
            raise RuntimeError(f"edit output {out.dtype} {out.shape}")
        if not np.array_equal(out[outside], image[outside]):
            raise RuntimeError("pixels outside the box changed")
        if launched != 10 * STEPS:
            raise RuntimeError(f"{launched} flash launches, expected {10 * STEPS}")
        edits.append(rec)
    edit_launches = flash_attention.launches

    # ---- 5. what came out: finite latents, and flash vs dense at full size
    region, _ = pipe._prepare_region(image, box, "check", RES, None)
    gen = torch.Generator(device=dev).manual_seed(7)
    r = RES // cfg.vae.scale_factor
    noise = [torch.randn((1, 4, r, r), generator=gen, device=dev)
             for _ in range(2)]
    with torch.inference_mode():
        ctx, mask_lat, masked_lat, lat0 = pipe._device_prep(
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

    # ---- 6. training path: free the pipeline, then three optimizer steps
    # through the trainer's entry point
    del pipe, lat, lat0, ctx, ctx16, mask_lat, masked_lat, x_in, eps_flash
    del eps_dense, noise, attns
    gc.collect()
    torch.cuda.empty_cache()
    flash_attention.launches = 0
    flash_attention.bwd_dq_launches = flash_attention.bwd_dkv_launches = 0
    history = run_unet.main([
        "--model_scale", "full", "--train_batch_size", str(TRAIN_BATCH),
        "--mixed_precision", "bf16", "--gradient_checkpointing",
        "--max_train_steps", str(TRAIN_STEPS), "--seed", "0"])
    train_launches = dict(fwd=flash_attention.launches,
                          dq=flash_attention.bwd_dq_launches,
                          dkv=flash_attention.bwd_dkv_launches)
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

    def entry(name, source, line, results, launches):
        main = results[0]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": f"diffute_tpu/ops/flash_attention.py:{line}",
                "launches": sum(launches.values()),
                "launches_by_path": launches,
                "max_abs_err": max(x["max_abs_err"] for x in results),
                **{key: main[key] for key in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")},
                "shapes": results}

    bwd_src = "diffute_tpu_torch/csrc/flash_bwd.cu"
    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": [
        entry("flash_fwd_bf16", "diffute_tpu_torch/csrc/flash_fwd.cu", 275,
              fwd_results, {"edit": edit_launches,
                            "train": train_launches["fwd"]}),
        entry("flash_bwd_dq_bf16", bwd_src, 396, dq_results,
              {"train": train_launches["dq"]}),
        entry("flash_bwd_dkv_bf16", bwd_src, 437, dkv_results,
              {"train": train_launches["dkv"]}),
    ], "edit_seconds": [e["seconds"] for e in edits],
        "train_step_seconds": [h["seconds"] for h in history],
        "train_max_memory_allocated": [h["max_memory_allocated"]
                                       for h in history]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
