"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):
  1. device: the card, torch/CUDA versions, Pillow and a TTF font;
  2. build: nvcc builds the port's CUDA kernels from diffute_tpu_torch/csrc;
  3. kernel: the flash-attention forward against its plain fp32 version in
     bf16 at the main path's shapes plus a ragged one, and both timed;
  4. main path: the full-width SD2-inpainting pipeline (bf16, flash on,
     random weights from a seed) runs three 50-step 512^2 single-region
     edits through DiffUTEPipeline.edit, counting kernel launches;
  5. checks: finite latents and a flash-vs-dense UNet forward at full size.
Then one JSON line of kernel results, and last the device JSON line.
Exits non-zero, with no result, when no CUDA device is available.
"""

from __future__ import annotations

import dataclasses
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    from diffute_tpu_torch.config import (DiffUTEConfig, EditConfig,
                                          TrOCRConfig, UNetConfig, VAEConfig)
    from diffute_tpu_torch.models import count_params
    from diffute_tpu_torch.models.attention import Attention
    from diffute_tpu_torch.ops import _build
    from diffute_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference, flash_fwd_3d)
    from diffute_tpu_torch.pipeline import DiffUTEPipeline
    from diffute_tpu_torch.text import find_font, trocr_preprocess_host
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

    # ---- 3. kernel against its plain version, bf16
    g = torch.Generator(device=dev).manual_seed(0)
    shapes = [(1, 4096, 4096, 5), (1, 1024, 1024, 10), (1, 1000, 577, 4)]
    results = []
    for b, s, t, h in shapes:
        q, k, v = (torch.randn((b * h, n, 64), generator=g, device=dev,
                               dtype=torch.bfloat16) for n in (s, t, t))
        o, lse = flash_fwd_3d(q, k, v, 0.125)
        torch.cuda.synchronize()
        ro, rlse = flash_attention_reference(q, k, v, 0.125)
        err_o = (o.float() - ro.float()).abs().max().item()
        err_lse = (lse - rlse).abs().max().item()
        ms = time_ms(lambda: flash_fwd_3d(q, k, v, 0.125))
        plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, 0.125))
        res = dict(shape=[b, s, t, h, 64], max_abs_err=err_o,
                   max_abs_err_lse=err_lse, ms=ms, plain_ms=plain_ms)
        phase("kernel", **res)
        if not (err_o <= TOL_O and err_lse <= TOL_LSE):
            raise RuntimeError(f"flash kernel disagrees at {res} "
                               f"(tolerance o {TOL_O}, lse {TOL_LSE})")
        results.append(res)

    # ---- 4. main path: full width, bf16, flash on, three edits
    bf16 = torch.bfloat16
    cfg = DiffUTEConfig(
        vae=VAEConfig(dtype=bf16),
        unet=UNetConfig(dtype=bf16, use_flash_attention=True),
        trocr=TrOCRConfig(dtype=bf16),
        edit=EditConfig(resolution=RES, num_inference_steps=STEPS))
    t0 = time.perf_counter()
    params = init_pipeline_params(cfg, seed=0, device=dev)
    pipe = DiffUTEPipeline(cfg, params, device=dev)
    del params
    n_unet, n_vae = count_params(pipe.unet), count_params(pipe.vae)
    phase("init", seconds=time.perf_counter() - t0, unet_params=n_unet,
          vae_params=n_vae, trocr_params=count_params(pipe.trocr))
    if (n_unet, n_vae) != (865_925_124, 83_653_863):
        raise RuntimeError(f"parameter counts {n_unet}, {n_vae}")

    h, w = int(RES * 1.5), RES * 2  # bench.py's scene and box
    image = np.random.RandomState(0).randint(0, 255, (h, w, 3), np.uint8)
    box = (w // 3, h // 3, w // 3 + RES // 4, h // 3 + RES // 12)
    outside = np.ones((h, w), bool)
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
    main_launches = flash_attention.launches

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

    main = results[0]
    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": [{
        "name": "flash_fwd_bf16",
        "route": "cuda",
        "source": "diffute_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "diffute_tpu/ops/flash_attention.py:275",
        "launches": main_launches,
        "max_abs_err": max(x["max_abs_err"] for x in results),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "shapes": results,
    }], "edit_seconds": [e["seconds"] for e in edits]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
