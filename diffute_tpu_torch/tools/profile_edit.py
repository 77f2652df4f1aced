"""Where one 50-step edit spends the card's time, with the UNet's opt-in
kernels off and on, at 512^2 or (``--res``) 768^2 or 1024^2.

  python -m diffute_tpu_torch.tools.profile_edit [--variants off,all]
      [--res 1024] [--out DIR]

Builds the full-width serving pipeline (bf16, flash attention, random weights
from a seed) once per variant over one set of weights: ``off``, ``fused_gn``,
``fused_conv``, ``int8`` or ``all`` (the three flags together).  Every
variant takes a warm-up edit and a few edits timed on the host clock (an edit
ends in a copy to the host), in turns; only then does each run one edit under
``torch.profiler``, whose kernels' device time is summed by group (once the
profiler has run, its hooks slow every later launch of the process, so no
edit is timed after it).  Prints one JSON object, with the
card's name and power limit, and writes it under ``--out`` (default
``runs/profile/``, git-ignored).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import time

import numpy as np
import torch

from diffute_tpu_torch.tools.profile_train_step import group_of

VARIANTS = {
    "off": {},
    "fused_gn": dict(use_fused_groupnorm=True),
    "fused_conv": dict(use_fused_conv=True),
    "int8": dict(use_int8_weights=True),
    "all": dict(use_fused_groupnorm=True, use_fused_conv=True,
                use_int8_weights=True),
}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--variants", default="off,all")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--res", type=int, default=512, choices=[512, 768, 1024],
                   help="edit resolution")
    p.add_argument("--timed", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="runs/profile")
    args = p.parse_args(argv)

    from torch.profiler import ProfilerActivity, profile

    from diffute_tpu_torch.config import (DiffUTEConfig, EditConfig,
                                          TrOCRConfig, UNetConfig, VAEConfig)
    from diffute_tpu_torch.pipeline import DiffUTEPipeline
    from diffute_tpu_torch.utils import init_pipeline_params, resolve_device

    dev = resolve_device("cuda")
    bf16 = torch.bfloat16
    res = args.res
    params = init_pipeline_params(DiffUTEConfig(), seed=args.seed, device=dev)
    # bench.py's scene and box
    h, w = int(res * 1.5), res * 2
    image = np.random.RandomState(0).randint(0, 255, (h, w, 3), np.uint8)
    box = (w // 3, h // 3, w // 3 + res // 4, h // 3 + res // 12)

    result = {"gpu": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
        "steps": args.steps, "resolution": res, "variants": {}}
    names = args.variants.split(",")
    pipes = {}
    for name in names:
        cfg = DiffUTEConfig(
            vae=VAEConfig(dtype=bf16),
            unet=UNetConfig(dtype=bf16, use_flash_attention=True,
                            **VARIANTS[name]),
            trocr=TrOCRConfig(dtype=bf16),
            edit=EditConfig(resolution=res, num_inference_steps=args.steps))
        pipes[name] = DiffUTEPipeline(cfg, params, device=dev)
    del params

    def edit(name, seed) -> float:
        t0 = time.perf_counter()
        pipes[name].edit(image, box, "BENCHMARK", seed=seed)
        return time.perf_counter() - t0

    seconds = {name: [] for name in names}
    for name in names:
        edit(name, 0)  # warm-up: the kernels' build, cuDNN's choices
    for i in range(args.timed):
        for name in names if i % 2 == 0 else names[::-1]:
            seconds[name].append(edit(name, i + 1))
    for name in names:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profiled_seconds = edit(name, 99)
        by_group = collections.Counter()
        by_kernel = collections.Counter()
        launches = collections.Counter()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us = e.time_range.elapsed_us()
                by_group[group_of(e.name)] += us
                by_kernel[e.name[:120]] += us
                launches[group_of(e.name)] += 1
        del prof
        device_ms = sum(by_group.values()) / 1e3
        result["variants"][name] = {
            "edit_seconds": seconds[name],
            "profiled_edit_seconds": profiled_seconds,
            "device_kernel_ms": device_ms,
            "device_events": sum(launches.values()),
            # kernels of one stream do not overlap, so their summed time over
            # the fastest unprofiled edit is the busy share of the card
            "device_idle_share": 1.0 - device_ms / 1e3 / min(seconds[name]),
            "ms_by_group": {k: v / 1e3 for k, v in by_group.most_common()},
            "launches_by_group": dict(launches),
            "top_kernels_ms": {k: v / 1e3
                               for k, v in by_kernel.most_common(20)},
        }
    os.makedirs(args.out, exist_ok=True)
    name = "edit_profile.json" if res == 512 else f"edit_profile_{res}.json"
    with open(os.path.join(args.out, name), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
