"""Where one stage-2 training step spends the card's time.

  python -m diffute_tpu_torch.tools.profile_train_step [--batch 4] [--out DIR]

Builds the full-width trainer (866M-parameter UNet, bf16, flash attention,
gradient checkpointing, AdamW, random weights and synthetic scenes from a
seed), takes warm-up steps, times a few steps on the host clock (each ends
in a synchronise), then runs one step under ``torch.profiler`` and sums the
device time of its kernels by group.  Prints one JSON object, with the
card's name and power limit, and writes it with a Chrome trace under
``--out`` (default ``runs/profile/``, git-ignored).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import time

import torch

# first match wins; names are substrings of CUDA kernel names
GROUPS = (
    # the Hopper forwards are flash_fwd_sm90_kernel<schedule>
    ("flash_fwd", ("flash_fwd_kernel", "PingPong>")),
    ("flash_fwd_pipelined", ("flash_fwd_pipelined_kernel", "Deferred>")),
    # the Hopper backward is flash_bwd_{dq,dkv}_sm90_kernel (before it,
    # flash_bwd_{dq,dkv}_kernel)
    ("flash_bwd_dq", ("flash_bwd_dq_",)),
    ("flash_bwd_dkv", ("flash_bwd_dkv_",)),
    ("gn_stats", ("gn_stats_kernel",)),
    # GN+SiLU: one gn_silu_kernel (an older build launched the statistics,
    # then gn_silu_apply_kernel)
    ("gn_silu_apply", ("gn_silu_apply_kernel", "gn_silu_kernel")),
    ("gn_silu_conv3x3", ("gn_silu_conv3x3_kernel", "splitk_reduce_kernel")),
    ("w8_matmul", ("w8_matmul_kernel",)),
    ("conv_layout_transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("optimizer_foreach", ("multi_tensor_apply",)),
    ("convolutions", ("cudnn", "conv", "wgrad", "dgrad", "fprop", "xmma")),
    ("gemms", ("gemm", "cutlass", "cublas", "nvjet", "sm90_")),
    ("norms", ("group_norm", "GroupNorm", "layer_norm", "LayerNorm",
               "RowwiseMoments", "ComputeInternalGradients",
               "GammaBetaBackward", "ComputeFusedParams")),
    ("softmax", ("softmax", "Softmax")),
    ("elementwise_and_copies", ("elementwise", "CatArray", "copy", "Copy",
                                "fill", "index", "gather")),
    ("reductions", ("reduce", "Reduce", "norm")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--timed", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="runs/profile")
    args = p.parse_args(argv)

    from diffute_tpu_torch.config import DiffUTEConfig, TrainConfig, UNetConfig
    from diffute_tpu_torch.io.dataset import SyntheticSceneDataset, make_unet_batch
    from diffute_tpu_torch.train import UNetTrainer
    from diffute_tpu_torch.utils import init_pipeline_params, resolve_device

    dev = resolve_device("cuda")
    cfg = DiffUTEConfig(
        unet=UNetConfig(use_flash_attention=True, remat=True),
        train=TrainConfig(train_batch_size=args.batch, mixed_precision="bf16",
                          gradient_checkpointing=True, seed=args.seed))
    params = init_pipeline_params(cfg, seed=args.seed, device=dev)
    trainer = UNetTrainer(cfg, params["unet"],
                          {"vae": params["vae"], "trocr": params["trocr"]},
                          device=dev)
    del params
    data = SyntheticSceneDataset(cfg, seed=args.seed)
    n = args.batch
    batches = [make_unet_batch([data[i * n + j] for j in range(n)], cfg)
               for i in range(args.warmup + args.timed + 1)]

    def step(batch) -> float:
        t0 = time.perf_counter()
        metrics = trainer.step(batch)
        float(metrics["loss"]), float(metrics["grad_norm"])  # waits for the card
        return time.perf_counter() - t0

    for b in batches[:args.warmup]:
        step(b)
    torch.cuda.reset_peak_memory_stats(dev)
    seconds = [step(b) for b in batches[args.warmup:-1]]
    peak = torch.cuda.max_memory_allocated(dev)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_seconds = step(batches[-1])
    by_group = collections.Counter()
    by_kernel = collections.Counter()
    launches = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            by_group[group_of(e.name)] += us
            by_kernel[e.name[:120]] += us
            launches[group_of(e.name)] += 1
    device_ms = sum(by_group.values()) / 1e3
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    result = {
        "gpu": gpu, "batch": n, "step_seconds": seconds,
        "max_memory_allocated": peak,
        "profiled_step_seconds": profiled_seconds,
        "device_kernel_ms": device_ms,
        "device_events": sum(launches.values()),
        # kernels of one stream do not overlap, so their summed time over the
        # unprofiled step time is the busy share of the card
        "device_idle_share": 1.0 - device_ms / 1e3 / min(seconds),
        "ms_by_group": {k: v / 1e3 for k, v in by_group.most_common()},
        "launches_by_group": dict(launches),
        "top_kernels_ms": {k: v / 1e3 for k, v in by_kernel.most_common(25)},
    }
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, "train_step_trace.json"))
    with open(os.path.join(args.out, "train_step_profile.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
