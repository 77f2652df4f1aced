"""Time the int8-weight matmul at the UNet's layer shapes under each tile
height (tokens a block) and number of K splits, beside cuBLAS on the
dequantised weight (a yardstick): the bf16 kernel against cuBLAS bf16, the
fp32 kernel against cuBLAS fp32 with TF32 off.

  python -m diffute_tpu_torch.tools.tune_w8_splits [--dtype bf16,fp32]

Prints one JSON line per dtype and shape (M, K, N): CUDA-event medians in ms
keyed ``bt<tokens>s<splits>`` (64 and 128 tokens; bf16: splits 1, 2, 3, 4,
6 and 8; fp32: splits 1, 2, 3, 4, 6, 8, 12 and 16), the
choice ``ops.quant.w8_plan`` or ``w8_fp32_plan`` makes, and the card's name
and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch

# (M, K, N) of the flagged UNet's linear layers at 512^2, batch 1: C -> C,
# C -> 8C (GEGLU), 4C -> C per level, and the hoisted cross-attention K/V
SHAPES = [(4096, 320, 320), (4096, 320, 2560), (4096, 1280, 320),
          (1024, 640, 640), (1024, 640, 5120), (1024, 2560, 640),
          (256, 1280, 1280), (256, 1280, 10240), (256, 5120, 1280),
          (64, 1280, 1280), (64, 1280, 10240), (64, 5120, 1280),
          (577, 1024, 320), (577, 1024, 1280)]


def time_ms(fn, iters: int = 25) -> float:
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


def valid(splits: int, steps: int) -> bool:
    """A split count the kernels take at ``steps`` k steps: none empty."""
    return splits <= steps and (splits - 1) * -(-steps // splits) < steps


def main(argv=None) -> None:
    import argparse

    from diffute_tpu_torch.ops.quant import (FP32_BLOCK_K, dequantize,
                                             pack_w8_weight, quant_matmul,
                                             quantize_per_channel,
                                             w8_fp32_plan, w8_plan)
    from diffute_tpu_torch.utils import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--dtype", default="bf16,fp32")
    dtypes = p.parse_args(argv).dtype.split(",")
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    g = torch.Generator(device=dev).manual_seed(0)
    for m, k, n in SHAPES:
        x = torch.randn((m, k), generator=g, device=dev)
        q, scale = quantize_per_channel(
            torch.randn((n, k), generator=g, device=dev) * k ** -0.5)
        if "bf16" in dtypes:
            xb, sb, w = x.bfloat16(), scale.bfloat16(), q.bfloat16()
            packed = pack_w8_weight(q)
            ms = {f"bt{bt}s{splits}": time_ms(lambda: quant_matmul(
                      xb, q, sb, splits=splits, tokens_per_block=bt,
                      packed=packed))
                  for bt in (64, 128) for splits in (1, 2, 3, 4, 6, 8)
                  if valid(splits, -(-k // 64))}
            plan = w8_plan(m, n, k)
            print(json.dumps({"gpu": gpu, "dtype": "bf16", "shape": [m, k, n],
                              "ms": ms,
                              "chosen": f"bt{plan['tokens_per_block']}"
                                        f"s{plan['splits']}",
                              "cublas_bf16_ms": time_ms(lambda: xb @ w.t())}),
                  flush=True)
        if "fp32" in dtypes:
            w = dequantize(q, scale)
            ms = {f"bt{bt}s{splits}": time_ms(lambda: quant_matmul(
                      x, q, scale, splits=splits, tokens_per_block=bt))
                  for bt in (64, 128) for splits in (1, 2, 3, 4, 6, 8, 12, 16)
                  if valid(splits, -(-k // FP32_BLOCK_K))}
            plan = w8_fp32_plan(m, n, k)
            print(json.dumps({"gpu": gpu, "dtype": "fp32", "shape": [m, k, n],
                              "ms": ms,
                              "chosen": f"bt{plan['block_m']}"
                                        f"s{plan['splits']}",
                              "cublas_fp32_ms": time_ms(lambda: x @ w.t())}),
                  flush=True)


if __name__ == "__main__":
    main()
