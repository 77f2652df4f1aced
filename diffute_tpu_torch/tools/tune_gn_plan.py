"""Time the GroupNorm kernels at the UNet's GroupNorm shapes under each
cluster size and block width, beside the choice ``ops.groupnorm.gn_plan``
makes.

  python -m diffute_tpu_torch.tools.tune_gn_plan

Prints one JSON line per shape (B, C, H, W): CUDA-event medians in ms of the
statistics kernel and of GN+SiLU, keyed ``c<cluster>t<threads>`` for
clusters of 1, 2, 4 and 8 blocks and 64 to 1024 threads, the plan's keys, the
time of an empty launch (``torch.cuda._sleep(0)``, the floor of any kernel
timed this way), and the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess

import torch

# (B, C, H = W): every GroupNorm of a flagged UNet pass at 512^2, batch 1,
# then batch 2 and the 1024^2 edit's top level
SHAPES = [(1, 320, 64), (1, 640, 64), (1, 960, 64), (1, 320, 32),
          (1, 640, 32), (1, 960, 32), (1, 1280, 32), (1, 1920, 32),
          (1, 640, 16), (1, 1280, 16), (1, 1920, 16), (1, 2560, 16),
          (1, 1280, 8), (1, 2560, 8), (2, 640, 32), (1, 320, 128),
          (1, 960, 128)]
THREADS = (64, 128, 256, 512, 1024)


def main() -> None:
    from diffute_tpu_torch.ops.flash_attention import _launch
    from diffute_tpu_torch.ops.groupnorm import MAX_SMEM, gn_plan
    from diffute_tpu_torch.tools.tune_w8_splits import time_ms
    from diffute_tpu_torch.utils import resolve_device

    dev = resolve_device("cuda")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    empty_ms = time_ms(lambda: torch.cuda._sleep(0))
    for b, c, hw in SHAPES:
        x = torch.randn((b, c, hw, hw), generator=g, device=dev).bfloat16()
        gamma = torch.ones(c, device=dev, dtype=torch.bfloat16)
        beta = torch.zeros(c, device=dev, dtype=torch.bfloat16)
        y = torch.empty_like(x)
        stats = torch.empty((2, b, 32), device=dev)
        cpg = c // 32
        n_vec = cpg * hw * hw // 8
        plan = gn_plan(b, c, hw, hw, 32)
        stats_ms, silu_ms = {}, {}
        for cluster in (1, 2, 4, 8):
            per = -(-n_vec // cluster)
            if per * (cluster - 1) >= n_vec:
                continue  # an empty last piece
            staged = min(per, (MAX_SMEM - 8 * cpg) // 16)
            widths = set(THREADS)
            if cluster == plan["cluster"]:
                widths |= {plan["threads"], plan["silu_threads"]}
            for threads in sorted(widths):
                key = f"c{cluster}t{threads}"
                stats_ms[key] = time_ms(lambda: _launch(
                    "gn_stats_bf16", x.data_ptr(), stats[0].data_ptr(),
                    stats[1].data_ptr(), b * 32, 8 * n_vec, cluster, threads,
                    1e-5, stream))
                silu_ms[key] = time_ms(lambda: _launch(
                    "gn_silu_bf16", x.data_ptr(), gamma.data_ptr(),
                    beta.data_ptr(), 1, y.data_ptr(), b, c, hw * hw, 32,
                    cluster, threads, staged, 1e-5, stream))
        best = {name: min(ms, key=ms.get)
                for name, ms in (("stats", stats_ms), ("silu", silu_ms))}
        print(json.dumps({"gpu": gpu, "shape": [b, c, hw, hw],
                          "chosen": {
                              "stats": f"c{plan['cluster']}t{plan['threads']}",
                              "silu": f"c{plan['cluster']}"
                                      f"t{plan['silu_threads']}"},
                          "best": best, "empty_launch_ms": empty_ms,
                          "stats_ms": stats_ms, "silu_ms": silu_ms}),
              flush=True)


if __name__ == "__main__":
    main()
