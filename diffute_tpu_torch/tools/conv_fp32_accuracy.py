"""How far the fp32 GN+SiLU+conv3x3 kernel and its plain fp32 version each
are from the same function computed in fp64, and what the length of the
kernel's tensor-core sums does to that distance and to its time.

  python -m diffute_tpu_torch.tools.conv_fp32_accuracy [--taps-per-sum 9,3,1]
      [--out FILE]

At a few shapes of a flagged 512^2 UNet pass (random inputs from a seed):
the relative L2 distance from fp64 of the kernel (``csrc/conv_fused_fp32.cu``
through ``gn_silu_conv3x3``), of the plain fp32 version (cuDNN with TF32
off) and of TF32 alone (``gn_silu_conv3x3_tf32_reference`` with one
product).  With ``--taps-per-sum`` the kernel's source is also built with
each given ``kTapsPerSum`` (the taps one tensor-core accumulator sums from
zero before the sum joins the running fp32 sum; the tensor cores truncate
their fp32 sums), and each build's distance and CUDA-event median time (25
launches) are reported.  Prints one JSON object with the card's name and
power limit, and writes it to ``--out`` if given.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess

import torch
import torch.nn.functional as F

# (B, Cin, Cout, H = W)
SHAPES = [(1, 320, 320, 64), (1, 1920, 640, 32), (1, 2560, 1280, 16),
          (1, 1280, 1280, 8), (1, 2560, 1280, 8)]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def _fp64(x, gamma, beta, w, bias, groups=32, eps=1e-5):
    xd = x.double().reshape(x.shape[0], groups, -1)
    mu = xd.mean(dim=2, keepdim=True)
    var = (xd - mu).square().mean(dim=2, keepdim=True)
    n = ((xd - mu) * torch.rsqrt(var + eps)).reshape(x.shape)
    n = n * gamma.double().view(1, -1, 1, 1) + beta.double().view(1, -1, 1, 1)
    return F.conv2d(n * torch.sigmoid(n), w.double(), bias.double(), padding=1)


def _time_ms(fn, iters: int = 25) -> float:
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


def _variant(taps: int, build_dir: str):
    """The kernel's entry built from its source with kTapsPerSum = taps."""
    from diffute_tpu_torch.ops import _build

    src = open(os.path.join(_build.CSRC, "conv_fused_fp32.cu")).read()
    src, n = re.subn(r"kTapsPerSum = \d+;", f"kTapsPerSum = {taps};", src)
    if n != 1:
        raise RuntimeError("conv_fused_fp32.cu declares no kTapsPerSum")
    os.makedirs(build_dir, exist_ok=True)
    path = os.path.join(build_dir, f"conv_fused_fp32_taps{taps}.cu")
    with open(path, "w") as f:
        f.write(src)
    so = _build.build_shared_library(
        f"conv_fused_fp32_taps{taps}", [_build._nvcc(), *_build.NVCC_FLAGS,
                                         "-I", _build.CSRC],
        [path], hashed=[os.path.join(_build.CSRC, "tf32_sm90.cuh")])
    fn = ctypes.CDLL(so).gn_silu_conv3x3_fp32
    fn.argtypes = _build._signatures()["gn_silu_conv3x3_fp32"]
    fn.restype = ctypes.c_int
    return fn


def measure(taps_per_sum=(), seed: int = 0) -> list:
    from diffute_tpu_torch.ops import _build
    from diffute_tpu_torch.ops.conv_fused import (
        conv_fp32_plan, gn_silu_conv3x3, gn_silu_conv3x3_reference,
        gn_silu_conv3x3_tf32_reference)
    from diffute_tpu_torch.ops.groupnorm import group_norm_stats

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    variants = {t: _variant(t, os.path.join(_build.BUILD_DIR, "variants"))
                for t in taps_per_sum}
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, mean=0.0, std=1.0):
        return torch.randn(shape, generator=g, device="cuda") * std + mean

    rows = []
    for b, cin, cout, hw in SHAPES:
        x = randn(b, cin, hw, hw)
        gamma, beta = randn(cin, mean=1.0, std=0.3), randn(cin, std=0.5)
        w = randn(cout, cin, 3, 3, std=(9 * cin) ** -0.5)
        bias = randn(cout, std=0.1)
        args = (x, gamma, beta, w, bias, 32, 1e-5)
        ref64 = _fp64(x, gamma, beta, w, bias)
        row = {"shape": [b, cin, cout, hw, hw],
               "kernel": _rel(gn_silu_conv3x3(*args), ref64),
               "plain": _rel(gn_silu_conv3x3_reference(*args), ref64),
               "tf32_alone": _rel(gn_silu_conv3x3_tf32_reference(
                   *args, products=1), ref64)}
        plan = conv_fp32_plan(b, cin, cout, hw, hw)
        for taps, fn in variants.items():
            def run(fn=fn):
                mean, rstd = group_norm_stats(x, 32, 1e-5)
                out = torch.empty((b, cout, hw, hw), device="cuda")
                part = (torch.empty((plan["splits"], b, cout, hw, hw),
                                    device="cuda")
                        if plan["splits"] > 1 else None)
                err = fn(x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                         gamma.data_ptr(), beta.data_ptr(), 0, w.data_ptr(),
                         bias.data_ptr(), 0, out.data_ptr(),
                         part.data_ptr() if part is not None else None, b,
                         cin, cout, hw, hw, 32, plan["splits"],
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
                return out

            row[f"taps_per_sum_{taps}"] = dict(from_fp64=_rel(run(), ref64),
                                               ms=_time_ms(run))
        rows.append(row)
        del x, w, ref64
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--taps-per-sum", default="",
                   help="comma-separated kTapsPerSum values to build and "
                   "compare (1 to 9)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_fp32_accuracy: no CUDA device")
    taps = tuple(int(t) for t in args.taps_per_sum.split(",") if t)
    if any(not 1 <= t <= 9 for t in taps):
        raise SystemExit("--taps-per-sum takes values from 1 to 9")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = {"gpu": gpu, "rows": measure(taps)}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
