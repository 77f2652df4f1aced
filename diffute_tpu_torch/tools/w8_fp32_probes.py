"""Time variant builds of the fp32 int8 matmul (``csrc/quant_fp32_sm90.cu``)
against the package's own build, in turns, at the UNet's few-token and
many-token layer shapes.

  python -m diffute_tpu_torch.tools.w8_fp32_probes [VARIANT.cu ...]
      [--probes] [--iters 25] [--out FILE]

Each VARIANT.cu is a copy of the source with one change (a schedule to
try), built with the package's ``nvcc`` flags and headers.  ``--probes``
adds builds of the source that each drop part of the work, to show what it
costs (their outputs are wrong by design): ``no_split`` leaves the x tile
unsplit (the producer warpgroup reads it and arrives, but writes no plane),
``no_q`` loads no q tile, ``no_x`` no x tile, ``no_loads`` neither,
``hi_only`` issues only the hi plane's four products a tile, ``no_wgmma``
issues none, and ``ring8`` keeps eight stages in place of six at 64 tokens
a block (a real variant: the same bits).  While a variant is timed
its ``w8_matmul_fp32`` takes the package's place behind ``quant_matmul``.
For each shape (and K split): whether each variant gives the package's
bits, and CUDA-event medians of ``--iters`` launches behind a GPU sleep,
the package and every variant in turns (forward order, then backward).
Prints one JSON object per shape with the card's name and power limit, and
writes them to ``--out`` if given.  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import tempfile

import torch

from diffute_tpu_torch.tools import kernel_variants

SOURCE = "quant_fp32_sm90.cu"
_LO = ("    wgmma_tf32(part, a[s], tf32_desc(hi_s + W8Tile<BT>::x_bytes, s, 0), "
       "s > 0);\n")
_HI = "    wgmma_tf32(part, a[s], tf32_desc(hi_s, s, 0), 1);\n"
_EXPECT = "  mbar_expect_tx(ring.full(st), T::x_bytes + kQBytes);"
_X_LOAD = ("  tma_load_2d(base, &p.tm_x, ring.full(st), (tile0 + j) * kBK, "
           "m0);\n")
_Q_LOAD = ("  tma_load_2d(base + 2 * T::x_bytes, &p.tm_q, ring.full(st),\n"
           "              (tile0 + j) * kBK, n0);\n")
_SPLIT = "      for (int w = 0; w < {}; ++w) {{\n        uint32_t e[4]"
# each probe's edits: (text, replacement), each text found once
PROBES = {
    "no_split": [(_SPLIT.format(4), _SPLIT.format(0))],
    "no_q": [(_EXPECT, "  mbar_expect_tx(ring.full(st), T::x_bytes);"),
             (_Q_LOAD, "")],
    "no_x": [(_EXPECT, "  mbar_expect_tx(ring.full(st), kQBytes);"),
             (_X_LOAD, "")],
    "no_loads": [(_EXPECT, "  mbar_expect_tx(ring.full(st), 0);"),
                 (_X_LOAD, ""), (_Q_LOAD, "")],
    "hi_only": [(_LO, "")],
    "no_wgmma": [(_LO, ""), (_HI, "")],
    "ring8": [("ring = BT == 64 ? 6 : 4;", "ring = BT == 64 ? 8 : 4;")],
}
# ((M, K, N), K splits or None for the plan's): one block's walk of a deep
# K (the plan's split and none), the most launched shapes of a pass
SHAPES = [((64, 5120, 1280), None), ((64, 5120, 1280), 1),
          ((256, 1280, 1280), None), ((1024, 640, 640), None),
          ((4096, 320, 320), None), ((4096, 320, 2560), None)]


def write_probes(directory: str) -> list:
    from diffute_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC, SOURCE)) as f:
        text = f.read()
    paths = []
    for name, edits in PROBES.items():
        out = text
        for old, new in edits:
            if out.count(old) != 1:
                raise RuntimeError(f"probe {name}: {old!r} not found once")
            out = out.replace(old, new)
        path = os.path.join(directory, f"w8_{name}.cu")
        with open(path, "w") as f:
            f.write(out)
        paths.append(path)
    return paths


def build(paths) -> dict:
    """Variant name -> its w8_matmul_fp32, each built into the package's
    build directory with the package's headers."""
    from diffute_tpu_torch.ops import _build

    argtypes = _build._signatures()["w8_matmul_fp32"]
    out = {}
    for path in paths:
        fn = kernel_variants.build_library(path).w8_matmul_fp32
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        out[os.path.splitext(os.path.basename(path))[0]] = fn
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("variants", nargs="*", metavar="VARIANT.cu")
    p.add_argument("--probes", action="store_true")
    p.add_argument("--iters", type=int, default=25)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not (args.variants or args.probes):
        p.error("name a VARIANT.cu or pass --probes")
    if not torch.cuda.is_available():
        raise SystemExit("w8_fp32_probes: no CUDA device")
    from diffute_tpu_torch.ops import _build
    from diffute_tpu_torch.ops.quant import (quant_matmul,
                                             quantize_per_channel,
                                             w8_fp32_plan)

    gpu = kernel_variants.card()
    with tempfile.TemporaryDirectory() as tmp:
        paths = list(args.variants) + (write_probes(tmp) if args.probes
                                       else [])
        lib = _build.load()
        variants = {"package": lib.w8_matmul_fp32, **build(paths)}
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for (m, k, n), splits in SHAPES:
        x = torch.randn((m, k), generator=g, device="cuda")
        q, scale = quantize_per_channel(
            torch.randn((n, k), generator=g, device="cuda") * k ** -0.5)

        def run():
            return quant_matmul(x, q, scale, splits=splits)

        ref = run()
        row = {"gpu": gpu, "shape": [m, k, n],
               "splits": w8_fp32_plan(m, n, k, splits)["splits"],
               "same_bits_as_package": {}, "ms": {v: [] for v in variants}}
        for name, fn in variants.items():
            lib.w8_matmul_fp32 = fn
            row["same_bits_as_package"][name] = torch.equal(run(), ref)
        for name in list(variants) + list(variants)[::-1]:
            lib.w8_matmul_fp32 = variants[name]
            row["ms"][name].append(kernel_variants.time_ms(run, args.iters))
        lib.w8_matmul_fp32 = variants["package"]
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"gpu": gpu, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
