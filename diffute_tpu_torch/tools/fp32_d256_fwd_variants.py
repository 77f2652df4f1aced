"""Time the fp32 head_dim-256 forwards (``csrc/flash_fp32_d256_sm90.cu``)
built at other ring depths against each other, in turns.

  python -m diffute_tpu_torch.tools.fp32_d256_fwd_variants
      [--stages 4,4 3,4 4,3 ...] [--probes] [--iters 10] [--out FILE]

Each ``--stages N,T`` is a copy of the source with ``kNatStages = N`` (K's
planes and V's landing) and ``kTrStages = T`` (V^T's planes), built with
the package's ``nvcc`` flags and headers into a library of its own (the
source's own depths are 4,4).  ``--probes`` adds four copies of the
source at its own depths that each drop one piece of the work, to show
what it costs (their outputs are wrong by design): ``no_k_split`` leaves
K's raw tile as its hi plane and writes no lo plane, ``no_v_split`` writes
no V^T planes, ``no_pv`` issues no P V product, ``no_softmax`` gathers the
summed scores as p (no row max, no barrier of the warpgroup, no
exponentials; the exchange as it is).  For each shape, (16,
4096^2) (the fp32 small stage-1 step's), (1, 4096^2) (a 256^2 codec's) and
the ragged (2, 1000, 1500): each variant's standard forward (and the deferred one where T
is a whole number of 64-row tiles) held to the tiled plain version at the
kernel's tile and domain (relative L2 of o, max abs of the LSE), and
CUDA-event medians of ``--iters`` launches, every variant in one order and
then the reverse.  Prints one JSON object per shape, and the card's name
and power limit, and writes them to ``--out`` if given.  Needs a CUDA
device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import importlib
import json
import os
import re
import shutil
import tempfile

import torch

from diffute_tpu_torch.tools import kernel_variants

SOURCE = "flash_fp32_d256_sm90.cu"
SHAPES = ((16, 4096, 4096), (1, 4096, 4096), (2, 1000, 1500))
_STAGES = re.compile(r"constexpr int kNatStages = \d+, kTrStages = \d+;")


# the probes: the lines of the source each one drops (from the first
# marker up to the second, which stays), and what takes their place
PROBES = {
    "no_k_split": ("    split_plane(nat + FwdSmem::k, kPlane, tid);\n",
                   "    fence_proxy_async();\n", ""),
    "no_v_split": ("    write_transposed<1, 1>({tr}, raw, tid);\n",
                   "    fence_proxy_async();\n", ""),
    "no_pv": ("      issue_out(st.part, st.hi, st.lo, vt, vt + kPlane);\n",
              "      issue_end(st.part, st.hi, st.lo);\n", ""),
    "no_softmax": ("  float mx_lo = fmaxf(s.x, s.y), mx_hi = fmaxf(s.z, s.w);\n",
                   "  scatter(x, par * kGathTile, pt, 8 * par);\n",
                   "  const float mn_lo = 0.f, mn_hi = 0.f, alpha_lo = 1.f,"
                   " alpha_hi = 1.f;\n  float4 a, b;\n  const float4 pt = s;\n"
                   "  st.l_lo += pt.x;\n  st.l_hi += pt.z;\n")}


def apply_probe(text: str, name: str) -> tuple:
    """``text`` with the probe's lines replaced; (text, 1) if its markers
    are where they should be, (text, 0) otherwise."""
    first, last, new = PROBES[name]
    a = text.find(first)
    b = text.find(last, a)
    if a < 0 or b < 0 or text.count(first) != 1:
        return text, 0
    return text[:a] + new + text[b:], 1


def build(variant, root: str) -> tuple:
    """The source at ``variant`` (kNatStages, kTrStages), or with a probe's
    line dropped (a name of PROBES), built under ``root``: (library path,
    ptxas registers and spills by kernel)."""
    from diffute_tpu_torch.ops import _build

    name = variant if isinstance(variant, str) else "n%dt%d" % variant
    with open(os.path.join(_build.CSRC, SOURCE)) as f:
        text = f.read()
    if isinstance(variant, str):
        text, n = apply_probe(text, variant)
    else:
        text, n = _STAGES.subn(
            "constexpr int kNatStages = %d, kTrStages = %d;" % variant, text)
    if n != 1:
        raise SystemExit(f"fp32_d256_fwd_variants: {name} does not apply to "
                         f"{SOURCE}")
    so, _, stderr = kernel_variants.build_copy(_build.CSRC, SOURCE, text,
                                               root, name)
    return so, kernel_variants.ptxas_by_kernel(stderr)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stages", nargs="+", default=["4,4", "3,4", "4,3"])
    p.add_argument("--probes", action="store_true")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fp32_d256_fwd_variants: no CUDA device")
    fa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")
    card = kernel_variants.card()
    print(card, flush=True)
    variants = [tuple(int(x) for x in s.split(",")) for s in args.stages]
    variants += list(PROBES) if args.probes else []
    root = tempfile.mkdtemp(prefix="fp32_d256_fwd_variants_")
    try:
        with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
            built = list(pool.map(lambda v: build(v, root), variants))
        fp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        libs = {}
        for var, (so, ptxas) in zip(variants, built):
            name = var if isinstance(var, str) else "n%dt%d" % var
            lib = ctypes.CDLL(so)
            for entry in ("flash_fwd_d256_fp32", "flash_fwd_pipelined_d256_fp32"):
                getattr(lib, entry).argtypes = (
                    [fp] * 5 + [i] * 4 + [ctypes.POINTER(ctypes.c_longlong), f,
                                          fp])
            libs[name] = lib
            print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
        gen = torch.Generator(device="cuda").manual_seed(8)
        d, sc = 256, 256 ** -0.5
        lines = [card]
        for bh, s, t in SHAPES:
            q, k, v = (torch.randn((1, n, bh, d), generator=gen, device="cuda")
                       for n in (s, t, t))
            o = torch.empty_like(q)
            lse = torch.empty((bh, s), device="cuda")
            strides = (ctypes.c_longlong * 12)(*(
                list(q.stride()[:3]) + list(k.stride()[:3])
                + list(v.stride()[:3]) + list(o.stride()[:3])))
            q3, k3, v3 = (x[0].transpose(0, 1) for x in (q, k, v))
            kinds = [False] + ([True] if fa._pipelined_takes(t, d) else [])
            refs = {pipe: fa.flash_fwd_tiled_reference(
                q3, k3, v3, sc, fa.kernel_block_kv(d, torch.float32),
                "prescaled" if pipe else "natural") for pipe in kinds}
            out = {"shape": [bh, s, t]}
            order = list(libs.items())
            for turn in (order, order[::-1]):
                for name, lib in turn:
                    for pipe, (ro, rlse) in refs.items():
                        fn = (lib.flash_fwd_pipelined_d256_fp32 if pipe
                              else lib.flash_fwd_d256_fp32)

                        def call():
                            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    o.data_ptr(), lse.data_ptr(), 1, bh, s, t,
                                    strides, sc,
                                    torch.cuda.current_stream().cuda_stream)
                            if rc:
                                raise RuntimeError(f"{name}: CUDA error {rc}")
                        call()
                        torch.cuda.synchronize()
                        o3 = o[0].transpose(0, 1)
                        rec = out.setdefault(
                            name + ("_deferred" if pipe else ""),
                            {"rel_l2": ((o3 - ro).norm() / ro.norm()).item(),
                             "lse_abs": (lse - rlse).abs().max().item(),
                             "ms": []})
                        rec["ms"].append(
                            kernel_variants.time_ms(call, args.iters))
            print(json.dumps(out), flush=True)
            lines.append(out)
            del q, k, v, o, lse, refs
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)


if __name__ == "__main__":
    main()
