"""Time variant builds of the fp32 head_dim-512 kernels against the
package's own build, in turns: the backward pair
(``csrc/flash_fp32_d512_bwd_sm90.cu``) at its training shape and a ragged
one, and the two forwards (``csrc/flash_fp32_d512_sm90.cu``) at the fp32
SD2 codecs' and stage-1 step's shapes and a ragged one.

  python -m diffute_tpu_torch.tools.fp32_d512_bwd_variants [VARIANT.cu ...]
      [--probes] [--forward-probes] [--iters 10] [--out FILE]

Each VARIANT.cu is a copy of one of those sources with one change (a
schedule to try), built with the package's ``nvcc`` flags and headers; the
entries it exports say which kernels it stands for.  ``--probes`` adds
three made from the backward source, ``--forward-probes`` the same three
made from the forwards' source, each dropping part of the work to show
what it costs (their outputs are wrong by design): ``hihi`` issues only the
hi x hi product of each 3xTF32 step (a third of the mma.sync), ``nosplit``
takes each operand's bits as hi and zero as lo (no split arithmetic),
``block_barriers`` waits on the block's barrier where each tile waits on
the cluster's (a cluster barrier stays at the start and the end, so no
block reads another that has not started or has left).  The products and
the barriers live in ``csrc/flash_fp32_d512_sm90.cuh``: a probe is its
source and an edited copy of that header, side by side.  While a variant is
timed its entries (``flash_bwd_dq_d512_fp32`` and
``flash_bwd_dkv_d512_fp32``, or ``flash_fwd_d512_fp32`` and
``flash_fwd_pipelined_d512_fp32``) take the package's place behind the
wrappers.  For each shape: the package's outputs against the tiled plain
version at its tile, whether each variant gives the package's bits, and
CUDA-event medians of ``--iters`` launches of each kernel, the package and
every variant in turns (forward order, then backward).  Prints one JSON
object per shape with the card's name and power limit, and writes them to
``--out`` if given.  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import importlib
import json
import os
import subprocess
import tempfile

import torch

HEADER = "flash_fp32_d512_sm90.cuh"
# each source's entries; a variant stands for the source whose entries it
# exports
SOURCES = {
    "flash_fp32_d512_bwd_sm90.cu": ("flash_bwd_dq_d512_fp32",
                                    "flash_bwd_dkv_d512_fp32"),
    "flash_fp32_d512_sm90.cu": ("flash_fwd_d512_fp32",
                                "flash_fwd_pipelined_d512_fp32"),
}
BWD, FWD = SOURCES
# the probes' edits: (file, text, replacement), each text found once in
# that file (the header, or the source the probe is made from)
_HIHI = [(HEADER,
          "  for (int i = 0; i < N; ++i) mma_tf32(d[i], a[i].lo, b[i].hi[0], "
          "b[i].hi[1]);\n#pragma unroll\n"
          "  for (int i = 0; i < N; ++i) mma_tf32(d[i], a[i].hi, b[i].lo[0], "
          "b[i].lo[1]);\n", "")]
_NOSPLIT = [(HEADER,
             "  hi = rna_tf32(x);\n  lo = rna_tf32(x - __uint_as_float(hi));",
             "  hi = __float_as_uint(x);\n  lo = 0u;")]
_BLOCK_BARRIERS = [
    (HEADER, "__device__ __forceinline__ void cluster_arrive() {",
     "__device__ __forceinline__ void cluster_arrive() {}\n"
     "__device__ __forceinline__ void cluster_wait() {\n"
     "  __syncthreads();\n}\n"
     "__device__ __forceinline__ void cluster_arrive_all() {"),
    (HEADER, "__device__ __forceinline__ void cluster_wait() {\n  asm",
     "__device__ __forceinline__ void cluster_wait_all() {\n  asm")]
_ARRIVE = ("  cluster_arrive();  // this block runs: the others may store "
           "into it\n", "  cluster_arrive_all();\n")
_WAIT = ("  cluster_wait();  // every block of the cluster runs\n",
         "  cluster_wait_all();\n")
_END = "  cluster_arrive_all();\n  cluster_wait_all();\n"
PROBES = {
    BWD: {"hihi": _HIHI, "nosplit": _NOSPLIT, "block_barriers": (
        _BLOCK_BARRIERS + [(BWD, *_ARRIVE), (BWD, *_WAIT)]
        + [(BWD, f"  {x}", f"{_END}  {x}") for x in (
            "float* dqb = p.out0", "const int row0 = kv0")])},
    FWD: {"hihi": _HIHI, "nosplit": _NOSPLIT, "block_barriers": (
        _BLOCK_BARRIERS + [(FWD, *_ARRIVE), (FWD, *_WAIT),
                           (FWD, "  // ---- o / l through o's strides",
                            _END + "  // ---- o / l through o's strides")])},
}


def write_probes(directory: str, source: str) -> list:
    """The probes of ``source``, each written with its edited header into a
    directory of its own under ``directory``."""
    from diffute_tpu_torch.ops import _build

    text = {}
    for name in (HEADER, source):
        with open(os.path.join(_build.CSRC, name)) as f:
            text[name] = f.read()
    paths = []
    for name, edits in PROBES[source].items():
        probe = dict(text)
        for file, old, new in edits:
            # the bwd source holds each call-site text in both kernels
            count = probe[file].count(old)
            if count != 1 and not (count == 2 and file == BWD
                                   and "cluster_" in old):
                raise RuntimeError(f"probe {name}: {old!r} found {count} "
                                   f"times in {file}")
            probe[file] = probe[file].replace(old, new)
        sub = os.path.join(directory, f"{source[:-3]}_{name}")
        os.makedirs(sub)
        with open(os.path.join(sub, HEADER), "w") as f:
            f.write(probe[HEADER])
        path = os.path.join(sub, f"{source[:-3]}_{name}.cu")
        with open(path, "w") as f:
            f.write(probe[source])
        paths.append(path)
    return paths


# (B*H, S, T): the backward pair's fp32 SD2 stage-1 mid-block call and a
# ragged one; the forwards' stage-1 call, a 1024^2 and a 512^2 codec, and
# the ragged one
SHAPES = {BWD: [(4, 4096, 4096), (2, 1000, 1500)],
          FWD: [(4, 4096, 4096), (1, 16384, 16384), (1, 4096, 4096),
                (2, 1000, 1500)]}


def build(paths) -> dict:
    """Variant name -> (source it stands for, {entry: ctypes function}),
    each built into the package's build directory."""
    from diffute_tpu_torch.ops import _build

    command = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC]
    headers = sorted(glob.glob(os.path.join(_build.CSRC, "*.cuh")))
    sigs = _build._signatures()
    out = {}
    for path in paths:
        stem = os.path.splitext(os.path.basename(path))[0]
        local = sorted(glob.glob(os.path.join(os.path.dirname(path),
                                              "*.cuh")))
        lib = ctypes.CDLL(_build.build_shared_library(
            f"variant_{stem}", command, [path], hashed=headers + local))
        source = next(s for s, entries in SOURCES.items()
                      if hasattr(lib, entries[0]))
        fns = {}
        for name in SOURCES[source]:
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = sigs[name], ctypes.c_int
            fns[name] = fn
        out[stem] = (source, fns)
    return out


def median_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def _rel(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def measure(variants: dict, source: str, iters: int, seed: int = 8) -> list:
    """Rows of the package against the variants of ``source``."""
    from diffute_tpu_torch.ops import _build

    fa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")
    lib = _build.load()
    entries = SOURCES[source]
    variants = {"package": {n: getattr(lib, n) for n in entries},
                **{name: fns for name, (src, fns) in variants.items()
                   if src == source}}

    def use(name):
        for entry, fn in variants[name].items():
            setattr(lib, entry, fn)

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(seed)
    d, sc = 512, 512 ** -0.5
    bkv = fa.kernel_block_kv(d, torch.float32, "bwd_dq" if source == BWD
                             else "fwd")
    rows = []
    for bh, s, t in SHAPES[source]:
        q, k, v, do = (torch.randn((bh, n, d), generator=g, device="cuda")
                       for n in (s, t, t, s))
        row = {"shape": [bh, s, t, d], "block_kv": bkv}
        if source == BWD:
            o, lse = fa.flash_fwd_3d(q, k, v, sc)

            def dq():
                return fa.flash_bwd_dq_3d(q, k, v, o, lse, do, sc)

            def dkv():
                return fa.flash_bwd_dkv_3d(q, k, v, do, lse, delta, sc)

            use("package")
            delta = dq()[1]

            def every():
                a, b = dq()
                return (a, b, *dkv())
            kernels = {"dq": dq, "dkv": dkv}
            ref_bits = every()
            ref = fa.flash_bwd_tiled_reference(q, k, v, o, lse, do, sc, bkv)
            row["package_rel_l2"] = {
                n: _rel(a, b) for n, a, b in zip(
                    ("dq", "dk", "dv"), (ref_bits[0], *ref_bits[2:]), ref)}
        else:
            kernels = {"fwd": lambda: fa.flash_fwd_3d(q, k, v, sc)}
            if fa._pipelined_takes(t, d):
                kernels["fwd_pipelined"] = (
                    lambda: fa.flash_fwd_3d_pipelined(q, k, v, sc))

            def every():
                return tuple(x for fn in kernels.values() for x in fn())
            use("package")
            ref_bits = every()
            row["package_rel_l2"] = {}
            for i, kind in enumerate(kernels):
                ro, rlse = fa.flash_fwd_tiled_reference(
                    q, k, v, sc, bkv,
                    "prescaled" if kind == "fwd_pipelined" else "natural")
                row["package_rel_l2"][kind] = _rel(ref_bits[2 * i], ro)
                row["package_rel_l2"][kind + "_lse_abs"] = (
                    ref_bits[2 * i + 1] - rlse).abs().max().item()
            del ro, rlse
        times = {name: {kind: [] for kind in kernels} for name in variants}
        for name in variants:
            use(name)
            times[name]["same_bits_as_package"] = all(
                torch.equal(a, b) for a, b in zip(every(), ref_bits))
        for name in list(variants) + list(variants)[::-1]:
            use(name)
            for kind, fn in kernels.items():
                times[name][kind].append(median_ms(fn, iters))
        use("package")
        row["variants"] = times
        rows.append(row)
        del q, k, v, do, ref_bits
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("variants", nargs="*", metavar="VARIANT.cu")
    p.add_argument("--probes", action="store_true",
                   help="add the three probes made from the backward source")
    p.add_argument("--forward-probes", action="store_true",
                   help="add the three probes made from the forwards' source")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not (args.variants or args.probes or args.forward_probes):
        p.error("name a VARIANT.cu or pass --probes / --forward-probes")
    if not torch.cuda.is_available():
        raise SystemExit("fp32_d512_bwd_variants: no CUDA device")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        paths = list(args.variants)
        if args.probes:
            paths += write_probes(tmp, BWD)
        if args.forward_probes:
            paths += write_probes(tmp, FWD)
        variants = build(paths)
    rows = []
    for source in SOURCES:
        if any(src == source for src, _ in variants.values()):
            rows += measure(variants, source, args.iters)
    for row in rows:
        print(json.dumps(dict(row, gpu=gpu)), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"gpu": gpu, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
