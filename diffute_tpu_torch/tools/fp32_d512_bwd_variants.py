"""Time variant builds of the fp32 head_dim-512 backward pair
(``csrc/flash_fp32_d512_bwd_sm90.cu``) against the package's own build, in
turns, at its training shape and a ragged one.

  python -m diffute_tpu_torch.tools.fp32_d512_bwd_variants [VARIANT.cu ...]
      [--probes] [--iters 10] [--out FILE]

Each VARIANT.cu is a copy of that source with one change (a schedule to
try), built with the package's ``nvcc`` flags and headers.  ``--probes``
adds three made from the package's source, each dropping part of the work
to show what it costs (their outputs are wrong by design): ``hihi`` issues
only the hi x hi product of each 3xTF32 step (a third of the mma.sync),
``nosplit`` takes each operand's bits as hi and zero as lo (no split
arithmetic), ``block_barriers`` waits on the block's barrier where each
tile waits on the cluster's (a cluster barrier stays at the start and the
end, so no block reads another that has not started or has left).  While
a variant is timed its two entries, ``flash_bwd_dq_d512_fp32`` and
``flash_bwd_dkv_d512_fp32``, take the package's place behind the
wrappers.  For each shape: the package's
dq, dk and dv against the tiled plain version at its tile, whether each
variant gives the package's bits, and CUDA-event medians of ``--iters``
launches of dq and of dk/dv, the package and every variant in turns
(forward order, then backward).  Prints one JSON object per shape with the
card's name and power limit, and writes them to ``--out`` if given.  Needs
a CUDA device and ``nvcc``.
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

ENTRIES = ("flash_bwd_dq_d512_fp32", "flash_bwd_dkv_d512_fp32")
SOURCE = "flash_fp32_d512_bwd_sm90.cu"
# the probes' edits of SOURCE: (text, replacement) pairs, each found once
# (the cluster barriers' twice: one in each kernel)
PROBES = {
    "hihi": [(
        "  for (int i = 0; i < N; ++i) mma_tf32(d[i], a[i].lo, b[i].hi[0], "
        "b[i].hi[1]);\n#pragma unroll\n"
        "  for (int i = 0; i < N; ++i) mma_tf32(d[i], a[i].hi, b[i].lo[0], "
        "b[i].lo[1]);\n", "")],
    "nosplit": [(
        "  hi = rna_tf32(x);\n  lo = rna_tf32(x - __uint_as_float(hi));",
        "  hi = __float_as_uint(x);\n  lo = 0u;")],
    "block_barriers": [
        ("__device__ __forceinline__ void cluster_arrive() {",
         "__device__ __forceinline__ void cluster_arrive() {}\n"
         "__device__ __forceinline__ void cluster_wait() {\n"
         "  __syncthreads();\n}\n"
         "__device__ __forceinline__ void cluster_arrive_all() {"),
        ("__device__ __forceinline__ void cluster_wait() {\n  asm",
         "__device__ __forceinline__ void cluster_wait_all() {\n  asm"),
        ("  cluster_arrive();  // this block runs: the others may store into "
         "it\n", "  cluster_arrive_all();\n"),
        ("  cluster_wait();  // every block of the cluster runs\n",
         "  cluster_wait_all();\n"),
        ("  float* dqb = p.out0", "  cluster_arrive_all();\n"
         "  cluster_wait_all();\n  float* dqb = p.out0"),
        ("  const int row0 = kv0", "  cluster_arrive_all();\n"
         "  cluster_wait_all();\n  const int row0 = kv0")],
}


def write_probes(directory: str) -> list:
    """The probes' sources, written into ``directory``."""
    from diffute_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC, SOURCE)) as f:
        text = f.read()
    paths = []
    for name, edits in PROBES.items():
        probe = text
        for old, new in edits:
            count = probe.count(old)
            if count not in (1, 2) or (count == 2 and "cluster_" not in old):
                raise RuntimeError(f"probe {name}: {old!r} found {count} "
                                   f"times in {SOURCE}")
            probe = probe.replace(old, new)
        path = os.path.join(directory, f"{name}.cu")
        with open(path, "w") as f:
            f.write(probe)
        paths.append(path)
    return paths


# (B*H, S, T): the fp32 SD2 stage-1 step's mid-block call and a ragged one
SHAPES = [(4, 4096, 4096), (2, 1000, 1500)]


def build(paths) -> dict:
    """Variant name -> {entry: ctypes function}, each source built into
    the package's build directory."""
    from diffute_tpu_torch.ops import _build

    command = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC]
    headers = sorted(glob.glob(os.path.join(_build.CSRC, "*.cuh")))
    sigs = _build._signatures()
    out = {}
    for path in paths:
        stem = os.path.splitext(os.path.basename(path))[0]
        lib = ctypes.CDLL(_build.build_shared_library(
            f"variant_{stem}", command, [path], hashed=headers))
        fns = {}
        for name in ENTRIES:
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = sigs[name], ctypes.c_int
            fns[name] = fn
        out[stem] = fns
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


def measure(variants: dict, iters: int, seed: int = 8) -> list:
    from diffute_tpu_torch.ops import _build

    fa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")
    lib = _build.load()
    variants = {"package": {n: getattr(lib, n) for n in ENTRIES},
                **variants}

    def use(name):
        for entry, fn in variants[name].items():
            setattr(lib, entry, fn)

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(seed)
    d, sc = 512, 512 ** -0.5
    bkv = fa.kernel_block_kv(d, torch.float32, "bwd_dq")
    rows = []
    for bh, s, t in SHAPES:
        q, k, v, do = (torch.randn((bh, n, d), generator=g, device="cuda")
                       for n in (s, t, t, s))
        o, lse = fa.flash_fwd_3d(q, k, v, sc)

        def pair():
            dq, delta = fa.flash_bwd_dq_3d(q, k, v, o, lse, do, sc)
            return (dq, delta, *fa.flash_bwd_dkv_3d(q, k, v, do, lse, delta,
                                                    sc))

        use("package")
        ref_bits = pair()
        ref = fa.flash_bwd_tiled_reference(q, k, v, o, lse, do, sc, bkv)
        row = {"shape": [bh, s, t, d], "block_kv": bkv, "package_rel_l2": {
            n: ((a - b).norm() / b.norm()).item()
            for n, a, b in zip(("dq", "dk", "dv"),
                               (ref_bits[0], *ref_bits[2:]), ref)}}
        del ref
        delta = ref_bits[1]
        times = {name: {"dq": [], "dkv": []} for name in variants}
        for name in variants:
            use(name)
            times[name]["same_bits_as_package"] = all(
                torch.equal(a, b) for a, b in zip(pair(), ref_bits))
        for name in list(variants) + list(variants)[::-1]:
            use(name)
            times[name]["dq"].append(median_ms(
                lambda: fa.flash_bwd_dq_3d(q, k, v, o, lse, do, sc), iters))
            times[name]["dkv"].append(median_ms(
                lambda: fa.flash_bwd_dkv_3d(q, k, v, do, lse, delta, sc),
                iters))
        use("package")
        row["variants"] = times
        rows.append(row)
        del q, k, v, do, o, lse, ref_bits, delta
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("variants", nargs="*", metavar="VARIANT.cu")
    p.add_argument("--probes", action="store_true",
                   help="add the three probes made from the package's source")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not (args.variants or args.probes):
        p.error("name a VARIANT.cu or pass --probes")
    if not torch.cuda.is_available():
        raise SystemExit("fp32_d512_bwd_variants: no CUDA device")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        paths = list(args.variants) + (write_probes(tmp) if args.probes
                                       else [])
        variants = build(paths)
    rows = measure(variants, args.iters)
    for row in rows:
        print(json.dumps(dict(row, gpu=gpu)), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"gpu": gpu, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
