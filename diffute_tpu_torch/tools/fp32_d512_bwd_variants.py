"""Time variant builds of the fp32 head_dim-512 kernels against the
package's own build, in turns: the backward pair
(``csrc/flash_fp32_d512_bwd_sm90.cu``) at its training shape and a ragged
one, and the two forwards (``csrc/flash_fp32_d512_sm90.cu``) at the fp32
SD2 codecs' and stage-1 step's shapes and a ragged one.

  python -m diffute_tpu_torch.tools.fp32_d512_bwd_variants [VARIANT.cu ...]
      [--probes] [--forward-probes] [--iters 10] [--out FILE]
  python -m diffute_tpu_torch.tools.fp32_d512_bwd_variants --chain-study
      ROUTE.pt [--chains 8,4,2,1]

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
``--out`` if given.

``--chain-study ROUTE.pt`` reads the mid-block flash calls of an fp32
stage-1 step (each a dict of its q, k, v and dO, (B, S, H, 512), as
``chip_smoke.py --fp32-d512-only --save-route ROUTE.pt`` writes them) and
builds the backward source once for each tensor-core chain length of its
score partials (``kScoreChain``, in k-steps of 8 head_dim columns: 8 is 64
columns), each variant also storing the pair's summed S and dP (dq's and
dk/dv's) of every tile.  For each call, on the standard and on the deferred
forward's o and LSE, it prints for each chain: the signed mean, the mean
absolute and the largest error of S and dP against fp64, dq, dk and dv
against the backward's own function in fp64 on that o and LSE and against
fp64 attention, the route rule's verdict (within 1e-5 of the tiled plain
fp32 backward, or no further from fp64 attention than twice that plain
version is), and the medians of the two kernels in turns.  Needs a CUDA
device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import re
import tempfile

import torch

from diffute_tpu_torch.tools import kernel_variants

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

    sigs = _build._signatures()
    out = {}
    for path in paths:
        stem = os.path.splitext(os.path.basename(path))[0]
        lib = kernel_variants.build_library(path)
        source = next(s for s, entries in SOURCES.items()
                      if hasattr(lib, entries[0]))
        fns = {}
        for name in SOURCES[source]:
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = sigs[name], ctypes.c_int
            fns[name] = fn
        if hasattr(lib, "d512_set_dump"):  # a --chain-study variant
            fn = lib.d512_set_dump
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
            fn.restype = ctypes.c_int
            fns["d512_set_dump"] = fn
        out[stem] = (source, fns)
    return out


# --chain-study: the chain lengths it builds, and the source text it edits
STUDY_CHAINS = (8, 4, 2, 1)
_CHAIN = re.compile(r"constexpr int kScoreChain = \d+;")
# the pair's summed S and dP of a tile, as each reducer thread holds them
# (.x (r, c), .y (r, c + 1), .z (r + 8, c), .w (r + 8, c + 1); r a resident
# row, c a streamed one), stored as (B*H, S, T) fp32 where the study set
# buffers: dq's S and dP, then dk/dv's S^T and dP^T
_DUMP = """
__device__ float* g_dump[4];
__device__ long long g_dump_st[2];

__device__ __forceinline__ void dump_scores(int kernel, const Reducer& x,
                                            int j, float4 s, float4 dp) {
  float* ds = g_dump[2 * kernel];
  float* dd = g_dump[2 * kernel + 1];
  if (!ds) return;
  const long long len_s = g_dump_st[0], len_t = g_dump_st[1];
  const float sv[4] = {s.x, s.y, s.z, s.w}, dv[4] = {dp.x, dp.y, dp.z, dp.w};
  const int r0 = (blockIdx.x / kRanks) * kRows + x.row;
  const int c0 = j * kBlockKV + x.col;
  for (int e = 0; e < 4; ++e) {
    const long long r = r0 + 8 * (e >> 1), c = c0 + (e & 1);
    const long long qi = kernel ? c : r, ki = kernel ? r : c;
    if (qi >= len_s || ki >= len_t) continue;
    const long long at = ((long long)blockIdx.y * len_s + qi) * len_t + ki;
    ds[at] = sv[e];
    dd[at] = dv[e];
  }
}

"""
_DUMP_SET = """
extern "C" int d512_set_dump(void* s0, void* dp0, void* s1, void* dp1,
                             long long len_s, long long len_t) {
  float* h[4] = {static_cast<float*>(s0), static_cast<float*>(dp0),
                 static_cast<float*>(s1), static_cast<float*>(dp1)};
  const long long st[2] = {len_s, len_t};
  cudaMemcpyToSymbol(g_dump, h, sizeof h);
  cudaMemcpyToSymbol(g_dump_st, st, sizeof st);
  return (int)cudaGetLastError();
}
"""
_DQ_MARK = "// " + "-" * 67 + " dq"
_SUMS = ("float4 s = sum_ranks(part, x, 0);\n"
         "  const float4 dp = sum_ranks(part, x, 1);\n")
_DUMP_EDITS = [(_DQ_MARK, _DUMP + _DQ_MARK),
               ("  " + _SUMS,
                "  " + _SUMS + "  dump_scores(0, x, j, s, dp);\n"),
               ("  const " + _SUMS,
                "  const " + _SUMS + "  dump_scores(1, x, i, s, dp);\n")]


def write_chain_variants(directory: str, chains) -> list:
    """The backward source with kScoreChain set to each of ``chains`` and
    the score dump added, one file each under ``directory``."""
    from diffute_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC, BWD)) as f:
        text = f.read()
    if len(_CHAIN.findall(text)) != 1:
        raise RuntimeError(f"{BWD}: kScoreChain not found once")
    for old, _ in _DUMP_EDITS:
        if text.count(old) != 1:
            raise RuntimeError(f"{BWD}: {old!r} not found once")
    paths = []
    for chain in chains:
        out = _CHAIN.sub(f"constexpr int kScoreChain = {chain};", text)
        for old, new in _DUMP_EDITS:
            out = out.replace(old, new)
        path = os.path.join(directory, f"chain{8 * chain}.cu")
        with open(path, "w") as f:
            f.write(out + _DUMP_SET)
        paths.append(path)
    return paths


def bwd_fp64(q, k, v, o, lse, do, scale) -> tuple:
    """The flash backward's function in fp64 on given o and LSE (B*H, L, D)
    / (B*H, S): p = exp(s * scale - lse), ds = p (dO v^T - rowsum(dO o)),
    dq = ds k * scale, dk = ds^T q * scale, dv = p^T dO."""
    q, k, v, o, do = (x.double() for x in (q, k, v, o, do))
    p = torch.exp(torch.einsum("bsd,btd->bst", q, k) * scale
                  - lse.double()[..., None])
    ds = p * (torch.einsum("bsd,btd->bst", do, v)
              - (do * o).sum(-1, keepdim=True))
    return (torch.einsum("bst,btd->bsd", ds, k) * scale,
            torch.einsum("bst,bsd->btd", ds, q) * scale,
            torch.einsum("bst,bsd->btd", p, do))


def attention_grads_fp64(q, k, v, do, scale) -> tuple:
    """dq, dk, dv of softmax(q k^T scale) v in fp64 (B*H, L, D)."""
    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    o = torch.softmax(torch.einsum("bsd,btd->bst", leaves[0], leaves[1])
                      * scale, -1) @ leaves[2]
    return torch.autograd.grad(o, leaves, do.double())


def _errors(got: torch.Tensor, ref: torch.Tensor) -> dict:
    err = got.double() - ref
    return {"signed_mean": err.mean().item(),
            "mean_abs": err.abs().mean().item(),
            "max_abs": err.abs().max().item(),
            "mean_abs_ref": ref.abs().mean().item()}


def chain_study(route: str, chains, iters: int) -> list:
    """Rows of the chain study (module docstring) for each recorded call
    of ``route`` and each forward."""
    from diffute_tpu_torch.ops import _build

    fa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")
    lib = _build.load()
    with tempfile.TemporaryDirectory() as tmp:
        variants = build(write_chain_variants(tmp, chains))
    entries = SOURCES[BWD]
    package = {entry: getattr(lib, entry) for entry in entries}

    def use(name):
        for entry in entries:
            setattr(lib, entry, variants[name][1][entry])

    torch.backends.cuda.matmul.allow_tf32 = False
    records = torch.load(route, map_location="cuda")
    rows = []
    for index, rec in enumerate(records):
        q, k, v, do = (fa._heads_first(rec[n]).contiguous()
                       for n in ("q", "k", "v", "do"))
        bh, s_len, d = q.shape
        t_len, sc = k.shape[1], d ** -0.5
        bkv = fa.kernel_block_kv(d, torch.float32, "bwd_dq")
        s64 = torch.einsum("bsd,btd->bst", q.double(), k.double())
        dp64 = torch.einsum("bsd,btd->bst", do.double(), v.double())
        exact = attention_grads_fp64(q, k, v, do, sc)
        for forward in ("standard", "deferred"):
            fwd = (fa.flash_fwd_3d if forward == "standard"
                   else fa.flash_fwd_3d_pipelined)
            o, lse = fwd(q, k, v, sc)
            own = bwd_fp64(q, k, v, o, lse, do, sc)
            ref = fa.flash_bwd_tiled_reference(q, k, v, o, lse, do, sc, bkv)
            plain = {n: {"vs_own_fp64": _rel(r, w), "vs_fp64": _rel(r, e)}
                     for n, r, w, e in zip(("dq", "dk", "dv"), ref, own,
                                           exact)}
            row = {"call": index, "shape": [bh, s_len, t_len, d],
                   "forward": forward, "max_abs_score": s64.abs().max().item()
                   * sc, "plain": plain, "chains": {}}
            for name in variants:
                use(name)
                dump = [torch.full((bh, s_len, t_len), float("nan"),
                                   device="cuda") for _ in range(4)]
                variants[name][1]["d512_set_dump"](
                    *(x.data_ptr() for x in dump), s_len, t_len)
                dq, delta = fa.flash_bwd_dq_3d(q, k, v, o, lse, do, sc)
                dk, dv = fa.flash_bwd_dkv_3d(q, k, v, do, lse, delta, sc)
                torch.cuda.synchronize()
                variants[name][1]["d512_set_dump"](None, None, None, None, 0,
                                                   0)
                res = {f"{kernel}_{what}": _errors(x, r)
                       for (kernel, what), x, r in zip(
                           (("dq", "s"), ("dq", "dp"), ("dkv", "s"),
                            ("dkv", "dp")), dump, (s64, dp64, s64, dp64))}
                del dump
                for n, g, r, w, e in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                         ref, own, exact):
                    res[n] = {"vs_plain": _rel(g, r),
                              "vs_own_fp64": _rel(g, w),
                              "vs_fp64": _rel(g, e),
                              "held": (_rel(g, r) <= 1e-5 or _rel(g, e)
                                       <= 2 * plain[n]["vs_fp64"])}
                row["chains"][name] = res
            times = {name: {"dq": [], "dkv": []} for name in variants}
            delta = fa.flash_bwd_dq_3d(q, k, v, o, lse, do, sc)[1]
            for name in list(variants) + list(variants)[::-1]:
                use(name)
                times[name]["dq"].append(kernel_variants.time_ms(
                    lambda: fa.flash_bwd_dq_3d(q, k, v, o, lse, do, sc),
                    iters))
                times[name]["dkv"].append(kernel_variants.time_ms(
                    lambda: fa.flash_bwd_dkv_3d(q, k, v, do, lse, delta, sc),
                    iters))
            for name in variants:
                row["chains"][name]["ms"] = times[name]
            rows.append(row)
            del o, lse, own, ref
            torch.cuda.empty_cache()
        del q, k, v, do, s64, dp64, exact
    for entry, fn in package.items():  # the package's own kernels again
        setattr(lib, entry, fn)
    return rows


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
                times[name][kind].append(kernel_variants.time_ms(fn, iters))
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
    p.add_argument("--chain-study", default=None, metavar="ROUTE.pt",
                   help="the chain study on these recorded calls")
    p.add_argument("--chains", default=",".join(map(str, STUDY_CHAINS)),
                   help="with --chain-study: kScoreChain values (k-steps)")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not (args.variants or args.probes or args.forward_probes
            or args.chain_study):
        p.error("name a VARIANT.cu or pass --probes / --forward-probes / "
                "--chain-study")
    if not torch.cuda.is_available():
        raise SystemExit("fp32_d512_bwd_variants: no CUDA device")
    gpu = kernel_variants.card()
    if args.chain_study:
        rows = chain_study(args.chain_study,
                           [int(c) for c in args.chains.split(",")],
                           args.iters)
        for row in rows:
            print(json.dumps(dict(row, gpu=gpu)), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"gpu": gpu, "rows": rows}, f, indent=1)
        return
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
