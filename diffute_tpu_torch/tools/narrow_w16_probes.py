"""Time the bf16 flash kernels at tile width 16
(``csrc/flash_narrow_w16_sm90.cu``: both forwards and the backward pair)
built with other block shapes and launch bounds, and probes that drop one
piece of the work, against the package's build and another checkout's, in
turns; count the instructions of their inner loops.

  python -m diffute_tpu_torch.tools.narrow_w16_probes [VARIANT.cu ...]
      [--variants W,S,B8,B16,B16D ...] [--bwd-variants Q8,Q16,K8,K16 ...]
      [--probes] [--other-csrc DIR] [--sass] [--dump] [--iters 10]
      [--out FILE]

Each VARIANT.cu is another version of the source (the same entries),
built in its place and timed beside it.

Each ``--variants W,S,B8,B16,B16D`` is a copy of the source with
``kWarps = W`` (16 rows a warp), ``kStages = S`` (the ring's stages) and
the launch bounds' blocks an SM ``kMinBlocks8 = B8`` (both forwards at
D = 8), ``kMinBlocks16 = B16`` (the standard forward at D = 16) and
``kMinBlocks16Deferred = B16D`` (the deferred one); each
``--bwd-variants Q8,Q16,K8,K16`` one with the pair's
``kDqMinBlocks8 = Q8``, ``kDqMinBlocks16 = Q16``, ``kDkvMinBlocks8 = K8``
and ``kDkvMinBlocks16 = K16``.  Each is built with the package's ``nvcc``
flags and headers into a library of its own (``kernel_variants``, as
every build here) and gives the package's bits (held with
``torch.equal``).  ``--probes`` adds copies that each change one piece of
the work to show what it costs (their outputs are wrong by design, but
``exp2f``'s): ``exp2f`` takes every exponential of all four kernels
through ``exp2f`` (without ``-ftz``: a compare, two predicated multiplies
and the MUFU), ``no_exp`` takes none (p = the exponent), ``no_max`` takes
one pair's max for the row's, ``no_pv`` issues no product into o, dq, dk
or dv, ``no_loads`` issues no copy of the forwards' and dq's after the
prologue, ``no_barrier`` takes no barrier a tile in the forwards,
``deferred_order`` runs the standard forward on the deferred one's
schedule (right where T is a whole number of tiles, as at every shape
here), ``pair_no_dp`` issues none of the pair's dO v^T products, and
``pair_no_stats`` reads no lse or delta in dk/dv (0 for each).
``--other-csrc`` (another checkout's ``csrc/``, e.g. the parent unpacked
by ``git archive``) adds that checkout's width-16 bf16 kernels, each from
the source that defines it.  For each shape, (2, 65536^2) and (4,
16384^2) at head_dim 8 and (1, 65536^2) at 16 (the tiny model's 512^2
pass and its VAE's mid-block): CUDA-event medians of ``--iters`` launches
of each build's standard and deferred forward, dq and dk/dv (the pair on
the package's o, LSE and delta), every build in one order and then the
reverse, with ptxas's registers and spills and the blocks an SM
(cudaOccupancyMaxActiveBlocksPerMultiprocessor, this source's builds).
``--sass`` prints, for each build's width-16 kernels, the instructions of
every loop (a backward branch of ``cuobjdump -sass``) by opcode, and the
instructions a score (the largest loop over the 32 scores a thread owns a
tile, times the tiles a trip); ``--dump`` puts the package's loops
instruction by instruction into ``--out``.  Prints one JSON object a
shape and the card's name and power limit, and writes them to ``--out``
if given.  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import ctypes
import json
import os
import re
import shutil
import tempfile

import torch

from diffute_tpu_torch.tools import kernel_variants

SOURCE = "flash_narrow_w16_sm90.cu"
SHAPES = ((2, 65536, 65536, 8), (4, 16384, 16384, 8), (1, 65536, 65536, 16))
FWD_ENTRIES = ("flash_fwd_w16_bf16", "flash_fwd_pipelined_w16_bf16")
BWD_ENTRIES = ("flash_bwd_dq_w16_bf16", "flash_bwd_dkv_w16_bf16")
_SHAPE = re.compile(r"constexpr int kWarps = \d+, kStages = \d+, "
                    r"kMinBlocks8 = \d+, kMinBlocks16 = \d+,\s+"
                    r"kMinBlocks16Deferred = \d+;")
_BWD_SHAPE = re.compile(r"constexpr int kDqMinBlocks8 = \d+, "
                        r"kDqMinBlocks16 = \d+, kDkvMinBlocks8 = \d+,\s+"
                        r"kDkvMinBlocks16 = \d+;")

# the probes: name -> the changes it makes, each (text the source must
# hold, what takes its place at each place it is)
PROBES = {
    "exp2f": [('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));\n',
               "  y = exp2f(x);\n")],
    "no_exp": [('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));\n',
                "  y = x;\n")],
    "no_max": [("  float mx_lo = max_tree(a), mx_hi = max_tree(b);\n",
                "  float mx_lo = a[0], mx_hi = b[0];\n")],
    "no_pv": [("      mma_bf16(o[0], pa[2 * h], v4[0], v4[1]);\n"
               "      mma_bf16(o[0], pa[2 * h + 1], v4[2], v4[3]);\n", ""),
              ("      mma_bf16(o[0], pa[kk], v4[0], v4[1]);\n"
               "      mma_bf16(o[1], pa[kk], v4[2], v4[3]);\n", ""),
              ("  mma_bf16(o[0], pa, b[0], b[1]);\n"
               "  if constexpr (kD == 16) mma_bf16(o[1], pa, b[2], b[3]);\n",
               "")],
    "no_loads": [("    if (j + kStages - 1 < n_tiles) "
                  "load_kv<kD>(ld, j + kStages - 1, t_len);\n", "")],
    "no_barrier": [("      cp_async_wait<kStages - 2 - kLead>();\n"
                    "      __syncthreads();\n    }\n", "    }\n")],
    "deferred_order": [("  if constexpr (!kDeferred) {\n",
                        "  if constexpr (false) {\n"),
                       ("  constexpr int kLead = kDeferred ? 1 : 0;",
                        "  constexpr int kLead = 1;")],
    "pair_no_dp": [("        mma_rows<kD>(dp, da[m], vb);\n", ""),
                   ("        mma_rows<kD>(dp, va[m], db);\n", ""),
                   ("        float s[2][4], dp[2][4];\n",
                    "        float s[2][4], dp[2][4] = {};\n")],
    "pair_no_stats": [("      const float4 x[2] = {sd[(k0 / 8) * 4 + t], "
                       "sd[(k0 / 8 + 1) * 4 + t]};\n",
                       "      const float4 x[2] = {};\n")],
}


def variant_text(text: str, variant) -> str:
    """The source with the block shape ``variant`` (W, S, B8, B16, B16D),
    the pair's launch bounds (``("bwd", Q8, Q16, K8, K16)``) or the probe
    ``variant`` (a name of PROBES) applied."""
    if isinstance(variant, str):
        for old, new in PROBES[variant]:
            if old not in text:
                raise SystemExit(f"narrow_w16_probes: {variant} does not "
                                 f"apply to {SOURCE}")
            text = text.replace(old, new)
        return text
    if variant[0] == "bwd":
        text, n = _BWD_SHAPE.subn(
            "constexpr int kDqMinBlocks8 = %d, kDqMinBlocks16 = %d, "
            "kDkvMinBlocks8 = %d, kDkvMinBlocks16 = %d;" % variant[1:], text)
        if n != 1:
            raise SystemExit(f"narrow_w16_probes: the pair's launch bounds "
                             f"line is not in {SOURCE}")
        return text
    text, n = _SHAPE.subn(
        "constexpr int kWarps = %d, kStages = %d, kMinBlocks8 = %d, "
        "kMinBlocks16 = %d, kMinBlocks16Deferred = %d;" % variant, text)
    if n != 1:
        raise SystemExit(f"narrow_w16_probes: the block shape line is not "
                         f"in {SOURCE}")
    return text


def variant_name(variant) -> str:
    if isinstance(variant, str):
        return variant
    if variant[0] == "bwd":
        return "dq%d_%d_dkv%d_%d" % variant[1:]
    return "w%ds%db%dm%dd%d" % variant


def wanted(kernel: str) -> bool:
    """A width-16 bf16 kernel: this source's, or flash_narrow.cu's
    Narrow<bf16, 16> instances."""
    if not re.search(r"(fwd|fwd_deferred|dq|dkv)_kernel", kernel):
        return False
    return "Narrow" not in kernel or ("bfloat16" in kernel
                                      and "Li16E" in kernel)


def opcode(ins: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]


def loops(listing: list, text: bool = False) -> list:
    """Every loop of one kernel (a BRA to an earlier address): its first
    and last address, its instructions and their opcodes by count (and,
    with ``text``, the instructions themselves)."""
    out = []
    for addr, ins in listing:
        if opcode(ins) != "BRA":
            continue
        m = re.search(r"0x([0-9a-f]+)", ins)
        if not m or int(m.group(1), 16) >= addr:
            continue
        start = int(m.group(1), 16)
        body = [t for a, t in listing if start <= a <= addr]
        out.append({"from": hex(start), "to": hex(addr),
                    "instructions": len(body),
                    "opcodes": dict(collections.Counter(
                        opcode(t) for t in body).most_common()),
                    **({"text": body} if text else {})})
    return out


def sass_report(cubin: str, text: bool = False) -> dict:
    """The width-16 kernels' loops; the largest loop's instructions a score:
    over the 32 scores a thread owns a tile, times two for this source's
    deferred forward (``fwd_kernel<D, true>``: two kv tiles a trip) and its
    pair (``BwdParams``: two m16 tiles a warp)."""
    out = {}
    for name, listing in kernel_variants.sass(cubin).items():
        if not wanted(name):
            continue
        found = loops(listing, text)
        rec = {"instructions": len(listing), "loops": found}
        if found:
            main = max(found, key=lambda x: x["instructions"])
            tiles = 2 if re.search(r"Lb1E|BwdParams", name) else 1
            rec["per_score"] = main["instructions"] / (32 * tiles)
            rec["mufu_per_score"] = sum(
                n for op, n in main["opcodes"].items()
                if op.startswith("MUFU")) / (32 * tiles)
        out[name] = rec
    return out


def source_of(csrc: str, entry: str) -> str:
    """The source of a ``csrc/`` that defines the width-16 bf16 ``entry``:
    by its text, or by flash_narrow.cu's macro line of B16."""
    part = "BWD_" if entry in BWD_ENTRIES else "FWD_"
    for name in (SOURCE, "flash_narrow.cu"):
        path = os.path.join(csrc, name)
        if os.path.exists(path):
            with open(path) as f:
                text = f.read()
            if f"int {entry}(" in text or re.search(
                    rf"^FLASH_NARROW_({part})?ENTRIES\(B16, w16, bf16\)$",
                    text, re.M):
                return name
    raise SystemExit(f"narrow_w16_probes: no source under {csrc} defines "
                     f"{entry}")


def call_entry(lib, entry: str, x: dict, bh: int, s: int, t: int,
               d: int) -> None:
    """Launch ``entry`` of ``lib`` on the (1, len, B*H, d) tensors of ``x``
    (q, k, v, o, lse, dO, delta and the outputs) on the current stream."""
    fp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd = entry in FWD_ENTRIES
    names = (("q", "k", "v", "o") if fwd
             else ("q", "k", "v", "o", "do", "dq") if "dq" in entry
             else ("q", "k", "v", "do", "dk", "dv"))
    strides = (ctypes.c_longlong * (3 * len(names)))(
        *(st for n in names for st in x[n].stride()[:3]))
    ptrs = ([x[n] for n in ("q", "k", "v", "o", "lse")] if fwd else
            [x[n] for n in ("q", "k", "v", "o", "do", "lse", "delta", "dq")]
            if "dq" in entry else
            [x[n] for n in ("q", "k", "v", "do", "lse", "delta", "dk",
                            "dv")])
    fn = getattr(lib, entry)
    fn.argtypes = ([fp] * len(ptrs) + [i] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), f, fp])
    rc = fn(*(y.data_ptr() for y in ptrs), 1, bh, s, t, d, strides,
            d ** -0.5, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{entry}: CUDA error {rc}")


# each entry's outputs, held against the package build's
OUTPUTS = {FWD_ENTRIES[0]: ("o", "lse"), FWD_ENTRIES[1]: ("o", "lse"),
           BWD_ENTRIES[0]: ("dq", "delta"), BWD_ENTRIES[1]: ("dk", "dv")}


def main(argv=None) -> None:
    from diffute_tpu_torch.ops import _build

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("variant_sources", nargs="*", default=[])
    p.add_argument("--variants", nargs="*", default=[])
    p.add_argument("--bwd-variants", nargs="*", default=[])
    p.add_argument("--probes", action="store_true")
    p.add_argument("--other-csrc", default=None)
    p.add_argument("--sass", action="store_true")
    p.add_argument("--dump", action="store_true",
                   help="with --sass and --out: the loops' instructions of "
                   "the package's build in the file")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("narrow_w16_probes: no CUDA device")
    card = kernel_variants.card()
    print(card, flush=True)
    with open(os.path.join(_build.CSRC, SOURCE)) as f:
        text = f.read()
    # (name, csrc, source, text or None, entries)
    builds = [("package", _build.CSRC, SOURCE, None, FWD_ENTRIES + BWD_ENTRIES)]
    variants = ([tuple(int(x) for x in v.split(",")) for v in args.variants]
                + [("bwd", *(int(x) for x in v.split(",")))
                   for v in args.bwd_variants]
                + (list(PROBES) if args.probes else []))
    for v in variants:
        builds.append((variant_name(v), _build.CSRC, SOURCE,
                       variant_text(text, v), FWD_ENTRIES + BWD_ENTRIES))
    for path in args.variant_sources:
        with open(path) as f:
            builds.append((os.path.splitext(os.path.basename(path))[0],
                           _build.CSRC, SOURCE, f.read(),
                           FWD_ENTRIES + BWD_ENTRIES))
    if args.other_csrc:
        by_source = collections.defaultdict(list)
        for entry in FWD_ENTRIES + BWD_ENTRIES:
            by_source[source_of(args.other_csrc, entry)].append(entry)
        for source, entries in sorted(by_source.items()):
            builds.append((f"other_{os.path.splitext(source)[0]}",
                           args.other_csrc, source, None, tuple(entries)))
    root = tempfile.mkdtemp(prefix="narrow_w16_probes_")
    lines = [card]
    try:
        with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
            built = list(pool.map(
                lambda b: kernel_variants.build_copy(b[1], b[2], b[3], root,
                                                     b[0], with_cubin=True),
                builds))
        i = ctypes.c_int
        libs, info = {}, {}
        for (name, _, source, _, entries), (so, cubin, stderr) in zip(
                builds, built):
            ptxas = {k: v for k, v in kernel_variants.ptxas_by_kernel(
                stderr).items() if wanted(k)}
            lib = ctypes.CDLL(so)
            libs[name] = (lib, entries)
            rec = {"build": name, "source": source, "ptxas": ptxas}
            for query, kinds in (("flash_fwd_w16_bf16_blocks_per_sm",
                                  ("fwd", "fwd_pipelined")),
                                 ("flash_bwd_w16_bf16_blocks_per_sm",
                                  ("bwd_dq", "bwd_dkv"))):
                if hasattr(lib, query):
                    occ = getattr(lib, query)
                    occ.argtypes = [i, i]
                    rec.setdefault("blocks_per_sm", {}).update(
                        {f"{kind}_d{d}": occ(n, d)
                         for n, kind in enumerate(kinds) for d in (8, 16)})
            if args.sass:
                rec["sass"] = sass_report(cubin)
            info[name] = rec
            print(json.dumps(rec), flush=True)
            if args.sass and args.dump and name == "package":
                rec = dict(rec, sass=sass_report(cubin, text=True))
            lines.append(rec)
        gen = torch.Generator(device="cuda").manual_seed(27)
        package = libs["package"][0]
        for bh, s, t, d in SHAPES:
            x = {n: torch.randn((1, m, bh, d), generator=gen, device="cuda",
                                dtype=torch.bfloat16)
                 for n, m in (("q", s), ("k", t), ("v", t), ("do", s))}
            x.update({n: torch.empty_like(x[m]) for n, m in (
                ("o", "q"), ("dq", "q"), ("dk", "k"), ("dv", "v"))})
            x.update(lse=torch.empty((bh, s), device="cuda"),
                     delta=torch.empty((bh, s), device="cuda"))
            # the pair's inputs: the package's o, LSE and delta
            for entry in (FWD_ENTRIES[0], BWD_ENTRIES[0]):
                call_entry(package, entry, x, bh, s, t, d)
            inputs = {n: x[n].clone() for n in ("o", "lse", "delta")}
            out = {"shape": [bh, s, t, d]}
            ref = {}
            order = list(libs.items())
            for turn in (order, order[::-1]):
                for name, (lib, entries) in turn:
                    for entry in entries:
                        def call():
                            call_entry(lib, entry, x, bh, s, t, d)
                        for n, y in inputs.items():
                            x[n].copy_(y)
                        call()
                        torch.cuda.synchronize()
                        got = {n: x[n].clone() for n in OUTPUTS[entry]}
                        for n, y in inputs.items():
                            x[n].copy_(y)
                        key = f"{name}:{entry}"
                        if key not in out:
                            if name == "package":
                                ref[entry] = got
                            rec = {"ms": []}
                            if entry in ref:
                                first = OUTPUTS[entry][0]
                                diff = (got[first].float()
                                        - ref[entry][first].float())
                                rec.update(
                                    same_bits=all(torch.equal(
                                        got[n], ref[entry][n])
                                        for n in OUTPUTS[entry]),
                                    rel_l2=(diff.norm() / ref[entry][first]
                                            .float().norm()).item())
                            out[key] = rec
                        out[key]["ms"].append(
                            kernel_variants.time_ms(call, args.iters))
            for name, _, _, new_text, entries in builds:
                if new_text is not None and name in info and not (
                        name in PROBES):
                    for entry in entries:
                        if not out[f"{name}:{entry}"].get("same_bits"):
                            out[f"{name}:{entry}"]["NOT_THE_PACKAGE_BITS"] = 1
            print(json.dumps(out), flush=True)
            lines.append(out)
            del x, inputs, ref
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)


if __name__ == "__main__":
    main()
