"""Time the bf16 flash forwards at tile width 16
(``csrc/flash_narrow_w16_sm90.cu``) built with other block shapes, and
probes that drop one piece of the work, against the package's build and
another checkout's, in turns; count the instructions of their inner loops.

  python -m diffute_tpu_torch.tools.narrow_w16_probes [VARIANT.cu ...]
      [--variants W,S,B8,B16,B16D ...] [--probes] [--other-csrc DIR]
      [--sass] [--dump] [--iters 10] [--out FILE]

Each VARIANT.cu is another version of the source (the same entries),
built in its place and timed beside it.

Each ``--variants W,S,B8,B16,B16D`` is a copy of the source with
``kWarps = W`` (16 query rows a warp), ``kStages = S`` (the K and V ring)
and the launch bounds' blocks an SM ``kMinBlocks8 = B8`` (both forwards at
D = 8), ``kMinBlocks16 = B16`` (the standard forward at D = 16) and
``kMinBlocks16Deferred = B16D`` (the deferred one), built with the
package's ``nvcc`` flags and headers into a library of its own
(``kernel_variants``, as every build here); each gives the package's bits
(held with ``torch.equal``).  ``--probes`` adds copies that
each change one piece of the work to show what it costs (their outputs
are wrong by design, but ``exp2f``'s): ``exp2f`` takes every exponential
through ``exp2f`` (without ``-ftz``: a compare, two predicated multiplies
and the MUFU), ``no_exp`` takes none (p = the exponent), ``no_max``
takes one pair's max for the row's, ``no_pv`` issues no p v product,
``no_loads`` issues no copy after the prologue, ``no_barrier`` takes no
barrier a tile, ``deferred_order`` runs the standard forward on the
deferred one's schedule (right where T is a whole number of tiles, as at
every shape here).  ``--other-csrc`` (another checkout's ``csrc/``, e.g. the
parent unpacked by ``git archive``) adds that checkout's width-16 bf16
forwards, from the source that defines them.  For each shape, (2, 65536^2)
and (4, 16384^2) at head_dim 8 and (1, 65536^2) at 16 (the tiny model's
512^2 pass and its VAE's mid-block): CUDA-event medians of ``--iters``
launches of each build's standard and deferred forward, every build in one
order and then the reverse, with ptxas's registers and spills and the
blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor, this source's
builds).  ``--sass`` prints, for each build's forward kernels, the
instructions of every loop (a backward branch of ``cuobjdump -sass``) by
opcode, and the instructions a score (the loop over the 32 scores a
thread owns a kv tile, times the tiles a trip); ``--dump`` puts the
package's loops instruction by instruction into ``--out``.  Prints one
JSON object a shape and the card's name and power limit, and writes them
to ``--out`` if given.  Needs a CUDA device and ``nvcc``.
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
ENTRIES = ("flash_fwd_w16_bf16", "flash_fwd_pipelined_w16_bf16")
_SHAPE = re.compile(r"constexpr int kWarps = \d+, kStages = \d+, "
                    r"kMinBlocks8 = \d+, kMinBlocks16 = \d+,\s+"
                    r"kMinBlocks16Deferred = \d+;")

# the probes: (text the source must hold once, what takes its place)
PROBES = {
    "exp2f": ('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));\n',
              "  y = exp2f(x);\n"),
    "no_exp": ('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));\n',
               "  y = x;\n"),
    "no_max": ("  float mx_lo = max_tree(a), mx_hi = max_tree(b);\n",
               "  float mx_lo = a[0], mx_hi = b[0];\n"),
    "no_pv": ("      mma_bf16(o[0], pa[2 * h], v4[0], v4[1]);\n"
              "      mma_bf16(o[0], pa[2 * h + 1], v4[2], v4[3]);\n", ""),
    "no_loads": ("    if (j + kStages - 1 < n_tiles) "
                 "load_kv<kD>(ld, j + kStages - 1, t_len);\n", ""),
    "no_barrier": ("      cp_async_wait<kStages - 2 - kLead>();\n"
                   "      __syncthreads();\n    }\n", "    }\n"),
    "deferred_order": ("  if constexpr (!kDeferred) {\n",
                       "  if constexpr (false) {\n"),
}
# the second change of two probes: the head_dim-16 half of no_pv, and
# deferred_order's wait a tile ahead
_SECOND = {"no_pv": ("      mma_bf16(o[0], pa[kk], v4[0], v4[1]);\n"
                     "      mma_bf16(o[1], pa[kk], v4[2], v4[3]);\n", ""),
           "deferred_order": ("  constexpr int kLead = kDeferred ? 1 : 0;",
                              "  constexpr int kLead = 1;")}


def variant_text(text: str, variant) -> str:
    """The source with the block shape ``variant`` (W, S, B8, B16, B16D) or
    the probe ``variant`` (a name of PROBES) applied."""
    if isinstance(variant, str):
        old, new = PROBES[variant]
        if text.count(old) != 1:
            raise SystemExit(f"narrow_w16_probes: {variant} does not apply "
                             f"to {SOURCE}")
        text = text.replace(old, new)
        if variant in _SECOND:
            old, new = _SECOND[variant]
            if text.count(old) != 1:
                raise SystemExit(f"narrow_w16_probes: {variant} does not "
                                 f"apply to {SOURCE}")
            text = text.replace(old, new)
        return text
    text, n = _SHAPE.subn(
        "constexpr int kWarps = %d, kStages = %d, kMinBlocks8 = %d, "
        "kMinBlocks16 = %d, kMinBlocks16Deferred = %d;" % variant, text)
    if n != 1:
        raise SystemExit(f"narrow_w16_probes: the block shape line is not "
                         f"in {SOURCE}")
    return text


def variant_name(variant) -> str:
    return (variant if isinstance(variant, str)
            else "w%ds%db%dm%dd%d" % variant)


def wanted(kernel: str) -> bool:
    """A width-16 bf16 forward kernel: this source's, or flash_narrow.cu's
    Narrow<bf16, 16> instances."""
    if "fwd" not in kernel or "bwd" in kernel:
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
    """The forward kernels' loops; the largest loop's instructions a score
    (this source's deferred forward, ``fwd_kernel<D, true>``, takes two kv
    tiles a trip)."""
    out = {}
    for name, listing in kernel_variants.sass(cubin).items():
        if not wanted(name):
            continue
        found = loops(listing, text)
        rec = {"instructions": len(listing), "loops": found}
        if found:
            main = max(found, key=lambda x: x["instructions"])
            tiles = 2 if "Lb1E" in name else 1
            rec["per_score"] = main["instructions"] / (32 * tiles)
            rec["mufu_per_score"] = sum(
                n for op, n in main["opcodes"].items()
                if op.startswith("MUFU")) / (32 * tiles)
        out[name] = rec
    return out


def source_of(csrc: str) -> str:
    """The source of a ``csrc/`` that defines the width-16 bf16 forward."""
    for name in (SOURCE, "flash_narrow.cu"):
        path = os.path.join(csrc, name)
        if os.path.exists(path):
            with open(path) as f:
                text = f.read()
            if ("flash_fwd_w16_bf16(" in text
                    or "FLASH_NARROW_ENTRIES(B16, w16, bf16)" in text):
                return name
    raise SystemExit(f"narrow_w16_probes: no source under {csrc} defines "
                     f"flash_fwd_w16_bf16")


def main(argv=None) -> None:
    from diffute_tpu_torch.ops import _build

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("variant_sources", nargs="*", default=[])
    p.add_argument("--variants", nargs="*", default=[])
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
    builds = [("package", _build.CSRC, SOURCE, None)]
    for v in [tuple(int(x) for x in s.split(",")) for s in args.variants] + (
            list(PROBES) if args.probes else []):
        builds.append((variant_name(v), _build.CSRC, SOURCE,
                       variant_text(text, v)))
    for path in args.variant_sources:
        with open(path) as f:
            builds.append((os.path.splitext(os.path.basename(path))[0],
                           _build.CSRC, SOURCE, f.read()))
    if args.other_csrc:
        builds.append(("other", args.other_csrc, source_of(args.other_csrc),
                       None))
    root = tempfile.mkdtemp(prefix="narrow_w16_probes_")
    lines = [card]
    try:
        with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
            built = list(pool.map(
                lambda b: kernel_variants.build_copy(b[1], b[2], b[3], root,
                                                     b[0], with_cubin=True),
                builds))
        fp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        libs, info = {}, {}
        for (name, _, source, _), (so, cubin, stderr) in zip(builds, built):
            ptxas = {k: v for k, v in kernel_variants.ptxas_by_kernel(
                stderr).items() if wanted(k)}
            lib = ctypes.CDLL(so)
            for entry in ENTRIES:
                getattr(lib, entry).argtypes = (
                    [fp] * 5 + [i] * 5 + [ctypes.POINTER(ctypes.c_longlong),
                                          f, fp])
            libs[name] = lib
            rec = {"build": name, "source": source, "ptxas": ptxas}
            if hasattr(lib, "flash_fwd_w16_bf16_blocks_per_sm"):
                occ = lib.flash_fwd_w16_bf16_blocks_per_sm
                occ.argtypes = [i, i]
                rec["blocks_per_sm"] = {f"{kind}_d{d}": occ(n, d)
                                        for n, kind in enumerate(
                                            ("fwd", "fwd_pipelined"))
                                        for d in (8, 16)}
            if args.sass:
                rec["sass"] = sass_report(cubin)
            info[name] = rec
            print(json.dumps(rec), flush=True)
            if args.sass and args.dump and name == "package":
                rec = dict(rec, sass=sass_report(cubin, text=True))
            lines.append(rec)
        gen = torch.Generator(device="cuda").manual_seed(27)
        for bh, s, t, d in SHAPES:
            q, k, v = (torch.randn((1, n, bh, d), generator=gen, device="cuda",
                                   dtype=torch.bfloat16) for n in (s, t, t))
            o = torch.empty_like(q)
            lse = torch.empty((bh, s), device="cuda")
            strides = (ctypes.c_longlong * 12)(*(
                list(q.stride()[:3]) + list(k.stride()[:3])
                + list(v.stride()[:3]) + list(o.stride()[:3])))
            sc = d ** -0.5
            out = {"shape": [bh, s, t, d]}
            ref = {}
            order = list(libs.items())
            for turn in (order, order[::-1]):
                for name, lib in turn:
                    for entry in ENTRIES:
                        fn = getattr(lib, entry)

                        def call():
                            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    o.data_ptr(), lse.data_ptr(), 1, bh, s,
                                    t, d, strides, sc,
                                    torch.cuda.current_stream().cuda_stream)
                            if rc:
                                raise RuntimeError(f"{name} {entry}: CUDA "
                                                   f"error {rc}")
                        call()
                        torch.cuda.synchronize()
                        key = f"{name}:{entry}"
                        if key not in out:
                            if name == "package" and entry == ENTRIES[0]:
                                ref = {"o": o.clone(), "lse": lse.clone()}
                            rec = {"ms": []}
                            if ref:
                                diff = (o.float() - ref["o"].float())
                                rec.update(
                                    same_bits=bool(torch.equal(o, ref["o"])
                                                   and torch.equal(
                                                       lse, ref["lse"])),
                                    rel_l2=(diff.norm() / ref["o"].float()
                                            .norm()).item())
                            out[key] = rec
                        out[key]["ms"].append(
                            kernel_variants.time_ms(call, args.iters))
            for name, _, _, new_text in builds:
                if new_text is not None and name in info and not (
                        name in PROBES):
                    for entry in ENTRIES:
                        if not out[f"{name}:{entry}"].get("same_bits"):
                            out[f"{name}:{entry}"]["NOT_THE_PACKAGE_BITS"] = 1
            print(json.dumps(out), flush=True)
            lines.append(out)
            del q, k, v, o, lse, ref
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)


if __name__ == "__main__":
    main()
