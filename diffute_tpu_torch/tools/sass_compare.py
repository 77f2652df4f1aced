"""Compare the machine code of the port's CUDA sources in two checkouts:
each kernel's SASS, instruction by instruction.

  python -m diffute_tpu_torch.tools.sass_compare OTHER_CSRC
      [SOURCE.cu ...] [--out FILE]

Builds each SOURCE (by default every ``csrc/*.cu`` that both checkouts
have) from the package's ``csrc/`` and from ``OTHER_CSRC`` (another
checkout's, e.g. its parent unpacked by ``git archive``) to a cubin with
the package's ``nvcc`` flags, disassembles both with ``cuobjdump -sass``
and, for every kernel either defines, prints its instruction count on each
side and how many instructions differ (``kernel_variants.sass``: the
per-file anonymous-namespace tags in the kernel names and the instruction
offsets are left out and branch labels read as the offsets they stand
for, so a kernel whose code did not move reads 0).  A change that only
moves shared code into a header should leave every kernel at 0.  Prints one JSON
object, writes it to ``--out`` if given.  Needs ``nvcc`` and
``cuobjdump`` (the CUDA toolkit), not a card.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile

from diffute_tpu_torch.tools import kernel_variants


def sass(csrc: str, source: str, out_dir: str) -> dict:
    """{kernel name: [instruction]} of one source built from ``csrc``."""
    path = kernel_variants.cubin(
        os.path.join(csrc, source),
        os.path.join(out_dir, f"{abs(hash(csrc))}_{source}.cubin"))
    return {name: [ins for _, ins in listing]
            for name, listing in kernel_variants.sass(path).items()}


def main(argv=None) -> None:
    from diffute_tpu_torch.ops import _build

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("other_csrc")
    p.add_argument("sources", nargs="*")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sources = args.sources or sorted(
        os.path.basename(x) for x in glob.glob(os.path.join(_build.CSRC,
                                                            "*.cu"))
        if os.path.exists(os.path.join(args.other_csrc, os.path.basename(x))))
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        for source in sources:
            ours = sass(_build.CSRC, source, tmp)
            theirs = sass(args.other_csrc, source, tmp)
            for name in sorted(set(ours) | set(theirs)):
                a, b = theirs.get(name), ours.get(name)
                rec = {"other": None if a is None else len(a),
                       "this": None if b is None else len(b)}
                if a is not None and b is not None:
                    rec["differing"] = (sum(x != y for x, y in zip(a, b))
                                        + abs(len(a) - len(b)))
                report[f"{source}:{name}"] = rec
    print(json.dumps(report, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
