"""What the tools that time or read variant builds of the port's CUDA
sources share: the card's name and power limit, a CUDA-event median,
builds with the package's ``nvcc`` flags (a changed copy of a source, a
variant file into the package's build directory, a cubin), ptxas's
registers and spills by kernel, and each kernel's SASS.

Used by ``narrow_w16_probes``, ``fp32_d256_fwd_variants``,
``fp32_d512_bwd_variants``, ``w8_fp32_probes`` and ``sass_compare``.  The
builds need ``nvcc`` and the SASS ``cuobjdump`` (the CUDA toolkit); the
timing needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import glob
import os
import re
import shutil
import statistics
import subprocess


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def time_ms(fn, iters: int) -> float:
    """Median device time of ``fn`` over ``iters`` calls (CUDA events), each
    behind a short device sleep so that the host's launch is not timed."""
    import torch

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


def cubin_flags() -> list:
    """The package's ``nvcc`` flags without the shared library's."""
    from diffute_tpu_torch.ops import _build

    return [f for f in _build.NVCC_FLAGS
            if f not in ("-shared", "-Xcompiler", "-fPIC")]


def cubin(path: str, out: str) -> str:
    """``path`` compiled to the cubin ``out`` with the package's flags."""
    from diffute_tpu_torch.ops import _build

    subprocess.run([_build._nvcc(), *cubin_flags(), "-cubin", "-o", out,
                    path], check=True, capture_output=True, text=True)
    return out


def build_copy(csrc: str, source: str, text, root: str, name: str,
               with_cubin: bool = False) -> tuple:
    """``source`` of ``csrc`` (its text replaced by ``text`` unless None)
    built in a copy of ``csrc`` at ``root/name``, so that it includes that
    checkout's headers: (library path, cubin path or None, ptxas -v's
    output)."""
    from diffute_tpu_torch.ops import _build

    d = os.path.join(root, name)
    shutil.copytree(csrc, d)
    path = os.path.join(d, source)
    if text is not None:
        with open(path, "w") as f:
            f.write(text)
    so = os.path.join(d, "variant.so")
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                          "-o", so, path], capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"{name} did not build:\n{res.stderr[-3000:]}")
    out = cubin(path, os.path.join(d, "variant.cubin")) if with_cubin else None
    return so, out, res.stderr


def build_library(path: str) -> ctypes.CDLL:
    """A variant file of a package source, anywhere, built into the
    package's build directory with the package's flags and headers (a
    header beside ``path`` comes first, and keys the build too)."""
    from diffute_tpu_torch.ops import _build

    command = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC]
    headers = sorted(glob.glob(os.path.join(_build.CSRC, "*.cuh")))
    local = sorted(glob.glob(os.path.join(os.path.dirname(path), "*.cuh")))
    stem = os.path.splitext(os.path.basename(path))[0]
    return ctypes.CDLL(_build.build_shared_library(
        f"variant_{stem}", command, [path], hashed=headers + local))


def ptxas_by_kernel(stderr: str) -> dict:
    """{kernel: {registers, spill_bytes}} from ptxas -v's output."""
    out, cur = {}, None
    for line in stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and cur:
            out.setdefault(cur, {})["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


def sass(cubin_path: str) -> dict:
    """{kernel name: [(offset, instruction)]} of a cubin by ``cuobjdump
    -sass``: the anonymous namespace's tags left out of the names (a hash
    after _GLOBAL__N__ and, in some builds, another after the file's name),
    each instruction's text up to its ``;``, and branch targets given as
    labels turned into the offsets they stand for, so that a kernel whose
    code did not move reads the same from any build."""
    from diffute_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", cubin_path], check=True,
                          capture_output=True, text=True).stdout
    text = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", text)
    text = re.sub(r"(_cuh?)_[0-9a-f]{8}(?=\d)", r"\1_", text)
    kernels, labels, name, pending = {}, {}, None, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name], labels[name], pending = [], {}, []
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if name is not None and m:
            addr = int(m.group(1), 16)
            labels[name].update(dict.fromkeys(pending, addr))
            pending = []
            kernels[name].append((addr, re.sub(r"\s+", " ", m.group(2))))
    return {name: [(a, re.sub(r"`\((\.L_x_\d+)\)",
                              lambda m: hex(labels[name].get(m.group(1), -1)),
                              t)) for a, t in ins]
            for name, ins in kernels.items()}
