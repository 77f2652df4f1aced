"""Build and load the port's native code at first use.

``load()`` compiles every CUDA source under ``diffute_tpu_torch/csrc/`` with
``nvcc`` for ``sm_90a`` (one compiler process per source, all at once) into
shared libraries with a plain C interface and loads them with ``ctypes``.  :func:`build_shared_library` is the one place
that compiles: into ``diffute_tpu_torch/_build/`` (listed in ``.gitignore``),
under a name keyed by a hash of the sources and the command, so an edited
source is rebuilt and an unchanged one reused.  Nothing happens at import
time: this module is imported on machines without ``nvcc``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None


def build_shared_library(stem: str, command: Sequence[str],
                         sources: Sequence[str],
                         hashed: Sequence[str] = ()) -> str:
    """Compile ``command + ["-o", out] + sources`` into
    ``BUILD_DIR/lib<stem>_<hash>.so`` unless it exists; return its path.
    ``hashed`` lists extra files (headers) whose content keys the build.
    Raises ``RuntimeError`` with the compiler's stderr on failure."""
    h = hashlib.sha256(" ".join(command[1:]).encode())
    for path in list(sources) + list(hashed):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [*command, "-o", tmp, *sources]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"build failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
    return so


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from source at first use")


def _signatures() -> dict:
    """Exported function name -> ctypes argument types (all return int, the
    launch's cudaGetLastError())."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # (q, k, v, o, lse, B, H, S, T, 12 element strides, scale, stream)
    fwd = [p] * 5 + [i] * 4 + [ctypes.POINTER(ctypes.c_longlong), f, p]
    bwd = [p] * 8 + [i] * 4 + [ctypes.POINTER(ctypes.c_longlong), f, p]
    return {
        "flash_fwd_bf16": fwd,
        "flash_fwd_pipelined_bf16": fwd,
        # (q, k, v, o, dO, lse, delta, dq | q, k, v, dO, lse, delta, dk, dv;
        #  B, H, S, T, 18 element strides, scale, stream)
        "flash_bwd_dq_bf16": bwd,
        "flash_bwd_dkv_bf16": bwd,
        # the same four at head_dim 512 and 256 (csrc/flash_wide.cu)
        "flash_fwd_d512_bf16": fwd,
        "flash_fwd_pipelined_d512_bf16": fwd,
        "flash_bwd_dq_d512_bf16": bwd,
        "flash_bwd_dkv_d512_bf16": bwd,
        "flash_fwd_d256_bf16": fwd,
        "flash_fwd_pipelined_d256_bf16": fwd,
        "flash_bwd_dq_d256_bf16": bwd,
        "flash_bwd_dkv_d256_bf16": bwd,
        # the same four on fp32 inputs at head_dim 64, 256 and 512
        # (csrc/flash_fp32.cu)
        **{f"flash_{kind}{width}_fp32": bwd if kind.startswith("bwd") else fwd
           for kind in ("fwd", "fwd_pipelined", "bwd_dq", "bwd_dkv")
           for width in ("", "_d256", "_d512")},
        # (x, mean, rstd, B*G, n_elem, cluster, threads, eps, stream), bf16
        # and fp32 x
        **{f"gn_stats_{t}": [p] * 3 + [i] * 4 + [f, p]
           for t in ("bf16", "fp32")},
        # (x, gamma, beta, affine_bf16, y, B, C, HW, groups, cluster, threads,
        #  staged, eps, stream), bf16 and fp32 x and y
        **{f"gn_silu_{t}": [p, p, p, i, p] + [i] * 7 + [f, p]
           for t in ("bf16", "fp32")},
        # (x, mean, rstd, gamma, beta, gn_bf16, wp, bias, bias_bf16, out,
        #  partial, B, Cin, Cout, H, W, groups, tiles, splits, stream)
        "gn_silu_conv3x3_bf16": [p] * 5 + [i, p, p, i, p, p] + [i] * 8 + [p],
        # (x, mean, rstd, gamma, beta, gn_bf16, w, bias, bias_bf16, out,
        #  partial, B, Cin, Cout, H, W, groups, splits, stream), fp32 x, w
        #  and out (csrc/conv_fused_fp32.cu)
        "gn_silu_conv3x3_fp32": [p] * 5 + [i, p, p, i, p, p] + [i] * 7 + [p],
        # (x, packed q, scale, scale_bf16, bias, y, workspace, tickets, M, N,
        #  K, tokens per block, splits, stream)
        "w8_matmul_bf16": [p, p, p, i, p, p, p, p] + [i] * 5 + [p],
        # (x, q, scale, scale_bf16, bias, y, M, N, K, stream), fp32 x and y
        # (csrc/quant_fp32.cu)
        "w8_matmul_fp32": [p, p, p, i, p, p] + [i] * 3 + [p],
    }


def ptxas_info(source: str) -> str:
    """What ``nvcc -Xptxas -v`` says of one source under ``csrc/`` (each
    kernel's registers, shared memory, stack frame and spills), compiled with
    the build's flags to a discarded cubin."""
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    res = subprocess.run([_nvcc(), *flags, "-Xptxas", "-v", "-cubin", "-o",
                          os.devnull, os.path.join(CSRC, source)],
                         capture_output=True, text=True, check=True)
    return res.stderr.strip()


class _Kernels:
    """The exported kernel launchers, gathered from the per-source
    libraries."""


def load() -> _Kernels:
    """Return the CUDA kernel launchers, building their libraries first if
    needed: one ``nvcc`` per source under ``csrc/``, all started together,
    each into its own shared library."""
    global _lib
    with _lock:
        if _lib is None:
            srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
            if not srcs:
                raise RuntimeError(f"no CUDA sources under {CSRC}")
            command = [_nvcc(), *NVCC_FLAGS]
            headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))

            def build(src):
                stem = os.path.splitext(os.path.basename(src))[0]
                return build_shared_library(f"diffute_{stem}", command, [src],
                                            hashed=headers)

            with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
                libs = [ctypes.CDLL(so) for so in pool.map(build, srcs)]
            kernels = _Kernels()
            for name, argtypes in _signatures().items():
                fn = next((getattr(lib, name) for lib in libs
                           if hasattr(lib, name)), None)
                if fn is None:
                    raise RuntimeError(f"no built library exports {name}")
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                setattr(kernels, name, fn)
            _lib = kernels
        return _lib
