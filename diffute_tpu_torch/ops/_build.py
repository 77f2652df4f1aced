"""Build and load the port's native code at first use.

``load()`` compiles every CUDA source under ``diffute_tpu_torch/csrc/`` with
``nvcc`` for ``sm_90a`` into one shared library with a plain C interface and
loads it with ``ctypes``.  :func:`build_shared_library` is the one place
that compiles: into ``diffute_tpu_torch/_build/`` (listed in ``.gitignore``),
under a name keyed by a hash of the sources and the command, so an edited
source is rebuilt and an unchanged one reused.  Nothing happens at import
time: this module is imported on machines without ``nvcc``.
"""

from __future__ import annotations

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


def load() -> ctypes.CDLL:
    """Return the CUDA kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
            if not srcs:
                raise RuntimeError(f"no CUDA sources under {CSRC}")
            so = build_shared_library(
                "diffute_kernels", [_nvcc(), *NVCC_FLAGS], srcs,
                hashed=sorted(glob.glob(os.path.join(CSRC, "*.cuh"))))
            lib = ctypes.CDLL(so)
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.flash_fwd_bf16.argtypes = [p, p, p, p, p, i, i, i,
                                           ctypes.c_float, p]
            lib.flash_fwd_bf16.restype = i
            # (q, k, v, dO, lse, delta, dq | dk, dv, bh, S, T, scale, stream)
            lib.flash_bwd_dq_bf16.argtypes = [p] * 7 + [i, i, i,
                                                        ctypes.c_float, p]
            lib.flash_bwd_dq_bf16.restype = i
            lib.flash_bwd_dkv_bf16.argtypes = [p] * 8 + [i, i, i,
                                                         ctypes.c_float, p]
            lib.flash_bwd_dkv_bf16.restype = i
            _lib = lib
        return _lib
