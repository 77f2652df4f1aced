"""Host uint8 image ops through the repository's native library.

Counterpart of ``diffute_tpu/io/hostops.py`` for what the edit path needs:
``resize_bilinear_u8``, the cv2 ``INTER_LINEAR`` uint8 resize, computed by
``native/hostops.cpp`` (cv2's fixed-point arithmetic: bit-identical for
downscales, within 1 LSB on a few border pixels of upscales; pinned by
tests/test_hostops.py).  The port does not import cv2.  The library is
compiled by the host C++ compiler at first use (``ops._build``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import numpy as np

from diffute_tpu_torch.ops._build import build_shared_library

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                    "native", "hostops.cpp"))
# no -march=native: the build directory may travel with the checkout to
# another host, and the fixed-point arithmetic is the same either way
_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            cxx = shutil.which("c++") or shutil.which("g++")
            if cxx is None:
                raise RuntimeError("no C++ compiler for native/hostops.cpp")
            lib = ctypes.CDLL(build_shared_library("hostops", [cxx, *_FLAGS],
                                                   [_SRC]))
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i = ctypes.c_int
            lib.resize_bilinear_u8.argtypes = [u8p, i, i, i, u8p, i, i]
            lib.resize_bilinear_u8.restype = None
            _lib = lib
        return _lib


def resize_bilinear_u8(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """cv2.resize(INTER_LINEAR)-compatible uint8 resize (HWC or HW)."""
    squeeze = src.ndim == 2
    src = np.ascontiguousarray(src[..., None] if squeeze else src,
                               dtype=np.uint8)
    sh, sw, c = src.shape
    out = np.empty((dh, dw, c), np.uint8)
    _load().resize_bilinear_u8(src, sh, sw, c, out, dh, dw)
    return out[..., 0] if squeeze else out
