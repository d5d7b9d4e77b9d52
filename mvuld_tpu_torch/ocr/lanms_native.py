"""ctypes binding for the C++ locality-aware NMS (``native/lanms.cpp``).

Counterpart of ``mvuld_tpu/ocr/lanms_native.py``: the same source, compiled
with ``g++ -O3`` on first use into the port's own build directory,
``build/mvuld_tpu_torch/liblanms-<hash>.so`` at the root of the checkout
(beside the CUDA libraries of ``ops/_build.py``; ``build/`` is
git-ignored), never into ``native/build/``. The hash covers the source and
the flags, so an edited source rebuilds. ``ocr/detect.py`` falls back to
its numpy NMS when this does not build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC = os.path.join(_REPO, "native", "lanms.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "mvuld_tpu_torch")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LOCK = threading.Lock()
_lib = None


def library_path() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"liblanms-{digest.hexdigest()[:16]}.so")


def load() -> ctypes.CDLL:
    """Build (once) and load the library; raises when it cannot."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(["g++", *FLAGS, SRC, "-o", tmp], check=True,
                           capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.lanms_merge_quadrangle.restype = ctypes.c_int
        lib.lanms_merge_quadrangle.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return lib


def merge_quadrangle_n9(polys: np.ndarray, thresh: float = 0.2) -> np.ndarray:
    """[n, 9] float32 quads+score → kept/merged [m, 9]."""
    polys = np.ascontiguousarray(polys, np.float32)
    n = polys.shape[0]
    if n == 0:
        return polys
    lib = load()
    out = np.zeros_like(polys)
    kept = lib.lanms_merge_quadrangle(
        polys.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
        ctypes.c_float(thresh),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out[:kept]
