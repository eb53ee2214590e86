"""ctypes bindings to the native host runtime (libsparsetpu_native.so).

The library is built from this directory's C++ sources by its ``Makefile``
into ``build/sparsetpu_torch/native/`` beside the package, at first use; a
failed build raises with the compiler's stderr.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_LIB_NAME = "libsparsetpu_native.so"
_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "sparsetpu_torch", "native")
LIB_PATH = os.path.join(BUILD_DIR, _LIB_NAME)


def _build() -> None:
    """``make`` the library into BUILD_DIR (make skips an up-to-date one)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    try:
        proc = subprocess.run(["make", "-C", _HERE, f"LIB={LIB_PATH}"],
                              capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(f"cannot build {_LIB_NAME}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"building {_LIB_NAME} failed (rc="
                           f"{proc.returncode}):\n{proc.stderr[-4000:]}")


def _lib():
    global _LIB
    if _LIB is None:
        _build()
        lib = ctypes.CDLL(LIB_PATH)
        lib.stpu_count_triplets.restype = ctypes.c_longlong
        lib.stpu_count_triplets.argtypes = [ctypes.c_char_p]
        lib.stpu_read_triplets.restype = ctypes.c_longlong
        lib.stpu_read_triplets.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_longlong,
        ]
        _LIB = lib
    return _LIB


def read_triplets(path: str, pattern: bool = False):
    """Parse a triplet/.mtx body natively; returns (rows, cols, vals) as
    0-based numpy arrays (the 1-based conversion of csr.cpp:118 included)."""
    lib = _lib()
    cpath = path.encode()
    n = lib.stpu_count_triplets(cpath)
    if n < 0:
        raise IOError(f"native loader failed to open {path!r}")
    rows = np.empty(n, dtype=np.int32)
    cols = np.empty(n, dtype=np.int32)
    vals = np.empty(n, dtype=np.float64)
    got = lib.stpu_read_triplets(
        cpath, ctypes.c_int(1 if pattern else 0),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)
    if got < 0:
        raise IOError(f"native loader failed parsing {path!r}")
    return rows[:got], cols[:got], vals[:got]
