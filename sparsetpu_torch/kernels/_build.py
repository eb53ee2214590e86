"""Build the port's CUDA sources into one shared library and load it.

``nvcc`` compiles ``sparsetpu_torch/csrc/*.cu`` for ``sm_90a`` into
``build/sparsetpu_torch/`` beside the package, at first use.  The library
exposes plain C entry points, bound with ctypes (every pointer and the
stream as ``c_void_p``), so nothing includes PyTorch's headers and a build
takes seconds.  The file name carries a hash of the sources and flags: an
edited ``.cu`` builds a new library.  A failed build raises with nvcc's
stderr.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "sparsetpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class _Library:
    """The loaded library, and what nvcc said while building it."""

    def __init__(self):
        self.lib = None
        self.path = None
        self.log = ""
        self.build_s = 0.0


_LIBRARY = _Library()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built")
    return path


def library() -> _Library:
    """Build (if needed) and load the kernels' library."""
    if _LIBRARY.lib is not None:
        return _LIBRARY
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR,
                        f"libsparsetpu_torch_{h.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (rc={proc.returncode}):\n"
                               f"{proc.stderr[-8000:]}")
        os.replace(tmp, path)   # atomic: concurrent builds agree
        _LIBRARY.log = proc.stderr
    _LIBRARY.build_s = time.perf_counter() - t0
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_spmv_launch.restype = i
    lib.fused_spmv_launch.argtypes = [p] * 12 + [i] * 11 + [p]
    lib.sparsetpu_error_string.restype = ctypes.c_char_p
    lib.sparsetpu_error_string.argtypes = [i]
    _LIBRARY.lib, _LIBRARY.path = lib, path
    return _LIBRARY


def check(lib, rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        msg = lib.sparsetpu_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
