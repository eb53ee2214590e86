"""Build the port's CUDA sources into one shared library and load it.

The fused SpMV, the k-plane forward and the row-sorted final
(``final_rows.cu``, the classic devices' final level, one plane or k)
template their kernels on the real type: one source holds a kernel's f32
and f64 (native FP64) forms, each behind its own entry point; the classic
forward's f64 form is its own kernel over the live slots
(``gstream_spmv.cu``).  The BSR
partials (``bsr_spmv.cu``) are f32 only, as the TPU's BSR device; the
stage ladder (``micro_ladder.cu``, ``bench/micro.py``), the fused
kernel's stage split (``fused_stages.cu``, ``bench/fused_stages.py``), the
fused-redesign prototypes (``fused_proto.cu``, ``bench/fused_proto.py``)
and the select chains (``select_chains.cu``, ``bench/select_chains.py``)
are measurement kernels.

``nvcc`` compiles ``sparsetpu_torch/csrc/*.cu`` for ``sm_90a`` into
``build/sparsetpu_torch/`` beside the package, at first use: one compiler
per source, all at once, then one link.  The library
exposes plain C entry points, bound with ctypes (every pointer and the
stream as ``c_void_p``), so nothing includes PyTorch's headers and a build
takes seconds; the build or load is ``utils/timing.py:SETUP``'s phase
``csrc``.  The file name carries a hash of the sources, the headers
beside them and the flags: an edited ``.cu`` or ``.cuh`` builds a new
library.  A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

from ..utils.timing import SETUP

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "sparsetpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class _Library:
    """The loaded library, and what nvcc said while building it."""

    def __init__(self):
        self.lib = None
        self.path = None
        self.log = ""


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


def _compile_and_link(sources, out: str) -> str:
    """One nvcc per source, all started together, then one link into
    ``out``; returns what the compilers printed (``-Xptxas -v``)."""
    nvcc = _nvcc()
    procs = []
    for src in sources:
        obj = f"{out}.{os.path.basename(src)}.o"
        procs.append((obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for obj, proc in procs:
        _, err = proc.communicate(timeout=600)
        log.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {obj} (rc={proc.returncode}):\n"
                          f"{err[-8000:]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    objs = [obj for obj, _ in procs]
    proc = subprocess.run([nvcc, "-shared", "-o", out, *objs],
                          capture_output=True, text=True, timeout=600)
    for obj in objs:
        os.remove(obj)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed (rc={proc.returncode}):\n"
                           f"{proc.stderr[-8000:]}")
    return "".join(log)


def library() -> _Library:
    """Build (if needed) and load the kernels' library."""
    if _LIBRARY.lib is not None:
        return _LIBRARY
    with SETUP.phase("csrc"):
        sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
        headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sources + headers:
            with open(src, "rb") as f:
                h.update(f.read())
        path = os.path.join(BUILD_DIR,
                            f"libsparsetpu_torch_{h.hexdigest()[:16]}.so")
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            _LIBRARY.log = _compile_and_link(sources, tmp)
            os.replace(tmp, path)   # atomic: concurrent builds agree
        lib = ctypes.CDLL(path)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # the fused SpMV: a plan (``spmv_fused._Plan``) built once, then a call
    lib.fused_spmv_prepare.restype = i
    lib.fused_spmv_prepare.argtypes = [p]
    lib.fused_spmv_run.restype = i
    lib.fused_spmv_run.argtypes = [p, p, ll, p, p, p]
    lib.gstream_spmv_launch.restype = i
    lib.gstream_spmv_launch.argtypes = [p, i] + [p] * 5 + [ll] + [i] * 4 \
        + [p]
    # the fused SpMM: the same plan, then a call on k planes
    lib.fused_spmm_prepare.restype = i
    lib.fused_spmm_prepare.argtypes = [p]
    lib.fused_spmm_run.restype = i
    lib.fused_spmm_run.argtypes = [p, p, ll, i, i, p, p, p]
    lib.gstream_spmm_launch.restype = i
    lib.gstream_spmm_launch.argtypes = [p, i] + [p] * 5 + [ll] + [i] * 6 \
        + [p]
    # f64 (native FP64) entry points
    lib.live_slots_f64_launch.restype = i
    lib.live_slots_f64_launch.argtypes = [p] * 6 + [i, p]
    lib.gstream_spmm_f64_launch.restype = i
    lib.gstream_spmm_f64_launch.argtypes = [p] * 5 + [ll] + [i] * 5 + [p]
    lib.final_rows_launch.restype = i
    lib.final_rows_launch.argtypes = [p] * 4 + [ll, i, p, p]
    lib.final_rows_f64_launch.restype = i
    lib.final_rows_f64_launch.argtypes = [p] * 4 + [ll, i, p, p]
    lib.final_rows_multi_launch.restype = i
    lib.final_rows_multi_launch.argtypes = [i] + [p] * 4 + [ll, i, i, i, p,
                                                             p]
    lib.bsr_spmv_launch.restype = i
    lib.bsr_spmv_launch.argtypes = [p] * 4 + [ll, p]
    lib.micro_ladder_launch.restype = i
    lib.micro_ladder_launch.argtypes = [i] + [p] * 6 + [ll] + [i] * 3 + [p]
    lib.fused_stage_launch.restype = i
    lib.fused_stage_launch.argtypes = [i] + [p] * 8 + [i] * 8 + [p]
    lib.tile_ladder_launch.restype = i
    lib.tile_ladder_launch.argtypes = [i] + [p] * 6 + [i] * 4 + [p]
    lib.fused_proto_launch.restype = i
    lib.fused_proto_launch.argtypes = [p] * 8 + [i] * 5 + [p]
    lib.streams_launch.restype = i
    lib.streams_launch.argtypes = [i, p, i, p, p, p, i, i, p]
    lib.select_chains_launch.restype = i
    lib.select_chains_launch.argtypes = [i, i] + [p] * 7 + [ll] + [i] * 6 \
        + [p]
    lib.sparsetpu_error_string.restype = ctypes.c_char_p
    lib.sparsetpu_error_string.argtypes = [i]
    _LIBRARY.lib, _LIBRARY.path = lib, path
    return _LIBRARY


def vector_width(k: int, *tensors) -> int:
    """The plane vector's width W of a k-plane kernel: the most values, 4,
    2 or 1 and at most 16 B, that divide k and whose size every tensor's
    address is a multiple of (``csrc/vec.cuh``)."""
    elt = tensors[0].element_size()
    for w in (4, 2):
        if w * elt <= 16 and k % w == 0 and all(
                t.data_ptr() % (w * elt) == 0 for t in tensors):
            return w
    return 1


def check(lib, rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        msg = lib.sparsetpu_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
