"""ctypes bindings for the native final-level builder (final_builder.cpp)."""

from __future__ import annotations

import ctypes

import numpy as np

from .loader import _lib


def _bind(lib):
    if getattr(lib, "_final_bound", False):
        return lib
    lib.stpu_final_build.restype = ctypes.c_longlong
    lib.stpu_final_build.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.stpu_final_spills.restype = ctypes.c_longlong
    lib.stpu_final_spills.argtypes = [ctypes.c_void_p]
    lib.stpu_final_copy.restype = None
    lib.stpu_final_copy.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.stpu_final_free.restype = None
    lib.stpu_final_free.argtypes = [ctypes.c_void_p]
    lib._final_bound = True
    return lib


def available() -> bool:
    try:
        lib = _lib()
        return lib is not None and hasattr(lib, "stpu_final_build")
    except Exception:
        return False


def final_build_native(rows: np.ndarray, pos: np.ndarray, nt_pad: int,
                       tps: int, G: int, nw: int, inst_cap: int = 8):
    """Run the C++ builder: children (rows, pos) must be sorted by row.
    Returns (step_meta, cells, route, spill_pos, spill_row)."""
    lib = _bind(_lib())
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    handle = ctypes.c_void_p()
    n_steps = lib.stpu_final_build(
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_longlong(rows.shape[0]), ctypes.c_longlong(nt_pad),
        ctypes.c_int(tps), ctypes.c_int(G), ctypes.c_int(nw),
        ctypes.c_int(inst_cap), ctypes.byref(handle))
    if n_steps < 0:
        raise RuntimeError("stpu_final_build failed")
    n_steps = int(n_steps)
    n_spills = int(lib.stpu_final_spills(handle))
    step_meta = np.empty((n_steps, nw + 2), dtype=np.int32)
    cells = np.empty((n_steps * tps * 8, 128), dtype=np.int16)
    route = np.empty((n_steps * tps * 8, 128), dtype=np.int8)
    spill_pos = np.empty(max(n_spills, 1), dtype=np.int32)
    spill_row = np.empty(max(n_spills, 1), dtype=np.int32)
    try:
        lib.stpu_final_copy(
            handle,
            step_meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cells.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            route.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            spill_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            spill_row.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    finally:
        lib.stpu_final_free(handle)
    return (step_meta, cells, route, spill_pos[:n_spills],
            spill_row[:n_spills])
