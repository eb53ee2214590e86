"""ctypes bindings for the native GStream pack engine (packer.cpp)."""

from __future__ import annotations

import ctypes

import numpy as np

from .loader import _lib


def _bind(lib):
    if getattr(lib, "_pack_bound", False):
        return lib
    lib.stpu_pack_block_q.restype = ctypes.c_longlong
    lib.stpu_pack_block_q.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_longlong, ctypes.c_int32, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.stpu_pack_copy_q.restype = None
    lib.stpu_pack_copy_q.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.stpu_pack_free.restype = None
    lib.stpu_pack_free.argtypes = [ctypes.c_void_p]
    lib.stpu_pack_v2.restype = ctypes.c_longlong
    lib.stpu_pack_v2.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
        ctypes.c_int32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.stpu_pack_copy_v2.restype = None
    lib.stpu_pack_copy_v2.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.stpu_pack_v2_free.restype = None
    lib.stpu_pack_v2_free.argtypes = [ctypes.c_void_p]
    lib.stpu_fused_finish.restype = ctypes.c_longlong
    lib.stpu_fused_finish.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.stpu_fused_finish_copy.restype = None
    lib.stpu_fused_finish_copy.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int8),
    ]
    lib.stpu_fused_finish_free.restype = None
    lib.stpu_fused_finish_free.argtypes = [ctypes.c_void_p]
    lib._pack_bound = True
    return lib


def fused_finish_native(orow, sub, lane, scr_rows: int,
                        max_f1: int = 32, f1_drain: int = 32,
                        direct: bool = False, l1_keys: int = 0):
    """Two-stage finish build for the fused layout (see packer.cpp).
    Children must be sorted by orow.  Returns (cells1 (n1*8, 128) i16,
    route1 i8, group2 (n2,) i32, cells2 (n2*8, 128) i16, route2 i8) or
    None when stage 1 overflows ``max_f1`` tiles."""
    lib = _bind(_lib())
    orow = np.ascontiguousarray(orow, dtype=np.int32)
    sub = np.ascontiguousarray(sub, dtype=np.int32)
    lane = np.ascontiguousarray(lane, dtype=np.int32)
    handle = ctypes.c_void_p()
    packed = lib.stpu_fused_finish(
        orow.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        sub.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lane.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_longlong(orow.shape[0]), ctypes.c_int(max_f1),
        ctypes.c_int(1 if direct else 0), ctypes.c_int(l1_keys),
        ctypes.byref(handle))
    if packed < 0:
        return None
    n1 = int(packed >> 32)
    n2 = int(packed & 0xFFFFFFFF)
    cells1 = np.empty((n1 * 8, 128), dtype=np.int16)
    route1 = np.empty((n1 * 8, 128), dtype=np.int8)
    group2 = np.empty(n2, dtype=np.int32)
    cells2 = np.empty((n2 * 8, 128), dtype=np.int16)
    route2 = np.empty((n2 * 8, 128), dtype=np.int8)
    try:
        lib.stpu_fused_finish_copy(
            handle, ctypes.c_int(scr_rows), ctypes.c_int(f1_drain),
            cells1.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            route1.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            group2.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cells2.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            route2.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    finally:
        lib.stpu_fused_finish_free(handle)
    return cells1, route1, group2, cells2, route2


def pack_v2_native(rows, cols, vals, trap_row: int, q: int, GL: int,
                   G: int, max_open: int = 0, slab_rows: int = 0,
                   lane_shuffle=False):
    """v2 pack of one column block from raw row-sorted triplets; returns
    (values, cells[relative], route, chunk_row, tile_base).

    ``lane_shuffle`` is the lane mode: False/0 = rank order, True/1 =
    per-tile 37-stride shuffle, 2 = row-keyed (lane = row & 127, the
    scattered-regime mode — see packer.cpp stpu_pack_v2)."""
    lib = _bind(_lib())
    if not max_open:
        max_open = DEFAULT_MAX_OPEN.get(q, 16)
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    handle = ctypes.c_void_p()
    n_tiles = lib.stpu_pack_v2(
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_longlong(rows.shape[0]), ctypes.c_int32(trap_row),
        ctypes.c_int(q), ctypes.c_int(GL), ctypes.c_int(G),
        ctypes.c_int(max_open), ctypes.c_int(slab_rows),
        ctypes.c_int(int(lane_shuffle)),
        ctypes.byref(handle))
    if n_tiles < 0:
        raise RuntimeError("stpu_pack_v2 failed")
    n_tiles = int(n_tiles)
    planes = 8 // q
    values = np.empty((n_tiles * 8, 128), dtype=np.float32)
    cells = np.empty((n_tiles * 8, 128), dtype=np.int16)
    route = np.empty((n_tiles * 8, 128), dtype=np.int16)
    chunk_row = np.empty((n_tiles * planes, 128), dtype=np.int32)
    tile_base = np.empty((n_tiles,), dtype=np.int32)
    try:
        lib.stpu_pack_copy_v2(
            handle, ctypes.c_int(q),
            values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            cells.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            route.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            chunk_row.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            tile_base.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    finally:
        lib.stpu_pack_v2_free(handle)
    return values, cells, route.astype(np.int8), chunk_row, tile_base


# First-fit window (open tiles tried per chunk).  Small quanta give each
# chunk fewer slot choices, so the matcher needs more open tiles to keep
# fill high: measured on the 10M-nnz headline matrix, Q=2 packs at fill
# 0.21 with 8 open tiles but 0.92 with 64 (pack time ~2x, still seconds).
DEFAULT_MAX_OPEN = {8: 16, 4: 32, 2: 64, 1: 64}


def pack_block_native(prow, pcol, pval, preal, trap_row: int,
                      max_open: int = 0, q: int = 8):
    """Pack one column block's padded chunk stream; returns
    (values, cells, route, chunk_row) with the gather_stream layout."""
    lib = _bind(_lib())
    if not max_open:
        max_open = DEFAULT_MAX_OPEN.get(q, 16)
    prow = np.ascontiguousarray(prow, dtype=np.int32)
    pcol = np.ascontiguousarray(pcol, dtype=np.int32)
    pval = np.ascontiguousarray(pval, dtype=np.float32)
    preal = np.ascontiguousarray(preal, dtype=np.uint8)
    handle = ctypes.c_void_p()
    n_tiles = lib.stpu_pack_block_q(
        prow.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pcol.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pval.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        preal.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_longlong(prow.shape[0]), ctypes.c_int32(trap_row),
        ctypes.c_int(max_open), ctypes.c_int(q), ctypes.byref(handle))
    if n_tiles < 0:
        raise RuntimeError("stpu_pack_block_q failed")
    n_tiles = int(n_tiles)
    planes = 8 // q
    values = np.empty((n_tiles * 8, 128), dtype=np.float32)
    cells = np.empty((n_tiles * 8, 128), dtype=np.int16)
    route = np.empty((n_tiles * 8, 128), dtype=np.int16)
    chunk_row = np.empty((n_tiles * planes, 128), dtype=np.int32)
    try:
        lib.stpu_pack_copy_q(
            handle, ctypes.c_int(q),
            values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            cells.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            route.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            chunk_row.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    finally:
        lib.stpu_pack_free(handle)
    # residues are < 128: int8 stream (12% less kernel traffic)
    return values, cells, route.astype(np.int8), chunk_row


def available() -> bool:
    try:
        _bind(_lib())
        return True
    except Exception:
        return False
