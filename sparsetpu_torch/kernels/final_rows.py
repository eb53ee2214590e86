"""The final level of the classic devices as a row-sorted gather-sum on the
card (counterpart of the JAX ``_FinalLevel``, ``_FinalLevelV2`` and
``_FinalLevelMulti`` ``apply`` and of their kernels #4, #5 and #12, and of
the k-plane finals ``_final_v2_sums_multi`` and ``_final_gather_sums_multi``
and their kernels #8 and #9).

A final level is a fixed 0/1 map from positions (the chunk sums and the F
levels' outputs) to rows, and so are its spills.  ``FinalRows`` holds that
map in the card's form, built once at upload from the very tables the JAX
package builds (``pack/final_levels.py``, uploaded for the build by
``FinalDevice.tables``):

  rowptr     (nr_rows + 1,) int32: row r adds idx[rowptr[r]:rowptr[r+1]];
  idx        int32 positions, sorted by row (stably: within a row the
             order of (level, instance, tile, sublane), the spills last);
  by_length  int32 rows in ascending order of their entry count
             (stably), so the rows past any threshold are its tail
             (``rows_over``);
  long_rows  its tail past ``SHORT_MAX`` (the one-plane form's long bin).

``final_rows(vec, rows)`` is y from the flat position vector: on CUDA
tensors ``csrc/final_rows.cu`` (or it raises), a thread a row over every
row, then a warp a row over the long ones where there are any; on CPU
tensors ``final_rows_reference``.  ``final_rows_multi(vec, rows)`` is Y
(nr_rows, k) from the k-plane position vector (n_positions, k), row-major,
through the same map: on CUDA tensors the k-plane entry of the same
source, a group of threads a row, each a 16-byte vector of the row's k
values, then a warp per (long row, vector), long past
``short_max_multi``; on CPU tensors
``final_rows_multi_reference``.  Only live slots are kept: a slot
that reads the drain, a position at or past ``n_positions`` (where the TPU
layout reads the zero pad) or a grid row at or past ``nr_rows`` (which the
TPU layout slices off) adds nothing, and padded spills are dropped at
upload, so the function is exactly the TPU layout's.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch
from torch import nn

from ..utils.timing import span
from ._build import check, library, vector_width

LANES = 128
# a row of at most SHORT_MAX entries is summed by a thread, a longer one
# by a warp.  On an H100 (chip_smoke.py's final_rows_bins) a warp a row
# beat a thread a row from 32 entries a row on, not at 16.
SHORT_MAX = 16
INT32_MAX = 2**31 - 1


def short_max_multi(nv: int) -> int:
    """The k-plane form's threshold for rows of nv plane vectors: a row of
    at most this many entries is summed by its group of nv threads (a
    thread a vector), a longer one by a warp a vector.  On an H100
    (chip_smoke.py's final_rows_multi_bins) a group a row beat a warp a
    vector up to 16 entries and lost from 32 on at k = 8 (2 vectors a row),
    and won up to 512 at k = 72 (18): the group's own threads are the
    parallelism a warp would add."""
    return SHORT_MAX * max(1, nv // 2)


class FinalRows(nn.Module):
    """The row-sorted map of a final level (every level of a multi final)
    and its spills.  ``FinalRows(rowptr, idx, n_positions)`` takes the map
    (int32, on the target device); ``from_levels`` builds it from the TPU
    tables of a final's levels (``FinalDevice.tables``)."""

    def __init__(self, rowptr: torch.Tensor, idx: torch.Tensor,
                 n_positions: int):
        super().__init__()
        if rowptr.dtype != torch.int32 or idx.dtype != torch.int32 or \
                rowptr.dim() != 1 or idx.dim() != 1 or rowptr.numel() < 1:
            raise ValueError("rowptr and idx must be 1-D int32")
        if idx.numel() and (int(idx.min()) < 0
                            or int(idx.max()) >= n_positions):
            raise ValueError("a position lies outside the position vector")
        if int(rowptr[0]) != 0 or int(rowptr[-1]) != idx.numel() or \
                bool((rowptr.diff() < 0).any()):
            raise ValueError("rowptr must rise from 0 to the entry count")
        self.nr_rows = rowptr.numel() - 1
        self.n_positions = n_positions
        self.register_buffer("rowptr", rowptr.contiguous())
        self.register_buffer("idx", idx.contiguous())
        lens, order = torch.sort(rowptr.diff(), stable=True)
        self.register_buffer("by_length", order.to(torch.int32))
        # ascending, on the host, int64: searchsorted with a Python int on
        # an int32 array casts the whole array, 1.2 ms a call at 2M rows
        self._lens = lens.cpu().numpy().astype(np.int64)
        self.n_long = self.count_over(SHORT_MAX)
        # the one-plane form's long bin, kept as its own buffer: its launch
        # looks nothing up on the host
        self.register_buffer("long_rows", self.rows_over(SHORT_MAX).clone())

    @property
    def n_entries(self) -> int:
        return self.idx.numel()

    def count_over(self, max_len: int) -> int:
        """How many rows have more than ``max_len`` entries."""
        return self.nr_rows - int(np.searchsorted(self._lens, max_len,
                                                  side="right"))

    def rows_over(self, max_len: int) -> torch.Tensor:
        """The rows of more than ``max_len`` entries (int32, a view of
        ``by_length``: ascending entry count)."""
        return self.by_length[self.nr_rows - self.count_over(max_len):]

    @classmethod
    def from_levels(cls, levels, nr_rows: int, n_positions: int,
                    device) -> "FinalRows":
        """The map of ``levels`` (each a level's TPU tables and
        dropped-pad spills on ``device``, ``FinalDevice.tables``; any
        iterable, read once, so a generator uploads one level at a time):
        each level's live slots, one level at a time, then every level's
        spills; stably sorted by row.
        Raises ``ValueError`` when the positions, the rows or the entries
        do not fit int32."""
        from .spmv_gstream import final_gather_index   # it imports this
        if n_positions > INT32_MAX or nr_rows >= INT32_MAX:
            raise ValueError(f"n_positions {n_positions} or nr_rows "
                             f"{nr_rows} does not fit int32")
        dev = torch.device(device)
        rows, pos, spill_rows, spill_pos = [], [], [], []
        for lvl in levels:
            idx, ok = final_gather_index(
                lvl.step_meta, lvl.tile_bases, lvl.cells, lvl.route,
                tps=lvl.tps, G=lvl.G, nw=lvl.nw, GS=lvl.GS, v2=lvl.v2)
            o = lvl.step_meta[:, lvl.nw + 1].long().view(-1, 1, 1, 1)
            t = torch.arange(lvl.tps, device=dev).view(1, -1, 1, 1)
            lane = torch.arange(LANES, device=dev).view(1, 1, 1, -1)
            row = ((o * lvl.tps + t) * LANES + lane).expand_as(idx)
            keep = ok & (idx < n_positions) & (row < nr_rows)
            rows.append(row[keep].to(torch.int32))
            pos.append(idx[keep].to(torch.int32))
            del idx, ok, row, keep
            spill_rows.append(lvl.spill_row.to(torch.int32))
            spill_pos.append(lvl.spill_pos.to(torch.int32))
        rows += spill_rows
        pos += spill_pos
        n = sum(r.numel() for r in rows)
        if n > INT32_MAX:
            raise ValueError(f"{n} entries do not fit int32")
        row = torch.cat(rows) if rows else torch.zeros(0, dtype=torch.int32,
                                                       device=dev)
        idx = torch.cat(pos) if pos else torch.zeros_like(row)
        return cls._sorted(row, idx, nr_rows, n_positions)

    @classmethod
    def from_chunk_row(cls, chunk_row, nr_rows: int,
                       device) -> "FinalRows":
        """The map of a pack's own chunk rows (``GStreamMatrix.chunk_row``
        or any array of one row a position, ``nr_rows`` or past it for
        none): every position that holds a row, ascending within its row.
        Any final level built from that chunk_row (its live slots and its
        spills) holds the same entries, a row's in (level, instance, tile,
        sublane) order (``from_levels``); this map builds for every
        placement, where a level may not.  Raises ``ValueError`` when the
        positions do not fit int32."""
        dev = torch.device(device)
        cr = torch.as_tensor(np.asarray(chunk_row)).reshape(-1).to(
            dev, torch.int64)
        n_positions = cr.numel()
        if n_positions > INT32_MAX or nr_rows >= INT32_MAX:
            raise ValueError(f"n_positions {n_positions} or nr_rows "
                             f"{nr_rows} does not fit int32")
        pos = torch.nonzero((cr >= 0) & (cr < nr_rows)).squeeze(1)
        return cls._sorted(cr[pos].to(torch.int32), pos.to(torch.int32),
                           nr_rows, n_positions)

    @classmethod
    def _sorted(cls, row, idx, nr_rows: int,
                n_positions: int) -> "FinalRows":
        """The map of the entries (row[i], idx[i]), int32 on one device,
        stably sorted by row."""
        row, order = torch.sort(row, stable=True)
        rowptr = torch.zeros(nr_rows + 1, dtype=torch.int64,
                             device=row.device)
        rowptr[1:] = torch.cumsum(torch.bincount(row, minlength=nr_rows), 0)
        return cls(rowptr.to(torch.int32), idx[order].contiguous(),
                   n_positions)


def _check(vec: torch.Tensor, rows: FinalRows, multi: bool = False) -> None:
    """vec: 1-D, or with ``multi`` 2-D (positions, k >= 1); contiguous, f32
    or f64, holding the map's positions, on the map's device."""
    dims = 2 if multi else 1
    if vec.dtype not in (torch.float32, torch.float64) or \
            vec.dim() != dims or not vec.is_contiguous() or \
            (multi and vec.shape[1] < 1):
        raise ValueError(f"vec must be a contiguous {dims}-D f32 or f64 "
                         f"tensor, got {vec.dtype} {tuple(vec.shape)}")
    if vec.shape[0] < rows.n_positions:
        raise ValueError(f"vec has {vec.shape[0]} positions, the final reads "
                         f"{rows.n_positions}")
    if rows.rowptr.device != vec.device:
        raise ValueError(f"the final lies on {rows.rowptr.device}, vec on "
                         f"{vec.device}")


def _entry_rows(rows: FinalRows, device) -> torch.Tensor:
    """Each entry's row (int64)."""
    return torch.repeat_interleave(
        torch.arange(rows.nr_rows, device=device),
        rows.rowptr.diff().long(), output_size=rows.n_entries)


def final_rows_reference(vec: torch.Tensor, rows: FinalRows) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``index_add_`` of vec[idx] into
    zeros at each entry's row, in vec's real type.  Returns y
    (nr_rows,)."""
    _check(vec, rows)
    y = torch.zeros(rows.nr_rows, dtype=vec.dtype, device=vec.device)
    return y.index_add_(0, _entry_rows(rows, vec.device),
                        vec[rows.idx.long()])


def final_rows_multi_reference(vec: torch.Tensor,
                               rows: FinalRows) -> torch.Tensor:
    """Plain PyTorch version of the k-plane kernel: ``index_add_`` of the
    rows vec[idx] into zeros at each entry's row, in vec's real type.
    vec (n_positions, k) row-major; returns Y (nr_rows, k)."""
    _check(vec, rows, multi=True)
    Y = torch.zeros(rows.nr_rows, vec.shape[1], dtype=vec.dtype,
                    device=vec.device)
    return Y.index_add_(0, _entry_rows(rows, vec.device),
                        vec[rows.idx.long()])


def final_rows(vec: torch.Tensor, rows: FinalRows) -> torch.Tensor:
    """The final level: y (nr_rows,) in vec's real type (f32, or f64 for
    the f64 devices).

    On CUDA tensors it launches ``csrc/final_rows.cu`` on the current
    stream: the short bin over every row, then the long bin where it is
    not empty (or it raises); on CPU tensors it runs
    ``final_rows_reference``.  ``final_rows.launches`` counts launches by
    bin and type: ``"short"``, ``"long"``, ``"short_f64"``,
    ``"long_f64"``.  A ``sparsetpu.launch.final_rows`` span a call."""
    with span("launch.final_rows"):
        if vec.device.type == "cpu":
            return final_rows_reference(vec, rows)
        if vec.device.type != "cuda":
            raise ValueError(f"final_rows: unsupported device {vec.device}")
        _check(vec, rows)
        if rows.idx.data_ptr() % 16:
            raise ValueError("idx must be 16-byte aligned (the kernel's wide "
                             "loads)")
        f64 = vec.dtype == torch.float64
        lib = library().lib
        launch = lib.final_rows_f64_launch if f64 else lib.final_rows_launch
        with torch.cuda.device(vec.device):
            y = torch.empty(rows.nr_rows, dtype=vec.dtype, device=vec.device)
            stream = ctypes.c_void_p(
                torch.cuda.current_stream(vec.device).cuda_stream)
            for name, n, lst in (
                    ("short", rows.nr_rows
                     if rows.n_long < rows.nr_rows else 0, None),
                    ("long", rows.n_long, rows.long_rows)):
                if not n:
                    continue
                rc = launch(ctypes.c_void_p(rows.rowptr.data_ptr()),
                            ctypes.c_void_p(rows.idx.data_ptr()),
                            ctypes.c_void_p(vec.data_ptr()),
                            ctypes.c_void_p(lst.data_ptr() if lst is not None
                                            else 0),
                            n, SHORT_MAX, ctypes.c_void_p(y.data_ptr()),
                            stream)
                check(lib, rc, f"final_rows {name} launch")
                final_rows.launches[name + ("_f64" if f64 else "")] += 1
        return y


final_rows.launches = collections.Counter()


def final_rows_multi(vec: torch.Tensor, rows: FinalRows) -> torch.Tensor:
    """The final level on k planes: Y (nr_rows, k) from vec (n_positions,
    k), row-major, in vec's real type (f32, or f64 for the f64 devices).

    On CUDA tensors it launches the k-plane entry of ``csrc/final_rows.cu``
    on the current stream: the short bin (a group of threads a row, rows
    of at most ``short_max_multi`` entries), then the long bin where there
    are longer rows (or it raises); on CPU tensors it runs
    ``final_rows_multi_reference``.  ``final_rows_multi.launches`` counts
    launches by bin and type: ``"short"``, ``"long"``, ``"short_f64"``,
    ``"long_f64"``.  A ``sparsetpu.launch.final_rows_multi`` span a
    call."""
    with span("launch.final_rows_multi"):
        if vec.device.type == "cpu":
            return final_rows_multi_reference(vec, rows)
        if vec.device.type != "cuda":
            raise ValueError(f"final_rows_multi: unsupported device "
                             f"{vec.device}")
        _check(vec, rows, multi=True)
        f64 = vec.dtype == torch.float64
        k = vec.shape[1]
        lib = library().lib
        with torch.cuda.device(vec.device):
            Y = torch.empty(rows.nr_rows, k, dtype=vec.dtype,
                            device=vec.device)
            vw = vector_width(k, vec, Y)
            max_len = short_max_multi(k // vw)
            long_rows = rows.rows_over(max_len)
            stream = ctypes.c_void_p(
                torch.cuda.current_stream(vec.device).cuda_stream)
            for name, n, lst in (
                    ("short", rows.nr_rows
                     if long_rows.numel() < rows.nr_rows else 0, None),
                    ("long", long_rows.numel(), long_rows)):
                if not n:
                    continue
                rc = lib.final_rows_multi_launch(
                    int(f64), ctypes.c_void_p(rows.rowptr.data_ptr()),
                    ctypes.c_void_p(rows.idx.data_ptr()),
                    ctypes.c_void_p(vec.data_ptr()),
                    ctypes.c_void_p(lst.data_ptr() if lst is not None else 0),
                    n, max_len, k, vw, ctypes.c_void_p(Y.data_ptr()),
                    stream)
                check(lib, rc, f"final_rows_multi {name} launch")
                final_rows_multi.launches[name + ("_f64" if f64 else "")] += 1
        return Y


final_rows_multi.launches = collections.Counter()
