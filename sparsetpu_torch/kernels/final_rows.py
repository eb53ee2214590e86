"""The final level of the classic devices as a row-sorted gather-sum on the
card (counterpart of the JAX ``_FinalLevel``, ``_FinalLevelV2`` and
``_FinalLevelMulti`` ``apply``, and of their kernels #4, #5 and #12).

A final level is a fixed 0/1 map from positions (the chunk sums and the F
levels' outputs) to rows, and so are its spills.  ``FinalRows`` holds that
map in the card's form, built once at upload from the very tables the JAX
package builds (``pack/final_levels.py``, uploaded by ``FinalDevice``):

  rowptr     (nr_rows + 1,) int32: row r adds idx[rowptr[r]:rowptr[r+1]];
  idx        int32 positions, sorted by row (stably: within a row the
             order of (level, instance, tile, sublane), the spills last);
  long_rows  int32 rows with more than ``SHORT_MAX`` entries.

``final_rows(vec, rows)`` is y from the flat position vector: on CUDA
tensors ``csrc/final_rows.cu`` (or it raises), a thread a row over every
row, then a warp a row over the long ones where there are any; on CPU
tensors ``final_rows_reference``.  Only live slots are kept: a slot
that reads the drain, a position at or past ``n_positions`` (where the TPU
layout reads the zero pad) or a grid row at or past ``nr_rows`` (which the
TPU layout slices off) adds nothing, and padded spills are dropped at
upload, so the function is exactly the TPU layout's.
"""

from __future__ import annotations

import collections
import ctypes

import torch
from torch import nn

from ._build import check, library

LANES = 128
# a row of at most SHORT_MAX entries is summed by a thread, a longer one
# by a warp.  On an H100 (chip_smoke.py's final_rows_bins) a warp a row
# beat a thread a row from 32 entries a row on, not at 16.
SHORT_MAX = 16
INT32_MAX = 2**31 - 1


class FinalRows(nn.Module):
    """The row-sorted map of a final level (every level of a multi final)
    and its spills.  ``FinalRows(rowptr, idx, n_positions)`` takes the map
    (int32, on the target device); ``from_levels`` builds it from uploaded
    ``FinalDevice`` levels."""

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
        lens = rowptr.diff()
        self.register_buffer("long_rows", torch.nonzero(
            lens > SHORT_MAX).reshape(-1).to(torch.int32))
        self.n_long = self.long_rows.numel()

    @property
    def n_entries(self) -> int:
        return self.idx.numel()

    @classmethod
    def from_levels(cls, levels, nr_rows: int, n_positions: int,
                    device) -> "FinalRows":
        """The map of ``levels`` (``FinalDevice`` modules, their TPU tables
        and dropped-pad spills on ``device``): each level's live slots, one
        level at a time, then every level's spills; stably sorted by row.
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
        row, order = torch.sort(row, stable=True)
        rowptr = torch.zeros(nr_rows + 1, dtype=torch.int64, device=dev)
        rowptr[1:] = torch.cumsum(torch.bincount(row, minlength=nr_rows), 0)
        return cls(rowptr.to(torch.int32), idx[order].contiguous(),
                   n_positions)


def _check(vec: torch.Tensor, rows: FinalRows) -> None:
    if vec.dtype not in (torch.float32, torch.float64) or vec.dim() != 1 \
            or not vec.is_contiguous():
        raise ValueError(f"vec must be a contiguous 1-D f32 or f64 tensor, "
                         f"got {vec.dtype} {tuple(vec.shape)}")
    if vec.numel() < rows.n_positions:
        raise ValueError(f"vec has {vec.numel()} positions, the final reads "
                         f"{rows.n_positions}")
    if rows.rowptr.device != vec.device:
        raise ValueError(f"the final lies on {rows.rowptr.device}, vec on "
                         f"{vec.device}")


def final_rows_reference(vec: torch.Tensor, rows: FinalRows) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``index_add_`` of vec[idx] into
    zeros at each entry's row, in vec's real type.  Returns y
    (nr_rows,)."""
    _check(vec, rows)
    row = torch.repeat_interleave(
        torch.arange(rows.nr_rows, device=vec.device),
        rows.rowptr.diff().long(), output_size=rows.n_entries)
    y = torch.zeros(rows.nr_rows, dtype=vec.dtype, device=vec.device)
    return y.index_add_(0, row, vec[rows.idx.long()])


def final_rows(vec: torch.Tensor, rows: FinalRows) -> torch.Tensor:
    """The final level: y (nr_rows,) in vec's real type (f32, or f64 for
    the f64 devices).

    On CUDA tensors it launches ``csrc/final_rows.cu`` on the current
    stream: the short bin over every row, then the long bin where it is
    not empty (or it raises); on CPU tensors it runs
    ``final_rows_reference``.  ``final_rows.launches`` counts launches by
    bin and type: ``"short"``, ``"long"``, ``"short_f64"``,
    ``"long_f64"``."""
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
                ("short", rows.nr_rows if rows.n_long < rows.nr_rows else 0,
                 None),
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
