"""The benchmark's own CSR container: what a generator makes and what both
the program (through its public constructor) and the reference read."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Csr(NamedTuple):
    row_ptr: np.ndarray   # (nr_rows + 1,) int32
    col_ind: np.ndarray   # (nnz,) int32, ascending within a row
    values: np.ndarray    # (nnz,) float32 or float64
    nr_rows: int
    nr_cols: int

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])


def from_sorted_keys(rows: np.ndarray, cols: np.ndarray, values: np.ndarray,
                     nr_rows: int, nr_cols: int) -> Csr:
    """CSR from entries already sorted by (row, col)."""
    counts = np.bincount(rows, minlength=nr_rows)
    row_ptr = np.zeros(nr_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    if row_ptr[-1] >= 2 ** 31:
        raise ValueError("nnz past the int32 range of the CSR indices")
    return Csr(row_ptr.astype(np.int32), cols.astype(np.int32, copy=False),
               values, int(nr_rows), int(nr_cols))
