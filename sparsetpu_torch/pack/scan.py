"""Pass 1 of the repack engine: matrix scan.

Vectorized re-design of ``scan_matrix`` (csr_hw.cpp:7-146), which computes,
in one pass over the CSR structure:
  * per-2D-block column thresholds ``thres_l/thres_h`` (csr_hw.cpp:64-76),
  * per-block, per-row nnz counts padded up to the vector factor
    (csr_hw.cpp:87-119, pad at 108-114),
  * column padding of nr_cols to block granularity (csr_hw.cpp:29-33),
  * total expanded (padded) nnz (csr_hw.cpp:124-130).

The reference walks row_ptr/col_ind with scalar loops on the ARM core; here
it is a handful of NumPy histogram ops (and the native C++ engine offers the
same via native/ for very large matrices).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..formats.csr import CSRMatrix
from ..utils.config import SpmvConfig


@dataclasses.dataclass
class BlockScan:
    """Result of the scan pass (the reference keeps these in loose arrays)."""

    nr_blocks: int
    thres_l: np.ndarray          # (nr_blocks,) inclusive low col per block
    thres_h: np.ndarray          # (nr_blocks,) exclusive high col per block
    block_row_nnz: np.ndarray    # (nr_blocks, nr_rows) raw nnz per block/row
    block_row_nnz_padded: np.ndarray  # same, padded up to vf multiple (csr_hw.cpp:108-114)
    expanded_nr_nzeros: int      # total padded nnz (csr_hw.cpp:124-130)
    padded_nr_cols: int          # nr_cols padded (csr_hw.cpp:29-33)
    empty_rows_bitmap: np.ndarray  # (nr_blocks, nr_rows) bool: row empty in block
                                  # (csr_hw.cpp:340-347 / 723-727)


def scan_matrix(matrix: CSRMatrix, config: SpmvConfig) -> BlockScan:
    bc = config.block_cols
    nr_blocks = config.nr_blocks(matrix.nr_cols)
    blocks_idx = np.arange(nr_blocks, dtype=np.int64)
    thres_l = blocks_idx * bc
    thres_h = np.minimum(thres_l + bc, matrix.nr_cols)

    # per-(block, row) nnz histogram
    rows = np.repeat(np.arange(matrix.nr_rows, dtype=np.int64),
                     matrix.row_nnz())
    blk = matrix.col_ind.astype(np.int64) // bc
    flat = blk * matrix.nr_rows + rows
    counts = np.bincount(flat, minlength=nr_blocks * matrix.nr_rows)
    block_row_nnz = counts.reshape(nr_blocks, matrix.nr_rows)

    vf = config.vf or 1   # 0 = auto quantum: report unpadded counts
    padded = ((block_row_nnz + vf - 1) // vf) * vf
    empty = block_row_nnz == 0

    return BlockScan(
        nr_blocks=nr_blocks,
        thres_l=thres_l,
        thres_h=thres_h,
        block_row_nnz=block_row_nnz.astype(np.int64),
        block_row_nnz_padded=padded.astype(np.int64),
        expanded_nr_nzeros=int(padded.sum()),
        padded_nr_cols=nr_blocks * bc,
        empty_rows_bitmap=empty,
    )
