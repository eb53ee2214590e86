"""Matrix file ingest.

Re-implements the reference reader semantics (csr.cpp:10-46 read_csr_header,
csr.cpp:87-136 read_csr_matrix): a row-sorted, 1-based triplet file whose
first (non-comment) line is ``nr_rows nr_cols nr_nzeros`` followed by one
``row col value`` line per non-zero — i.e. a MatrixMarket body without the
``%%MatrixMarket`` banner.  Empty rows are handled by filling row_ptr through
them (csr.cpp:115-117) and indices are converted 1-based -> 0-based
(csr.cpp:118).

Extensions beyond the reference: full ``.mtx`` MatrixMarket support
(banner, ``%`` comments, symmetric/pattern matrices, unsorted input) and an
optional C++ fast-path loader (native/) for large files.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from .csr import CSRMatrix, INDEX_DTYPE


@dataclasses.dataclass
class CSRHeader:
    """csr_header analogue (csr.h:24-29)."""

    nr_rows: int
    nr_cols: int
    nr_nzeros: int
    symmetric: bool = False
    pattern: bool = False

    def nr_blocks(self, block_cols: int) -> int:
        """blocks = ceil(nr_cols / block_cols) (csr.cpp:39-43)."""
        return -(-self.nr_cols // block_cols)


def _open_lines(path):
    with open(path, "r") as f:
        for line in f:
            yield line


def read_csr_header(path: str) -> CSRHeader:
    """Parse the size line (csr.cpp:10-46).  Skips ``%`` comment lines and an
    optional MatrixMarket banner."""
    symmetric = False
    pattern = False
    for line in _open_lines(path):
        s = line.strip()
        if not s:
            continue
        if s.startswith("%"):
            if s.lower().startswith("%%matrixmarket"):
                toks = s.lower().split()
                symmetric = "symmetric" in toks
                pattern = "pattern" in toks
                if "complex" in toks:
                    raise ValueError("complex matrices are not supported")
                if "coordinate" not in toks:
                    raise ValueError("only coordinate-format .mtx supported")
            continue
        parts = s.split()
        if len(parts) != 3:
            raise ValueError(f"bad header line in {path!r}: {s!r}")
        nr_rows, nr_cols, nr_nzeros = (int(p) for p in parts)
        return CSRHeader(nr_rows, nr_cols, nr_nzeros, symmetric, pattern)
    raise ValueError(f"no header line found in {path!r}")


def read_matrix(path: str, dtype=np.float64,
                use_native: Optional[bool] = None) -> CSRMatrix:
    """Read a triplet/.mtx file into CSR (read_csr_matrix, csr.cpp:87-136).

    Unlike the reference we do not require row-sorted input (README.md:29):
    the CSR build sorts.  Symmetric matrices are expanded; pattern matrices
    get value 1.0 (standard MatrixMarket semantics).
    """
    header = read_csr_header(path)
    if use_native is None:
        use_native = os.path.getsize(path) > (1 << 22)  # >4 MiB: native pays off
    data = None
    if use_native:
        try:
            from ..native import loader as native_loader
            data = native_loader.read_triplets(path, header.pattern)
        except Exception:
            data = None
    if data is None:
        data = _read_triplets_py(path, header)
    rows, cols, vals = data
    vals = vals.astype(dtype, copy=False)
    if header.symmetric:
        off = rows != cols  # mirror strictly-off-diagonal entries
        rows, cols = (np.concatenate([rows, cols[off]]),
                      np.concatenate([cols, rows[off]]))
        vals = np.concatenate([vals, vals[off]])
    return CSRMatrix.from_coo(rows, cols, vals, header.nr_rows,
                              header.nr_cols, sum_duplicates=True)


def _read_triplets_py(path: str, header: CSRHeader):
    # Parse with numpy for speed; tolerate both "r c v" and pattern "r c".
    rows_l, cols_l, vals_l = [], [], []
    seen_header = False
    chunk_rows, chunk_cols, chunk_vals = [], [], []
    with open(path, "r") as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("%"):
                continue
            if not seen_header:
                seen_header = True  # size line
                continue
            parts = s.split()
            chunk_rows.append(int(parts[0]))
            chunk_cols.append(int(parts[1]))
            if header.pattern or len(parts) < 3:
                chunk_vals.append(1.0)
            else:
                chunk_vals.append(float(parts[2]))
    rows = np.asarray(chunk_rows, dtype=np.int64) - 1  # 1-based -> 0-based (csr.cpp:118)
    cols = np.asarray(chunk_cols, dtype=np.int64) - 1
    vals = np.asarray(chunk_vals, dtype=np.float64)
    if rows.size and (rows.min() < 0 or rows.max() >= header.nr_rows
                      or cols.min() < 0 or cols.max() >= header.nr_cols):
        raise ValueError(f"index out of bounds in {path!r}")
    return rows.astype(INDEX_DTYPE), cols.astype(INDEX_DTYPE), vals


def write_matrix(path: str, m: CSRMatrix, banner: bool = True) -> None:
    """Write CSR as a 1-based row-sorted triplet file (round-trips through
    the reference's reader format)."""
    coo = m.to_coo()
    with open(path, "w") as f:
        if banner:
            f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{m.nr_rows} {m.nr_cols} {m.nr_nzeros}\n")
        for r, c, v in zip(coo.row_ind, coo.col_ind, coo.values):
            f.write(f"{int(r) + 1} {int(c) + 1} {v:.17g}\n")
