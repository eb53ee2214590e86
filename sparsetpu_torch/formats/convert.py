"""Format conversions: COO <-> CSR <-> BSR (host paths).

Capability extension scoped by BASELINE.json ("BSR/COO format conversion").
Device-side conversion of the packed formats lives in the pack modules.
"""

from __future__ import annotations

import numpy as np

from .csr import BSRMatrix, COOMatrix, CSRMatrix, INDEX_DTYPE


def csr_to_coo(m: CSRMatrix) -> COOMatrix:
    return m.to_coo()


def coo_to_csr(m: COOMatrix) -> CSRMatrix:
    return m.to_csr()


def csr_to_bsr(m: CSRMatrix, block_shape=(8, 128)) -> BSRMatrix:
    """Tile CSR into dense (bh, bw) blocks, keeping only nonzero blocks."""
    bh, bw = block_shape
    nbr = -(-m.nr_rows // bh)
    coo = m.to_coo()
    brow = coo.row_ind // bh
    bcol = coo.col_ind // bw
    key = brow.astype(np.int64) * (-(-m.nr_cols // bw)) + bcol
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, starts = np.unique(key_s, return_index=True)
    n_blocks = uniq.shape[0]
    values = np.zeros((n_blocks, bh, bw), dtype=m.dtype)
    block_of = np.searchsorted(uniq, key)
    lr = (coo.row_ind % bh).astype(np.int64)
    lc = (coo.col_ind % bw).astype(np.int64)
    np.add.at(values, (block_of, lr, lc), coo.values)
    b_rows = (uniq // (-(-m.nr_cols // bw))).astype(INDEX_DTYPE)
    b_cols = (uniq % (-(-m.nr_cols // bw))).astype(INDEX_DTYPE)
    row_ptr = np.zeros(nbr + 1, dtype=np.int64)
    np.add.at(row_ptr, b_rows + 1, 1)
    row_ptr = np.cumsum(row_ptr).astype(INDEX_DTYPE)
    return BSRMatrix(row_ptr, b_cols, values, m.nr_rows, m.nr_cols)


def bsr_to_csr(m: BSRMatrix) -> CSRMatrix:
    return m.to_csr()
