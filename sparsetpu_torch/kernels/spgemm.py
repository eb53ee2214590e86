"""SpGEMM: C = A @ B for two sparse matrices, numeric phase on the card
(counterpart of ``sparsetpu/kernels/spgemm.py``).

Row-merge formulation, as the reference's:
  * symbolic phase (host, once, NumPy): C's sparsity pattern and the
    multiplication events: every (i, k, j) with A[i, k] != 0 and
    B[k, j] != 0 adds A[i, k] * B[k, j] to C[i, j];
  * numeric phase: an SpMV,  c = M @ b,  with b = B.values (length nnz(B))
    and M[o, e] = A[i, k] (o the C-nnz index of (i, j), e the B-nnz index
    of (k, j)).  M is packed once as a ``SparseMatrix`` (auto routing: the
    fused device where its x fits, else the classic device), so the
    multiply runs through the SpMV kernels; new B values with the same
    structure cost one SpMV.

Values are f32, as in the reference (the event matrix holds A's values
rounded to f32; B's values are rounded too).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _host
from ..utils.device import require_device


def _expand_events(a, b):
    """All multiplication events: returns (ea, eb, out_idx, c_pattern)
    where ea/eb index A/B nnz, out_idx indexes C nnz, and c_pattern is
    (row_ptr, col_ind) of C."""
    deg_b = np.diff(b.row_ptr).astype(np.int64)        # nnz per B row
    acol = a.col_ind.astype(np.int64)
    # per A-event fanout = deg_b[A.col]
    fan = deg_b[acol]
    ea = np.repeat(np.arange(a.nr_nzeros, dtype=np.int64), fan)
    # eb = concat of B row ranges per A event (CSR range expansion)
    starts = b.row_ptr[acol].astype(np.int64)
    total = int(fan.sum())
    if total == 0:
        return (ea, np.zeros(0, np.int64), np.zeros(0, np.int64),
                (np.zeros(a.nr_rows + 1, np.int64),
                 np.zeros(0, np.int64)))
    first = np.repeat(starts, fan)
    run_starts = np.concatenate([[0], np.cumsum(fan)[:-1]])
    offs = np.arange(total, dtype=np.int64) - np.repeat(run_starts, fan)
    eb = first + offs

    arow = np.repeat(np.arange(a.nr_rows, dtype=np.int64),
                     np.diff(a.row_ptr).astype(np.int64))
    i = np.repeat(arow, fan)                            # C row per event
    j = b.col_ind.astype(np.int64)[eb]                  # C col per event

    # C pattern: unique (i, j)
    key = i * b.nr_cols + j
    uniq, out_idx = np.unique(key, return_inverse=True)
    c_rows = (uniq // b.nr_cols).astype(np.int64)
    c_cols = (uniq % b.nr_cols).astype(np.int64)
    c_row_ptr = np.zeros(a.nr_rows + 1, dtype=np.int64)
    np.add.at(c_row_ptr, c_rows + 1, 1)
    c_row_ptr = np.cumsum(c_row_ptr)
    return ea, eb, out_idx, (c_row_ptr, c_cols)


class SpGEMMPlan:
    """Structural plan for C = A @ B: pattern + packed event matrix.

    Reusable: ``plan(new_b_values)`` recomputes C's values on the device
    for any B with the same sparsity structure (A's values are baked in:
    they are the event matrix's entries)."""

    def __init__(self, a, b, device="cuda"):
        from ..api.api import SparseMatrix    # the API imports this module

        self.device = require_device(device)
        self.nr_rows, self.nr_cols = a.nr_rows, b.nr_cols
        ea, eb, out_idx, (c_row_ptr, c_cols) = _expand_events(a, b)
        self.c_row_ptr = c_row_ptr
        self.c_col_ind = c_cols.astype(np.int32)
        self.nnz_c = int(c_cols.shape[0])
        self.flops = 2 * int(ea.shape[0])
        self.event_matrix = None
        if self.nnz_c == 0 or ea.shape[0] == 0:
            return
        m = _host.CSRMatrix.from_coo(out_idx, eb,
                                     a.values[ea].astype(np.float32),
                                     self.nnz_c, b.nr_nzeros,
                                     sum_duplicates=True)
        self.event_matrix = SparseMatrix(m, device=self.device)

    def __call__(self, b_values) -> torch.Tensor:
        """C.values (f32, on the plan's device) for the given B values."""
        if self.event_matrix is None:
            return torch.zeros(self.nnz_c, device=self.device)
        return self.event_matrix.spmv(torch.as_tensor(
            b_values, dtype=torch.float32, device=self.device))

    def to_csr(self, c_values):
        """C as a host ``CSRMatrix`` with f32 values."""
        if isinstance(c_values, torch.Tensor):
            c_values = c_values.cpu().numpy()
        return _host.CSRMatrix(self.c_row_ptr.astype(np.int64),
                               self.c_col_ind.astype(np.int32),
                               np.asarray(c_values, dtype=np.float32),
                               self.nr_rows, self.nr_cols)


def spgemm(a, b, *, device="cuda"):
    """C = A @ B with the numeric phase on ``device``; returns a host
    ``CSRMatrix``."""
    if a.nr_cols != b.nr_rows:
        raise ValueError(f"dimension mismatch: {a.shape} @ {b.shape}")
    plan = SpGEMMPlan(a, b, device=device)
    return plan.to_csr(plan(b.values))
