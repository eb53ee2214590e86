"""COO SpMV/SpMM in plain PyTorch (counterpart of
``sparsetpu/kernels/spmv_xla.py``): gather, multiply, ``index_add_``.

This is the ``backend="coo"`` path of ``SparseMatrix``, as the XLA path is
``backend="xla"`` in the JAX package; it is not a port of a Pallas kernel.
Semantics contract: ``spmv_gold``.  Indices must be in bounds.  The JAX
names (``spmv_coo_xla``, ``spmm_coo_xla``, ``spmv_chunked_xla``) are the
same functions.
"""

from __future__ import annotations

import torch


def spmv_coo(row_ind: torch.Tensor, col_ind: torch.Tensor,
             values: torch.Tensor, x: torch.Tensor,
             nr_rows: int) -> torch.Tensor:
    """y[r] = sum over e with row_ind[e] == r of values[e] * x[col_ind[e]]."""
    y = torch.zeros(nr_rows, dtype=values.dtype, device=values.device)
    return y.index_add_(0, row_ind, values * x[col_ind])


def spmm_coo(row_ind: torch.Tensor, col_ind: torch.Tensor,
             values: torch.Tensor, x: torch.Tensor,
             nr_rows: int) -> torch.Tensor:
    """Multi-RHS: Y = A @ X with X (nr_cols, k)."""
    y = torch.zeros(nr_rows, x.shape[1], dtype=values.dtype,
                    device=values.device)
    return y.index_add_(0, row_ind, values[:, None] * x[col_ind])


def spmv_chunked(chunk_sums: torch.Tensor, chunk_rows: torch.Tensor,
                 nr_rows: int) -> torch.Tensor:
    """Reduce per-chunk partial sums into y; chunk row ``nr_rows`` is the
    padding trap and is dropped."""
    y = torch.zeros(nr_rows + 1, dtype=chunk_sums.dtype,
                    device=chunk_sums.device)
    return y.index_add_(0, chunk_rows, chunk_sums)[:nr_rows]


# the JAX package's names of the same functions (``spmv_xla.py``)
spmv_coo_xla, spmm_coo_xla, spmv_chunked_xla = spmv_coo, spmm_coo, spmv_chunked
