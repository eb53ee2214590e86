"""CSR SpMV and the preconditioned CG, in plain NumPy, in a stated real
type, and the numbers that judge the program's outputs against them."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

BF16 = "bfloat16"


def round_bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bfloat16 (to nearest, ties to even) and widened back
    to float32: NumPy has no bfloat16 type."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _row_sums(prod: np.ndarray, row_ptr: np.ndarray) -> np.ndarray:
    """Sum of each row's products; 0 for an empty row."""
    nr = row_ptr.shape[0] - 1
    out = np.zeros(nr, dtype=prod.dtype)
    starts = row_ptr[:-1]
    nonempty = starts < row_ptr[1:]
    if prod.size:
        out[nonempty] = np.add.reduceat(prod, starts[nonempty])
    return out


def threads() -> int:
    """Worker threads for the reference's row blocks: the cores this process
    may use, at most 8 (NumPy's gathers, products and sums release the
    interpreter lock)."""
    return max(1, min(8, len(os.sched_getaffinity(0))))


def _blocked(csr, fn, pool: Optional[ThreadPoolExecutor], dtype):
    """``fn(lo, hi, s, e)`` for each block of rows [lo, hi) (entries [s,
    e)), concatenated; blocks run on ``pool`` when given."""
    nb = 1 if pool is None else 4 * pool._max_workers
    bounds = np.linspace(0, csr.nr_rows, nb + 1).astype(np.int64)
    jobs = [(int(lo), int(hi), int(csr.row_ptr[lo]), int(csr.row_ptr[hi]))
            for lo, hi in zip(bounds[:-1], bounds[1:])]
    parts = (pool.map(lambda j: fn(*j), jobs) if pool is not None
             else map(lambda j: fn(*j), jobs))
    return np.concatenate([np.zeros(0, dtype), *parts])


def spmv(csr, x: np.ndarray, dtype=np.float64,
         pool: Optional[ThreadPoolExecutor] = None) -> np.ndarray:
    """y = A x with every product and sum in ``dtype``; ``dtype`` bfloat16
    rounds A's values, x, the products and y to bfloat16 and sums in
    float32, as a bfloat16 kernel with float32 accumulators would.  Rows
    are summed in blocks, on ``pool``'s threads when given; each row's sum
    runs in the same order either way."""
    bf16 = isinstance(dtype, str) and dtype == BF16
    dt = np.dtype(np.float32 if bf16 else dtype)
    xs = round_bf16(x) if bf16 else x.astype(dt)

    def block(lo, hi, s, e):
        vals = csr.values[s:e]
        prod = np.take(xs, csr.col_ind[s:e])
        prod *= round_bf16(vals) if bf16 else vals.astype(dt, copy=False)
        if bf16:
            prod = round_bf16(prod)
        return _row_sums(prod, csr.row_ptr[lo:hi + 1] - s)

    y = _blocked(csr, block, pool, dt)
    return round_bf16(y) if bf16 else y


def abs_row_sums(csr, x: np.ndarray,
                 pool: Optional[ThreadPoolExecutor] = None) -> np.ndarray:
    """sum_j |a_ij x_j| in float64: the scale of each row's rounding."""
    xa = np.abs(x.astype(np.float64))

    def block(lo, hi, s, e):
        prod = np.take(xa, csr.col_ind[s:e])
        prod *= np.abs(csr.values[s:e].astype(np.float64))
        return _row_sums(prod, csr.row_ptr[lo:hi + 1] - s)

    return _blocked(csr, block, pool, np.float64)


def spmv_err(y: np.ndarray, y_ref: np.ndarray, scale: np.ndarray) -> float:
    """max_i |y_i - y_ref_i| / sum_j |a_ij x_j|: the worst row's error
    against the size of the terms it sums; inf for a non-finite y, a wrong
    length, or a nonzero y where every term is zero."""
    y = np.asarray(y, dtype=np.float64)
    if y.shape != y_ref.shape or not np.isfinite(y).all():
        return float("inf")
    diff = np.abs(y - y_ref)
    zero = scale == 0.0
    if np.any(diff[zero] != 0.0):
        return float("inf")
    if zero.all():
        return 0.0
    return float(np.max(diff[~zero] / scale[~zero]))


def jacobi_inverse(csr, dtype=np.float64) -> np.ndarray:
    """1 / diag(A), a missing or zero diagonal taken as 1, rounded to
    float32: the preconditioner that ``pcg_df64`` is given keeps its
    inverse diagonal in float32, so that rounding is part of the stated
    method."""
    rows = np.repeat(np.arange(csr.nr_rows, dtype=np.int64),
                     np.diff(csr.row_ptr).astype(np.int64))
    on = rows == csr.col_ind
    diag = np.zeros(csr.nr_rows, dtype=np.float64)
    np.add.at(diag, rows[on], csr.values[on].astype(np.float64))
    diag = np.where(diag == 0.0, 1.0, diag)
    return (1.0 / diag).astype(np.float32).astype(dtype)


def pcg(csr, b: np.ndarray, iterations: int, dtype=np.float64,
        pool: Optional[ThreadPoolExecutor] = None):
    """At most ``iterations`` steps of Jacobi-preconditioned CG from x0 = 0,
    every vector, product and dot in ``dtype``, stopping early only where
    r.r rounds to 0 in float32 (the test of ``pcg_df64`` at tol = 0);
    returns (x, ||r||, steps)."""
    dtype = np.dtype(dtype)
    m_inv = jacobi_inverse(csr, dtype)
    b = b.astype(dtype)
    x = np.zeros_like(b)
    r = b.copy()
    z = m_inv * r
    p = z
    rz = np.dot(r, z)
    k = 0
    while k < iterations and np.float32(np.dot(r, r)) > 0:
        ap = spmv(csr, p, dtype, pool)
        alpha = rz / np.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = m_inv * r
        rz_new = np.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return x, float(np.sqrt(np.dot(r, r))), k


def vec_err(x: np.ndarray, x_ref: np.ndarray) -> float:
    """max |x - x_ref| / max |x_ref|; inf for a non-finite x or a wrong
    length."""
    x = np.asarray(x, dtype=np.float64)
    if x.shape != x_ref.shape or not np.isfinite(x).all():
        return float("inf")
    den = float(np.max(np.abs(x_ref))) if x_ref.size else 0.0
    return float(np.max(np.abs(x - x_ref))) / den if den else \
        float(np.max(np.abs(x), initial=0.0))
