from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from spbench.generators.csr import Csr
from spbench.reference import spmv as ref


def _random_csr(rng, n, m, dtype, empty_rows=True):
    d = rng.standard_normal((n, m)) * (rng.random((n, m)) < 0.2)
    if empty_rows:
        d[::5] = 0.0
    rows, cols = np.nonzero(d)
    row_ptr = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=n), out=row_ptr[1:])
    return Csr(row_ptr, cols.astype(np.int32), d[rows, cols].astype(dtype),
               n, m), d.astype(dtype).astype(np.float64)


@pytest.mark.parametrize("threads", [None, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmv_against_dense(dtype, threads):
    rng = np.random.default_rng(1)
    csr, d = _random_csr(rng, 97, 61, dtype)
    x = rng.standard_normal(61).astype(dtype)
    with ThreadPoolExecutor(threads or 1) as ex:
        y = ref.spmv(csr, x, np.float64, ex if threads else None)
        y_lo = ref.spmv(csr, x, dtype, ex if threads else None)
        scale = ref.abs_row_sums(csr, x, ex if threads else None)
    np.testing.assert_allclose(y, d @ x.astype(np.float64), rtol=1e-12,
                               atol=1e-12)
    assert y_lo.dtype == dtype
    np.testing.assert_allclose(scale, np.abs(d) @ np.abs(x.astype(
        np.float64)), rtol=1e-12)
    eps = np.finfo(dtype).eps
    assert ref.spmv_err(y_lo, y, scale) <= 30 * eps


def test_bf16_rounding():
    a = np.array([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 3.0e38, -2.5],
                 np.float32)
    r = ref.round_bf16(a)
    assert r[0] == 1.0 and r[1] == 1.0 and r[2] == 1.0 + 2 ** -6
    assert r[4] == -2.5
    assert (ref.round_bf16(r) == r).all()
    u = r.view(np.uint32)
    assert (u & 0xFFFF == 0).all()


def test_spmv_err_faults():
    y_ref = np.array([1.0, 0.0, -2.0])
    scale = np.array([1.0, 0.0, 2.0])
    assert ref.spmv_err(y_ref.copy(), y_ref, scale) == 0.0
    assert ref.spmv_err(np.array([1.0, 1e-30, -2.0]), y_ref, scale) == \
        float("inf")
    assert ref.spmv_err(np.array([np.nan, 0.0, -2.0]), y_ref, scale) == \
        float("inf")
    assert ref.spmv_err(y_ref[:2], y_ref, scale) == float("inf")
    assert ref.spmv_err(np.array([1.5, 0.0, -2.0]), y_ref, scale) == 0.5


def test_pcg_against_dense_pcg():
    rng = np.random.default_rng(2)
    n = 40
    m = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.2)
    d = m @ m.T + n * np.eye(n)
    rows, cols = np.nonzero(d)
    row_ptr = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=n), out=row_ptr[1:])
    csr = Csr(row_ptr, cols.astype(np.int32), d[rows, cols], n, n)
    b = rng.standard_normal(n)
    inv = (1.0 / np.diag(d)).astype(np.float32).astype(np.float64)
    x, r, p = np.zeros(n), b.copy(), inv * b
    z, rz = p, b @ (inv * b)
    for _ in range(7):
        ap = d @ p
        alpha = rz / (p @ ap)
        x, r = x + alpha * p, r - alpha * ap
        z = inv * r
        rz, rz_old = r @ z, rz
        p = z + rz / rz_old * p
    xr, rn, steps = ref.pcg(csr, b, 7)
    assert steps == 7
    np.testing.assert_allclose(xr, x, rtol=1e-10, atol=1e-12)
    assert rn == pytest.approx(np.linalg.norm(r), rel=1e-8)
    # converged to the end: r.r rounds to 0 in float32, as pcg_df64 stops
    _, _, steps = ref.pcg(csr, b, 500)
    assert steps < 500


def test_vec_err():
    x = np.array([1.0, -4.0])
    assert ref.vec_err(x, x) == 0.0
    assert ref.vec_err(np.array([1.0, -3.0]), x) == 0.25
    assert ref.vec_err(np.array([np.inf, 0.0]), x) == float("inf")
