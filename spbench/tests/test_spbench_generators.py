import numpy as np
import pytest

from spbench.generators import hpcg, urand


def _dense(c):
    d = np.zeros((c.nr_rows, c.nr_cols))
    rows = np.repeat(np.arange(c.nr_rows), np.diff(c.row_ptr))
    d[rows, c.col_ind] = c.values
    return d


@pytest.mark.parametrize("n", [(2, 2, 2), (3, 4, 5), (8, 8, 8), (16, 3, 9)])
def test_hpcg_stencil(n):
    nx, ny, nz = n
    c = hpcg.generate({"nx": nx, "ny": ny, "nz": nz, "dtype": "float64"},
                      np.random.default_rng(0))
    assert c.nnz == (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    assert c.nr_rows == c.nr_cols == nx * ny * nz
    assert c.values.dtype == np.float64 and c.col_ind.dtype == np.int32
    d = _dense(c)
    assert (d == d.T).all()
    assert (np.diag(d) == 26.0).all()
    off = d - np.diag(np.diag(d))
    assert set(np.unique(off)) <= {0.0, -1.0}
    # every neighbour within one step in each direction, nothing else
    ix, iy, iz = np.unravel_index(np.arange(c.nr_rows), (nz, ny, nx))[::-1]
    near = ((np.abs(ix[:, None] - ix[None]) <= 1)
            & (np.abs(iy[:, None] - iy[None]) <= 1)
            & (np.abs(iz[:, None] - iz[None]) <= 1))
    assert ((d != 0) == near).all()
    for i in range(c.nr_rows):
        assert (np.diff(c.col_ind[c.row_ptr[i]:c.row_ptr[i + 1]]) > 0).all()


def test_hpcg104_sizes_from_formula():
    n = 104
    assert n ** 3 == 1124864 and (3 * n - 2) ** 3 == 29791000


def test_urand_deterministic_by_seed():
    cfg = {"scale": 10, "edge_factor": 16, "dtype": "float32"}
    a = urand.generate(cfg, np.random.default_rng([2 ** 31 + 5, 0]))
    b = urand.generate(cfg, np.random.default_rng([2 ** 31 + 5, 0]))
    c = urand.generate(cfg, np.random.default_rng([2 ** 31 + 6, 0]))
    for f in ("row_ptr", "col_ind", "values"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert not np.array_equal(a.col_ind[:1000], c.col_ind[:1000])


def test_urand_graph():
    cfg = {"scale": 11, "edge_factor": 16, "dtype": "float32"}
    c = urand.generate(cfg, np.random.default_rng(3))
    n = 1 << 11
    assert c.nr_rows == c.nr_cols == n and c.values.dtype == np.float32
    d = _dense(c)
    pattern = d != 0
    assert (pattern == pattern.T).all()          # undirected
    assert not np.diag(pattern).any()            # no self-loops
    deg = pattern.sum(axis=0)
    # PageRank's A^T D^-1: each column's entries are 1 / its degree
    np.testing.assert_allclose(d.sum(axis=0)[deg > 0], 1.0, rtol=1e-5)
    # at most 2 * 16 * n entries, duplicates removed
    assert c.nnz <= 2 * 16 * n and c.nnz > 0.99 * 2 * 16 * n
    assert np.median(np.diff(c.row_ptr)) in (31, 32, 33)
    for i in range(0, n, 97):
        assert (np.diff(c.col_ind[c.row_ptr[i]:c.row_ptr[i + 1]]) > 0).all()
