"""sparsetpu_torch's SpGEMM (``sm @ B``) against the JAX package's and the
gold, and ``SparseMatrix.unpack`` and ``.T``.

The symbolic phase is the port's NumPy copy of the JAX package's, so C's
pattern and the event matrix must be identical; the numeric phase is the
port's SpMV on the event matrix (the plain versions on the CPU).
Tolerances: C's values against ``spgemm_gold`` and the JAX C at the JAX
test's 1e-4 (rtol and atol; f32 values, a few products a term).
"""

import importlib

import numpy as np
import pytest
import torch

from sparsetpu.formats.random import random_csr

import sparsetpu_torch as st
from sparsetpu_torch import _host

# both packages' ``kernels`` export a function ``spgemm`` that shadows the
# module of that name
jsg = importlib.import_module("sparsetpu.kernels.spgemm")
sg = importlib.import_module("sparsetpu_torch.kernels.spgemm")

SHAPES = [((200, 300), (300, 150), 0.05, 0.05),
          ((64, 64), (64, 64), 0.2, 0.2),
          ((500, 100), (100, 800), 0.02, 0.03)]


def _assert_csr_close(c, g, tol=1e-4):
    """``tests/test_spgemm.py``'s check: C's pattern is the gold's (indices
    sorted), its values within ``tol``."""
    assert c.nr_rows == g.nr_rows and c.nr_cols == g.nr_cols
    gs = g.to_scipy().tocsr()
    gs.sum_duplicates()
    gs.sort_indices()
    np.testing.assert_array_equal(c.row_ptr, gs.indptr)
    np.testing.assert_array_equal(c.col_ind, gs.indices)
    assert c.values.dtype == np.float32
    np.testing.assert_allclose(c.values, gs.data, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape_a,shape_b,da,db", SHAPES)
def test_spgemm_matches_gold_and_jax_symbolic_phase(shape_a, shape_b, da,
                                                    db):
    a = random_csr(*shape_a, density=da, seed=31)
    b = random_csr(*shape_b, density=db, seed=32)
    for x, y in zip(sg._expand_events(a, b), jsg._expand_events(a, b)):
        for u, v in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            assert u.dtype == v.dtype and np.array_equal(u, v)
    c = st.spgemm(a, b, device="cpu")
    assert isinstance(c, _host.CSRMatrix)
    _assert_csr_close(c, _host.spgemm_gold(a, b))


def test_spgemm_matches_jax_numeric_phase():
    """One case through the JAX package's whole SpGEMM (the event matrix
    on its Pallas device, interpret mode)."""
    a = random_csr(200, 300, density=0.05, seed=31)
    b = random_csr(300, 150, density=0.05, seed=32)
    c = st.spgemm(a, b, device="cpu")
    jc = jsg.spgemm(a, b, interpret=True)
    np.testing.assert_array_equal(c.row_ptr, jc.row_ptr)
    np.testing.assert_array_equal(c.col_ind, jc.col_ind)
    np.testing.assert_allclose(c.values, jc.values, rtol=1e-4, atol=1e-4)


def test_plan_reuse_with_new_b_values():
    """Same B structure, new values: one SpMV on the kept event matrix."""
    a = random_csr(100, 80, density=0.1, seed=33)
    b = random_csr(80, 120, density=0.1, seed=34)
    plan = st.SpGEMMPlan(a, b, device="cpu")
    assert plan.flops == 2 * int(np.diff(b.row_ptr)[a.col_ind].sum())
    for seed in (0, 1):
        vals = np.random.default_rng(seed).standard_normal(
            b.nr_nzeros).astype(np.float32)
        b2 = _host.CSRMatrix(b.row_ptr, b.col_ind, vals, b.nr_rows,
                             b.nr_cols)
        cv = plan(vals)
        assert isinstance(cv, torch.Tensor) and cv.dtype == torch.float32
        _assert_csr_close(plan.to_csr(cv), _host.spgemm_gold(a, b2))


def test_empty_result_and_shape_mismatch():
    a = _host.CSRMatrix.from_coo(np.array([0]), np.array([0]),
                                 np.array([1.0], np.float32), 4, 5)
    b = _host.CSRMatrix.from_coo(np.array([3]), np.array([2]),
                                 np.array([1.0], np.float32), 5, 6)
    c = st.spgemm(a, b, device="cpu")
    assert c.nr_nzeros == 0 and (c.nr_rows, c.nr_cols) == (4, 6)
    assert st.SpGEMMPlan(a, b, device="cpu").event_matrix is None
    with pytest.raises(ValueError, match="dimension mismatch"):
        st.spgemm(random_csr(10, 20, density=0.2, seed=1),
                  random_csr(30, 10, density=0.2, seed=2), device="cpu")


@pytest.mark.parametrize("operand", ["csr", "sparse_matrix"])
def test_sparse_at_sparse_operator(operand):
    """``sm @ m`` and ``sm @ sm``: SpGEMM on the left matrix's device, a
    host ``CSRMatrix``; the coo backend raises, as the JAX xla backend
    does."""
    a = random_csr(60, 40, density=0.15, seed=5, dtype=np.float32)
    b = random_csr(40, 50, density=0.15, seed=6, dtype=np.float32)
    A = st.SparseMatrix(a, device="cpu")
    B = b if operand == "csr" else st.SparseMatrix(b, device="cpu")
    _assert_csr_close(A @ B, _host.spgemm_gold(a, b))
    with pytest.raises(ValueError, match="coo"):
        st.SparseMatrix(a, backend="coo", device="cpu") @ B


def test_unpack_and_transpose():
    a = random_csr(300, 2000, density=0.01, seed=1, dtype=np.float32)
    A = st.SparseMatrix(a, device="cpu")
    assert A.unpack() is a
    At = A.T
    assert At is A.T is A.transpose()                       # cached
    assert At.shape == (2000, 300) and At.config is A.config
    assert At.device == A.device and At.backend == A.backend
    x = np.random.default_rng(2).standard_normal(300)
    tol = _host.default_tolerance(np.float32, 2.0)
    assert _host.verification(a.to_scipy().T @ x, (At @ x).numpy(),
                              *tol) == 0
    with pytest.raises(ValueError, match="COO"):
        st.SparseMatrix(a, backend="coo", device="cpu").unpack()
    # a handle without its source CSR: a classic pack unpacks, a fused
    # one raises (``sparsetpu/api/api.py:369-384``)
    wide = st.SparseMatrix(a, _host.SpmvConfig(dtype=np.float32,
                                               block_cols=8192),
                           device="cpu")
    wide._source = None
    back = wide.unpack()
    assert np.array_equal(back.to_dense(), a.to_dense())
    A._source = None
    with pytest.raises(ValueError, match="source"):
        A.unpack()


def test_reference_named_host_api():
    """``create_csr_hw_matrix`` / ``create_csr_hw_x_vector`` / ``spmv_hw``
    give ``A @ x`` (bit for bit: the same route and kernels); ``unpack``
    returns the kept CSR; the ``delete_*`` calls are no-ops."""
    a = random_csr(300, 2000, density=0.01, seed=1, dtype=np.float32)
    hw = st.create_csr_hw_matrix(a, device="cpu")
    assert isinstance(hw, st.SparseMatrix) and st.unpack(hw) is a
    x = np.random.default_rng(4).standard_normal(a.nr_cols)
    hx = st.create_csr_hw_x_vector(hw, x)
    y = st.spmv_hw(hw, hx)
    assert np.array_equal(y.numpy(), (hw @ x).numpy())
    tol = _host.default_tolerance(np.float32, a.nr_nzeros / a.nr_rows)
    assert _host.verification(_host.spmv_gold(a, x), y.numpy(), *tol) == 0
    assert st.delete_csr_hw_x_vector(hx) is None
    assert st.delete_csr_hw_matrix(hw) is None
