"""sparsetpu_torch's BSR device (#14) against the JAX package's.

The same host ``BSRMatrix`` (built by the JAX package's ``csr_to_bsr``,
which the port's copy must match byte for byte) goes to the JAX
``BSRDevice(interpret=True)`` and to the port's ``BSRDevice(device="cpu")``,
whose wrapper runs the kernel's plain PyTorch version on CPU tensors.

Tolerances: the partials, rtol 1e-6 and atol 1e-6 * max|ref| (the same 128
f32 products a row, summed in another order); y against the JAX y, rtol
1e-5 and atol 1e-5 * max(1, max|y|) (the block-row final adds the partials
in the same order, the partials differ in rounding only); y against the
gold at the JAX test's 1e-3 (``tests/test_kernels_ext.py:33-50``) and at
``default_tolerance(float32, nnz/row)``.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparsetpu.formats.convert import csr_to_bsr as jax_csr_to_bsr
from sparsetpu.formats.random import banded_csr, random_csr
from sparsetpu.kernels import bsr as jbsr
from sparsetpu.kernels import spmv_pallas as jsp

import sparsetpu_torch as st
from sparsetpu_torch import _host
from sparsetpu_torch.kernels import bsr
from sparsetpu_torch.pack import final_levels as fl
from test_torch_fused import native_engines_first  # noqa: F401 (autouse)

CASES = {
    "banded 300x300 bw 10": lambda: banded_csr(300, 300, bandwidth=10),
    "banded 1000x700 bw 40": lambda: banded_csr(1000, 700, bandwidth=40),
    "random 200x500": lambda: random_csr(200, 500, density=0.05, seed=72),
    # nr_rows % 8 and nr_cols % 128 nonzero
    "ragged 1001x1001": lambda: random_csr(1001, 1001, density=0.01, seed=73,
                                           dtype=np.float32),
}


def _close_to(y, ref, rtol=1e-5):
    y, ref = np.asarray(y), np.asarray(ref)
    atol = rtol * max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    np.testing.assert_allclose(y, ref, rtol=rtol, atol=atol)


def _gold_ok(m, x, y):
    assert _host.verification(_host.spmv_gold(m, x), y, diff_thres=1e-3,
                              rel_thres=1e-3) == 0
    tol = _host.default_tolerance(np.float32, m.nr_nzeros / max(m.nr_rows, 1))
    assert _host.verification(_host.spmv_gold(m, x), y, *tol) == 0


@pytest.mark.parametrize("case", list(CASES) + ["fem 8^3 f32"])
def test_csr_to_bsr_is_byte_identical_to_jax(case):
    m = (_host.fem_poisson_3d(8, np.float32) if case.startswith("fem")
         else CASES[case]())
    a, b = jax_csr_to_bsr(m), _host.csr_to_bsr(m)
    for k in ("row_ptr", "col_ind", "values"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k
    assert (a.nr_rows, a.nr_cols) == (b.nr_rows, b.nr_cols)
    back = _host.bsr_to_csr(b)
    assert np.array_equal(back.to_dense(), m.to_dense())
    coo = _host.csr_to_coo(back)
    assert np.array_equal(_host.coo_to_csr(coo).col_ind, back.col_ind)


def _jax_parts8(d):
    """The JAX kernel's output, undone to (n_blocks, 8) as ``bsr.py:125-127``
    undoes it."""
    x2 = jnp.asarray(d._x2)
    parts = jbsr._bsr_partials(d.bcol, x2, d.blocks,
                               blocks_per_step=d.BLOCKS_PER_STEP,
                               n_steps=d.n_steps, interpret=True)
    tiles = np.asarray(parts).reshape(d.n_blocks // jbsr.GROUP, 8, 128)
    return tiles[:, :, :jbsr.GROUP].transpose(0, 2, 1).reshape(
        d.n_blocks, 8)


def test_partials_reference_matches_jax_kernel():
    m = CASES["banded 1000x700 bw 40"]()
    b = jax_csr_to_bsr(m)
    jd = jbsr.BSRDevice(b, interpret=True)
    d = st.BSRDevice(b, device="cpu")
    x = np.random.default_rng(3).standard_normal(m.nr_cols)
    x2 = d.prepare_x(x)
    jd._x2 = x2.numpy()
    before = bsr.bsr_partials.launches
    parts = d.partials(x2)
    assert bsr.bsr_partials.launches == before       # CPU: no launch
    assert tuple(parts.shape) == (d.n_blocks, 8)
    np.testing.assert_array_equal(
        parts.numpy(), bsr.bsr_partials_reference(d.blocks, d.bcol,
                                                  x2).numpy())
    _close_to(parts.numpy(), _jax_parts8(jd), rtol=1e-6)
    np.testing.assert_array_equal(d.blocks.numpy(), np.asarray(jd.blocks))
    np.testing.assert_array_equal(d.bcol.numpy(), np.asarray(jd.bcol))


@pytest.mark.parametrize("case", ["banded 1000x700 bw 40",
                                  "ragged 1001x1001"])
def test_block_row_final_is_the_jax_final(case):
    b = jax_csr_to_bsr(CASES[case]())
    jfin = jbsr.BSRDevice(b, interpret=True).final
    fin = st.BSRDevice(b, device="cpu").plan
    assert fin is not None and jfin is not None
    for k in ("tiles_per_step", "G", "nw", "nt_pad", "x_pad_rows"):
        assert getattr(fin, k) == getattr(jfin, k), k
    for k in ("step_meta", "cell_idx", "route", "spill_pos", "spill_row"):
        a, c = getattr(fin, k), getattr(jfin, k)
        if c is None:
            assert a is None or np.asarray(a).size == 0, k
            continue
        assert np.array_equal(np.asarray(a), np.asarray(c)), k


@pytest.mark.parametrize("case", list(CASES))
def test_spmv_matches_jax_and_gold(case):
    """One host BSRMatrix (the JAX package's) feeds both devices."""
    m = CASES[case]()
    b = jax_csr_to_bsr(m)
    x = np.random.default_rng(3).standard_normal(m.nr_cols)
    y = st.bsr_spmv(b, x, device="cpu")
    assert y.dtype == torch.float32 and tuple(y.shape) == (m.nr_rows,)
    _close_to(y.numpy(), np.asarray(jbsr.bsr_spmv(b, x, interpret=True)))
    _gold_ok(m, x, y.numpy())
    np.testing.assert_allclose(y.numpy(), _host.bsr_spmv_gold(b, x),
                               rtol=1e-4, atol=1e-4)


def test_segment_sum_route_matches_jax(monkeypatch):
    """No final builds (stubbed in both packages, as a pathological
    placement makes it): both reduce the partials by a segment sum."""
    none = classmethod(lambda cls, *a, **k: None)
    monkeypatch.setattr(fl._FinalLevel, "build", none)
    monkeypatch.setattr(jsp._FinalLevel, "build", none)
    m = CASES["ragged 1001x1001"]()
    b = jax_csr_to_bsr(m)
    jd = jbsr.BSRDevice(b, interpret=True)
    d = st.BSRDevice(b, device="cpu")
    assert jd.final is None and d.final is None and d.plan is None
    np.testing.assert_array_equal(d.brow.numpy(), np.asarray(jd.brow))
    x = np.random.default_rng(5).standard_normal(m.nr_cols)
    y = d.spmv(x).numpy()
    _close_to(y, np.asarray(jd.spmv(x)))
    _gold_ok(m, x, y)


def test_bad_blocks_and_block_columns_raise():
    m = CASES["random 200x500"]()
    with pytest.raises(ValueError, match="blocks"):
        st.BSRDevice(_host.csr_to_bsr(m, block_shape=(4, 128)), "cpu")
    with pytest.raises(ValueError, match="blocks"):
        jbsr.BSRDevice(jax_csr_to_bsr(m, block_shape=(8, 64)),
                       interpret=True)
    b = _host.csr_to_bsr(m)
    b.col_ind = b.col_ind.copy()
    b.col_ind[-1] = 4                  # x has 500 columns: 4 segments
    with pytest.raises(ValueError, match="block column"):
        st.BSRDevice(b, "cpu")
    d = st.BSRDevice(_host.csr_to_bsr(m), "cpu")
    with pytest.raises(ValueError, match="x has shape"):
        d.spmv(np.ones(499))
    with pytest.raises(ValueError, match="bcol"):
        bsr.bsr_partials(d.blocks, d.bcol.long(), d.prepare_x(np.ones(500)))


def test_bsr_entry_points_default_to_the_card():
    for fn in (st.BSRDevice, st.bsr_spmv):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        b = _host.csr_to_bsr(CASES["random 200x500"]())
        with pytest.raises(RuntimeError, match="cuda"):
            st.BSRDevice(b)
