"""sparsetpu_torch.SparseMatrix: routing as the JAX package routes, the
COO backend, the module functions and the CLI.

Every f32 route of ``sparsetpu.SparseMatrix`` is ported: the fused layout,
the heavy-row hybrid, the classic GStream device (wide x, ``block_cols <
16384``, bf16 values) and row partitions; each case takes the same device
kind as the JAX package and gives the same y (rtol 1e-5, atol 1e-5 *
max(1, max|y|): the same f32 terms summed in another order).  f64 still
raises ``NotImplementedError``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sparsetpu.api.api import SparseMatrix as JaxSparseMatrix
from sparsetpu.formats.csr import CSRMatrix
from sparsetpu.formats.gold import default_tolerance, spmv_gold, verification
from sparsetpu.formats.random import random_csr
from sparsetpu.kernels.spmv_fused import FusedDevice as JaxFusedDevice
from sparsetpu.kernels.spmv_pallas import GStreamDevice as JaxGStreamDevice
from sparsetpu.pack.fused import MAX_RESIDENT_COLS, pack_fused
from sparsetpu.utils.config import SpmvConfig
import sparsetpu_torch as st
from sparsetpu_torch.kernels.spmv_coo import spmv_chunked

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gold_ok(m, x, y):
    tol = default_tolerance(np.float32, m.nr_nzeros / max(m.nr_rows, 1))
    assert verification(spmv_gold(m, x), np.asarray(y), *tol) == 0


def _heavy_matrix(n=3000, heavy_every=500, heavy_nnz=200):
    """Mostly 3 nnz/row (scattered profile: the ladder is (32,)), with a few
    rows far above 32 nnz."""
    rng = np.random.default_rng(0)
    rows, cols = [], []
    for r in range(n):
        k = heavy_nnz if r % heavy_every == 0 else 3
        rows.append(np.full(k, r))
        cols.append(rng.choice(n, k, replace=False))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return CSRMatrix.from_coo(rows, cols, vals, n, n)


def test_same_route_and_y_as_jax():
    m = random_csr(600, 4000, density=0.01, seed=3, dtype=np.float32)
    x = np.random.default_rng(0).standard_normal(m.nr_cols)
    jsm = JaxSparseMatrix(m, SpmvConfig(dtype=np.float32), interpret=True)
    assert isinstance(jsm._device, JaxFusedDevice)
    sm = st.SparseMatrix(m, device="cpu")
    assert sm.fused_device is not None
    for k in ("Q", "T", "GLW", "n_steps", "n_slabs", "SGRP", "fin_direct"):
        assert getattr(sm.packed, k) == getattr(jsm.packed, k), k
    assert np.array_equal(sm.packed.values, jsm.packed.values)
    assert sm.fill_factor() == jsm.fill_factor()
    assert sm.storage_overhead() == jsm.storage_overhead()
    y_jax = np.asarray(jsm @ x)
    y = (sm @ x).numpy()
    atol = 1e-5 * max(1.0, float(np.abs(y_jax).max()))
    np.testing.assert_allclose(y, y_jax, rtol=1e-5, atol=atol)
    _gold_ok(m, x, y)
    np.testing.assert_array_equal(sm.spmv_packed_x(sm.prepare_x(x)).numpy(),
                                  y)


def _same_y(m, cfg, x, jsm, sm):
    """y of the port equals the JAX package's and passes the gold."""
    y_jax = np.asarray(jsm @ x)
    y = (sm @ x).numpy()
    atol = 1e-5 * max(1.0, float(np.abs(y_jax).max()))
    np.testing.assert_allclose(y, y_jax, rtol=1e-5, atol=atol)
    _gold_ok(m, x, y)


def test_heavy_rows_raise_where_jax_leaves_the_plain_fused_device():
    """(The name dates from before the hybrid was ported.)  Heavy rows take
    the hybrid in both packages: the light rows fused, the heavy rows on a
    classic device, y added back at the heavy rows."""
    m = _heavy_matrix()
    x = np.random.default_rng(2).standard_normal(m.nr_cols)
    jsm = JaxSparseMatrix(m, SpmvConfig(dtype=np.float32), interpret=True)
    assert jsm._heavy_dev is not None
    sm = st.SparseMatrix(m, device="cpu")
    assert sm.fused_device is not None and sm.heavy_device is not None
    assert np.array_equal(sm._heavy_rows.numpy(),
                          np.asarray(jsm._heavy_rows))
    assert np.array_equal(sm.heavy_device.meta.values,
                          jsm._heavy_dev.meta.values)
    _same_y(m, None, x, jsm, sm)
    np.testing.assert_array_equal(sm.spmv_packed_x(sm.prepare_x(x)).numpy(),
                                  (sm @ x).numpy())


def test_wide_x_raises_where_jax_goes_classic():
    """(The name dates from before the classic device was ported.)  x wider
    than the resident budget goes wholly classic in both packages;
    ``backend="fused"`` still raises."""
    m = random_csr(10, MAX_RESIDENT_COLS + 1024, density=1e-5, seed=0,
                   dtype=np.float32)
    assert pack_fused(m) is None
    x = np.random.default_rng(1).standard_normal(m.nr_cols)
    jsm = JaxSparseMatrix(m, SpmvConfig(dtype=np.float32), interpret=True)
    assert isinstance(jsm._device, JaxGStreamDevice)
    sm = st.SparseMatrix(m, device="cpu")
    assert isinstance(sm.device_module, st.GStreamDevice)
    _same_y(m, None, x, jsm, sm)
    with pytest.raises(ValueError, match="not applicable"):
        st.SparseMatrix(m, backend="fused", device="cpu")


@pytest.mark.parametrize("cfg,match", [
    (dict(dtype=np.float64), "Queue 1 #6"),
    (dict(dtype=np.float32, num_partitions=2), "Queue 1 #4"),
    (dict(dtype=np.float32, block_cols=8192), "Queue 1 #4"),
])
def test_unported_devices_raise(cfg, match):
    """``match`` names the ROADMAP item: f64 still raises naming it; the
    routes it ported (partitions, block_cols < 16384) take the JAX
    package's device kinds and give its y."""
    m = random_csr(300, 2000, density=0.01, seed=1, dtype=np.float32)
    if match != "Queue 1 #4":
        with pytest.raises(NotImplementedError, match=match):
            st.SparseMatrix(m, SpmvConfig(**cfg), device="cpu")
        return
    x = np.random.default_rng(5).standard_normal(m.nr_cols)
    jsm = JaxSparseMatrix(m, SpmvConfig(**cfg), interpret=True)
    sm = st.SparseMatrix(m, SpmvConfig(**cfg), device="cpu")
    if jsm._parts is not None:
        kinds = [type(d).__name__ for d in jsm._parts]
        assert [type(d).__name__ for d in sm.parts] == kinds
    else:
        assert isinstance(jsm._device, JaxGStreamDevice)
        assert isinstance(sm.device_module, st.GStreamDevice)
        assert np.array_equal(sm.packed.values, jsm.packed.values)
    _same_y(m, cfg, x, jsm, sm)


def test_fused_spmm_and_spgemm_raise():
    m = random_csr(300, 2000, density=0.01, seed=1, dtype=np.float32)
    sm = st.SparseMatrix(m, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 #5"):
        sm @ np.ones((m.nr_cols, 2))
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        sm @ m


def test_device_is_required():
    """The entry points run on the card unless the caller asks for the
    CPU; without a card the default raises instead of falling back."""
    import inspect
    for fn in (st.SparseMatrix, st.pack, st.spmv):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        m = random_csr(300, 2000, density=0.01, seed=1, dtype=np.float32)
        with pytest.raises(RuntimeError, match="cuda"):
            st.SparseMatrix(m)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_coo_backend_matches_gold(dtype):
    m = random_csr(700, 900, density=0.02, seed=2, dtype=dtype)
    x = np.random.default_rng(3).standard_normal(m.nr_cols)
    sm = st.SparseMatrix(m, backend="coo", device="cpu")
    y = sm @ x
    assert y.dtype == (torch.float64 if dtype == np.float64
                       else torch.float32)
    _gold_ok(m, x, y.numpy())
    X = np.random.default_rng(4).standard_normal((m.nr_cols, 3))
    Y = (sm @ X).numpy()
    G = np.stack([spmv_gold(m, X[:, k]) for k in range(3)], axis=1)
    np.testing.assert_allclose(Y, G, rtol=1e-4, atol=1e-4)


def test_spmv_chunked_drops_trap_row():
    sums = torch.tensor([1.0, 2.0, 3.0, 4.0])
    rows = torch.tensor([0, 0, 2, 3])       # row 3 == nr_rows: the trap
    assert spmv_chunked(sums, rows, 3).tolist() == [3.0, 0.0, 3.0]


def test_module_functions():
    m = random_csr(500, 3000, density=0.01, seed=6, dtype=np.float32)
    x = np.random.default_rng(1).standard_normal(m.nr_cols)
    _gold_ok(m, x, st.spmv(m, x, device="cpu").numpy())
    sm = st.pack(m, device="cpu")
    _gold_ok(m, x, st.spmv(sm, torch.as_tensor(x), device="cpu").numpy())


def test_cli_random_cpu_passes():
    out = subprocess.run(
        [sys.executable, "-m", "sparsetpu_torch", "--random",
         "2000x2000x0.005", "--device", "cpu", "--repeats", "5"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Verification: PASS" in out.stdout


@pytest.mark.parametrize("flag", [["--double"],
                                  ["--double", "--partitions", "2"]])
def test_cli_unported_flags_raise(flag):
    from sparsetpu_torch.cli import main
    with pytest.raises(NotImplementedError):
        main(["--random", "100x100x0.05", "--device", "cpu", *flag])


def test_cli_partitions_cpu_passes():
    from sparsetpu_torch.cli import main
    assert main(["--random", "600x4000x0.01", "--device", "cpu",
                 "--partitions", "2", "--repeats", "2"]) == 0


def test_bench_cpu_reports_no_roofline():
    from sparsetpu_torch.bench.harness import bench_spmv
    m = random_csr(500, 3000, density=0.01, seed=6, dtype=np.float32)
    r = bench_spmv(m, repeats=3, device="cpu")
    assert r.verify_errors == 0 and np.isnan(r.roofline_frac)
    assert r.kernel_ms > 0 and r.layout_q in (1, 2, 4, 8)
    assert "Verification: PASS" in r.report()
