"""sparsetpu_torch's solvers against the JAX package's, on the same
operator: the JAX ``SparseMatrix(m, backend="xla").spmv`` and the port's
``SparseMatrix(m, backend="coo", device="cpu").spmv`` (the same gather and
segment sum), or the df64 and BSR devices where a solver needs them.  The
cases are ``tests/test_solvers.py``'s and ``tests/test_df64_jit.py``'s.

Tolerances: x against the JAX x at the solver's own tolerance, scaled by
the system's conditioning where the test names it; iteration counts equal
for the float64 solvers (``cg_df64``, ``pcg_df64``, whose stopping test is
the reference's float32 one) and within +-1 in float32 (dot products summed
in another order); ``power_iteration``'s eigenvalue within 1e-3 relative
(its start vector is not ``jax.random``'s).
"""

import importlib
import inspect

import numpy as np
import pytest
import scipy.sparse as ssp
import torch

import jax
import jax.numpy as jnp

from sparsetpu import DF64
from sparsetpu import SparseMatrix as JaxSparseMatrix
from sparsetpu.formats import csr_to_bsr as jax_csr_to_bsr
from sparsetpu.kernels.bsr import BSRDevice as JaxBSRDevice

import sparsetpu_torch as st
from sparsetpu_torch import _host

# the module (``sparsetpu.solvers`` exports a function of the same name)
jcg = importlib.import_module("sparsetpu.solvers.cg")


def _ops(m):
    """(JAX spmv, port spmv) of one matrix: the XLA and COO backends."""
    return (JaxSparseMatrix(m, backend="xla").spmv,
            st.SparseMatrix(m, backend="coo", device="cpu").spmv)


def _dense_csr(dense):
    rows, cols = np.nonzero(dense)
    return _host.CSRMatrix.from_coo(rows, cols, dense[rows, cols].astype(
        np.float32), *dense.shape)


def _ill_scaled(n=24):
    """test_pcg_jacobi_converges_faster's scaled Laplacian."""
    base = _host.laplace_2d(n).to_scipy()
    d = ssp.diags(np.exp(np.linspace(0, 4, n * n)))
    return _host.CSRMatrix.from_scipy((d @ base @ d).tocsr().astype(
        np.float32))


def _nonsymmetric():
    """test_bicgstab_nonsymmetric's diagonally dominated 80x80."""
    dense = _host.random_csr(80, 80, density=0.2, seed=30).to_dense()
    return dense + np.diag(np.abs(dense).sum(axis=1) + 1.0)


def _gmres_matrix():
    """test_gmres_nonsymmetric's I + small random sparse (400x400)."""
    rng = np.random.default_rng(3)
    s = ssp.random(400, 400, density=0.02, random_state=5,
                   data_rvs=lambda k: 0.1 * rng.standard_normal(k))
    return (ssp.eye(400) + s).toarray()


def _breakdown_matrix():
    """I + a rank-2 term: its Krylov space has dimension 3, so a GMRES
    cycle with restart 10 meets hnext ~ 0 at its fourth step."""
    u = np.random.default_rng(4).standard_normal((64, 2))
    v = np.random.default_rng(5).standard_normal((2, 64))
    return np.eye(64) + 0.3 * u @ v


def test_cg_laplace_matches_jax():
    m = _host.laplace_2d(12, np.float32)
    jspmv, spmv = _ops(m)
    b = np.ones(m.nr_rows, np.float32)
    jr = jcg.cg(jspmv, jnp.asarray(b), tol=1e-5, maxiter=2000)
    r = st.cg(spmv, torch.as_tensor(b), tol=1e-5, maxiter=2000)
    assert isinstance(r.iterations, int) and r.x.dtype == torch.float32
    assert abs(r.iterations - int(jr.iterations)) <= 1
    x = r.x.numpy()
    # kappa(laplace_2d(12)) ~ 60: x within 60 * tol of the JAX x
    _close(x, np.asarray(jr.x), 60 * 1e-5)
    assert np.linalg.norm(m.to_dense() @ x - b) <= 1e-5 * np.linalg.norm(b)


def _close(x, ref, rel):
    assert np.abs(x - ref).max() <= rel * np.abs(ref).max()


def test_bicgstab_matches_jax():
    dense = _nonsymmetric()
    m = _dense_csr(dense)
    jspmv, spmv = _ops(m)
    b = np.random.default_rng(0).standard_normal(80).astype(np.float32)
    jr = jcg.bicgstab(jspmv, jnp.asarray(b), tol=1e-6, maxiter=500)
    r = st.bicgstab(spmv, b, tol=1e-6, maxiter=500, device="cpu")
    assert abs(r.iterations - int(jr.iterations)) <= 1
    _close(r.x.numpy(), np.asarray(jr.x), 1e-5)
    assert np.allclose(dense @ r.x.numpy(), b, atol=1e-3)
    np.testing.assert_allclose(float(r.residual_norm),
                               float(jr.residual_norm), rtol=0.5,
                               atol=1e-6 * np.linalg.norm(b))


@pytest.mark.parametrize("case", ["I + sparse", "breakdown"])
def test_gmres_matches_jax(case):
    dense, restart = ((_gmres_matrix(), 25) if case == "I + sparse"
                      else (_breakdown_matrix(), 10))
    m = _dense_csr(dense)
    jspmv, spmv = _ops(m)
    b = np.random.default_rng(3 if case == "I + sparse" else 6) \
        .standard_normal(m.nr_rows).astype(np.float32)
    jr = jcg.gmres(jspmv, jnp.asarray(b), restart=restart, tol=1e-5,
                   maxiter=300)
    r = st.gmres(spmv, torch.as_tensor(b), restart=restart, tol=1e-5,
                 maxiter=300)
    # iterations count Arnoldi steps, a cycle (restart) at a time
    assert abs(r.iterations - int(jr.iterations)) <= restart
    x = r.x.numpy()
    assert np.linalg.norm(dense @ x - b) < 1e-3 * np.linalg.norm(b)
    _close(x, np.asarray(jr.x), 1e-3)


def test_power_iteration_eigenvalue_matches_jax():
    m = _host.laplace_2d(8, np.float32)
    jspmv, spmv = _ops(m)
    jlam, _ = jcg.power_iteration(jspmv, m.nr_rows, iters=200)
    lam, v = st.power_iteration(spmv, m.nr_rows, iters=200, device="cpu")
    assert v.shape == (m.nr_rows,) and v.dtype == torch.float32
    assert abs(float(lam) - float(jlam)) <= 1e-3 * abs(float(jlam))
    top = np.linalg.eigvalsh(m.to_dense())[-1]
    assert abs(float(lam) - top) < 1e-2 * abs(top)


def test_pcg_and_cg_on_ill_scaled_matrix_match_jax():
    """test_pcg_jacobi_converges_faster on the XLA/COO operator: PCG needs
    fewer iterations than CG in both packages.  Plain f32 CG on this
    system (diagonal scaling e^0..e^4 squared) takes about a thousand
    iterations, and its count follows the rounding of each dot (1035 here
    against the JAX package's 1075), so only PCG's count is held to +-1."""
    m = _ill_scaled()
    jspmv, spmv = _ops(m)
    b = np.ones(m.nr_rows, np.float32)
    jr1 = jcg.cg(jspmv, jnp.asarray(b), tol=1e-5, maxiter=3000)
    jr2 = jcg.pcg(jspmv, jnp.asarray(b), jcg.jacobi_preconditioner(m),
                  tol=1e-5, maxiter=3000)
    r1 = st.cg(spmv, torch.as_tensor(b), tol=1e-5, maxiter=3000)
    r2 = st.pcg(spmv, torch.as_tensor(b),
                st.jacobi_preconditioner(m, device="cpu"), tol=1e-5,
                maxiter=3000)
    assert r2.iterations < r1.iterations
    assert int(jr2.iterations) < int(jr1.iterations)
    assert abs(r2.iterations - int(jr2.iterations)) <= 1
    assert float(r2.residual_norm) < 1e-4 * np.linalg.norm(b)
    # the stopping test bounds the error by kappa * tol, so compare the
    # true residuals (f64) instead: the port's within twice the JAX one's
    a64 = m.to_scipy().astype(np.float64)
    res, jres = (np.linalg.norm(a64 @ np.asarray(x, np.float64) - b)
                 for x in (r2.x.numpy(), jr2.x))
    assert res <= 2 * max(jres, 1e-5 * np.linalg.norm(b))


def test_jacobi_iteration_matches_jax():
    m = _host.laplace_2d(16, np.float32)
    jspmv, spmv = _ops(m)
    b = np.ones(m.nr_rows, np.float32)
    jx = np.asarray(jcg.jacobi_iteration(jspmv, m, jnp.asarray(b),
                                         iters=200, omega=0.6))
    x = st.jacobi_iteration(spmv, m, torch.as_tensor(b), iters=200,
                            omega=0.6)
    _close(x.numpy(), jx, 1e-5)
    assert np.linalg.norm(b - m.to_dense() @ x.numpy()) < \
        0.5 * np.linalg.norm(b)


def test_cg_step_matches_jax():
    m = _host.laplace_2d(6, np.float32)
    jspmv, spmv = _ops(m)
    rng = np.random.default_rng(1)
    x, r, p = (rng.standard_normal(m.nr_rows).astype(np.float32)
               for _ in range(3))
    rs = np.float32(r @ r)
    out = st.cg_step(spmv)(*(torch.as_tensor(a) for a in (x, r, p)),
                           torch.tensor(rs))
    ref = jcg.cg_step(jspmv)(*(jnp.asarray(a) for a in (x, r, p)),
                             jnp.float32(rs))
    for a, c in zip(out, ref):
        _close(a.numpy(), np.asarray(c), 1e-5)


def test_cg_df64_matches_jax_df64():
    """test_cg_df64_in_while_loop: float64 tensors where the JAX package
    carries DF64 pairs; the same iteration count (the stopping test is the
    reference's, in float32)."""
    L = _host.laplace_2d(20)
    b = np.ones(L.nr_rows, np.float64)
    jr = jax.jit(lambda A, b: jcg.cg_df64(A.spmv, b, maxiter=400))(
        JaxSparseMatrix(L), DF64.from_f64(b))
    sm = st.SparseMatrix(L, backend="coo", device="cpu")
    r = st.cg_df64(sm.spmv, b, maxiter=400, device="cpu")
    assert r.x.dtype == torch.float64 and r.residual_norm.dtype == \
        torch.float32
    assert r.iterations == int(jr.iterations)
    x = r.x.numpy()
    assert np.abs(x - jr.x.to_f64()).max() < 1e-8
    a64 = L.to_scipy().astype(np.float64)
    assert np.linalg.norm(a64 @ x - b) < 1e-6 * np.linalg.norm(b)
    import scipy.sparse.linalg as spla
    xg, _ = spla.cg(a64, b, rtol=1e-12)
    assert np.abs(x - xg).max() < 1e-8


def test_pcg_df64_matches_jax_df64():
    L = _host.laplace_2d(16)
    b = np.ones(L.nr_rows, np.float64)
    jr = jax.jit(lambda A, b: jcg.pcg_df64(
        A.spmv, b, jcg.jacobi_preconditioner(L), maxiter=300))(
        JaxSparseMatrix(L), DF64.from_f64(b))
    sm = st.SparseMatrix(L, backend="coo", device="cpu")
    r = st.pcg_df64(sm.spmv, torch.as_tensor(b),
                    st.jacobi_preconditioner(L, device="cpu"), maxiter=300)
    assert r.iterations == int(jr.iterations)
    x = r.x.numpy()
    assert np.abs(x - jr.x.to_f64()).max() < 1e-8
    resid = np.linalg.norm(L.to_scipy().astype(np.float64) @ x - b)
    assert resid < 1e-6 * np.linalg.norm(b)


def test_pcg_on_bsr_matches_jax_bsr():
    """PCG on the port's ``BSRDevice`` against JAX ``pcg`` on the JAX
    ``BSRDevice(interpret=True)``: FEM-3D Poisson 8^3, 512 rows, banded
    (half bandwidth 73)."""
    m = _host.fem_poisson_3d(8, np.float32)
    b = jax_csr_to_bsr(m)
    rhs = np.ones(m.nr_rows, np.float32)
    jr = jcg.pcg(JaxBSRDevice(b, interpret=True).spmv, jnp.asarray(rhs),
                 jcg.jacobi_preconditioner(m), tol=1e-5, maxiter=200)
    r = st.pcg(st.BSRDevice(b, device="cpu").spmv, torch.as_tensor(rhs),
               st.jacobi_preconditioner(m, device="cpu"), tol=1e-5,
               maxiter=200)
    assert abs(r.iterations - int(jr.iterations)) <= 1
    # diagonally dominant (26 against 14.67): kappa < 4
    _close(r.x.numpy(), np.asarray(jr.x), 4e-5)
    assert float(r.residual_norm) <= 1e-5 * np.linalg.norm(rhs)


def test_solvers_default_to_the_card_and_keep_a_tensors_device():
    for fn in (st.cg, st.cg_df64, st.pcg_df64, st.bicgstab, st.gmres,
               st.power_iteration, st.pcg, st.jacobi_preconditioner,
               st.jacobi_iteration):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    m = _host.laplace_2d(4, np.float32)
    spmv = st.SparseMatrix(m, backend="coo", device="cpu").spmv
    # a tensor b keeps its device, whatever ``device`` says
    r = st.cg(spmv, torch.ones(m.nr_rows), tol=1e-5)
    assert r.x.device.type == "cpu" and r.x.dtype == torch.float32
    r = st.cg(spmv, torch.ones(m.nr_rows, dtype=torch.float64), tol=1e-5)
    assert r.x.dtype == torch.float64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            st.cg(spmv, np.ones(m.nr_rows))
        with pytest.raises(RuntimeError, match="cuda"):
            st.power_iteration(spmv, m.nr_rows)
