"""The float64 solvers' CUDA graph path (``solvers/cg.py``): ``cg_df64``
and ``pcg_df64`` replay each iteration as one graph where ``spmv`` is a
port ``SparseMatrix``'s on the card and ``m_inv`` the port's Jacobi, and
run the eager loop for everything else.  Imports nothing of JAX.

On the CPU: a user's function, a CPU tensor and ``BSRDevice.spmv`` run
eagerly (``eager_iterations`` counts them); the eager loop is the loop it
replaced bit for bit; the Jacobi object is the lambda it replaced bit for
bit; the graph cache holds its matrix and preconditioner weakly.  On the
card (``python -m pytest tests/test_torch_solvers_graph.py -m gpu
--noconftest``; skipped without one), over an HPCG-like 27-point f64
matrix on the classic and the fused f64 routes: the graph's x,
``iterations`` and ``residual_norm`` equal the eager loop's
(``torch.equal``) at ``tol=0`` and at a ``tol`` that stops early; one
capture serves two solves; the kernel wrappers' launch counts of a
replayed solve are the eager loop's; each solve returns its own x."""

import collections
import gc
import importlib
import threading
import time

import numpy as np
import pytest
import torch

import sparsetpu_torch as st
from sparsetpu_torch import _host
from sparsetpu_torch.kernels.f64emu import DF64GStreamDevice
from sparsetpu_torch.kernels.spmv_fused import DF64FusedDevice

# the module (``sparsetpu_torch.solvers`` exports a function of the same
# name)
cgm = importlib.import_module("sparsetpu_torch.solvers.cg")

# route: (config's block_cols, the device module it must pick)
ROUTES = {"classic_f64": (8192, DF64GStreamDevice),
          "fused_f64": (None, DF64FusedDevice)}


def _hpcg(n: int) -> _host.CSRMatrix:
    """HPCG's 27-point stencil on an n^3 grid: 26 on the diagonal, -1 to
    each neighbour (``GenerateProblem_ref.cpp``)."""
    idx = np.arange(n)
    i, j, k = (a.ravel() for a in np.meshgrid(idx, idx, idx, indexing="ij"))
    rows, cols, vals = [], [], []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                ok = ((i + di >= 0) & (i + di < n) & (j + dj >= 0)
                      & (j + dj < n) & (k + dk >= 0) & (k + dk < n))
                rows.append(((i * n + j) * n + k)[ok])
                cols.append((((i + di) * n + j + dj) * n + k + dk)[ok])
                vals.append(np.full(int(ok.sum()), 26.0 if di == dj == dk
                                    == 0 else -1.0))
    return _host.CSRMatrix.from_coo(np.concatenate(rows),
                                    np.concatenate(cols),
                                    np.concatenate(vals), n ** 3, n ** 3)


def _matrix(route, device, n=8):
    block_cols, kind = ROUTES[route]
    cfg = st.SpmvConfig(dtype=np.float64, **(
        {} if block_cols is None else {"block_cols": block_cols}))
    m = _hpcg(n)
    sm = st.SparseMatrix(m, cfg, device=device)
    assert type(sm.device_module) is kind
    return m, sm


def _b(m, seed, device):
    x = np.random.default_rng(seed).uniform(0.0, 1.0, m.nr_cols)
    return torch.as_tensor(_host.spmv_gold(m, x), device=device)


def _old_loop(spmv, b, m_inv, maxiter, tol):
    """The float64 loop before the graph path, as it was written."""
    x = torch.zeros_like(b)
    r = b - spmv(x)
    z = r if m_inv is None else m_inv(r)
    p = z
    rz = torch.dot(r, z)
    tol2 = torch.tensor(tol, dtype=torch.float32) ** 2 * torch.clamp_min(
        torch.dot(b, b).float(), 1e-30)
    k = 0
    while k < maxiter:
        rr = rz if m_inv is None else torch.dot(r, r)
        if not bool(rr.float() > tol2):
            break
        ap = spmv(p)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = r if m_inv is None else m_inv(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    rr = rz if m_inv is None else torch.dot(r, r)
    return x, k, torch.sqrt(rr.float())


def _solve(solver, spmv, b, jac, **kw):
    return (st.pcg_df64(spmv, b, jac, **kw) if solver == "pcg"
            else st.cg_df64(spmv, b, **kw))


def _counter(solver):
    return (st.pcg_df64 if solver == "pcg" else st.cg_df64).graphs


def _same(a, b):
    assert torch.equal(a.x, b.x) and a.iterations == b.iterations
    assert torch.equal(a.residual_norm, b.residual_norm)


# -- CPU ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_system():
    m, sm = _matrix("classic_f64", "cpu", n=6)
    return m, sm, st.jacobi_preconditioner(m, device="cpu")


def _operators(m, sm):
    """The spmv callables the graph path must leave eager on the CPU."""
    bsr = st.BSRDevice(_host.csr_to_bsr(m), device="cpu")
    return {"lambda": lambda v: sm.spmv(v),
            "matrix_on_cpu": sm.spmv,
            "bsr": bsr.spmv}


@pytest.mark.parametrize("solver", ["pcg", "cg"])
@pytest.mark.parametrize("op", ["lambda", "matrix_on_cpu", "bsr"])
def test_eager_on_the_cpu_counts_its_iterations(cpu_system, solver, op):
    m, sm, jac = cpu_system
    spmv = _operators(m, sm)[op]
    b = _b(m, 1, "cpu")
    assert cgm._graph_matrix(spmv, jac, b) is None
    graphs = _counter(solver)
    before = dict(graphs)
    res = _solve(solver, spmv, b, jac, tol=0.0, maxiter=7, device="cpu")
    assert res.iterations == 7
    assert graphs["eager_iterations"] == before.get("eager_iterations",
                                                    0) + 7
    for key in ("captures", "replays"):
        assert graphs[key] == before.get(key, 0)


@pytest.mark.parametrize("solver", ["pcg", "cg"])
@pytest.mark.parametrize("tol, maxiter", [(0.0, 12), (1e-6, 200)])
def test_eager_loop_is_the_old_loop_bit_for_bit(cpu_system, solver, tol,
                                                maxiter):
    m, sm, jac = cpu_system
    b = _b(m, 2, "cpu")
    res = _solve(solver, sm.spmv, b, jac, tol=tol, maxiter=maxiter,
                 device="cpu")
    x, k, rn = _old_loop(sm.spmv, b, jac if solver == "pcg" else None,
                         maxiter, tol)
    assert (k < maxiter) == (tol > 0)
    _same(res, cgm.CGResult(x, k, rn))


def test_graph_matrix_wants_a_port_matrix_and_the_port_jacobi(cpu_system):
    m, sm, jac = cpu_system
    b = _b(m, 3, "cpu")
    ops = _operators(m, sm)
    # a CPU tensor is never captured, whatever the operator
    for spmv in ops.values():
        for pre in (None, jac, lambda r: jac(r)):
            assert cgm._graph_matrix(spmv, pre, b) is None


def test_jacobi_object_is_the_old_lambda_bit_for_bit(cpu_system):
    m, _, jac = cpu_system
    n = m.nr_rows
    diag = np.zeros(n, dtype=np.float64)
    rows = np.repeat(np.arange(n), np.diff(m.row_ptr))
    on = rows == m.col_ind
    np.add.at(diag, rows[on], m.values[on])
    inv = torch.as_tensor((1.0 / np.where(diag == 0.0, 1.0, diag)).astype(
        np.float32))

    def old(r):
        return r * inv.to(r.dtype)
    assert isinstance(jac, cgm._Jacobi)
    for dtype in (torch.float32, torch.float64):
        r = torch.as_tensor(np.random.default_rng(4).standard_normal(n),
                            dtype=dtype)
        assert torch.equal(jac(r), old(r)) and jac(r).dtype == dtype


def test_graph_cache_holds_matrix_and_preconditioner_weakly():
    m, sm = _matrix("classic_f64", "cpu", n=4)
    jac = st.jacobi_preconditioner(m, device="cpu")
    made = []

    def make():
        made.append(object())
        return made[-1]
    first = cgm._cached(sm, jac, 0, make)
    assert cgm._cached(sm, jac, 0, make) is first and len(made) == 1
    cgm._cached(sm, None, 0, make)
    assert sm in cgm._GRAPHS and len(cgm._GRAPHS[sm]) == 2
    del jac
    gc.collect()
    assert len(cgm._GRAPHS[sm]) == 1         # the preconditioner's went
    del sm
    gc.collect()
    assert not any(isinstance(k, st.SparseMatrix) and k.nr_rows == m.nr_rows
                   and k.device.type == "cpu" for k in cgm._GRAPHS.keys())


def test_graph_cache_makes_an_entry_once_across_threads():
    m, sm = _matrix("classic_f64", "cpu", n=4)
    made, start = [], threading.Barrier(4)

    def make():
        made.append(object())
        time.sleep(0.05)
        return made[-1]

    def lookup(out):
        start.wait()
        out.append(cgm._cached(sm, None, 1, make))
    got = []
    threads = [threading.Thread(target=lookup, args=(got,))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(made) == 1 and all(g is made[0] for g in got)
    # one entry a stream
    assert cgm._cached(sm, None, 2, make) is made[1]


def test_count_adds_a_replay_gain_times_over():
    def counted():
        pass
    counted.launches = 3

    def by_form():
        pass
    by_form.launches = collections.Counter(short=1)
    gains = [(counted, 2), (by_form, collections.Counter(short=1, long=2))]
    cgm._count(gains, 5)
    assert counted.launches == 13
    assert by_form.launches == collections.Counter(short=6, long=10)
    cgm._count(gains, -5)
    assert counted.launches == 3 and +by_form.launches == {"short": 1}


def test_counters_are_the_wrappers_that_count_launches():
    import pkgutil
    import sparsetpu_torch.kernels as kernels
    counting = set()
    for info in pkgutil.iter_modules(kernels.__path__):
        mod = importlib.import_module(f"{kernels.__name__}.{info.name}")
        counting |= {f for f in vars(mod).values()
                     if callable(f) and hasattr(f, "launches")}
    assert counting == set(cgm._counters())
    for wrapper in counting:
        assert isinstance(wrapper.launches, (int, collections.Counter))


# -- the card -----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["pcg", "cg"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_graph_is_the_eager_loop_bit_for_bit(cuda, route, solver):
    m, sm = _matrix(route, cuda)
    jac = st.jacobi_preconditioner(m, device=cuda)
    graphs = _counter(solver)
    captures = graphs["captures"]
    for seed, tol, maxiter in ((5, 0.0, 12), (6, 1e-9, 400)):
        b = _b(m, seed, cuda)
        replays, eager = graphs["replays"], graphs["eager_iterations"]
        got = _solve(solver, sm.spmv, b, jac, tol=tol, maxiter=maxiter)
        assert graphs["replays"] == replays + got.iterations
        assert graphs["eager_iterations"] == eager
        want = _solve(solver, lambda v: sm.spmv(v), b, jac, tol=tol,
                      maxiter=maxiter)
        assert graphs["eager_iterations"] == eager + want.iterations
        assert (got.iterations < maxiter) == (tol > 0)
        _same(got, want)
    assert graphs["captures"] == captures + 1


def _launches():
    return [collections.Counter(w.launches)
            if isinstance(w.launches, collections.Counter)
            else w.launches for w in cgm._counters()]


def _gained(before):
    return [a - b for a, b in zip(_launches(), before)]


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["pcg", "cg"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_replays_count_the_launches_of_the_eager_loop(cuda, route, solver):
    m, sm = _matrix(route, cuda)
    jac = st.jacobi_preconditioner(m, device=cuda)
    b = _b(m, 9, cuda)
    _solve(solver, sm.spmv, b, jac, tol=0.0, maxiter=3)   # the capture
    before = _launches()
    got = _solve(solver, sm.spmv, b, jac, tol=0.0, maxiter=12)
    by_graph = _gained(before)
    before = _launches()
    want = _solve(solver, lambda v: sm.spmv(v), b, jac, tol=0.0,
                  maxiter=12)
    assert got.iterations == want.iterations == 12
    assert by_graph == _gained(before) and any(by_graph)


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_each_solve_returns_its_own_x(cuda, route):
    m, sm = _matrix(route, cuda)
    jac = st.jacobi_preconditioner(m, device=cuda)
    first = st.pcg_df64(sm.spmv, _b(m, 7, cuda), jac, tol=0.0, maxiter=20)
    kept = first.x.clone()
    second = st.pcg_df64(sm.spmv, _b(m, 8, cuda), jac, tol=0.0, maxiter=20)
    assert torch.equal(first.x, kept)
    assert not torch.equal(first.x, second.x)
    assert first.x.data_ptr() != second.x.data_ptr()
    entry = next(iter(cgm._GRAPHS[sm][jac].values()))
    assert second.x.data_ptr() != entry.state.x.data_ptr()
