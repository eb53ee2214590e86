"""Iterative solvers built on the SpMV (counterpart of
``sparsetpu/solvers/cg.py``).

Each solver takes ``spmv``, any callable y = A @ v on tensors:
``SparseMatrix.spmv``, ``BSRDevice.spmv``, or a user's own.  A tensor ``b``
keeps its device; anything else is placed on ``device`` (the card unless
the caller asks for the CPU).  The JAX package's ``lax.while_loop`` is a
Python loop here with the same condition, tested before each body, so the
iteration counts agree; reading that condition on the host costs one
scalar sync an iteration.  ``fori_loop`` is ``range``.

``cg_df64`` and ``pcg_df64`` replay each iteration as one CUDA graph where
they recognise their inputs: ``spmv`` the bound ``spmv`` of a port
``SparseMatrix``, b on the card, and for ``pcg_df64`` ``m_inv`` the port's
``jacobi_preconditioner``.  The iteration and the next convergence test
are captured once per (matrix, preconditioner, current stream) into
buffers the graph owns, cached weakly on the matrix and the
preconditioner: each stream a solve runs on keeps its own graph, buffers
and memory pool (about 110 MB at HPCG 104^3) while both live.  A solve's
prologue runs eagerly and writes into those buffers, then each pass reads
the test the prologue or the last replay wrote and replays.  The graph
issues the eager iteration's own operations in the same order
(``_iterate``, written in place), so x, ``iterations`` and
``residual_norm`` are the eager loop's bit for bit; x is returned as a
fresh tensor.  Anything else, or a graph another
thread is replaying, runs the eager loop.  ``cg_df64.graphs`` and
``pcg_df64.graphs`` count ``captures``, ``replays`` and
``eager_iterations``; the kernel wrappers' ``.launches`` count what ran,
the captured iteration's launches once for each replay.

``cg_df64`` and ``pcg_df64`` open spans (``utils/timing.py:span``) while a
profiler runs: ``sparsetpu.cg`` (``pcg``) over the solve,
``sparsetpu.cg.capture`` over a capture, ``sparsetpu.cg.iter`` over each
pass of the loop, and inside it ``sparsetpu.cg.check`` over the host's
read of the convergence test (its ``bool``), where the device drains, and
``sparsetpu.cg.replay`` over a graph's launch; an eager pass holds the
SpMV's own spans.  A solve that converges ends with a pass that holds its
test alone.

Real types follow the reference: ``cg`` and ``bicgstab`` run in b's float
type (float32 or float64), ``pcg``, ``gmres``, ``power_iteration`` and
``jacobi_iteration`` in float32, and ``cg_df64``/``pcg_df64`` in float64,
the port's counterpart of the reference's DF64 pairs (there is no DF64
type here), with the reference's float32 convergence test.
"""

from __future__ import annotations

import collections
import threading
import weakref
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..api import api as _api
from ..utils.device import require_device
from ..utils.timing import span


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor


def _vector(v, device, dtype=None) -> torch.Tensor:
    """``v`` as a 1-D tensor: a tensor keeps its device, anything else goes
    to ``device``; the real type is ``dtype``, else v's own float type
    (float32 for other types)."""
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(np.asarray(v), device=require_device(device))
    if dtype is None:
        dtype = v.dtype if v.dtype in (torch.float32, torch.float64) \
            else torch.float32
    return v.to(dtype)


def _typed(f, dtype):
    """``f`` with its result in ``dtype`` (an operator of another real type
    still runs in its own)."""
    return lambda v: f(v).to(dtype)


def _start(b, x0) -> torch.Tensor:
    return torch.zeros_like(b) if x0 is None else \
        _vector(x0, b.device, b.dtype).to(b.device)


def _tol2(tol, b) -> torch.Tensor:
    """tol^2 * max(b.b, 1e-30) in b's real type."""
    return torch.tensor(tol, dtype=b.dtype, device=b.device) ** 2 * \
        torch.clamp_min(torch.dot(b, b), 1e-30)


def _tol2_f32(tol, b) -> torch.Tensor:
    """The reference's df64 test: float32(tol)^2 * max(f32(b.b), 1e-30),
    in float32 (``cg.py:78-83``)."""
    return torch.tensor(tol, dtype=torch.float32, device=b.device) ** 2 * \
        torch.clamp_min(torch.dot(b, b).float(), 1e-30)


def cg(spmv: Callable[[torch.Tensor], torch.Tensor], b,
       x0=None, tol: float = 1e-6, maxiter: int = 1000, *,
       device="cuda") -> CGResult:
    """Conjugate gradients for SPD A."""
    b = _vector(b, device)
    x = _start(b, x0)
    spmv = _typed(spmv, b.dtype)
    r = b - spmv(x)
    p = r
    rs = torch.dot(r, r)
    tol2 = _tol2(tol, b)
    k = 0
    while k < maxiter and bool(rs > tol2):
        ap = spmv(p)
        alpha = rs / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
        k += 1
    return CGResult(x, k, torch.sqrt(rs))


def cg_df64(spmv, b, x0=None, tol: float = 1e-12, maxiter: int = 1000, *,
            device="cuda") -> CGResult:
    """Conjugate gradients in float64 (the reference's df64 CG, its DOUBLE=1
    solve): x, r, p and every dot in float64, ``spmv`` an f64 matvec (e.g.
    ``SparseMatrix.spmv`` of an f64 config; a float32 result is widened).
    The stopping test is the reference's, in float32; ``residual_norm`` is
    float32."""
    return _solve_df64("cg", cg_df64.graphs, spmv, b, None, x0, tol, maxiter,
                       device)


def pcg_df64(spmv, b, m_inv, x0=None, tol: float = 1e-12,
             maxiter: int = 1000, *, device="cuda") -> CGResult:
    """Preconditioned CG in float64: ``cg_df64`` with ``m_inv`` applied to
    the residual each step (its result is widened to float64)."""
    return _solve_df64("pcg", pcg_df64.graphs, spmv, b, m_inv, x0, tol,
                       maxiter, device)


cg_df64.graphs = collections.Counter()
pcg_df64.graphs = collections.Counter()


class _State:
    """A float64 CG iterate: x, r, p, the scalar ``rz`` (r.z; r.r without a
    preconditioner), ``tol2`` and the next test ``going``.  An eager solve
    binds new tensors each iteration; a graph's state (``owned``) is the
    buffers it reads and writes in place."""

    NAMES = ("x", "r", "p", "rz", "tol2", "going")

    def __init__(self, owned: bool = False, **tensors):
        self.owned = owned
        for name in self.NAMES:
            setattr(self, name, tensors[name])

    def out(self, name: str) -> Optional[torch.Tensor]:
        """The ``out=`` of a write to ``name``: its buffer, or None."""
        return getattr(self, name) if self.owned else None

    def put(self, name: str, value: torch.Tensor) -> None:
        if self.owned:
            getattr(self, name).copy_(value)
        else:
            setattr(self, name, value)

    def load(self, other: "_State") -> None:
        for name in self.NAMES:
            self.put(name, getattr(other, name))


def _prologue(b, x, mv, pre, tol) -> _State:
    """r0 = b - A x0, z0, p0 = z0, rz0 and the first test."""
    r = b - mv(x)
    z = r if pre is None else pre(r)
    rz = torch.dot(r, z)
    tol2 = _tol2_f32(tol, b)
    rr = rz if pre is None else torch.dot(r, r)
    return _State(x=x, r=r, p=z, rz=rz, tol2=tol2, going=rr.float() > tol2)


def _iterate(s: _State, mv, pre) -> None:
    """One CG iteration on ``s`` (PCG with ``pre``), then the next
    convergence test: the eager loop's body, and what a graph captures."""
    ap = mv(s.p)
    alpha = s.rz / torch.dot(s.p, ap)
    s.x = torch.add(s.x, alpha * s.p, out=s.out("x"))
    s.r = torch.sub(s.r, alpha * ap, out=s.out("r"))
    z = s.r if pre is None else pre(s.r)
    rz_new = torch.dot(s.r, z)
    s.p = torch.add(z, (rz_new / s.rz) * s.p, out=s.out("p"))
    s.put("rz", rz_new)
    rr = rz_new if pre is None else torch.dot(s.r, s.r)
    s.going = torch.gt(rr.float(), s.tol2, out=s.out("going"))


def _counters():
    """The kernel wrappers that count their launches in ``.launches`` (a
    count, or a ``Counter`` by form)."""
    from ..kernels import bsr, final_rows, spmm, spmv_fused, spmv_gstream
    return (spmv_fused.fused_spmv, spmv_fused.fused_spmv_f64,
            spmv_fused.fused_spmm, spmv_gstream.gstream_chunk_sums,
            spmv_gstream.live_slot_sums, final_rows.final_rows,
            final_rows.final_rows_multi, spmm.gstream_chunk_sums_multi,
            spmm.gstream_chunk_sums_multi_f64, bsr.bsr_partials)


def _count(gains, times: int) -> None:
    """Adds ``times`` x each wrapper's gain to its ``.launches``."""
    for wrapper, gain in gains:
        if isinstance(gain, collections.Counter):
            wrapper.launches.update({k: v * times for k, v in gain.items()})
        else:
            wrapper.launches += gain * times


class _Graph:
    """One captured iteration, its buffers, the wrappers' launch counts of
    one replay (``launches``: the counts the capture added, taken back out
    since a capture launches nothing, and added again for each replay) and
    a lock that one solve holds while it replays."""

    def __init__(self, s: _State, mv, pre):
        dev = s.x.device
        self.state = _State(owned=True, **{
            name: torch.zeros_like(getattr(s, name))
            for name in _State.NAMES})
        self.lock = threading.Lock()
        self.graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.device(dev):
            with torch.cuda.stream(side):
                _iterate(self.state, mv, pre)   # warm-up: cuBLAS's workspace
            before = [(w, collections.Counter(w.launches)
                       if isinstance(w.launches, collections.Counter)
                       else w.launches) for w in _counters()]
            with torch.cuda.graph(self.graph, stream=side,
                                  capture_error_mode="thread_local"):
                _iterate(self.state, mv, pre)
            self.launches = [(w, w.launches - n) for w, n in before
                             if w.launches != n]
            _count(self.launches, -1)
        torch.cuda.current_stream(dev).wait_stream(side)


class _Identity:
    """``cg_df64``'s preconditioner, as a key of the graph cache."""


# matrix -> preconditioner (or _IDENTITY) -> current stream -> _Graph
_GRAPHS = weakref.WeakKeyDictionary()
_GRAPHS_LOCK = threading.Lock()
_IDENTITY = _Identity()


def _cached(matrix, m_inv, stream, make):
    """The entry of (matrix, m_inv) for ``stream``, made by ``make()`` the
    first time (under a lock, so two threads never both make one); it
    lives as long as both do."""
    with _GRAPHS_LOCK:
        per_matrix = _GRAPHS.setdefault(matrix, weakref.WeakKeyDictionary())
        entries = per_matrix.setdefault(
            _IDENTITY if m_inv is None else m_inv, {})
        if stream not in entries:
            entries[stream] = make()
        return entries[stream]


def _graph_matrix(spmv, m_inv, b):
    """The port ``SparseMatrix`` whose iteration a graph may replay: spmv
    its bound ``spmv``, b on its card, m_inv None or the port's Jacobi on
    that card; else None."""
    matrix = getattr(spmv, "__self__", None)
    if getattr(spmv, "__func__", None) is not _api.SparseMatrix.spmv or \
            not isinstance(matrix, _api.SparseMatrix) or \
            b.device.type != "cuda" or matrix.device != b.device:
        return None
    if m_inv is not None and not (isinstance(m_inv, _Jacobi)
                                  and m_inv.inv.device == b.device):
        return None
    return matrix


def _solve_df64(name, graphs, spmv, b, m_inv, x0, tol, maxiter, device):
    """``cg_df64`` (``m_inv`` None) and ``pcg_df64``."""
    with span(name):
        b = _vector(b, device, torch.float64)
        mv = _typed(spmv, b.dtype)
        pre = None if m_inv is None else _typed(m_inv, b.dtype)
        s = _prologue(b, _start(b, x0), mv, pre, tol)
        g = None
        matrix = _graph_matrix(spmv, m_inv, b) if maxiter > 0 else None
        if matrix is not None:
            stream = torch.cuda.current_stream(b.device).cuda_stream

            def make():
                with span(name + ".capture"):
                    graph = _Graph(s, mv, pre)
                graphs["captures"] += 1
                return graph
            g = _cached(matrix, m_inv, stream, make)
            if g.lock.acquire(blocking=False):
                g.state.load(s)
                s = g.state
            else:
                g = None
        k = 0
        try:
            while k < maxiter:
                with span(name + ".iter"):
                    with span(name + ".check"):
                        if not bool(s.going):
                            break
                    if g is None:
                        _iterate(s, mv, pre)
                        graphs["eager_iterations"] += 1
                    else:
                        with span(name + ".replay"):
                            g.graph.replay()
                        graphs["replays"] += 1
                    k += 1
            rr = s.rz if pre is None else torch.dot(s.r, s.r)
            return CGResult(s.x if g is None else s.x.clone(), k,
                            torch.sqrt(rr.float()))
        finally:
            if g is not None:
                _count(g.launches, k)
                g.lock.release()


def cg_step(spmv: Callable[[torch.Tensor], torch.Tensor]):
    """One CG iteration as a standalone step function."""

    def step(x, r, p, rs):
        ap = spmv(p)
        alpha = rs / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        return x, r, p, rs_new

    return step


def bicgstab(spmv: Callable[[torch.Tensor], torch.Tensor], b,
             x0=None, tol: float = 1e-6, maxiter: int = 1000, *,
             device="cuda") -> CGResult:
    """BiCGSTAB for general (non-symmetric) A."""
    b = _vector(b, device)
    x = _start(b, x0)
    spmv = _typed(spmv, b.dtype)
    r = b - spmv(x)
    rhat = r
    rho = alpha = omega = torch.tensor(1.0, dtype=b.dtype, device=b.device)
    v = p = torch.zeros_like(b)
    tol2 = _tol2(tol, b)
    k = 0
    while k < maxiter and bool(torch.dot(r, r) > tol2):
        rho_new = torch.dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        v = spmv(p)
        alpha = rho_new / torch.dot(rhat, v)
        s = r - alpha * v
        t = spmv(s)
        omega = torch.dot(t, s) / torch.clamp_min(torch.dot(t, t), 1e-30)
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho = rho_new
        k += 1
    return CGResult(x, k, torch.linalg.norm(r))


def gmres(spmv: Callable[[torch.Tensor], torch.Tensor], b,
          x0=None, restart: int = 30, tol: float = 1e-6,
          maxiter: int = 1000, *, device="cuda") -> CGResult:
    """Restarted GMRES(m) for general A, in float32.  The small (m+1, m)
    least-squares solve is the reference's ``jnp.linalg.lstsq``: a
    min-norm solve through the SVD, singular values below eps * (m+1)
    times the largest dropped, so a cycle whose Krylov space breaks down
    (a zero ``hnext``) still solves.  ``iterations`` counts Arnoldi steps,
    m a cycle."""
    b = _vector(b, device, torch.float32)
    n, m = b.shape[0], int(restart)
    x = _start(b, x0)
    spmv = _typed(spmv, torch.float32)
    bnorm = torch.clamp_min(torch.linalg.norm(b), 1e-30)
    rcond = float(torch.finfo(torch.float32).eps) * (m + 1)

    def cycle(x):
        r = b - spmv(x)
        beta = torch.linalg.norm(r)
        V = torch.zeros(m + 1, n, dtype=torch.float32, device=b.device)
        V[0] = r / torch.clamp_min(beta, 1e-30)
        H = torch.zeros(m + 1, m, dtype=torch.float32, device=b.device)
        for j in range(m):
            w = spmv(V[j])
            # modified Gram-Schmidt against the basis so far (the
            # reference's rows past j are zero: its extra dots are no-ops)
            for i in range(j + 1):
                h = torch.dot(V[i], w)
                w = w - h * V[i]
                H[i, j] = h
            hnext = torch.linalg.norm(w)
            H[j + 1, j] = hnext
            V[j + 1] = w / torch.clamp_min(hnext, 1e-30)
        u, s, vh = torch.linalg.svd(H, full_matrices=False)
        keep = (s > 0) & (s >= rcond * s[0])
        s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
        y = vh.T @ (s_inv * (u[0] * beta))      # u.T @ (beta * e1)
        return x + V[:m].T @ y

    k = 0
    while k < maxiter and bool(
            torch.linalg.norm(b - spmv(x)) / bnorm > tol):
        x = cycle(x)
        k += m
    return CGResult(x, k, torch.linalg.norm(b - spmv(x)))


def power_iteration(spmv, n, iters: int = 50, seed: int = 0, *,
                    device="cuda"):
    """Dominant eigenvalue estimate: (v.A v, v) after ``iters`` normalised
    products.  v0 is drawn from a ``torch.Generator`` seeded with ``seed``
    (not the reference's ``jax.random`` draw)."""
    dev = require_device(device)
    spmv = _typed(spmv, torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    v = torch.randn(n, generator=gen, device=dev)
    v = v / torch.linalg.norm(v)
    for _ in range(iters):
        w = spmv(v)
        v = w / torch.linalg.norm(w)
    return torch.dot(v, spmv(v)), v


def pcg(spmv: Callable[[torch.Tensor], torch.Tensor], b,
        m_inv: Callable[[torch.Tensor], torch.Tensor],
        x0=None, tol: float = 1e-6, maxiter: int = 1000, *,
        device="cuda") -> CGResult:
    """Preconditioned CG in float32: ``m_inv`` applies the preconditioner
    inverse (e.g. ``jacobi_preconditioner(A)``); stops at ||r|| / ||b|| <=
    tol."""
    b = _vector(b, device, torch.float32)
    x = _start(b, x0)
    spmv, m_inv = _typed(spmv, b.dtype), _typed(m_inv, b.dtype)
    r = b - spmv(x)
    z = m_inv(r)
    p = z
    rz = torch.dot(r, z)
    bnorm = torch.clamp_min(torch.linalg.norm(b), 1e-30)
    k = 0
    while k < maxiter and bool(torch.linalg.norm(r) / bnorm > tol):
        ap = spmv(p)
        alpha = rz / torch.clamp_min(torch.dot(p, ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        z = m_inv(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / torch.clamp_min(rz, 1e-30)
        p = z + beta * p
        rz = rz_new
        k += 1
    return CGResult(x, k, torch.linalg.norm(r))


def jacobi_preconditioner(matrix, *, device="cuda") -> Callable:
    """Diagonal (Jacobi) preconditioner from a CSRMatrix: z = r / diag(A).

    Zero / missing diagonal entries fall back to 1 (identity on those
    rows).  The inverse diagonal is rounded to float32, as the reference
    keeps it, and applied in r's real type."""
    n = matrix.nr_rows
    diag = np.zeros(n, dtype=np.float64)
    rows = np.repeat(np.arange(n, dtype=np.int64),
                     np.diff(matrix.row_ptr).astype(np.int64))
    on_diag = rows == matrix.col_ind
    np.add.at(diag, rows[on_diag], matrix.values[on_diag])
    diag = np.where(diag == 0.0, 1.0, diag)
    return _Jacobi(torch.as_tensor((1.0 / diag).astype(np.float32),
                                   device=require_device(device)))


class _Jacobi:
    """z = r * inv, the inverse diagonal ``inv`` (float32) applied in r's
    real type: ``jacobi_preconditioner``'s result, which ``pcg_df64``
    recognises."""

    def __init__(self, inv: torch.Tensor):
        self.inv = inv

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return r * self.inv.to(r.dtype)


def jacobi_iteration(spmv, matrix, b, iters: int = 100, omega: float = 1.0,
                     *, device="cuda") -> torch.Tensor:
    """Weighted Jacobi relaxation x_{k+1} = x_k + omega D^-1 (b - A x_k),
    float32, from x_0 = 0."""
    b = _vector(b, device, torch.float32)
    spmv = _typed(spmv, b.dtype)
    m_inv = jacobi_preconditioner(matrix, device=b.device)
    x = torch.zeros_like(b)
    for _ in range(iters):
        x = x + omega * m_inv(b - spmv(x))
    return x
